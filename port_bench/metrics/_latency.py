"""Shared by the latency readers: a nearest-rank quantile of every
request's wait from due to answered, in ms."""
import math


def latency_quantile(run, q: float):
    if run["kind"] != "serve" or not run["requests"]:
        return None
    wait_end = run["elapsed_s"] + 60.0
    lat = sorted(((r["done"] if r["done"] is not None else wait_end)
                  - r["due"]) * 1e3 for r in run["requests"])
    return lat[max(0, math.ceil(q * len(lat)) - 1)]
