"""queue_ms.serve: the mean over the window's requests of their dispatch
(the program's call of the tenant's generator, seen by a forward
pre-hook; a tenant's requests run in order) less their due
time."""
LAYER = "server and scheduler (serve/server.py, serve/scheduling.py)"
UNIT, SOURCE, MOVES = "ms", "host_clock", "serve_busy_us_per_row"


def read(run):
    if run["kind"] != "serve":
        return None
    waits = [r["dispatched"] - r["due"] for r in run["requests"]
             if "dispatched" in r]
    return 1e3 * sum(waits) / len(waits) if waits else None
