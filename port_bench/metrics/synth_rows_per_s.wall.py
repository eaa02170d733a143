"""synth_rows_per_s.wall: rows of every answer delivered inside the window,
over the window's length."""
LAYER = "host path (the program's entry points, on the host's clock)"
UNIT, SOURCE, MOVES = "rows/s", "host_clock", "bulk_busy_us_per_row"


def read(run):
    if run["kind"] != "serve":
        return None
    rows = sum(r["rows"] for r in run["requests"]
               if r["done"] is not None and r["done"] <= run["elapsed_s"])
    return rows / run["elapsed_s"]
