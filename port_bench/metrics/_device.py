"""Shared by the device readers."""


def idle_share(run):
    t = run["trace"]
    if not t.busy_s or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def busy_us_per_row(run, kind: str):
    """Microseconds in which an operation ran on the card in the traced
    window, over the rows that window's work produced (trained rows, or
    the rows of every answered request); nothing without a trace."""
    t = run["trace"]
    if run["kind"] != kind or not t.busy_s:
        return None
    w = run["traced"]
    rows = (w["rows"] if kind == "train" else
            sum(r["rows"] for r in w["requests"] if r["done"] is not None))
    return 1e6 * t.busy_s / rows if rows else None
