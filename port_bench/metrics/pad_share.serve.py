"""pad_share.serve: rows generated only to fill a bucket, over all rows
generated, for the window's answered requests (their bucket is the
ladder's ``bucket_for``)."""
LAYER = "bucketing (serve/bucketing.py)"
UNIT, SOURCE, MOVES = "%", "program_counter", "serve_busy_us_per_row"


def read(run):
    done = [r for r in run["requests"] if r["bucket"] is not None] \
        if run["kind"] == "serve" else []
    total = sum(r["bucket"] for r in done)
    if not total:
        return None
    return 100.0 * sum(r["bucket"] - r["rows"] for r in done) / total
