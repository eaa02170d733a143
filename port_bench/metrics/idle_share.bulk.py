"""idle_share.bulk: the share of the traced window in which no operation
ran on the card, under closed-loop bulk requests."""
from port_bench.metrics._device import idle_share

LAYER = "device (H100)"
UNIT, SOURCE, MOVES = "%", "device_trace", "bulk_busy_us_per_row"


def read(run):
    return idle_share(run) if run["kind"] == "serve" else None
