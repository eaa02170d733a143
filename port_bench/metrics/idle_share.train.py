"""idle_share.train: the share of the traced window in which no
operation ran on the card."""
from port_bench.metrics._device import idle_share

LAYER = "device (H100)"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_busy_us_per_row"


def read(run):
    return idle_share(run) if run["kind"] == "train" else None
