"""train_busy_us_per_row: the card's busy time in the traced window (every
device record's duration) over the rows of that window's work, a round's local steps: the rows all clients consume
(batch x local steps x clients x rounds).

The card's time, not the host's: on a host shared with other work the
window's wall-clock numbers move from run to run by more than a bound
can hold (``PERF.md`` §2); they are per-layer metrics (``*.wall``)."""
from port_bench.metrics._device import busy_us_per_row

LAYER, UNIT, SOURCE, MOVES = "end to end", "us", "device_trace", None


def read(run):
    return busy_us_per_row(run, "train")
