"""serve_p95_ms.wall: the 95th percentile (nearest rank) over every request
due in the window of its answer's time less its due time; a request never
answered counts at the end of the wait."""
from port_bench.metrics._latency import latency_quantile

LAYER = "host path (the program's entry points, on the host's clock)"
UNIT, SOURCE, MOVES = "ms", "host_clock", "serve_busy_us_per_row"


def read(run):
    return latency_quantile(run, 0.95)
