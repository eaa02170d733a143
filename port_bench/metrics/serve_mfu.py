"""serve_mfu: the whole synthesis step's share of the float32 peak under
open-loop requests (see ``_decode.py``)."""
from port_bench.metrics._decode import serve_mfu

LAYER = "synthesis step (synth/engine.py, gan/trainer.py sample_synthetic)"
UNIT, SOURCE, MOVES = "%", "device_trace", "serve_busy_us_per_row"


def read(run):
    return serve_mfu(run)
