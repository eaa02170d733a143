"""vgm_decode_table_roofline.serve: the decode kernel's share of its
roofline under open-loop requests (see ``_decode.py``)."""
from port_bench.metrics._decode import decode_roofline

LAYER = "kernels (kernels/ops.py -> csrc/*.cu)"
UNIT, SOURCE, MOVES = "%", "device_trace", "serve_busy_us_per_row"


def read(run):
    return decode_roofline(run)
