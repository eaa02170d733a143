"""vgm_decode_table_roofline.bulk: the decode kernel's share of its
roofline under closed-loop bulk requests (see ``_decode.py``)."""
from port_bench.metrics._decode import decode_roofline

LAYER = "kernels (kernels/ops.py -> csrc/*.cu)"
UNIT, SOURCE, MOVES = "%", "device_trace", "bulk_busy_us_per_row"


def read(run):
    return decode_roofline(run)
