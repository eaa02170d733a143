"""segment_activations_roofline: the least time of the traced window's
forward and backward launches of the generator head's kernels (bytes and
operations of ``port_bench/work.py`` at the step's batch and the encoded
row's spans, without the kernels' padding) over their device time."""
from port_bench import work

LAYER = "kernels (kernels/ops.py -> csrc/*.cu)"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_busy_us_per_row"


def read(run):
    if run["kind"] != "train":
        return None
    t = run["trace"]
    fwd_ns, fwd = t.device_ns("segment_activations_tile",
                              "segment_activations_warp")
    bwd_ns, bwd = t.device_ns("segment_activations_bwd")
    if not fwd or not bwd:
        return None
    b, spans = run["batch"], run["spans"]
    least = (fwd * work.least_seconds(*work.segment_activations(b, spans))
             + bwd * work.least_seconds(*work.segment_activations(
                 b, spans, backward=True)))
    return 100.0 * least / ((fwd_ns + bwd_ns) / 1e9)
