"""train_mfu: the traced window's model FLOPs (the benchmark's CTGAN
formula, ``port_bench/work.py``: forward, backward and the penalty's
double backward, nothing recomputed) over the card's busy time in that
window times the H100's float32 peak, 67 TFLOP/s (TF32 is off): the
whole step's share of the peak while the card works, which bounds the
kernels' rooflines and moves as ``train_busy_us_per_row`` does."""
from port_bench import work

LAYER = ("local step (synth/engine.py RoundEngine, gan/trainer.py, "
         "gan/ctgan.py, optim/)")
UNIT, SOURCE, MOVES = "%", "device_trace", "train_busy_us_per_row"


def read(run):
    busy = run["trace"].busy_s
    if run["kind"] != "train" or not run["traced"]["steps"] or not busy:
        return None
    return 100.0 * run["traced"]["model_flops"] / (busy
                                                   * work.PEAK_F32_FLOPS)
