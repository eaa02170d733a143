"""launches_per_step.train: CUDA kernels launched in the traced window
(the program's, and the benchmark's few draws a round) per local step."""
LAYER = ("local step (synth/engine.py RoundEngine, gan/trainer.py, "
         "gan/ctgan.py, optim/)")
UNIT, SOURCE, MOVES = "launches", "device_trace", "train_busy_us_per_row"


def read(run):
    if run["kind"] != "train" or not run["trace"].kernels:
        return None
    return run["trace"].kernels / run["traced"]["steps"]
