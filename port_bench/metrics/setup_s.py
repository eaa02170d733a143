"""setup_s: seconds from the process's start to the end of set-up (the
card, the kernels' libraries, data, the program's set-up, weights, the
warm-up and, for training, the rounds the check follows)."""
LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", None


def read(run):
    return run["setup_s"]
