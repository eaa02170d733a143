"""merge_ms.train: device time of the federator's merge
(``weighted_agg_kernel``) per global round of the traced window."""
LAYER = "round and merge (fed/program.py, fed/merge.py -> weighted_agg)"
UNIT, SOURCE, MOVES = "ms", "device_trace", "train_busy_us_per_row"


def read(run):
    ns, n = run["trace"].device_ns("weighted_agg_kernel")
    if run["kind"] != "train" or not n:
        return None
    return ns / 1e6 / run["traced"]["rounds"]
