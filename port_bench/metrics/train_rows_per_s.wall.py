"""train_rows_per_s.wall: real rows all clients consume in local steps
(batch x local steps x clients x rounds) over the window's whole time,
to the synchronize after its last round."""
LAYER = "host path (the program's entry points, on the host's clock)"
UNIT, SOURCE, MOVES = "rows/s", "host_clock", "train_busy_us_per_row"


def read(run):
    if run["kind"] != "train":
        return None
    return run["rows"] / run["elapsed_s"]
