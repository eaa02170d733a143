"""The readings the output check's limits are set from, on the card at a
cell's own size, many seeds in one process:

    python3 port_bench/control.py --workload adult.train \\
        --seeds 101,102,103 --seconds 3 --faults 3

For each seed: the cell's set-up and a short window at its own load, the
program's state freed, the reference, and then, each held to the
reference by the cell's own comparison:

* ``sound``: the program (the lower reading);
* ``control``: the reference itself with TF32 on, the nearest precision
  below the float32 the configurations state (the upper reading);
* ``fault:<name>``: on the first ``--faults`` seeds, the reference put in
  the program's place with one fault planted (training: "half", the steps
  on half of their batch; "no_merge", the exchange left out; "encode", an
  encoded entry altered; "weights", a §4.2 weight altered; serving:
  "answer", a value altered; "half", the generator on half of the
  bucket).  A state left unchanged reads 1 by the training measure and
  needs no run.

One JSON line per seed.  The benchmark's runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":       # run as a script from a checkout
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

from port_bench import harness, serving, tracing  # noqa: E402
from port_bench.kinds import federated  # noqa: E402

FAULTS = {"federated": ("half", "no_merge", "encode", "weights"),
          "open_loop": ("answer", "half"),
          "closed_loop": ("answer", "half")}


@contextlib.contextmanager
def tf32():
    import torch
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def worst_loss(got: dict, want: dict) -> list:
    """Where the widest loss gap lies: [gap, round, client, step, loss],
    and the widest gap of each round (a gap that starts at one step and
    carries on is a discontinuity met there, not drift)."""
    import torch
    g, w = got["losses"], want["losses"]
    scale = torch.median(torch.abs(w), dim=0).values.median(0).values \
        .median(0).values
    gap = torch.abs(g - w) / torch.maximum(torch.abs(w), scale)
    i = int(torch.argmax(gap))
    idx = list(torch.unravel_index(torch.tensor(i), gap.shape))
    return [float(gap.flatten()[i]), *(int(x) for x in idx),
            [float(gap[r].max()) for r in range(gap.shape[0])]]


def readings(ctx, n_faults: int) -> dict:
    import importlib

    import torch
    kind_name = ctx.traffic["kind"]
    kind = importlib.import_module(f"port_bench.kinds.{kind_name}")
    st = kind.setup(ctx)
    kind.window(st, ctx.seconds, tracing.Trace(False))
    out = {}
    if kind_name == "federated":
        got = federated.program_outputs(st)
        st.fe = st.prog = st.pool = None
        torch.cuda.empty_cache()
        ref = federated.reference_outputs(st)
        out["sound"] = federated.compare(got, ref, diagnostics=True)
        out["sound_worst_loss"] = worst_loss(got, ref)
        with tf32():
            out["control"] = federated.compare(
                federated.reference_outputs(st), ref, diagnostics=True)
        for f in FAULTS[kind_name] if n_faults else ():
            out[f"fault:{f}"] = federated.compare(
                federated.reference_outputs(st, f), ref, diagnostics=True)
    else:
        items = serving.samples(st)
        st.srv = st.gens = None
        torch.cuda.empty_cache()
        ref = serving.reference_answers(st, items)
        out["sound"] = serving.compare([i["data"] for i in items], ref,
                                       st.kinds)
        with tf32():
            ctl = serving.reference_answers(st, items)
        out["control"] = serving.compare([w for w, _ in ctl], ref, st.kinds)
        for f in FAULTS[kind_name] if n_faults else ():
            bad = serving.reference_answers(st, items, f)
            out[f"fault:{f}"] = serving.compare([w for w, _ in bad], ref,
                                                st.kinds)
        out["rows_compared"] = sum(i["rows"] for i in items)
    return out


def main() -> int:
    import torch
    torch.set_num_threads(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", type=int, default=3,
                    help="read the faults on this many of the seeds")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              "cuda")
        out = readings(ctx, 1 if i < args.faults else 0)
        out.update(seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
