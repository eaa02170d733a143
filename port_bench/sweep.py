"""Find the knee of an open-loop serving cell: one set-up, then a window
at each offered rate, the latencies and whether the backlog grew.

    python3 port_bench/sweep.py --workload adult.serve --seed 1 \\
        --seconds 8 --rates 200,400,600,800

A rate's backlog grew when the requests due in the window's last quarter
waited far longer than those due in its first.  The cell's fixed rate is
set once, at about four fifths of the highest rate whose backlog did not
grow.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":       # run as a script from a checkout
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

from port_bench import harness, tracing  # noqa: E402


def main() -> int:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.empty(1, device="cuda")
    harness.pin_fastest_core()                  # as run.py
    ctx = harness.context(args.workload, args.seed, args.seconds, False,
                          "cuda")
    kind = __import__(f"port_bench.kinds.{ctx.traffic['kind']}",
                      fromlist=["setup"])
    st = kind.setup(ctx)
    print(f"set-up {time.perf_counter() - T0:.1f} s", flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.traffic["rate_per_s"] = rate
        st.sample, st.longest = [], None
        rec = kind.window(st, args.seconds, tracing.Trace(False))
        reqs = sorted(rec["requests"], key=lambda r: r["due"])
        lat = np.array([(r["done"] - r["due"]) * 1e3 if r["done"] is not None
                        else np.inf for r in reqs])
        q = max(1, len(lat) // 4)
        rows = sum(r["rows"] for r in reqs if r["done"] is not None
                   and r["done"] <= args.seconds)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(reqs),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "first_quarter_mean_ms": float(np.mean(lat[:q])),
            "last_quarter_mean_ms": float(np.mean(lat[-q:])),
            "last_answer_s": max(r["done"] or 0 for r in reqs),
            "rows_per_s_in_window": rows / args.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
