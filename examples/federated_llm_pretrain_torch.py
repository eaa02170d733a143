"""Fed-TGAN's technique beyond tabular GANs on the PyTorch port:
federated LM pre-training on the card.

The twin of ``examples/federated_llm_pretrain.py``.  The paper's §4.2
weighting generalizes to any per-client statistics.  Here 4 clients hold
Non-IID token streams (skewed Zipf exponents + rotated vocab); the
federator weights their model updates by token-frequency similarity and
runs weighted-FedAvg rounds over a reduced smollm-135m, each merged in
ONE ``weighted_agg`` kernel launch.

Run:  PYTHONPATH=src python examples/federated_llm_pretrain_torch.py
      (options: --rounds R --seq N --device cpu)
"""
import argparse
import sys
sys.path.insert(0, "src")

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import run_federated


def parse(argv=None) -> argparse.Namespace:
    """The settings of a run: the reference's flags and defaults, and
    ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return args


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("smollm-135m")
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    _, hist, w = run_federated(cfg, clients=4, rounds=args.rounds,
                               local_steps=2, batch=4, seq=args.seq,
                               lr=3e-4, iid=False, weighting="fedtgan",
                               device=dev)
    print(f"\nsimilarity weights over Non-IID clients: {np.round(w, 3)}")
    losses = [h["loss"] for h in hist]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "federated training should make progress"


if __name__ == "__main__":
    main()
