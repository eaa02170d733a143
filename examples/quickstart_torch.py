"""Quickstart on the PyTorch port: Fed-TGAN end to end on a synthetic
Adult-like table, on the card.

The twin of ``examples/quickstart.py`` through ``repro_torch``:
  1. clients compute local statistics (categorical freqs + local VGMs),
  2. the federator builds global encoders WITHOUT seeing any rows (§4.1),
  3. table-similarity-aware aggregation weights (§4.2, Fig.4),
  4. federated CTGAN training rounds, each merged in ONE ``weighted_agg``
     kernel launch (conditional batches drawn on the card inside the
     round; see repro_torch.synth.RoundEngine),
  5. synthesis through the fused one-launch decode kernel
     (repro_torch.synth.synthesize_table) + Avg-JSD / Avg-WD evaluation
     (§5.2).

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      (without a card: --device cpu, the kernels' plain PyTorch versions;
       smaller runs: --rows N --rounds R)
"""
import argparse
import sys
sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.architectures import run_federated
from repro_torch.device import resolve_device
from repro_torch.gan.ctgan import CTGANConfig
from repro_torch.synth import synthesize_table
from repro_torch.tabular import make_dataset, partition_quantity_skew


def parse(argv=None) -> argparse.Namespace:
    """The settings of a run: the reference's flags and defaults, and
    ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return args


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)

    # Synthetic stand-in for the paper's Adult subsample (14 columns).
    ds = make_dataset("adult", n_rows=args.rows, seed=0)
    print(f"dataset: {ds.name}, {ds.n_rows} rows, {len(ds.schema)} columns")

    # Paper §5.3.2 scenario: 2 small clients + 1 holding everything.
    parts = partition_quantity_skew(ds, n_clients=3, small_rows=250)
    print("client rows:", [len(p) for p in parts])

    cfg = CTGANConfig(batch_size=100, gen_hidden=(128, 128),
                      disc_hidden=(128, 128), pac=10, z_dim=64)
    res = run_federated(parts, ds.schema, cfg=cfg, rounds=args.rounds,
                        local_steps=2, weighting="fedtgan", eval_real=ds.data,
                        eval_every=4, eval_samples=1024, device=dev)

    print(f"\naggregation weights (§4.2): {np.round(res.weights, 3)}")
    print(f"  -> the {args.rows}-row client dominates, as the paper predicts")
    for h in res.history:
        print(f"round {h['round']:3d}: avg_jsd={h['avg_jsd']:.3f} "
              f"avg_wd={h['avg_wd']:.3f} g_loss={h['g_loss']:.3f}")
    print(f"\nbytes on wire per round (federator NIC): "
          f"{res.comm_bytes_per_round/1e6:.1f} MB")

    # Fused synthesis: generator pass + ONE vgm_decode_table launch for
    # all continuous columns (instead of a per-column decode loop).
    synth = synthesize_table(res.final_g_params, cfg, res.encoders, 5,
                             generator=torch.Generator(dev).manual_seed(42),
                             device=dev)
    print("\n5 synthetic rows (decoded through the fused kernel):")
    for row in synth:
        print("  " + " ".join(f"{v:8.2f}" for v in row))


if __name__ == "__main__":
    main()
