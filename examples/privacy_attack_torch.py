"""Record the wire, attack the recording, then buy the attack down with DP,
on the PyTorch port and the card.

The twin of ``examples/privacy_attack.py``.  An honest-but-curious
aggregator sees everything Fed-TGAN transmits: the §4.1 setup statistics
and every round's client update stack.  This example plays that adversary
end to end on a deliberately-overfit victim federation (tiny shards, many
local steps: the regime where updates memorise rows):

  1. train 2 clients on 20-row shards with ``run_federated(trace=...)``,
     recording the transmitted surface to a replayable ``RoundTrace``;
  2. read the §4.1 leakage straight off the trace (exact per-client
     categorical marginals, VGM moments);
  3. run the difficulty-calibrated membership-inference attack on a
     client's rows vs a same-distribution holdout, with its null
     calibration (~0.5 AUC on holdout-vs-holdout);
  4. recover each client's over-represented category from the updates
     alone via the de-meaned discriminator probe;
  5. retrain the SAME victim with in-program DP
     (``dp=DPConfig(noise_mult=...)``) and show the attack falling back
     toward chance, with the spent epsilon reported.

Run:  PYTHONPATH=src python examples/privacy_attack_torch.py
      (options: --rows N --rounds R --local-steps E --noise S --save F
       --device cpu)
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.core.architectures import run_federated
from repro_torch.device import resolve_device
from repro_torch.gan.ctgan import CTGANConfig
from repro_torch.gan.dp import DPConfig
from repro_torch.privacy import (RoundTrace, dominant_category_hits,
                                 loss_threshold_mia, null_auc,
                                 setup_marginals, vgm_client_moments)
from repro_torch.tabular import make_dataset, partition_label_skew

CFG = CTGANConfig(batch_size=8, gen_hidden=(32,), disc_hidden=(32,),
                  pac=4, z_dim=8)


def train_victim(parts, schema, *, rounds, local_steps, dp=None, seed=0,
                 device="cuda"):
    tr = RoundTrace()
    res = run_federated(parts, schema, cfg=CFG, rounds=rounds,
                        local_steps=local_steps, seed=seed,
                        weighting="uniform", dp=dp, trace=tr, device=device)
    return tr, res


def parse(argv=None) -> argparse.Namespace:
    """The settings of a run: the reference's flags and defaults, and
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--noise", type=float, default=2.0,
                    help="DP noise multiplier for the defended rerun")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None,
                    help="optional path to persist the raw trace (.npz)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return args


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)

    ds = make_dataset("adult", n_rows=args.rows, seed=args.seed)
    # label skew so the update-leakage probe has per-client structure
    parts = partition_label_skew(ds, 2, alpha=0.3, seed=args.seed)
    holdout = make_dataset("adult", n_rows=200, seed=args.seed + 100).data

    print(f"victim: {len(parts)} clients x "
          f"{[p.shape[0] for p in parts]} rows, "
          f"{args.rounds} rounds x {args.local_steps} local steps")
    tr, res = train_victim(parts, ds.schema, rounds=args.rounds,
                           local_steps=args.local_steps, seed=args.seed,
                           device=dev)
    if args.save:
        tr.save(args.save)
        print(f"trace saved to {args.save} "
              f"(replay: RoundTrace.load + the same attacks)")

    cat_cols = sorted(tr.cat_freqs)
    print("\n--- §4.1 setup leakage (transmitted exactly, by design) ---")
    j = cat_cols[0]
    print(f"column {j} per-client marginals:\n"
          f"{setup_marginals(tr, j).round(3)}")
    cont = sorted(tr.vgm_means)[0]
    mom = vgm_client_moments(tr, cont)
    print(f"column {cont} per-client mean/std: "
          f"{mom['mean'].round(3)} / {mom['std'].round(3)}")

    print("\n--- membership inference on client 0's rows ---")
    enc = res.encoders
    mia = loss_threshold_mia(tr, CFG, enc, parts[0], holdout)
    nl = null_auc(tr, CFG, enc, holdout)
    print(f"attack AUC {mia['auc']:.3f}   (null calibration {nl:.3f}, "
          f"chance = 0.5)")

    print("\n--- update leakage: which category over-indexes where ---")
    rep = dominant_category_hits(tr, CFG, enc)
    print(f"probe hit rate {rep['hit_rate']:.2f} over "
          f"{len(rep['columns'])} column(s) x {tr.n_clients} clients")

    print(f"\n--- same victim under in-program DP "
          f"(noise_mult={args.noise}) ---")
    tr_dp, res_dp = train_victim(parts, ds.schema, rounds=args.rounds,
                                 local_steps=args.local_steps,
                                 dp=DPConfig(noise_mult=args.noise),
                                 seed=args.seed, device=dev)
    mia_dp = loss_threshold_mia(tr_dp, CFG, enc, parts[0], holdout)
    print(f"attack AUC {mia['auc']:.3f} -> {mia_dp['auc']:.3f} "
          f"at eps ~= {res_dp.epsilon:.3g}")
    shrunk = abs(mia_dp["auc"] - 0.5) < abs(mia["auc"] - 0.5)
    print("DP moved the attack toward chance" if shrunk else
          "WARNING: attack did not shrink (tiny run / unlucky seed?)")
    # note: setup statistics are NOT protected by DP-SGD on the
    # discriminator — §4.1 marginals still read off tr_dp exactly.
    np.testing.assert_allclose(setup_marginals(tr_dp, j),
                               setup_marginals(tr, j))
    print("(§4.1 setup marginals are unchanged by DP — by design)")
    return 0 if shrunk else 1


if __name__ == "__main__":
    sys.exit(main())
