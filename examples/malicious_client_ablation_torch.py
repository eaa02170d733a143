"""Paper §5.3.3 ablation on the PyTorch port, re-expressed on the chaos
harness, on the card.

The twin of ``examples/malicious_client_ablation.py``.  The adversary
attacks the UPDATES: the last client ships byzantine-scaled deltas every
round, modeled as a ``repro_torch.fed.faults.FaultPlan``, and the defense
is the in-program ``UpdateGuard``: the norm guard flags the scaled update,
zeroes its weight, and renormalizes the survivors inside the SAME single
fused ``weighted_agg`` merge launch.

Three runs on IID shards, identical seeds:

  clean      no faults: the reference trajectory.
  attacked   byzantine client, guard OFF (diagnostics advisory only).
  defended   byzantine client, guard ON (masked out of every merge).

Plus a one-round probe of ``FederatedProgram.faulted_round`` showing the
per-client guard verdicts (``client_ok`` / ``w_eff``).

Run:  PYTHONPATH=src python examples/malicious_client_ablation_torch.py
      (options: --rows N --clients P --rounds R --scale S --host
       --device cpu; the --host flag reruns the defended run on the
       per-round host oracle and checks the one-program path matched it)
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.architectures import run_federated
from repro_torch.device import resolve_device
from repro_torch.fed import (FaultPlan, FederatedProgram, UpdateGuard,
                             byzantine_scale, partition, setup_federation)
from repro_torch.gan.ctgan import CTGANConfig
from repro_torch.tabular import make_dataset


def parse(argv=None) -> argparse.Namespace:
    """The settings of a run: the reference's flags and defaults, and
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--scale", type=float, default=64.0,
                    help="byzantine delta scale for the malicious client")
    ap.add_argument("--host", action="store_true",
                    help="also run the defended setup on the per-round "
                         "host oracle and verify the one-program path "
                         "matches it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.clients < 2:
        ap.error("--clients must be >= 2 (one malicious + >=1 honest)")
    return args


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)

    ds = make_dataset("intrusion", n_rows=args.rows, seed=0)
    parts = partition("iid", ds, args.clients, seed=0)
    bad = args.clients - 1                       # the adversary's slot
    plan = byzantine_scale(torch.Generator().manual_seed(0), args.rounds,
                           args.clients, clients=[bad], scale=args.scale)
    cfg = CTGANConfig(batch_size=100, gen_hidden=(64, 64),
                      disc_hidden=(64, 64), pac=10, z_dim=64)
    kw = dict(cfg=cfg, rounds=args.rounds, local_steps=1,
              eval_real=ds.data, eval_every=max(args.rounds // 2, 1),
              eval_samples=1024, device=dev)

    clean = run_federated(parts, ds.schema, weighting="fedtgan",
                          name="clean", **kw)
    attacked = run_federated(parts, ds.schema, weighting="fedtgan",
                             name="attacked", faults=plan, guard=None, **kw)
    defended = run_federated(parts, ds.schema, weighting="fedtgan",
                             name="defended", faults=plan,
                             guard=UpdateGuard(), **kw)

    # one-round probe: what the guard decides, per client
    fe = setup_federation(parts, ds.schema, cfg, 0, "fedtgan", device=dev)
    prog = FederatedProgram(cfg, fe.spans, fe.cond_spans,
                            batch=cfg.batch_size, local_steps=1,
                            weighting="fedtgan", guard=UpdateGuard())
    fault0 = FaultPlan(*(leaf[0] for leaf in plan))
    _, m = prog.faulted_round(fe.states, fe.tables, fe.weights, fault0,
                              generator=torch.Generator(dev).manual_seed(1))
    ok = m["client_ok"].cpu().numpy()
    w_eff = m["w_eff"].cpu().numpy()
    print(f"guard verdicts (client {bad} is byzantine, "
          f"scale={args.scale:g}):")
    print(f"  client_ok = {ok.astype(int).tolist()}")
    print(f"  w_eff     = {w_eff.round(3).tolist()}")
    assert not ok[bad] and w_eff[bad] == 0.0, \
        "norm guard must zero the byzantine client's merge weight"
    assert ok[:bad].all(), "honest clients must survive the guard"

    def q(res):
        return res.history[-1]["avg_jsd"], res.history[-1]["avg_wd"]

    print("\nfinal quality (lower is better):")
    for res in (clean, attacked, defended):
        jsd, wd = q(res)
        print(f"  {res.name:9s} jsd={jsd:.3f} wd={wd:.3f}")
    jsd_c, _ = q(clean)
    jsd_d, _ = q(defended)
    print(f"\ndefended vs clean jsd ratio: {jsd_d / max(jsd_c, 1e-9):.2f} "
          f"(masked merge keeps the survivors' trajectory)")

    if args.host:
        host = run_federated(parts, ds.schema, weighting="fedtgan",
                             name="defended-host", program="host",
                             faults=plan, guard=UpdateGuard(), **kw)
        # ulp tolerance: the host oracle merges per leaf, the one-program
        # path through one fused flat pass
        for a, b in zip(host.final_g_params.parameters(),
                        defended.final_g_params.parameters()):
            np.testing.assert_allclose(a.detach().cpu().numpy(),
                                       b.detach().cpu().numpy(),
                                       rtol=3e-6, atol=1e-7)
        print("\none-program == host-loop generator (ulp-tight): True")


if __name__ == "__main__":
    main()
