"""The paper's IID / Non-IID evaluation matrix as a scenario driver, the
port's copy of the JAX package's ``fed/scenarios.py``.

Fed-TGAN's §4.2 weighting exists to survive skewed client populations, so
the federation is run on the paper's partitions, not only uniform ones.
Each :class:`Scenario` names a partitioner over a
:class:`repro_torch.tabular.TabularDataset`:

  ``full_copy``  §5.3.1 ideal case: every client holds the whole table.
  ``iid``        disjoint equal IID shards (same marginals everywhere).
  ``quantity``   §5.3.2 quantity skew: small clients plus one big one.
  ``dirichlet``  Dirichlet(alpha) label skew on a categorical column,
                 the standard Non-IID benchmark split.
  ``malicious``  §5.3.3 ablation: one client repeats a single row.

``run_matrix`` crosses datasets x scenarios x weightings x fault regimes
(:data:`FAULTS`: none / dropout / straggler / byzantine / nan / chaos,
rendered as :class:`repro_torch.fed.faults.FaultPlan` schedules) x DP
noise levels through ``run_federated(program="fed")``, and the CLI runs a
small matrix end to end, on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.fed.scenarios --rows 400 --rounds 2
    PYTHONPATH=src python -m repro_torch.fed.scenarios --rows 400 \\
        --rounds 4 --scenarios iid --faults none,chaos --clients 8

The CLI exits non-zero if any cell's final global state is non-finite.

The partitioners are numpy and deterministic in ``seed``: the same seed
gives the reference's shards.  A fault regime draws from the
``torch.Generator`` streams ``seeded_generator("cpu", seed + 4242, i)``,
so a cell is reproducible from its seed; its plan is not the reference's
threefry draw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import seeded_generator
from ..gan.ctgan import CTGANConfig
from ..tabular.datasets import (TabularDataset, partition_full_copy,
                                partition_iid, partition_label_skew,
                                partition_malicious, partition_quantity_skew)
from .faults import (FaultPlan, byzantine_scale, compose, corrupt_nans,
                     dropout_uniform, straggler_deadline)
from .program import WEIGHTINGS


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named client-data partition of the evaluation matrix."""
    name: str
    description: str
    fn: Callable[..., list[np.ndarray]]     # (ds, n_clients, *, seed, **kw)


SCENARIOS: dict[str, Scenario] = {s.name: s for s in [
    Scenario("full_copy", "§5.3.1 ideal: every client holds the full table",
             lambda ds, n, *, seed=0, **kw: partition_full_copy(ds, n)),
    Scenario("iid", "disjoint equal IID shards",
             lambda ds, n, *, seed=0, **kw: partition_iid(ds, n, seed=seed)),
    Scenario("quantity", "§5.3.2 quantity skew: small clients + one big",
             lambda ds, n, *, seed=0, small_rows=None, **kw:
             partition_quantity_skew(
                 ds, n, small_rows=small_rows or max(ds.n_rows // 10, 2),
                 seed=seed)),
    Scenario("dirichlet", "Dirichlet(alpha) label skew on a categorical col",
             lambda ds, n, *, seed=0, alpha=0.3, cat_col=0, **kw:
             partition_label_skew(ds, n, cat_col=cat_col, alpha=alpha,
                                  seed=seed)),
    Scenario("malicious", "§5.3.3: one client repeats a single row",
             lambda ds, n, *, seed=0, good_rows=None, bad_rows=None, **kw:
             partition_malicious(
                 ds, n, good_rows=good_rows or max(ds.n_rows // 4, 2),
                 bad_rows=bad_rows or ds.n_rows, seed=seed)),
]}


def partition(name: str, ds: TabularDataset, n_clients: int, *,
              seed: int = 0, **kw) -> list[np.ndarray]:
    """One scenario's client shards (deterministic in ``seed``)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"options: {sorted(SCENARIOS)}")
    return SCENARIOS[name].fn(ds, n_clients, seed=seed, **kw)


def _gen(seed: int, *stream: int) -> torch.Generator:
    return seeded_generator("cpu", seed, *stream)


# Named fault regimes for the matrix's faults axis: each maps (seed,
# rounds, n_clients) to a FaultPlan or None, deterministic in the seed.
FAULTS: dict[str, Callable] = {
    "none": lambda seed, R, P: None,
    "dropout": lambda seed, R, P: dropout_uniform(_gen(seed), R, P,
                                                  rate=0.3),
    "straggler": lambda seed, R, P: straggler_deadline(
        _gen(seed), R, P, mean_latency=1.0, deadline=1.0),  # P(miss) ~ 0.37
    "byzantine": lambda seed, R, P: byzantine_scale(
        _gen(seed), R, P, n_byzantine=1, scale=64.0),
    "nan": lambda seed, R, P: corrupt_nans(_gen(seed), R, P, n_corrupt=1),
    "chaos": lambda seed, R, P: compose(
        dropout_uniform(_gen(seed), R, P, rate=0.3),
        corrupt_nans(_gen(seed, 1), R, P, n_corrupt=1),
        byzantine_scale(_gen(seed, 2), R, P, n_byzantine=1, scale=64.0)),
}


def build_fault_plan(name: str, rounds: int, n_clients: int, *,
                     seed: int = 0) -> FaultPlan | None:
    """A named fault regime as a validated plan (None: the dense round)."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault regime {name!r}; "
                         f"options: {sorted(FAULTS)}")
    plan = FAULTS[name](seed + 4242, rounds, n_clients)
    return plan.validate() if plan is not None else None


def run_matrix(datasets=("adult",), scenarios=("iid", "dirichlet", "quantity"),
               weightings=("fedtgan", "uniform"), faults=("none",),
               dp=(None,), *,
               n_clients: int = 3, rows: int = 600, rounds: int = 2,
               local_steps: int = 1, cfg: CTGANConfig | None = None,
               seed: int = 0, eval_samples: int = 512,
               client_chunk: int | None = None,
               edges: int | None = None,
               device: torch.device | str = "cuda") -> list[dict]:
    """Cross datasets x scenarios x weightings x fault regimes x DP noise
    levels through ``run_federated(program="fed")`` on ``device``; one
    record per cell: the final similarity metrics, the resolved client
    weights, the spent epsilon of a DP cell, the fault summary and retry
    count of a faulted cell, and ``finite``, read from the final merged
    generator on the host.

    ``client_chunk`` / ``edges`` select the scale renderings (chunked
    local rounds, the two-tier merge) for every cell.  ``dp`` is a tuple
    of noise multipliers (``None``: DP off); each other entry runs the
    cell with a :class:`repro_torch.gan.dp.DPConfig` of that noise."""
    from ..core.architectures import run_federated   # lazy: avoids a cycle
    from ..gan.dp import DPConfig
    from ..tabular import make_dataset
    cfg = cfg or CTGANConfig(batch_size=60, gen_hidden=(32, 32),
                             disc_hidden=(32, 32), pac=6, z_dim=32)
    records = []
    for d in datasets:
        ds = make_dataset(d, n_rows=rows, seed=seed)
        for sc in scenarios:
            parts = partition(sc, ds, n_clients, seed=seed)
            for wmode in weightings:
                if wmode not in WEIGHTINGS:
                    raise ValueError(f"unknown weighting {wmode!r}")
                for fname in faults:
                    plan = build_fault_plan(fname, rounds, n_clients,
                                            seed=seed)
                    for dpv in dp:
                        dpcfg = (None if dpv is None
                                 else DPConfig(noise_mult=float(dpv)))
                        res = run_federated(
                            parts, ds.schema, cfg=cfg, rounds=rounds,
                            local_steps=local_steps, seed=seed,
                            weighting=wmode, eval_real=ds.data,
                            eval_every=rounds, eval_samples=eval_samples,
                            faults=plan, client_chunk=client_chunk,
                            edges=edges, dp=dpcfg, device=device,
                            name=f"{d}/{sc}/{wmode}/{fname}/dp={dpv}")
                        final = res.history[-1]
                        finite = all(bool(torch.isfinite(p).all())
                                     for p in res.final_g_params.parameters())
                        records.append({
                            "dataset": d, "scenario": sc,
                            "weighting": wmode,
                            "faults": fname, "clients": n_clients,
                            "dp_noise": dpv, "epsilon": res.epsilon,
                            "client_rows": [int(p.shape[0]) for p in parts],
                            "weights":
                                np.asarray(res.weights).round(4).tolist(),
                            "avg_jsd": final["avg_jsd"],
                            "avg_wd": final["avg_wd"],
                            "seconds": res.seconds, "finite": finite,
                            "retries": res.retries,
                            "fault_summary": (plan.summary()
                                              if plan is not None else None),
                        })
    return records


def print_table(recs: list[dict]) -> None:
    """The matrix as the reference's CLI prints it."""
    print(f"{'dataset':10s} {'scenario':10s} {'weighting':9s} "
          f"{'faults':9s} {'dp':>5s} {'eps':>7s} "
          f"{'avg_jsd':>8s} {'avg_wd':>8s} "
          f"{'fin':>3s} {'try':>3s}  weights")
    for r in recs:
        eps = "inf" if r["epsilon"] is None else f"{r['epsilon']:7.2f}"
        dpcol = "off" if r["dp_noise"] is None else f"{r['dp_noise']:.2g}"
        print(f"{r['dataset']:10s} {r['scenario']:10s} {r['weighting']:9s} "
              f"{r['faults']:9s} {dpcol:>5s} {eps:>7s} "
              f"{r['avg_jsd']:8.3f} {r['avg_wd']:8.3f} "
              f"{'y' if r['finite'] else 'N':>3s} {r['retries']:3d}  "
              f"{r['weights']}")


def main():
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--datasets", default="adult")
    ap.add_argument("--scenarios", default="iid,dirichlet,quantity")
    ap.add_argument("--weightings", default="fedtgan,uniform")
    ap.add_argument("--faults", default="none",
                    help=f"comma list of fault regimes "
                         f"({','.join(sorted(FAULTS))})")
    ap.add_argument("--dp", default="none",
                    help="comma list of DP noise multipliers for the "
                         "matrix's privacy axis ('none' = DP off, e.g. "
                         "'none,1.0,4.0')")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--rows", type=int, default=600)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--client-chunk", type=int, default=None,
                    help="run local rounds in chunks of this many clients "
                         "(must divide --clients)")
    ap.add_argument("--edges", type=int, default=None,
                    help="hierarchical merge through this many edge "
                         "aggregators (must divide --clients)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="optional JSON output path")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of "
                         "the kernels")
    args = ap.parse_args()

    dp_axis = tuple(None if tok in ("none", "") else float(tok)
                    for tok in args.dp.split(","))
    recs = run_matrix(datasets=args.datasets.split(","),
                      scenarios=args.scenarios.split(","),
                      weightings=args.weightings.split(","),
                      faults=args.faults.split(","),
                      dp=dp_axis,
                      n_clients=args.clients, rows=args.rows,
                      rounds=args.rounds, local_steps=args.local_steps,
                      client_chunk=args.client_chunk, edges=args.edges,
                      seed=args.seed, device=args.device)
    print_table(recs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=2)
    if not all(r["finite"] for r in recs):
        print("FAIL: non-finite final global state in at least one cell",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
