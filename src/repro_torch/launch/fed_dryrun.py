"""Federated-round dry run: one Fed-TGAN training round (per-client local
steps and the similarity-weighted merge) at the production mesh's client
count, counted without a card; the port's copy of the JAX package's
``launch/fed_dryrun.py``.

Clients ride the data axes (16 clients single-pod, 32 multi-pod = pods x
data slices).  For an LM arch the count is one rank's: its client's
``LOCAL_STEPS`` train steps on the meta device (within a client the model
axis replicates), then the merge, the client-weighted sum, as ONE
all-reduce of the weighted flat parameters over the clients' group, on a
world of torch's fake backend (a dry-run device, never a run).

``ctgan-paper`` runs the paper's own workload on the CPU with real values
(1.24 M parameters a client; its sampler draws data-dependent batches,
which the meta device cannot): the encoders from the §4.1 protocol on a
synthetic Adult table, every client's local round, the in-program §4.2
weighting and the fused merge (one ``weighted_agg``) through
:class:`repro_torch.fed.FederatedProgram` on one device.
``--shard-map`` runs the collective rendering instead
(:func:`repro_torch.fed.shard_map_global_round`) on a fake group of one
rank per client and counts rank 0's round and its all-reduce;
``--faults`` runs the degraded round (``FederatedProgram.faulted_round``
with a neutral :class:`~repro_torch.fed.FaultPlan` and the guard).

  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --arch llama3-8b
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --arch ctgan-paper --shard-map
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --arch ctgan-paper --faults
  PYTHONPATH=src python -m repro_torch.launch.fed_dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch
import torch.distributed as dist

from .. import counting
from ..configs import ARCH_NAMES, get_config
from ..counting import OpCounter
from ..models import (InputShape, TrainState, Transformer, make_train_step,
                      tree_leaves)
from ..models.config import INPUT_SHAPES
from .dryrun import _adam_for, _mesh_name
from .input_specs import train_input_specs
from .mesh import PRODUCTION, fake_world, make_mesh
from .roofline import HLOStats

FED_ARCHS = ["ctgan-paper", "smollm-135m", "llama3-8b", "xlstm-1.3b"]
LOCAL_STEPS = 4


def _clients(dims: tuple[int, ...]) -> int:
    """Clients on the data axes: every mesh dim but the last (model)."""
    n = 1
    for d in dims[:-1]:
        n *= d
    return n


def lower_fed_round(arch: str, *, multi_pod: bool = False,
                    local_steps: int = LOCAL_STEPS, agg_dtype: str = "f32",
                    mesh_shape=None, cfg=None,
                    shape: InputShape | None = None):
    """Inside a fake world of the mesh's size: ``(run, args, n_clients)``,
    ``run(*args)`` one rank's round.  ``mesh_shape``, ``cfg`` and ``shape``
    replace the production mesh, the full config and train_4k."""
    dims = tuple(mesh_shape) if mesh_shape else PRODUCTION[multi_pod][0]
    n_clients = _clients(dims)
    # one group per model index over the clients (pod x data, row-major)
    group = make_mesh((n_clients, dims[-1]),
                      ("clients", "model")).get_group("clients")
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES["train_4k"]
    model = Transformer(cfg)
    opt = _adam_for(cfg)
    params = model.init(device="meta")
    state = TrainState(params, opt.init(tree_leaves(params)), 0)
    b_local = shape.global_batch // n_clients
    batch = train_input_specs(cfg, InputShape(shape.name, shape.seq_len,
                                              b_local, "train"))
    weights = torch.empty((n_clients,), device="meta")
    step_fn = make_train_step(model, opt)

    def fed_round(state, batch, w):
        """This rank's client: E local steps, then the weighted merge."""
        state = counting.repeat(local_steps,
                                lambda st: step_fn(st, batch)[0], state,
                                like=w)
        leaves = tree_leaves(state.params)
        wn = w / torch.clamp(torch.sum(w), min=1e-12)
        flat = torch.cat([p.detach().float().reshape(-1) for p in leaves])
        flat = flat * wn[dist.get_rank(group)]
        if agg_dtype == "bf16":
            # the scale in float32 locally, the reduction moves bf16: half
            # the wire bytes of the float32 merge
            flat = flat.bfloat16()
        dist.all_reduce(flat, group=group)
        with torch.no_grad():
            offset = 0
            for p in leaves:
                p.copy_(flat[offset:offset + p.numel()].view(p.shape))
                offset += p.numel()
        return state

    return fed_round, (state, batch, weights), n_clients


def lower_ctgan_fed_round(*, multi_pod: bool = False,
                          local_steps: int = LOCAL_STEPS,
                          shard_map: bool = False, faults: bool = False,
                          mesh_shape=None):
    """The paper's workload at the mesh's client count, on the CPU:
    ``(run, args, n_clients)``.  ``shard_map`` needs a world of one rank
    per client (the caller's)."""
    from ..configs.ctgan_paper import CONFIG as GAN_CFG
    from ..fed import (FederatedProgram, UpdateGuard, no_faults,
                       setup_federation, shard_map_global_round,
                       tile_federation)
    from ..fed.faults import FaultPlan
    from ..tabular.datasets import make_dataset, partition_full_copy

    if faults and shard_map:
        raise ValueError("--faults runs the fused one-device round; "
                         "combine it without --shard-map")
    dims = tuple(mesh_shape) if mesh_shape else PRODUCTION[multi_pod][0]
    n_clients = _clients(dims)
    # host-side §4.1 protocol on a small synthetic table, tiled out to
    # the client count
    ds = make_dataset("adult", n_rows=1200, seed=0)
    fe = setup_federation(partition_full_copy(ds, 2), ds.schema, GAN_CFG,
                          seed=0, device="cpu")
    fe = tile_federation(fe, n_clients)
    args = (fe.states, fe.tables, fe.S, fe.n_rows)
    kw = dict(batch=GAN_CFG.batch_size, local_steps=local_steps,
              weighting="fedtgan")
    if shard_map:
        return (shard_map_global_round(GAN_CFG, fe.spans, fe.cond_spans,
                                       **kw), args, n_clients)
    if faults:
        program = FederatedProgram(GAN_CFG, fe.spans, fe.cond_spans,
                                   guard=UpdateGuard(), **kw)
        plan = FaultPlan(*(t[0] for t in no_faults(1, n_clients)))
        return (program.faulted_round,
                (fe.states, fe.tables, fe.weights, plan), n_clients)
    program = FederatedProgram(GAN_CFG, fe.spans, fe.cond_spans, **kw)
    return program.global_round, args, n_clients


def run_one(arch: str, multi_pod: bool, agg_dtype: str = "f32",
            shard_map: bool = False, faults: bool = False, *,
            mesh_shape=None, cfg=None, shape: InputShape | None = None
            ) -> dict:
    """One round's record (status OK or FAIL)."""
    dims = tuple(mesh_shape) if mesh_shape else PRODUCTION[multi_pod][0]
    mode = ("fed_round_shard_map" if shard_map
            else "fed_round_faulted" if faults else "fed_round")
    t0 = time.time()
    try:
        if arch == "ctgan-paper":
            world = _clients(dims) if shard_map else None
            run, args, n_clients = lower_ctgan_fed_round(
                multi_pod=multi_pod, shard_map=shard_map, faults=faults,
                mesh_shape=dims)
        else:
            world = 1
            for d in dims:
                world *= d
        if world is None:                       # one device, no group
            stats = _count(run, args)
        else:
            with fake_world(world):
                if arch != "ctgan-paper":
                    run, args, n_clients = lower_fed_round(
                        arch, multi_pod=multi_pod, agg_dtype=agg_dtype,
                        mesh_shape=dims, cfg=cfg, shape=shape)
                stats = _count(run, args)
        rec = {"arch": arch, "mode": mode, "mesh": _mesh_name(dims),
               "clients": n_clients, "local_steps": LOCAL_STEPS,
               "agg_dtype": agg_dtype, "status": "OK",
               "t_s": round(time.time() - t0, 1),
               "flops": stats.flops, "flops_by_dtype": stats.flops_by_dtype,
               "hbm_bytes": stats.hbm_bytes, "kernels": stats.kernels,
               "collectives": stats.collectives,
               "collective_bytes": stats.collective_bytes,
               "temp_bytes": None,
               "peak_live_bytes_unverified": stats.peak_live_bytes}
        print(f"[fed-dryrun] {arch} [{rec['mesh']}] {mode}: OK {n_clients} "
              f"clients, coll={stats.collective_bytes / 2**30:.2f}GiB/rank/"
              f"round, kernels {stats.kernels} ({rec['t_s']}s)")
        return rec
    except Exception as e:   # a round's failure is its record
        print(f"[fed-dryrun] {arch}: FAIL {type(e).__name__}: {str(e)[:200]}")
        return {"arch": arch, "mode": mode, "mesh": _mesh_name(dims),
                "status": "FAIL", "error": str(e)[:500],
                "traceback": traceback.format_exc()[-1500:]}


def _count(run, args) -> HLOStats:
    with OpCounter() as c:
        run(*args)
    return HLOStats.from_counter(c)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES + ["ctgan-paper"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--agg-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--shard-map", action="store_true",
                    help="ctgan-paper only: the collective rendering "
                         "(repro_torch.fed.sharded) on one rank per client")
    ap.add_argument("--faults", action="store_true",
                    help="ctgan-paper only: the degraded round (FaultPlan "
                         "mask + guard + masked fused merge)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("--arch or --all")

    archs = FED_ARCHS if args.all else [args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    fails = 0
    for arch in archs:
        for mp in meshes:
            rec = run_one(arch, mp, args.agg_dtype,
                          shard_map=args.shard_map and arch == "ctgan-paper",
                          faults=args.faults and arch == "ctgan-paper")
            fails += rec["status"] == "FAIL"
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
