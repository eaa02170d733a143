"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes, per rank, without a card or an allocation, and emit
memory and roofline terms; the port's copy of the JAX package's
``launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod ...

Each combo builds the production mesh over a world of 256 (or 512) ranks
on torch's fake backend (:func:`repro_torch.launch.mesh.fake_world`, made
here and destroyed after the combo, never at import), the ``Transformer``
on the meta device, and distributes its parameters, the Adam state, the
batch and, for decode, the caches as DTensors by the sharding policy.  One
train step, prefill (the full-sequence forward) or decode step then runs
under :class:`repro_torch.counting.OpCounter`, which counts rank 0's local
ops and the collectives DTensor issues, and
:class:`~repro_torch.launch.shardings.ReshardFallbacks`, which reshards
where DTensor refuses an op (recorded in ``fallbacks``).  The record
keeps the reference's keys; ``lower_s`` and ``compile_s`` become one
``trace_s``, and in ``memory`` ``argument_size_in_bytes`` and
``output_size_in_bytes`` are rank 0's shard bytes.  ``temp_size_in_bytes``
is None: the counter's peak of live op outputs on rank 0, kept as
``peak_live_bytes_unverified``, reads several times a plain step's at the
rank's batch under DTensor (smollm-135m x train_4k: 216.9 against 62.5
GiB) and has not been held to a card's allocator, so it is no size to
plan a launch by.  A combo that DTensor cannot run (an op with no sharding
strategy, which the fallbacks cannot get past, or any other error) is a
FAIL record with the error; the exit code is 1 on any FAIL.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_NAMES, get_config, supported_shapes
from ..counting import OpCounter
from ..models import (ShardHints, TrainState, Transformer, make_serve_step,
                      make_train_step, tree_items)
from ..models.config import INPUT_SHAPES, InputShape, ModelConfig
from ..optim import adam
from .input_specs import input_specs
from .mesh import PRODUCTION, fake_world, make_mesh
from .roofline import HLOStats, model_flops_for, roofline_from_stats
from .shardings import (ReshardFallbacks, ShardPolicy, build_batch_specs,
                        build_cache_specs, build_param_specs,
                        clear_sharding_cache, distribute, local_bytes)

BIG_MODEL_PARAMS = 5e10        # >50B -> bf16 adam moments


def _adam_for(cfg: ModelConfig):
    mdt = (torch.bfloat16 if cfg.param_count() > BIG_MODEL_PARAMS
           else torch.float32)
    return adam(1e-4, b1=0.9, b2=0.95, moment_dtype=mdt)


def _mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def _tensor_bytes(tree) -> int:
    """Bytes of the local tensors of ``tree`` (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for _, t in tree_items(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def spec_argument_bytes(cfg: ModelConfig, shape: InputShape, mesh_shape,
                        **policy) -> int:
    """Rank 0's bytes of a step's inputs from the specs' arithmetic alone
    (``shardings.local_bytes``), independent of the DTensors a dry run
    makes: parameters, two Adam moments in the dtype ``_adam_for`` gives
    (train), the batch, the caches (decode)."""
    from types import SimpleNamespace
    mesh = SimpleNamespace(mesh_dim_names=PRODUCTION[len(mesh_shape) == 3][1],
                           shape=tuple(mesh_shape))
    pol = ShardPolicy(mesh, **policy)
    model = Transformer(cfg)
    params = model.init(device="meta")
    pspecs = build_param_specs(params, pol, cfg.n_experts)
    batch = input_specs(cfg, shape)
    total = (local_bytes(params, mesh, pspecs)
             + local_bytes(batch, mesh, build_batch_specs(batch, pol)))
    if shape.mode == "train":
        mdt = (torch.bfloat16 if cfg.param_count() > BIG_MODEL_PARAMS
               else torch.float32)
        moments = {p: torch.empty(t.shape, dtype=mdt, device="meta")
                   for p, t in tree_items(params)}
        total += 2 * local_bytes(moments, mesh, dict(tree_items(pspecs)))
    elif shape.mode == "decode":
        caches = model.init_caches(shape.global_batch, shape.seq_len,
                                   device="meta")
        total += local_bytes(caches, mesh, build_cache_specs(caches, pol))
    return total


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                fsdp: bool = True, moe_mode: str = "auto",
                residual: str = "dmodel", mesh_shape=None,
                cfg: ModelConfig | None = None,
                shape: InputShape | None = None):
    """Builds one combo inside the current (fake) world and returns
    ``(run, args, meta, cfg, shape)``: ``run(*args)`` is the step.
    ``mesh_shape``, ``cfg`` and ``shape`` replace the production mesh, the
    full config and the named input shape (the tests' small meshes)."""
    dims, axes = PRODUCTION[multi_pod]
    if mesh_shape is not None:
        dims = tuple(mesh_shape)
    mesh = make_mesh(dims, axes)
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    pol = ShardPolicy(mesh, fsdp=fsdp, moe_mode=moe_mode)
    model = Transformer(cfg, shard=ShardHints(dp=pol.dp, tp=pol.tp,
                                              residual=residual))
    params = model.init(device="meta")
    pspecs = build_param_specs(params, pol, cfg.n_experts)
    batch = input_specs(cfg, shape)
    bspecs = build_batch_specs(batch, pol)
    chips = 1
    for n in dims:
        chips *= n
    meta = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(dims),
            "chips": chips, "mode": shape.mode, "fsdp": fsdp,
            "moe_mode": moe_mode}
    dparams = distribute(params, mesh, pspecs)
    dbatch = distribute(batch, mesh, bspecs)
    if shape.mode == "train":
        opt = _adam_for(cfg)
        leaves = [t for _, t in tree_items(dparams)]
        state = TrainState(dparams, opt.init(leaves), 0)
        return make_train_step(model, opt), (state, dbatch), meta, cfg, shape
    if shape.mode == "prefill":
        def fwd(params, batch):
            with torch.no_grad():
                return model.forward(params, batch)[0]
        return fwd, (dparams, dbatch), meta, cfg, shape
    caches = model.init_caches(shape.global_batch, shape.seq_len,
                               device="meta")
    dcaches = distribute(caches, mesh, build_cache_specs(caches, pol))
    serve = make_serve_step(model)

    def decode(params, caches, batch):
        with torch.no_grad():
            return serve(params, caches, batch)
    return decode, (dparams, dcaches, dbatch), meta, cfg, shape


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              fsdp: bool = True, moe_mode: str = "auto",
              residual: str = "dmodel", verbose: bool = True,
              mesh_shape=None, cfg: ModelConfig | None = None,
              shape: InputShape | None = None) -> dict:
    """One combo's record (status OK, SKIP or FAIL), in a fake world of the
    mesh's size made and destroyed here."""
    dims = tuple(mesh_shape) if mesh_shape else PRODUCTION[multi_pod][0]
    mesh_name = _mesh_name(dims)
    if shape_name not in supported_shapes(arch):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "SKIP",
               "reason": get_config(arch).notes or "unsupported shape"}
        if verbose:
            print(f"[dryrun] {arch} x {shape_name}: SKIP ({rec['reason']})")
        return rec
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    world = 1
    for n in dims:
        world *= n
    try:
        with fake_world(world):
            run, args, meta, cfg, shape = lower_combo(
                arch, shape_name, multi_pod=multi_pod, fsdp=fsdp,
                moe_mode=moe_mode, residual=residual, mesh_shape=dims,
                cfg=cfg, shape=shape)
            arg_bytes = _tensor_bytes(args)
            if cfg.n_experts:      # the topk cache bug: see the function
                clear_sharding_cache()
            with OpCounter() as counter:
                with implicit_replication(), ReshardFallbacks() as fallbacks:
                    out = run(*args)
            stats = HLOStats.from_counter(counter)
            out_bytes = _tensor_bytes(out)
        trace_s = time.time() - t0
        rep = roofline_from_stats(
            stats, arch=arch, shape=shape_name, mesh=meta["mesh"],
            chips=meta["chips"],
            model_flops=model_flops_for(cfg, shape, shape.mode))
        mem_info = {"argument_size_in_bytes": arg_bytes,
                    "output_size_in_bytes": out_bytes,
                    "temp_size_in_bytes": None,
                    "peak_live_bytes_unverified": stats.peak_live_bytes}
        rec = {**meta, "status": "OK", "trace_s": round(trace_s, 1),
               "memory": mem_info, "roofline": rep.as_dict(),
               "flops_by_dtype": stats.flops_by_dtype,
               "kernels": stats.kernels,
               "collectives": stats.collectives,
               "fallbacks": dict(fallbacks.fallbacks),
               "unknown_trip_loops": stats.unknown_trip_loops}
        if verbose:
            r = rep
            print(f"[dryrun] {arch} x {shape_name} [{meta['mesh']}]: OK "
                  f"trace={trace_s:.0f}s | compute={r.compute_s*1e3:.2f}ms "
                  f"mem={r.memory_s*1e3:.2f}ms "
                  f"coll={r.collective_s*1e3:.2f}ms dom={r.dominant} "
                  f"useful={r.useful_flops_ratio:.2f} "
                  f"args={arg_bytes/2**30:.2f}GiB")
        return rec
    except Exception as e:   # a combo's failure is its record
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        if verbose:
            print(f"[dryrun] {arch} x {shape_name}: FAIL {rec['error'][:200]}")
        return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moe-mode", default="auto",
                    choices=["auto", "f2d", "ep_pad"])
    ap.add_argument("--residual", default="dmodel", choices=["dmodel", "seq"])
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        combos = [(arch, shape, mp) for arch in ARCH_NAMES
                  for shape in INPUT_SHAPES for mp in meshes]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape, mp) for mp in meshes]
    else:
        ap.error("--arch and --shape, or --all")

    n_ok = n_fail = n_skip = 0
    for arch, shape, mp in combos:
        rec = run_combo(arch, shape, multi_pod=mp, fsdp=not args.no_fsdp,
                        moe_mode=args.moe_mode, residual=args.residual)
        n_ok += rec["status"] == "OK"
        n_fail += rec["status"] == "FAIL"
        n_skip += rec["status"] == "SKIP"
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"[dryrun] done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
