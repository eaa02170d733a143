"""Drive the PyTorch port's serving and federated training paths once on
one CUDA card.

    python3 chip_smoke.py

From the root of the repository.  Imports only ``repro_torch`` (from
``src/``), torch and numpy; the JAX package is not used.  Phases, each of
which stops the run with a non-zero exit on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the four CUDA sources from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) into ``build/repro_torch``;
3. register two tenants at full width: ``adult`` and ``intrusion`` from
   ``make_dataset`` at the paper's 40,000 rows, encoders fitted on the card,
   a ``ctgan_paper.CONFIG`` generator (z 128, hidden (256, 256)) from a fixed
   seed; each registration encodes the 40,000-row table with
   ``vgm_encode_table`` to build its conditional sampler tables;
4. one 40,000-row ``synthesize_table`` per tenant (the paper's evaluation
   size): categorical values in their category sets, every value finite;
5. a 16-request trace over both tenants (sizes 100, 777, 4096, half
   conditional) through ``StreamingSynthesizer``, FIFO then continuous: 0
   serving compiles, 1 decode dispatch per request, a replayed seed gives
   the same rows, and generation enqueues without waiting for the card;
   rows/s and the card's busy share of the drain;
6. Fed-TGAN training at full width: ``adult`` at 40,000 rows split IID
   into 5 clients, ``ctgan_paper.CONFIG`` (batch 500, pac 10), the §4.2
   ``fedtgan`` weights, 4 global rounds of 2 local steps and an evaluation
   on 40,000 synthesized rows, through ``setup_federation`` and
   ``run_federated``: seconds for setup and per round, every loss finite,
   the weights summing to 1, one ``weighted_agg`` launch per round, one
   ``segment_activations_bwd`` launch per client and local step, every
   client bit-identical after each merge, a finite similarity report; and
   the card's busy share of one more global round;
7. a 1-round run with 4 IID clients through 2 edge aggregators: 2
   ``weighted_agg`` launches; the two-tier merge of a trained client stack
   equal to the flat merge within a few ulps;
8. one train step on the card against the same step on the CPU: a small
   width, the same carried-over weights and moments, the same injected
   noise, TF32 off;
9. the card's synthesis path against the port's CPU path on a small input
   with the same injected noise: equal categories, close continuous values;
10. each kernel at its main path's shapes against its plain PyTorch version
   on the card, with its time, the plain version's time, its bound and,
   where one PyTorch call computes the same function, that call's time.

Phases 3-5 are the serving main path and phase 6 the training main path:
the kernel launch counters are set to 0 just before each and read just
after, every kernel of the path must have launched, and no plain-version
counter may move.  The last two lines of output are the ``kernels`` JSON
object and ``{"ok": true, "device": {...}}``; a longer record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
# tensor cores ops/s.  The kernels are float32 elementwise work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

SIZES = (100, 777, 4096)
N_ROWS = 40_000
FED_CLIENTS, FED_ROUNDS, FED_STEPS = 5, 4, 2
F32_EPS = 2.0 ** -23


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 20, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, repeats: int = 5, *, before=None,
              exclude: str | None = None) -> tuple[float, list]:
    """Device time per call: the durations of the CUDA kernels that the
    profiler saw in a window of ``reps`` calls, summed and divided by
    ``reps``; median over ``repeats`` windows.  Unlike back-to-back CUDA
    events, this leaves out the host's launch overhead.  ``before`` runs
    ahead of every call, and kernels whose name contains ``exclude`` are
    not counted.  Also returns the names of the kernels seen."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times, names = [], set()
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (exclude is None or exclude not in e.key)]
        times.append(sum(e.self_device_time_total for e in kern) / reps / 1e3)
        names.update(e.key[:60] for e in kern)
    return statistics.median(times), sorted(names)


def cold_ms(fn) -> float:
    """Device time per call (:func:`device_ms`) when every call follows a
    128 MB write that evicts the 50 MB L2 cache, so that its inputs come
    from device memory; the write itself is not counted."""
    import torch
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    return device_ms(fn, before=flush.zero_, exclude="FillFunctor")[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_params(states) -> bool:
    """Every client holds bit-identical parameters."""
    import torch
    ref = states[0].params()
    return all(torch.equal(a, b) for st in states[1:]
               for a, b in zip(ref, st.params(), strict=True))


def federated_phase(dev, cfg, ds) -> dict:
    """Phase 6, the training main path: ``setup_federation`` and
    ``run_federated`` at full width, then one more global round on the
    staged federation for the card's busy share."""
    import numpy as np
    import torch

    from repro_torch.core.architectures import run_federated
    from repro_torch.fed import FederatedProgram, setup_federation
    from repro_torch.kernels import ops
    from repro_torch.tabular import partition_iid

    parts = partition_iid(ds, FED_CLIENTS, seed=0)
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    fe = setup_federation(parts, ds.schema, cfg, 0, "fedtgan", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_gen = sum(p.numel() for p in fe.states[0].gen.parameters())
    n_disc = sum(p.numel() for p in fe.states[0].disc.parameters())
    w = fe.weights.cpu().numpy()
    check(abs(float(w.sum()) - 1.0) < 1e-5, f"weights sum to {w.sum()}")
    layout = fe.enc.spans()
    print(f"setup_federation: {FED_CLIENTS} clients x "
          f"{[len(x) for x in parts]} rows of adult, encoded width "
          f"{fe.enc.encoded_dim}, cond {fe.enc.cond_dim}, {len(layout)} "
          f"spans, {n_gen + n_disc} parameters per client (G {n_gen}, D "
          f"{n_disc}), fedtgan weights {np.round(w, 6).tolist()}, "
          f"{setup_s:.3f} s")

    hooks = []

    def on_round(r, states, m):
        torch.cuda.synchronize()
        hooks.append(time.perf_counter())
        check(same_params(states), f"round {r}: clients differ after merge")
        losses = {k: v.cpu().numpy() for k, v in m.items()}
        check(all(np.isfinite(v).all() for v in losses.values()),
              f"round {r}: non-finite loss {losses}")
        check(losses["d_loss"].shape == (FED_CLIENTS, FED_STEPS),
              f"round {r}: metrics shape {losses['d_loss'].shape}")
        print(f"  round {r + 1}: d_loss {losses['d_loss'].mean():.4f} "
              f"g_loss {losses['g_loss'].mean():.4f}, clients bit-identical")
        hooks[-1] = (hooks[-1], time.perf_counter())   # (done, checked)

    t1 = time.perf_counter()
    with ops.dispatch_scope() as counts:
        res = run_federated(parts, ds.schema, cfg=cfg, rounds=FED_ROUNDS,
                            local_steps=FED_STEPS, seed=0,
                            weighting="fedtgan", eval_real=ds.data,
                            eval_every=FED_ROUNDS, eval_samples=N_ROWS,
                            on_round=on_round, device=dev)
    t_end = time.perf_counter()
    run_s = t_end - t1
    # rounds start where run_federated's own clock starts (after its setup)
    start = t_end - res.seconds
    round_s = []
    for done, checked in hooks:
        round_s.append(done - start)
        start = checked
    eval_s = t_end - hooks[-1][1]
    check(len(round_s) == FED_ROUNDS, f"{len(round_s)} rounds ran")
    check(abs(float(res.weights.sum()) - 1.0) < 1e-5,
          f"run weights sum to {res.weights.sum()}")
    [rep] = res.history
    check(all(np.isfinite(rep[k]) for k in ("avg_jsd", "avg_wd", "d_loss",
                                             "g_loss")),
          f"similarity report not finite: {rep}")
    launches = dict(counts)
    refs = {k: v for k, v in ops.DISPATCH_COUNTS.items() if k.endswith("_ref")}
    check(not refs, f"the plain route ran on the card: {refs}")
    check(launches.get("weighted_agg") == FED_ROUNDS,
          f"weighted_agg launched {launches.get('weighted_agg')} times, "
          f"not once per round")
    want_bwd = FED_CLIENTS * FED_STEPS * FED_ROUNDS
    check(launches.get("segment_activations_bwd") == want_bwd,
          f"segment_activations_bwd launched "
          f"{launches.get('segment_activations_bwd')} times, not {want_bwd}")
    for k in ("vgm_encode_table", "segment_activations", "vgm_decode_table"):
        check(launches.get(k, 0) > 0, f"{k} never launched in training")
    print(f"run_federated: {FED_ROUNDS} rounds x {FED_STEPS} local steps, "
          f"{run_s:.3f} s in all (its setup {run_s - res.seconds:.3f} s); "
          f"seconds per round {[round(x, 4) for x in round_s]}; evaluation "
          f"on {N_ROWS} synthesized rows {eval_s:.3f} s: avg_jsd "
          f"{rep['avg_jsd']:.4f} avg_wd {rep['avg_wd']:.4f}; kernel "
          f"launches {launches}; {res.comm_bytes_per_round / 1e6:.2f} MB "
          "on the wire per round")

    # the card's busy share of one global round, as the serving phase
    # measures a drain: profiler device time of a round over the wall time
    # of an unprofiled round
    prog = FederatedProgram(cfg, fe.spans, fe.cond_spans,
                            batch=cfg.batch_size, local_steps=FED_STEPS)

    def one_round():
        return prog.weighted_round(fe.states, fe.tables, fe.weights)
    one_round()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    busy_ms, seen = device_ms(one_round, reps=1, repeats=3)
    busy = busy_ms / (wall * 1e3)
    print(f"one global round on the staged federation: {wall * 1e3:.3f} ms "
          f"wall, device busy {busy_ms:.3f} ms (idle share {1 - busy:.3f})")

    # a trained, unmerged client stack: the merge kernel's real input
    from repro_torch.fed import flatten_stacked
    prog.engine.clients_round(fe.states, fe.tables)
    stack = flatten_stacked([st.params() for st in fe.states])
    torch.cuda.synchronize()
    return {"setup_s": setup_s, "run_s": run_s, "round_s": round_s,
            "eval_s": eval_s, "report": rep, "launches": launches,
            "weights": w.tolist(), "params": {"G": n_gen, "D": n_disc},
            "round_wall_ms": wall * 1e3, "round_busy_ms": busy_ms,
            "round_busy_share": busy, "kernels_seen": seen,
            "comm_bytes_per_round": res.comm_bytes_per_round,
            "stack": stack, "fe": fe}


def edges_phase(dev, cfg, ds, stack, weights) -> dict:
    """Phase 7: 4 clients through 2 edge aggregators, one round; and the
    two tiers against the flat merge on a trained stack."""
    import numpy as np
    import torch

    from repro_torch.core.architectures import run_federated
    from repro_torch.fed import tiered_weighted_merge_flat
    from repro_torch.kernels import ops
    from repro_torch.tabular import partition_iid

    parts = partition_iid(ds, 4, seed=1)
    with ops.dispatch_scope() as counts:
        run_federated(parts, ds.schema, cfg=cfg, rounds=1,
                      local_steps=FED_STEPS, seed=1, edges=2, device=dev,
                      on_round=lambda r, st, m: check(
                          same_params(st), "edges: clients differ"))
        torch.cuda.synchronize()
    check(counts.get("weighted_agg") == 2,
          f"edges=2: weighted_agg launched {counts.get('weighted_agg')} "
          "times, not 2")
    four = stack[:4].contiguous()
    w4 = weights[:4].contiguous()
    tiered = tiered_weighted_merge_flat(four, w4, 2)
    flat = ops.weighted_average_flat(four, w4)
    # a weighted average of P values rounds within ~P ulps of its largest
    ulps = ((tiered - flat).abs()
            / (four.abs().amax(dim=0) * F32_EPS).clamp(min=1e-30))
    worst = float(ulps.max())
    check(worst <= 8.0, f"edges: two tiers {worst:.2f} ulps from flat")
    print(f"edges=2 run: 1 round, 4 clients, weighted_agg launches 2, "
          f"clients bit-identical; two tiers vs flat merge on a trained "
          f"stack: at most {worst:.2f} ulps of the largest client value "
          f"(max abs {float((tiered - flat).abs().max()):.3g})")
    return {"launches": dict(counts), "tiered_vs_flat_ulps": worst}


def step_phase(dev) -> dict:
    """Phase 8: one train step on the card against the same step on the
    CPU, from the same weights, moments and noise."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import ctgan_paper
    from repro_torch.gan.trainer import (GANState, StepNoise,
                                         draw_step_noise, init_gan_state,
                                         make_train_steps)
    from repro_torch.optim import AdamState
    from repro_torch.synth import DeviceSampler, RoundEngine, draw_batch
    from repro_torch.tabular import fit_centralized_encoders, make_dataset

    cfg = ctgan_paper.smoke_config()
    cpu = torch.device("cpu")
    ds = make_dataset("adult", n_rows=2000, seed=3)
    enc = fit_centralized_encoders(ds.data, ds.schema, device=cpu,
                                   generator=torch.Generator().manual_seed(3))
    tables = DeviceSampler(enc.encode(
        ds.data, generator=torch.Generator().manual_seed(3)).numpy(), enc,
        cpu).tables
    spans, cspans = enc.spans(), enc.condition_spans()
    st_cpu = init_gan_state(cfg, enc.cond_dim, enc.encoded_dim, device=cpu,
                            generator=torch.Generator().manual_seed(4),
                            rng=torch.Generator().manual_seed(5))
    RoundEngine(cfg, spans, cspans, batch=cfg.batch_size,
                local_steps=2).local_round(st_cpu, tables)   # moments != 0

    def to_dev(x):
        return [t.to(dev) for t in x] if isinstance(x, list) else x.to(dev)
    st_gpu = GANState(copy.deepcopy(st_cpu.gen).to(dev),
                      copy.deepcopy(st_cpu.disc).to(dev),
                      AdamState(to_dev(st_cpu.g_opt.mu),
                                to_dev(st_cpu.g_opt.nu), st_cpu.g_opt.count),
                      AdamState(to_dev(st_cpu.d_opt.mu),
                                to_dev(st_cpu.d_opt.nu), st_cpu.d_opt.count),
                      st_cpu.step, torch.Generator(dev))
    batch = draw_batch(tables, cfg.batch_size, enc.cond_dim,
                       generator=torch.Generator().manual_seed(6))
    noise = draw_step_noise(torch.Generator().manual_seed(7), cfg,
                            st_cpu.disc, cfg.batch_size, enc.encoded_dim, cpu)
    step = make_train_steps(cfg, spans, cspans)
    m_gpu = step(st_gpu, tuple(b.to(dev) for b in batch),
                 StepNoise(*(to_dev(x) for x in noise)))
    m_cpu = step(st_cpu, batch, noise)
    torch.cuda.synchronize()
    loss_rel = max(abs(float(m_gpu[k]) - float(m_cpu[k]))
                   / max(abs(float(m_cpu[k])), 1e-6) for k in m_cpu)
    check(loss_rel <= 1e-4, f"step card vs CPU: loss rel error {loss_rel}")
    mom = max(float((a.cpu() - b).abs().max()) for x, y in (
        (st_gpu.g_opt, st_cpu.g_opt), (st_gpu.d_opt, st_cpu.d_opt))
        for a, b in zip(x.mu + x.nu, y.mu + y.nu))
    check(mom <= 2e-6, f"step card vs CPU: moment error {mom}")
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                       for a, b in zip(st_gpu.params(), st_cpu.params())])
    par, within = float(diffs.max()), float((diffs <= 2e-6).float().mean())
    check(par <= cfg.lr and within >= 0.99,
          f"step card vs CPU: params max {par}, {within:.4f} within 2e-6")
    print(f"train step card vs CPU (z {cfg.z_dim}, hidden {cfg.gen_hidden}, "
          f"batch {cfg.batch_size}, pac {cfg.pac}, TF32 off, carried-over "
          f"weights and moments, the same noise): losses rel error "
          f"{loss_rel:.3g} (<= 1e-4), moments max abs {mom:.3g} (<= 2e-6), "
          f"parameters max abs {par:.3g} (<= lr {cfg.lr}: Adam turns "
          f"rounding-level gradients into steps of up to lr) and "
          f"{within:.4f} of them within 2e-6 (>= 0.99)")
    return {"loss_rel": loss_rel, "moment_abs": mom, "param_abs": par,
            "param_within_2e-6": within}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import ctgan_paper
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as plain
    from repro_torch.launch.serve import make_tenant
    from repro_torch.serve import (StreamingSynthesizer, SynthesisRequest,
                                   TableRegistry, ladder_from_sizes)
    from repro_torch.synth import DeviceSampler, SamplerDraws, synthesize_table
    from repro_torch.tabular import TableEncoders, VGMParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    record: dict = {}

    # ---- 1. the card --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    record["card"] = card

    # ---- 2. build -----------------------------------------------------
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s for {len(_build.SOURCES)} sources "
          f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    for stem in _build.SOURCES:
        used = [ln.split("ptxas info    : ")[-1] for ln in
                _build.build_log(stem).splitlines() if "Used" in ln]
        print(f"  ptxas {stem}: {'; '.join(used) or 'built earlier'}")
    record["build_s"] = build_s

    # ---- 3-5. the main path -------------------------------------------
    cfg = ctgan_paper.CONFIG
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    registry = TableRegistry()
    tenants = {}
    for seed, name in enumerate(("adult", "intrusion")):
        ts = time.perf_counter()
        ds, enc, gen, encoded = make_tenant(name, n_rows=N_ROWS, cfg=cfg,
                                            seed=seed, device=dev)
        registry.register(name, cfg, enc, gen,
                          ladder=ladder_from_sizes(SIZES), encoded=encoded,
                          device=dev)
        torch.cuda.synchronize()
        tenants[name] = (ds, enc, gen, encoded)
        print(f"register {name}: {ds.n_rows} rows x {len(ds.schema)} columns"
              f", encoded width {enc.encoded_dim}, cond {enc.cond_dim}, "
              f"{time.perf_counter() - ts:.2f} s")

    for seed, name in enumerate(("adult", "intrusion")):
        ds, enc, gen, _ = tenants[name]
        ts = time.perf_counter()
        raw = synthesize_table(gen, cfg, enc, N_ROWS, device=dev,
                               generator=torch.Generator(dev).manual_seed(seed))
        dt = time.perf_counter() - ts
        check(raw.shape == (N_ROWS, len(ds.schema)),
              f"{name}: synthesized shape {raw.shape}")
        check(np.isfinite(raw).all(), f"{name}: non-finite synthesized value")
        for j, le in enc.label_encoders.items():
            check(np.isin(raw[:, j], le.categories).all(),
                  f"{name}: column {j} left its category set")
        print(f"synthesize_table {name}: {N_ROWS} rows in {dt:.3f} s, "
              "finite, categories in range")

    trace = [("adult" if i % 2 == 0 else "intrusion", SIZES[i % 3],
              1000 + i, i % 4 >= 2) for i in range(16)]

    def submit_trace(server):
        for name, rows, seed, cond in trace:
            server.submit(name, rows, seed=seed, conditional=cond)

    serving = {}
    for sched in ("fifo", "continuous"):
        server = StreamingSynthesizer(registry, scheduler=sched, device=dev)
        built = server.warmup(conditional=None)
        submit_trace(server)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        resps = server.serve()
        dt = time.perf_counter() - ts
        stats = server.stats()
        rows = sum(r.rows for r in resps)
        check(len(resps) == 16, f"{sched}: {len(resps)} responses")
        check(all(np.isfinite(r.data).all() for r in resps),
              f"{sched}: non-finite response")
        check(stats["serving_compiles"] == 0,
              f"{sched}: {stats['serving_compiles']} serving compiles")
        check(stats["decode_dispatches"] == {1: 16},
              f"{sched}: decode dispatches {stats['decode_dispatches']}")
        # replay: the same (table, rows, seed, mode) gives the same rows
        name, rows0, seed0, cond0 = trace[3]
        server.submit(name, rows0, seed=seed0, conditional=cond0)
        [again] = server.serve()
        first = next(r for r in resps if r.rid == 3)
        replay_ok = bool(np.array_equal(again.data, first.data))
        check(replay_ok, f"{sched}: replayed seed gave other rows")
        # the device's busy share: profiler device time (kernels and
        # copies) of the same trace drained again, over the wall time of
        # the unprofiled drain above
        busy_ms, _ = device_ms(lambda: (submit_trace(server), server.serve()),
                               reps=1, repeats=3)
        busy = busy_ms / (dt * 1e3)
        serving[sched] = {"requests": len(resps), "rows": rows,
                          "seconds": dt, "rows_per_s": rows / dt,
                          "warmup_runs": built,
                          "serving_compiles": stats["serving_compiles"],
                          "decode_dispatches_per_request": 1,
                          "replay_identical": replay_ok,
                          "device_busy_ms": busy_ms, "device_busy_share": busy}
        print(f"serve {sched}: {len(resps)} requests, {rows} rows in "
              f"{dt:.4f} s = {rows / dt:.0f} rows/s; warmup ran {built}; "
              f"serving_compiles {stats['serving_compiles']}; decode "
              f"dispatches per request 1; replay identical {replay_ok}; "
              f"device busy {busy_ms:.3f} ms of {dt * 1e3:.3f} ms "
              f"(idle share {1.0 - busy:.3f})")

    # generation enqueues work without waiting for the card
    entry = registry.get("intrusion")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for cond in (False, True):
                req = SynthesisRequest(-1, "intrusion", 4096, 7, True, cond)
                server._generate(req, entry, 4096)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"_generate waited for the card: {syncs[:3]}")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: ops.DISPATCH_COUNTS[k] for k in
                ("vgm_encode_table", "segment_activations", "vgm_decode_table")}
    ref_calls = {k: v for k, v in ops.DISPATCH_COUNTS.items()
                 if k.endswith("_ref")}
    print(f"main path: {main_s:.1f} s; kernel launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(not ref_calls, f"the plain route ran on the card: {ref_calls}")
    record.update(serving=serving, main_path_s=main_s, launches=launches)

    # ---- 6. Fed-TGAN training, the second main path --------------------
    from repro_torch.tabular import make_dataset
    fed_ds = make_dataset("adult", n_rows=N_ROWS, seed=0)
    fed = federated_phase(dev, cfg, fed_ds)
    stack, fe = fed.pop("stack"), fed.pop("fe")
    record["federated"] = fed

    # ---- 7. hierarchical merge -----------------------------------------
    record["edges"] = edges_phase(dev, cfg, fed_ds, stack, fe.weights)

    # ---- 8. one train step, card against CPU ---------------------------
    record["step_card_vs_cpu"] = step_phase(dev)

    # ---- 9. card path against the CPU path on a small input -----------
    ds, enc, gen, encoded = tenants["adult"]
    cpu = torch.device("cpu")
    enc_cpu = TableEncoders(enc.schema, enc.label_encoders,
                            {j: VGMParams(*(t.cpu() for t in (
                                p.weights, p.means, p.stds, p.valid)))
                             for j, p in enc.vgms.items()}, cpu)
    gen_cpu = copy.deepcopy(gen).to(cpu)
    enc_np = encoded.cpu().numpy()
    n = 512
    rng = torch.Generator().manual_seed(5)
    z = torch.randn((n, cfg.z_dim), generator=rng)
    u = torch.rand((n, enc.encoded_dim), generator=rng)
    draws = SamplerDraws(torch.randint(0, len(enc.condition_spans()), (n,),
                                       generator=rng),
                         torch.rand(n, generator=rng),
                         torch.rand(n, generator=rng))
    cat = list(enc.label_encoders)
    cont = sorted(enc.vgms)
    for cond in (False, True):
        tab_gpu = registry.get("adult").tables if cond else None
        tab_cpu = DeviceSampler(enc_np, enc_cpu, cpu).tables if cond else None
        on_card = synthesize_table(gen, cfg, enc, n, tables=tab_gpu,
                                   draws=draws, z=z, uniforms=u, device=dev)
        on_cpu = synthesize_table(gen_cpu, cfg, enc_cpu, n, tables=tab_cpu,
                                  draws=draws, z=z, uniforms=u, device=cpu)
        check(np.array_equal(on_card[:, cat], on_cpu[:, cat]),
              f"card vs CPU (conditional={cond}): categories differ")
        err = float(np.max(np.abs(on_card[:, cont] - on_cpu[:, cont])
                           / np.maximum(1.0, np.abs(on_cpu[:, cont]))))
        check(err <= 1e-4, f"card vs CPU (conditional={cond}): relative "
              f"error {err:.3g} > 1e-4")
        print(f"card vs CPU path, {n} rows, conditional={cond}: categories "
              f"equal, continuous max relative error {err:.3g} (<= 1e-4: "
              "matrix products sum in another order on the card)")

    # ---- 10. each kernel at the main path's shapes --------------------
    ds, enc, gen, _ = tenants["intrusion"]
    plan, dplan = enc.plan(), enc.decode_plan()
    x = torch.as_tensor(np.ascontiguousarray(ds.data[:, list(plan.cont_cols)]),
                        dtype=torch.float32, device=dev)
    ug = torch.rand((N_ROWS, x.shape[1] * plan.kmax), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    gumbel = -torch.log(-torch.log(ug.clamp_(min=torch.finfo().tiny)))
    enc_args = (x, plan.means, plan.stds, plan.logw, gumbel)
    B = max(SIZES)
    g = torch.Generator(dev).manual_seed(2)
    with torch.no_grad():
        logits = gen(torch.randn((B, cfg.z_dim), device=dev, generator=g),
                     torch.zeros((B, enc.cond_dim), device=dev))
    layout, px, pu = ops.pack_segments(
        logits, enc.spans(), torch.rand(logits.shape, device=dev, generator=g))
    kinds = torch.as_tensor(layout.kinds, device=dev)
    acts = ops.segment_activations(logits, enc.spans(),
                                   torch.rand(logits.shape, device=dev,
                                              generator=g), cfg.tau, True)
    slots = torch.where(dplan.pad[None], -1e30,
                        acts.index_select(1, dplan.src)).contiguous()
    dec_args = (slots, dplan.means, dplan.stds)
    from repro_torch.kernels.segment_activations import (
        segment_activations_bwd_cuda, segment_activations_cuda)
    from repro_torch.kernels.vgm_decode import vgm_decode_table_cuda
    from repro_torch.kernels.vgm_encode import vgm_encode_table_cuda
    from repro_torch.kernels.weighted_agg import weighted_agg_cuda

    Nq, Q = x.shape
    K = plan.kmax
    S, W = layout.kinds.shape
    Qd = dplan.means.shape[0]

    # the merge: the trained, unmerged stack of phase 6 and its weights
    P, D = stack.shape
    w = fe.weights.contiguous()
    stack4, w4 = stack[:4].reshape(2, 2, D).contiguous(), w[:4].reshape(2, 2)
    # the activation backward at the training shape: a G step's logits
    fenc, gen0 = fe.enc, fe.states[0].gen
    Bt = cfg.batch_size
    gt = torch.Generator(dev).manual_seed(3)
    with torch.no_grad():
        tlogits = gen0(torch.randn((Bt, cfg.z_dim), device=dev, generator=gt),
                       torch.zeros((Bt, fenc.cond_dim), device=dev))
    tlayout, tpx, tpu = ops.pack_segments(
        tlogits, fenc.spans(), torch.rand(tlogits.shape, device=dev,
                                          generator=gt))
    tkinds = torch.as_tensor(tlayout.kinds, device=dev)
    tct = torch.rand(tpx.shape, device=dev, generator=gt) * 2 - 1
    St, Wt = tlayout.kinds.shape
    fed_launches = record["federated"]["launches"]

    cases = [
        # the Pallas call it replaces, launches on its main path, bytes
        # moved and float ops for the bound, tolerance against the plain
        # version, one PyTorch call that computes the same function
        dict(name="vgm_encode_table", stem="vgm_encode",
             kern=lambda: vgm_encode_table_cuda(*enc_args),
             plain=lambda: plain.vgm_encode_table_ref(*enc_args),
             bytes=4 * (Nq * Q + 3 * Q * K + Nq * Q * K + Nq * Q * (1 + K)),
             ops=Nq * Q * (9 * K + 4), tol=0.0,
             replaces="src/repro/kernels/vgm_encode.py:137",
             launches=launches["vgm_encode_table"],
             shape=f"x ({Nq}, {Q}), Kmax {K}"),
        dict(name="segment_activations", stem="segment_activations",
             kern=lambda: segment_activations_cuda(px, pu, kinds, cfg.tau,
                                                   True),
             plain=lambda: plain.segment_activations_ref(px, pu, kinds,
                                                         cfg.tau, True),
             bytes=4 * (3 * B * S * W + S * W), ops=B * S * W * 12, tol=2e-6,
             replaces="src/repro/kernels/segment_activations.py:134",
             launches=launches["segment_activations"],
             shape=f"({B}, {S} spans x Wmax {W}), hard"),
        dict(name="vgm_decode_table", stem="vgm_decode",
             kern=lambda: vgm_decode_table_cuda(*dec_args),
             plain=lambda: plain.vgm_decode_table_ref(*dec_args),
             bytes=4 * (B * Qd * (1 + K) + 2 * Qd * K + B * Qd),
             ops=B * Qd * (K + 4), tol=0.0,
             replaces="src/repro/kernels/vgm_decode.py:62",
             launches=launches["vgm_decode_table"],
             shape=f"slots ({B}, {Qd} x {1 + K})"),
        dict(name="weighted_agg", stem="weighted_agg",
             kern=lambda: weighted_agg_cuda(stack[None], w[None])[0],
             plain=lambda: plain.weighted_agg_ref(stack, w),
             library=lambda: (w / torch.sum(w)) @ stack,
             bytes=4 * (P * D + P + D), ops=2 * P * D,
             tol=1e-7 + 1e-6 * float(stack.abs().max()),
             replaces="src/repro/kernels/weighted_agg.py:47",
             launches=fed_launches["weighted_agg"],
             shape=f"flat ({P}, {D})"),
        dict(name="segment_activations_bwd", stem="segment_activations",
             kern=lambda: segment_activations_bwd_cuda(tpx, tpu, tkinds, tct,
                                                       cfg.tau),
             plain=lambda: plain.segment_activations_bwd_ref(
                 tpx, tpu, tkinds, tct, cfg.tau),
             bytes=4 * (4 * Bt * St * Wt + St * Wt), ops=Bt * St * Wt * 16,
             tol=3e-5,
             replaces="src/repro/kernels/segment_activations.py:200",
             launches=fed_launches["segment_activations_bwd"],
             shape=f"({Bt}, {St} spans x Wmax {Wt}), ct in [-1, 1]"),
    ]
    edges_case = dict(
        name="weighted_agg (edges)", stem="weighted_agg",
        kern=lambda: weighted_agg_cuda(stack4, w4),
        plain=lambda: plain.weighted_agg_edges_ref(stack4, w4),
        library=lambda: torch.bmm((w4 / torch.sum(w4, 1, keepdim=True))[:, None],
                                  stack4)[:, 0],
        bytes=4 * (4 * D + 4 + 2 * D), ops=2 * 4 * D,
        tol=1e-7 + 1e-6 * float(stack4.abs().max()),
        replaces="src/repro/kernels/ops.py:235", launches=None,
        shape=f"edges (2, 2, {D})")
    kernels, timing, shapes = [], {}, {}
    for case in cases + [edges_case]:
        name, kern, ref_fn = case["name"], case["kern"], case["plain"]
        out_k, out_p = kern(), ref_fn()
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        tol = case["tol"]
        check(err <= tol, f"{name}: max abs error {err:.3g} > {tol:.3g}")
        if name == "segment_activations":
            soft = ~layout.pack_pad & (np.repeat(layout.kinds[:, 0],
                                                 layout.wmax) < 0.5)
            soft = torch.as_tensor(soft, device=dev)
            check(torch.equal(out_k[:, soft].round(), out_p[:, soft].round()),
                  f"{name}: hard one-hots differ")
        ms, seen = device_ms(kern)
        plain_ms, _ = device_ms(ref_fn)
        source = "profiler device time"
        if ms <= 0.0 or plain_ms <= 0.0:   # the profiler saw no kernels
            ms, plain_ms = cuda_ms(kern), cuda_ms(ref_fn)
            source = "CUDA events (profiler saw no device time)"
        call_ms, plain_call_ms = cuda_ms(kern), cuda_ms(ref_fn)
        lib = case.get("library")
        lib_ms = device_ms(lib)[0] if lib is not None else None
        extra = {}
        if case["stem"] == "weighted_agg":
            lib_err = float((lib() - out_p).abs().max())
            extra = {"cold_ms": cold_ms(kern), "library_cold_ms": cold_ms(lib),
                     "library_max_abs_err": lib_err}
        b_ms, b_by = bound_ms(case["bytes"], case["ops"])
        shapes[name] = case["shape"]
        timing[name] = {"source": source, "kernels_seen": seen,
                        "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **extra}
        if case["launches"] is not None:
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{case['stem']}.cu",
                "replaces": case["replaces"], "launches": case["launches"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        lib_txt = ("no single PyTorch call computes it" if lib is None else
                   f"library call {lib_ms * 1e3:.2f} us")
        cold_txt = ("" if not extra else
                    f"; cold L2: kernel {extra['cold_ms'] * 1e3:.2f} us, "
                    f"library {extra['library_cold_ms'] * 1e3:.2f} us "
                    f"(profiler device time)")
        print(f"kernel {name} [{case['shape']}]: {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us ({source}); per call with launch "
              f"{call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us "
              f"(CUDA events); bound {b_ms * 1e3:.2f} us ({b_by}); max abs "
              f"err {err:.3g} (tol {tol:.3g}); launches {case['launches']}; "
              f"{lib_txt}{cold_txt}; kernels seen {seen}")
    record.update(kernels=kernels, shapes=shapes, timing=timing)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
