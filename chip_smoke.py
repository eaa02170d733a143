"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

From the root of the repository.  Imports only ``repro_torch`` (from
``src/``), torch and numpy; the JAX package is not used.  Phases, each of
which stops the run with a non-zero exit on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the three CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
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
6. the card's path against the port's CPU path on a small input with the
   same injected noise: equal categories, close continuous values;
7. each kernel at the main path's shapes against its plain PyTorch version
   on the card, with its time, the plain version's time and its bound.

Phases 3-5 are the main path: the kernel launch counters are set to 0 just
before it and read just after, and every kernel must have launched.  The
last two lines of output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``; a longer record goes to
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


def device_ms(fn, reps: int = 20, repeats: int = 5) -> tuple[float, list]:
    """Device time per call: the durations of the CUDA kernels that the
    profiler saw in a window of ``reps`` calls, summed and divided by
    ``reps``; median over ``repeats`` windows.  Unlike back-to-back CUDA
    events, this leaves out the host's launch overhead.  Also returns the
    names of the kernels seen."""
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
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        times.append(sum(e.self_device_time_total for e in kern) / reps / 1e3)
        names.update(e.key[:60] for e in kern)
    return statistics.median(times), sorted(names)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    # ---- 6. card path against the CPU path on a small input -----------
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

    # ---- 7. each kernel at the main path's shapes ---------------------
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
    from repro_torch.kernels.segment_activations import segment_activations_cuda
    from repro_torch.kernels.vgm_decode import vgm_decode_table_cuda
    from repro_torch.kernels.vgm_encode import vgm_encode_table_cuda

    Nq, Q = x.shape
    K = plan.kmax
    S, W = layout.kinds.shape
    Qd = dplan.means.shape[0]
    cases = [
        # name, source stem, kernel, plain, bytes moved, float ops,
        # the Pallas call it replaces, tolerance against the plain version
        ("vgm_encode_table", "vgm_encode", lambda: vgm_encode_table_cuda(*enc_args),
         lambda: plain.vgm_encode_table_ref(*enc_args),
         4 * (Nq * Q + 3 * Q * K + Nq * Q * K + Nq * Q * (1 + K)),
         Nq * Q * (9 * K + 4), "src/repro/kernels/vgm_encode.py:137", 0.0),
        ("segment_activations", "segment_activations",
         lambda: segment_activations_cuda(px, pu, kinds, cfg.tau, True),
         lambda: plain.segment_activations_ref(px, pu, kinds, cfg.tau, True),
         4 * (3 * B * S * W + S * W), B * S * W * 12,
         "src/repro/kernels/segment_activations.py:134", 2e-6),
        ("vgm_decode_table", "vgm_decode", lambda: vgm_decode_table_cuda(*dec_args),
         lambda: plain.vgm_decode_table_ref(*dec_args),
         4 * (B * Qd * (1 + K) + 2 * Qd * K + B * Qd), B * Qd * (K + 4),
         "src/repro/kernels/vgm_decode.py:62", 0.0),
    ]
    shapes = {"vgm_encode_table": f"x ({Nq}, {Q}), Kmax {K}",
              "segment_activations": f"({B}, {S} spans x Wmax {W}), hard",
              "vgm_decode_table": f"slots ({B}, {Qd} x {1 + K})"}
    kernels, timing = [], {}
    for name, stem, kern, ref_fn, n_bytes, n_ops, replaces, tol in cases:
        out_k, out_p = kern(), ref_fn()
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        check(err <= tol, f"{name}: max abs error {err:.3g} > {tol}")
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
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        timing[name] = {"source": source, "kernels_seen": seen,
                        "call_ms": call_ms, "plain_call_ms": plain_call_ms}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{stem}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        print(f"kernel {name} [{shapes[name]}]: {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us ({source}); per call with launch "
              f"{call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us "
              f"(CUDA events); bound {b_ms * 1e3:.2f} us ({b_by}); max abs "
              f"err {err:.3g} (tol {tol}); launches {launches[name]}; no "
              "single PyTorch call computes it; kernels seen "
              f"{seen}")
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
