"""Drive the PyTorch port's serving, federated CTGAN training, federated
LM pre-training and xLSTM LM serving paths once on one CUDA card.

    python3 chip_smoke.py

From the root of the repository.  Imports only ``repro_torch`` (from
``src/``), torch and numpy; the JAX package is not used.  Phases, each of
which stops the run with a non-zero exit on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the seven CUDA sources from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) into ``build/repro_torch``, and count the HGMMA
   (``wgmma``) instructions of every bf16 flash kernel and of every
   tensor-core grid of ``mlstm_chunk_sm90`` in the built libraries
   (``cuobjdump -sass``): each must have some;
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
10. federated LM pre-training at full width and depth: smollm-135m (30
   layers, d_model 576, 9 query and 3 KV heads of 64, vocab 49,152, bf16,
   remat) with attention through the flash kernels, 4 non-IID clients x 2
   rounds x 2 local steps of batch 4 x 2,048 tokens, ``fedtgan`` weights,
   through ``repro_torch.launch.train.run_federated``: finite losses,
   clients bit-identical after each merge, per round 480 flash forward
   launches (30 layers x 8 local steps, twice under remat), 240 dq, 240
   dk/dv and one ``weighted_agg``, the mean loss per round within 1e-2 of
   10.3518 / 9.0413 (the CUDA-core flash kernels' run); seconds per round,
   tokens/s and the card's busy share of one more round;
11. the per-column ``encode_loop`` on ``adult`` at 40,000 rows: one
   single-column ``vgm_encode`` launch per continuous column, equal to the
   one-dispatch ``encode`` with the same Gumbel noise;
12. the full-width smollm-135m's logits through the flash kernels against
   the plain ``gqa_attention`` route, float32, TF32 off;
13. xLSTM LM serving at full width and depth: xlstm-1.3b (48 layers of
   alternating mLSTM and sLSTM blocks, d_model 2,048, 4 heads, mLSTM head
   dim 1,024, vocab 50,304, bf16) through
   ``repro_torch.launch.serve.prefill_and_decode``: a greedy 4 x 2,048-token
   prefill and 32 decoded tokens, 24 ``mlstm_chunk`` launches (one per
   mLSTM layer), finite logits, tokens in the vocabulary; prefill and
   decode tokens/s, peak memory and the card's busy share of one more
   prefill; then a float32 copy of the same model, TF32 off: a prefill of
   the first 1,792 tokens and 256 ``decode_step``s against a prefill of all
   2,048 (the last logits) and a full forward (every decoded position),
   which holds the kernel's final (C, n, m) carry against the per-step
   decode;
14. each kernel at its main path's shapes against its plain PyTorch version
   on the card, with its time, the plain version's time, its bound and,
   where one PyTorch call computes the same function, that call's time;
   for the flash kernels also the products done against the least; the
   flash kernels on a ragged and a sliding-window case against autograd
   through the plain full-matrix attention; the activations forward in
   each of its layouts over span widths; and the layout line: the
   activation backward in each layout timed at the training shape and at
   500 to 4,099 rows over span widths, and the table decode at each rung
   of the serving ladder, each against its plain version; and the encode's
   shape line: the table encode at (40,000, 22), (40,000, 5), (8,000, 5)
   and (128, 22) and the column encode at 40,000 and 8,000 rows, Kmax 10,
   each equal to its plain version, with its device time, its traced
   launch, the plain version's time and its bound.

Phases 3-5 are the serving main path, phase 6 the CTGAN training main
path, phase 10 the LM main path, phase 11 the path of the single-column
encode and phase 13 the xLSTM serving path: the kernel launch counters
are set to 0 just before each and read just after, every kernel of the
path must have launched, and no plain-version counter may move.  The last two lines of output are the
``kernels`` JSON object and ``{"ok": true, "device": {...}}``; a longer
record goes to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --encode-shapes [--tree DIR]

runs phases 1-2 and the encode's shape line alone, for the ``repro_torch``
of the checkout at ``DIR`` (default: this one): run in turns on two
checkouts in one call, it compares their encode kernels on one card.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
# tensor cores ops/s (the tabular kernels' float32 elementwise work), dense
# bf16 tensor-core ops/s (the flash kernels' products on bf16 inputs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12

SIZES = (100, 777, 4096)
N_ROWS = 40_000
FED_CLIENTS, FED_ROUNDS, FED_STEPS = 5, 4, 2
F32_EPS = 2.0 ** -23
LM_CLIENTS, LM_ROUNDS, LM_STEPS, LM_BATCH, LM_SEQ = 4, 2, 2, 4, 2048
# the LM run's mean loss per round with the CUDA-core flash kernels
LM_LOSSES = (10.3518, 9.0413)
# the C entries of the bf16 flash library and their kernels' names
SM90_KERNELS = {"flash_attention_fwd": "flash_fwd_sm90",
                "flash_attention_dq": "flash_dq_sm90",
                "flash_attention_dkv": "flash_dkv_sm90"}
# the tensor-core grids of the mLSTM library: the main grid's two value-tile
# widths (128 on the prefill's path) and the gated scores
MLSTM_TC_KERNELS = ("mlstm_mainILi128E", "mlstm_mainILi64E", "mlstm_scores")
# widths of the activations forward's layout sweep
ACT_SWEEP_WIDTHS = (8, 16, 19, 24, 32, 40, 44, 48, 64, 128, 300)
# the activation backward's layout line: rows (the training batch and more)
# and span widths, about 342 lanes a row as in the training layout (9 and
# 17, just past a power of two, idle most of a group's threads); and the
# layouts it times (they differ past 32 lanes)
BWD_SWEEP_ROWS = (500, 4099)
BWD_SWEEP_WIDTHS = (8, 9, 17, 18, 32, 64, 300)
BWD_SWEEP_LAYOUTS = ("groups", "groups_unstaged")
# the encode's shape line, Kmax 10: (rows, columns) of the table entry
# (intrusion and adult at the paper's 40,000 rows, one training client of
# adult, a table of one serving rung) and the rows of the column entry
ENCODE_TABLE_SHAPES = ((40_000, 22), (40_000, 5), (8000, 5), (128, 22))
ENCODE_COLUMN_ROWS = (40_000, 8000)
ENCODE_KMAX = 10
# the four grids of one mlstm_chunk_sm90 call, and nothing else in its trace
MLSTM_GRIDS = ("mlstm_gates", "mlstm_prep", "mlstm_scores", "mlstm_main")
# bf16 products the mLSTM kernel does for each product of its least work
MLSTM_PRODUCTS = 3
XL_BATCH, XL_PROMPT, XL_GEN, XL_SPLIT, XL_CHUNK = 4, 2048, 32, 1792, 256


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


def kernel_ms(fn, reps: int = 20, repeats: int = 5, *, before=None) -> float:
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that holds the
    card until the host has queued all of them, so the span holds their
    device work and no host launch gaps; median over ``repeats`` windows.
    ``before`` runs ahead of every call, and its own time, measured alike,
    is subtracted.  The host can queue only so many launches ahead of the
    card (about a thousand): ``reps`` calls of a function that launches
    hundreds of kernels each never fit behind the spin, so the spin grows
    at most 5 times before the measurement fails.  (Summing the
    profiler's kernel records over a window read up to 45% low late in a
    long run: records were dropped.)"""
    import torch

    def span(f):
        f()
        torch.cuda.synchronize()
        cycles, times = 10_000_000, []
        while len(times) < repeats:
            check(cycles <= 10_000_000 * 4 ** 5, f"kernel_ms: {reps} calls "
                  "never fit in the launch queue behind the spin kernel")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                f()
            stop.record()
            queued_in_time = not start.query()
            stop.synchronize()
            if queued_in_time:
                times.append(start.elapsed_time(stop) / reps)
            else:              # the card caught up with the host: spin longer
                cycles *= 4
        return statistics.median(times)

    if before is None:
        return span(fn)

    def both():
        before()
        fn()
    return span(both) - span(before)


def device_busy(fn, repeats: int = 1, top: int = 8) -> tuple[float, list]:
    """Device time of one call of ``fn``: the durations of its kernels and
    copies under a CUDA-only profiler, median over ``repeats`` calls; and
    the ``top`` kernels of the last call by device time, as (name, ms,
    launches).  It leaves out the gaps between kernels, so over a drain or
    a round it is the card's busy time.  Tracing only the device keeps the
    profiler cheap for a call of tens of thousands of operations, and its
    records complete late in a long run, where a CPU and CUDA trace's
    kernel records came back incomplete.  The trace's device records are
    summed as they come (an xLSTM prefill leaves ~1.2 M of them), not
    through ``key_averages``, which builds a Python object per record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    totals, by_name = [], {}
    for _ in range(repeats):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ns, n = by_name.get(e.name(), (0, 0))
                by_name[e.name()] = (ns + e.duration_ns(), n + 1)
        totals.append(sum(ns for ns, _ in by_name.values()) / 1e6)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return statistics.median(totals), [(name[:70], ns / 1e6, n)
                                       for name, (ns, n) in ranked]


def traced_launch_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean duration of one launch of the kernel named ``kernel`` over
    ``reps`` calls of ``fn`` in a CUDA-only trace (:func:`device_busy`):
    its own time on the card, without the gaps between launches that
    :func:`kernel_ms` counts.  A trace that holds no launch of it (the
    profiler has dropped records) is taken again, up to three times."""
    for _ in range(3):
        _, grids = device_busy(lambda: [fn() for _ in range(reps)],
                               top=1000)
        hits = [(ms, n) for g, ms, n in grids if kernel in g]
        launches = sum(n for _, n in hits)
        if launches > 0:
            return sum(ms for ms, _ in hits) / launches
    fail(f"traced_launch_ms: no {kernel} in three traces")


def cold_ms(fn) -> float:
    """Device time per call (:func:`kernel_ms`) when every call follows a
    128 MB write that evicts the 50 MB L2 cache, so that its inputs come
    from device memory; the write itself is not counted."""
    import torch
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    return kernel_ms(fn, before=flush.zero_)


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hgmma_counts(library: Path) -> dict:
    """HGMMA instructions (``wgmma`` in SASS) in each kernel of a built
    library, by mangled kernel name, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def mlstm_prefill_inputs(dev):
    """The chunkwise mLSTM's inputs at the xLSTM prefill's shape: 4 prompts
    x 4 heads, 2,048 steps, head dim 1,024, drawn as the reference's kernel
    tests draw them."""
    import torch
    import torch.nn.functional as F
    XB, XS, XD = XL_BATCH * 4, XL_PROMPT, 1024
    gm = torch.Generator(dev).manual_seed(19)
    mq = torch.randn((XB, XS, XD), device=dev, generator=gm) / XD ** 0.5
    mk, mv = (torch.randn((XB, XS, XD), device=dev, generator=gm)
              for _ in range(2))
    mlf = F.logsigmoid(2.0 + torch.randn((XB, XS), device=dev, generator=gm))
    mli = 0.5 * torch.randn((XB, XS), device=dev, generator=gm)
    return mq, mk, mv, mlf, mli


def mlstm_grid_times(dev) -> list:
    """Device time of each of the mLSTM kernel's four grids in one call at
    the prefill's shape, as (name, ms, launches), from a CUDA-only trace
    taken early in the run: a short trace late in a long run came back
    empty."""
    import torch
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_cuda
    args = mlstm_prefill_inputs(dev)

    def run():
        return mlstm_chunk_cuda(*args, chunk=XL_CHUNK, return_state=True)
    run()
    torch.cuda.synchronize()
    grids = device_busy(run, top=1000)[1]
    names = sorted(re.sub(r"^void |[(]anonymous namespace[)]::", "",
                          g).split("(")[0].split("<")[0] for g, _, _ in grids)
    check(names == sorted(MLSTM_GRIDS) and all(n == 1 for _, _, n in grids),
          f"mlstm_chunk: the trace of one call holds {grids}, not one launch "
          f"each of {MLSTM_GRIDS}")
    return grids


def activation_layouts(dev, tau, serving) -> list:
    """Device time per call of the activations forward in each of its two
    layouts (the tile and the warp with its stage), each held against the
    plain version: at the serving shape (``serving``: packed x, u and
    kinds) and at 4,096 rows of softmax spans of one width W each, about
    1,216 lanes a row, on both sides of the width where the kernel switches
    from the tile to the warp."""
    import torch
    from repro_torch.kernels.ref import segment_activations_ref
    from repro_torch.kernels.segment_activations import (
        segment_activations_cuda)
    g = torch.Generator(dev).manual_seed(23)
    inputs = [("serving", *serving)]
    for w in ACT_SWEEP_WIDTHS:
        s = max(1, 1216 // w)
        x = 2.0 * torch.randn((4096, s * w), device=dev, generator=g)
        u = 0.01 + 0.98 * torch.rand((4096, s * w), device=dev, generator=g)
        inputs.append((f"W {w}", x, u, torch.zeros((s, w), device=dev)))
    rows = []
    for what, x, u, kinds in inputs:
        want = segment_activations_ref(x, u, kinds, tau, False)
        row = {"inputs": what, "shape": [x.shape[0], *kinds.shape]}
        for layout in ("tile", "warp"):
            got = segment_activations_cuda(x, u, kinds, tau, False,
                                           layout=layout)
            err = float((got - want).abs().max())
            check(err <= 2e-6, f"segment_activations {layout} layout at "
                  f"{what}: max abs error {err:.3g}, tolerance 2e-6")
            row[f"{layout}_ms"] = kernel_ms(
                lambda: segment_activations_cuda(x, u, kinds, tau, True,
                                                 layout=layout))
        rows.append(row)
    return rows


def backward_and_decode_layouts(dev, tau, training, decode,
                                 rungs) -> dict:
    """Device time per call of the activation backward in each layout of
    ``BWD_SWEEP_LAYOUTS``, each held against the plain version (atol
    3e-5), at the training shape (``training``: packed x, u, kinds and ct)
    and at ``BWD_SWEEP_ROWS`` rows of softmax spans of each width of
    ``BWD_SWEEP_WIDTHS``; and of the table decode and its plain version at
    each rung of the serving ladder (the first ``rungs`` rows of
    ``decode``'s slots), held to it exactly; and an empty kernel's
    (``torch.cuda._sleep(0)``), the floor of any one launch.  The training
    shape's backward and every decode rung also give their kernel's own
    duration per launch in a trace (``trace_ms``)."""
    import torch
    from repro_torch.kernels.ref import (segment_activations_bwd_ref,
                                         vgm_decode_table_ref)
    from repro_torch.kernels.segment_activations import (
        segment_activations_bwd_cuda)
    from repro_torch.kernels.vgm_decode import vgm_decode_table_cuda
    g = torch.Generator(dev).manual_seed(29)
    inputs = [("training", *training)]
    for n in BWD_SWEEP_ROWS:
        for w in BWD_SWEEP_WIDTHS:
            s = max(1, 342 // w)
            x = 2.0 * torch.randn((n, s * w), device=dev, generator=g)
            u = 0.01 + 0.98 * torch.rand((n, s * w), device=dev, generator=g)
            ct = torch.rand((n, s * w), device=dev, generator=g) * 2 - 1
            inputs.append((f"W {w}", x, u, torch.zeros((s, w), device=dev),
                           ct))
    backward = []
    for what, x, u, kinds, ct in inputs:
        want = segment_activations_bwd_ref(x, u, kinds, ct, tau)
        row = {"inputs": what, "shape": [x.shape[0], *kinds.shape]}
        for layout in BWD_SWEEP_LAYOUTS:
            got = segment_activations_bwd_cuda(x, u, kinds, ct, tau,
                                               layout=layout)
            err = float((got - want).abs().max())
            check(err <= 3e-5, f"segment_activations_bwd {layout} layout at "
                  f"{what} {row['shape']}: max abs error {err:.3g}, "
                  "tolerance 3e-5")
            row[f"{layout}_ms"] = kernel_ms(
                lambda: segment_activations_bwd_cuda(x, u, kinds, ct, tau,
                                                     layout=layout))
            row[f"{layout}_err"] = err
        row["plain_ms"] = kernel_ms(
            lambda: segment_activations_bwd_ref(x, u, kinds, ct, tau))
        if what == "training":
            row["trace_ms"] = traced_launch_ms(
                lambda: segment_activations_bwd_cuda(x, u, kinds, ct, tau),
                "segment_activations_bwd")
        backward.append(row)
    slots, means, stds = decode
    # the floor of a launch: an empty kernel's device time, measured alike
    empty_ms = kernel_ms(lambda: torch.cuda._sleep(0))
    rows = []
    for n in rungs:
        args = (slots[:n], means, stds)
        got, want = vgm_decode_table_cuda(*args), vgm_decode_table_ref(*args)
        check(torch.equal(got, want), f"vgm_decode_table at {n} rows: not "
              "equal to the plain version")
        rows.append({"rows": n, "ms": kernel_ms(
            lambda: vgm_decode_table_cuda(*args)),
            "trace_ms": traced_launch_ms(
                lambda: vgm_decode_table_cuda(*args), "vgm_decode_table"),
            "plain_ms": kernel_ms(lambda: vgm_decode_table_ref(*args))})
    return {"backward": backward, "decode": rows, "empty_kernel_ms": empty_ms}


def encode_bytes_ops(n: int, q: int, k: int) -> tuple[int, int]:
    """Bytes an encode must move (x, the params, the Gumbels read once;
    the slots, or the column's alphas and betas, written once) and its
    float operations, for ``n`` rows of ``q`` columns of ``k`` modes."""
    return 4 * (n * q + 3 * q * k + n * q * k + n * q * (1 + k)), \
        n * q * (9 * k + 4)


def encode_shapes(dev) -> list:
    """Device time per call (:func:`kernel_ms`) of the table encode at
    ``ENCODE_TABLE_SHAPES`` and of the column encode at
    ``ENCODE_COLUMN_ROWS`` rows, Kmax 10, beside each launch's own duration
    in a trace, the plain version's time and the bound of the bytes moved;
    each result equal to the plain version's.  Inputs drawn on the card
    from a seed: x ~ 2 N(0, 1), means ~ 3 N(0, 1), stds in [0.5, 1.5), log
    weights ~ 0.3 N(0, 1), Gumbels -log(-log u), not nudged away from
    ties."""
    import torch
    from repro_torch.kernels.ref import vgm_encode_ref, vgm_encode_table_ref
    from repro_torch.kernels.vgm_encode import (vgm_encode_cuda,
                                                vgm_encode_table_cuda)
    g = torch.Generator(dev).manual_seed(31)
    K = ENCODE_KMAX
    rows = []
    for n, q in (list(ENCODE_TABLE_SHAPES)
                 + [(n, 1) for n in ENCODE_COLUMN_ROWS]):
        entry = "table" if (n, q) in ENCODE_TABLE_SHAPES else "column"
        x = 2 * torch.randn((n, q), device=dev, generator=g)
        means = 3 * torch.randn((q, K), device=dev, generator=g)
        stds = 0.5 + torch.rand((q, K), device=dev, generator=g)
        logw = 0.3 * torch.randn((q, K), device=dev, generator=g)
        u = torch.rand((n, q * K), device=dev, generator=g)
        gum = -torch.log(-torch.log(u.clamp_min(1e-30)))
        if entry == "table":
            args, kern, plain = ((x, means, stds, logw, gum),
                                 vgm_encode_table_cuda, vgm_encode_table_ref)
        else:
            args = (x[:, 0].contiguous(), means[0].contiguous(),
                    stds[0].contiguous(), logw[0].contiguous(), gum)
            kern, plain = vgm_encode_cuda, vgm_encode_ref
        got, want = kern(*args), plain(*args)
        same = (torch.equal(got, want) if entry == "table" else
                all(torch.equal(a, b) for a, b in zip(got, want)))
        check(same, f"vgm_encode {entry} at ({n}, {q}), Kmax {K}: not equal "
              "to the plain version")
        rows.append({
            "entry": entry, "rows": n, "columns": q, "kmax": K,
            "ms": kernel_ms(lambda: kern(*args)),
            "trace_ms": traced_launch_ms(lambda: kern(*args), "vgm_encode"),
            "plain_ms": kernel_ms(lambda: plain(*args)),
            "bound_ms": bound_ms(*encode_bytes_ops(n, q, K))[0]})
    return rows


def print_encode_shapes(rows) -> None:
    print("vgm_encode by shape (device time per call; its traced launch; "
          "plain; bound): " + "; ".join(
              f"{r['entry']} ({r['rows']}, {r['columns']}): "
              f"{r['ms'] * 1e3:.2f} us, traced {r['trace_ms'] * 1e3:.2f} us, "
              f"plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_ms'] / r['ms']:.2f} "
              "of it)" for r in rows))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def encode_shapes_main(tree: Path) -> int:
    """The card, the build and the encode's shape line alone, for the
    ``repro_torch`` of the checkout at ``tree``.  Run in turns on two
    checkouts in one call (``--tree`` pointing at the other), it compares
    their encode kernels on one card; the wrappers' signatures are the
    same in every checkout that has them."""
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: "
          "this script needs a card")
    check((tree / "src" / "repro_torch").is_dir(),
          f"no src/repro_torch in {tree}")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build
    print(card_line())
    print(f"tree {tree}; kernel build: {_build.build_all():.2f} s")
    rows = encode_shapes(torch.device("cuda", 0))
    print_encode_shapes(rows)
    print(json.dumps({"tree": str(tree), "encode_shapes": rows}))
    return 0


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
    busy_ms, top = device_busy(one_round, repeats=3)
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
            "round_busy_share": busy, "top_kernels": top,
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


def lm_phase(dev) -> dict:
    """Phase 10, the LM main path: ``run_federated`` at smollm-135m's full
    width and depth with the flash kernels, then one more global round on
    its states for the card's busy share."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDatasetSpec, client_token_streams
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (federated_round, lm_optimizer,
                                          run_federated)
    from repro_torch.models import Transformer, make_train_step, tree_leaves

    cfg = dataclasses.replace(get_config("smollm-135m"), use_flash_kernel=True)
    per_round = LM_CLIENTS * LM_STEPS
    want = {"flash_attention_fwd": cfg.n_layers * per_round
            * (2 if cfg.remat else 1),
            "flash_attention_dq": cfg.n_layers * per_round,
            "flash_attention_dkv": cfg.n_layers * per_round,
            "weighted_agg": 1}
    marks, round_counts, losses = [], [], []

    def on_round(r, states, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts = ops.DISPATCH_COUNTS.copy()
        round_counts.append(counts)
        ref = tree_leaves(states[0].params)
        check(all(torch.equal(a, b) for st in states[1:]
                  for a, b in zip(ref, tree_leaves(st.params), strict=True)),
              f"LM round {r}: clients differ after the merge")
        lv = m["loss"].cpu().numpy()
        check(lv.shape == (LM_CLIENTS, LM_STEPS) and np.isfinite(lv).all(),
              f"LM round {r}: losses {lv}")
        losses.append(float(lv.mean()))
        marks[-1] = (marks[-1], time.perf_counter())      # (done, checked)

    ops.DISPATCH_COUNTS.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    states, hist, w = run_federated(
        cfg, clients=LM_CLIENTS, rounds=LM_ROUNDS, local_steps=LM_STEPS,
        batch=LM_BATCH, seq=LM_SEQ, lr=3e-4, iid=False, weighting="fedtgan",
        device=dev, on_round=on_round)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.DISPATCH_COUNTS.copy()
    refs = {k: v for k, v in counts.items() if k.endswith("_ref")}
    check(not refs, f"LM: the plain route ran on the card: {refs}")
    prev: dict = {}
    for r, c in enumerate(round_counts):
        got = {k: c.get(k, 0) - prev.get(k, 0) for k in want}
        check(got == want, f"LM round {r}: launches {got}, expected {want}")
        prev = c
    check(abs(float(w.sum()) - 1.0) < 1e-5, f"LM weights sum to {w.sum()}")
    loss_err = max(abs(a - b) for a, b in zip(losses, LM_LOSSES, strict=True))
    check(loss_err <= 1e-2, f"LM mean loss per round {losses} vs "
          f"{list(LM_LOSSES)} with the CUDA-core flash kernels: {loss_err:.3g}")
    start = t0
    round_s = []
    for done, checked in marks:
        round_s.append(done - start)
        start = checked
    tokens = LM_CLIENTS * LM_STEPS * LM_BATCH * LM_SEQ
    n_params = sum(t.numel() for t in tree_leaves(states[0].params))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"LM run_federated: smollm-135m, {n_params} parameters, "
          f"{LM_CLIENTS} non-IID clients x {LM_ROUNDS} rounds x {LM_STEPS} "
          f"local steps of {LM_BATCH} x {LM_SEQ} tokens, bf16, remat "
          f"{cfg.remat}; client weights {np.round(w, 6).tolist()}; mean loss "
          f"per round {[round(x, 4) for x in losses]} (CUDA-core flash "
          f"kernels: {list(LM_LOSSES)}); seconds per round "
          f"{[round(x, 3) for x in round_s]} (the first includes the run's "
          f"setup: data, weights, init); {tokens / round_s[-1]:.0f} tokens/s "
          f"in the last round; launches per round {want} (gated); clients "
          f"bit-identical after each merge; peak memory {peak_gb:.2f} GB; "
          f"{run_s:.2f} s in all")

    # one more global round on the trained states, for the busy share
    step_fn = make_train_step(Transformer(cfg), lm_optimizer(3e-4))
    streams = client_token_streams(TokenDatasetSpec(cfg.vocab, LM_SEQ),
                                   LM_CLIENTS, LM_BATCH, LM_STEPS, iid=False,
                                   seed=7)
    w_dev = torch.as_tensor(w, device=dev)

    def one_round():
        return federated_round(states, step_fn, streams, w_dev)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    busy_ms, top = device_busy(one_round)
    check(busy_ms > 0.0, "LM: the profiler saw no device time")
    busy = busy_ms / (wall * 1e3)
    print(f"LM one more global round: {wall * 1e3:.1f} ms wall, "
          f"{tokens / wall:.0f} tokens/s, device busy {busy_ms:.1f} ms "
          f"(idle share {1 - busy:.3f}); top kernels by device time: "
          + "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in top))
    del states, step_fn
    torch.cuda.empty_cache()
    return {"run_s": run_s, "round_s": round_s, "losses": losses,
            "weights": w.tolist(), "params": n_params,
            "launches_per_round": want, "launches": dict(counts),
            "tokens_per_round": tokens,
            "tokens_per_s_last_round": tokens / round_s[-1],
            "extra_round_wall_ms": wall * 1e3, "extra_round_busy_ms": busy_ms,
            "extra_round_busy_share": busy, "peak_memory_gb": peak_gb,
            "top_kernels": top}


def encode_loop_phase(dev, enc, ds) -> dict:
    """Phase 11: the per-column ``encode_loop`` (the single-column kernel's
    path) against the one-dispatch ``encode``, on the same noise."""
    import torch

    from repro_torch.kernels import ops

    plan = enc.plan()
    g = plan.draw_gumbel(ds.n_rows, torch.Generator(dev).manual_seed(9))
    fused = enc.encode(ds.data, gumbel=g)
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    looped = enc.encode_loop(ds.data, gumbel=g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ops.DISPATCH_COUNTS)
    n_cont = len(plan.cont_cols)
    check(counts == {"vgm_encode": n_cont},
          f"encode_loop launches {counts}, expected {n_cont} vgm_encode")
    check(torch.equal(looped, fused), "encode_loop differs from encode")
    print(f"encode_loop adult: {ds.n_rows} rows, {n_cont} vgm_encode "
          f"launches (one per continuous column), equal to encode, "
          f"{dt * 1e3:.2f} ms")
    return {"launches": counts, "seconds": dt}


def logits_phase(dev) -> dict:
    """Phase 12: the full-width smollm-135m's logits through the flash
    kernels against the plain ``gqa_attention`` route, float32."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    params = Transformer(cfg).init(seed=5, device=dev)
    tk = torch.randint(0, cfg.vocab, (1, LM_SEQ), device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
    batch = {"tokens": tk, "labels": tk}
    with torch.no_grad():
        plain, _ = Transformer(cfg).forward(params, batch)
        flash, _ = Transformer(dataclasses.replace(
            cfg, use_flash_kernel=True)).forward(params, batch)
    torch.cuda.synchronize()
    err = float((flash - plain).abs().max())
    scale = float(plain.abs().max())
    tol = 1e-5 * max(1.0, scale) * cfg.n_layers
    check(bool(torch.isfinite(flash).all()), "flash logits not finite")
    check(err <= tol, f"flash vs plain logits: max abs err {err:.3g} > "
          f"{tol:.3g}")
    print(f"smollm-135m logits (1 x {LM_SEQ} tokens, float32, TF32 off): "
          f"flash kernels vs gqa_attention max abs err {err:.3g} (tol "
          f"{tol:.3g}: 1e-5 of max|logit| {scale:.3g} per layer, products "
          f"summed in another order in each of {cfg.n_layers} layers)")
    del params
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "tol": tol, "max_abs_logit": scale}


def flash_route_checks(dev) -> dict:
    """Phase 13's extra flash cases: ``ops.flash_attention`` on the card
    (GQA expansion, padding, the three kernels) against autograd through
    the plain full-matrix attention, float32, on a ragged and a
    sliding-window case."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as plain

    out = {}
    for name, S, window in (("ragged S=1000", 1000, None),
                            ("window 256, S=2048", 2048, 256)):
        g = torch.Generator(dev).manual_seed(S)
        q = torch.randn((2, 9, S, 64), device=dev, generator=g)
        k, v = (torch.randn((2, 3, S, 64), device=dev, generator=g)
                for _ in range(2))
        ct = torch.randn((2, 9, S, 64), device=dev, generator=g)
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        with ops.dispatch_scope() as d:
            o_k = ops.flash_attention(*a, causal=True, window=window)
            torch.sum(o_k * ct).backward()
            torch.cuda.synchronize()
        check(dict(d) == {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                          "flash_attention_dkv": 1},
              f"flash {name}: launches {dict(d)}")
        o_p = plain.attention_ref(*b, causal=True, window=window)
        torch.sum(o_p * ct).backward()
        errs = {"out": float((o_k - o_p).abs().max().detach())}
        tols = {"out": 2e-5}
        for n, x, y in zip(("dq", "dk", "dv"), a, b):
            errs[n] = float((x.grad - y.grad).abs().max())
            tols[n] = 1e-4 * max(1.0, float(y.grad.abs().max()))
        for n in errs:
            check(errs[n] <= tols[n], f"flash {name}: {n} max abs err "
                  f"{errs[n]:.3g} > {tols[n]:.3g}")
        print(f"flash route {name} (2, 9/3 heads, 64), float32, vs autograd "
              f"through the plain attention: max abs err "
              + ", ".join(f"{n} {errs[n]:.3g} (tol {tols[n]:.3g})"
                          for n in errs))
        out[name] = errs
    return out


def xlstm_phase(dev) -> dict:
    """Phase 13, the xLSTM serving path: ``prefill_and_decode`` at
    xlstm-1.3b's full width and depth (bf16, greedy), one more prefill for
    the card's busy share, and the float32 prefill-vs-decode gate."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_and_decode
    from repro_torch.models import Transformer, tree_leaves, tree_unflatten

    cfg = get_config("xlstm-1.3b")
    model = Transformer(cfg)
    n_mlstm = cfg.pattern.count("mlstm") * cfg.n_rep
    params = model.init(seed=11, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompts = torch.randint(0, cfg.vocab, (XL_BATCH, XL_PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(11))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    gen, stats = prefill_and_decode(
        cfg, batch=XL_BATCH, prompt_len=XL_PROMPT, gen_tokens=XL_GEN,
        temperature=0, seed=11, device=dev, params=params, prompts=prompts)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(ops.DISPATCH_COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts == {"mlstm_chunk": n_mlstm},
          f"xLSTM serving launches {counts}, expected {n_mlstm} mlstm_chunk "
          "and no plain route")
    check(stats["logits_finite"], "xLSTM serving: a logit is not finite")
    check(gen.shape == (XL_BATCH, XL_GEN)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"xLSTM serving: tokens {gen.shape} outside the vocabulary")
    prefill_tps = XL_BATCH * XL_PROMPT / stats["prefill_s"]
    print(f"xLSTM serve: xlstm-1.3b, {n_params} parameters "
          f"(param_count {int(cfg.param_count())} + norm scales), bf16, "
          f"{XL_BATCH} x {XL_PROMPT}-token greedy prefill in "
          f"{stats['prefill_s']:.3f} s = {prefill_tps:.0f} tokens/s; "
          f"{XL_GEN} decode steps in {stats['decode_s']:.3f} s = "
          f"{stats['tok_per_s']:.1f} tokens/s; launches {counts} (gated: "
          f"{n_mlstm} per prefill); logits finite; peak memory "
          f"{peak_gb:.2f} GB; {run_s:.2f} s in all; sample "
          f"{gen[0][:8].tolist()}")

    def one_prefill():
        with torch.no_grad():
            model.prefill(params, {"tokens": prompts}, XL_PROMPT + XL_GEN)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    one_prefill()
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    tp = time.perf_counter()
    busy_ms, top = device_busy(one_prefill)
    trace_s = time.perf_counter() - tp
    check(busy_ms > 0.0, "xLSTM: the profiler saw no device time")
    busy = busy_ms / (wall * 1e3)
    print(f"xLSTM one more prefill: {wall * 1e3:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms (busy share {busy:.3f}, idle {1 - busy:.3f}; "
          f"traced in {trace_s:.1f} s); top kernels by device time: "
          + "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in top))

    # float32: prefill of XL_SPLIT tokens, then decode the rest one token
    # at a time, against a prefill of all of them (the last logits) and a
    # full forward (every decoded position).  Tolerance rtol = atol = 1e-2:
    # the two paths differ in rounding only, but the chunkwise and the
    # per-step mLSTM round differently -- the reference bounds that gap at
    # 2e-3 per block (tests/test_ssm_blocks.py) and its own model-level
    # prefill-vs-replay test at 5e-2 -- and 48 blocks sit on the path.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = Transformer(cfg32)
    p32 = tree_unflatten(params, [t.detach().float()
                                  for t in tree_leaves(params)])
    del params
    torch.cuda.empty_cache()
    tol = dict(rtol=1e-2, atol=1e-2)

    def worst(got, want):      # max |got - want| / (atol + rtol |want|)
        return float(((got - want).abs()
                      / (tol["atol"] + tol["rtol"] * want.abs())).max())
    with torch.no_grad():
        ops.DISPATCH_COUNTS.clear()
        t1 = time.perf_counter()
        fwd, _ = m32.forward(p32, {"tokens": prompts})
        want_steps = fwd[:, XL_SPLIT - 1:].contiguous()   # positions >= 1791
        del fwd
        torch.cuda.empty_cache()
        head, caches = m32.prefill(p32, {"tokens": prompts[:, :XL_SPLIT]},
                                   XL_PROMPT)
        ratios = [worst(head, want_steps[:, 0])]
        errs = [float((head - want_steps[:, 0]).abs().max())]
        # the gate's power: the first step from caches whose mLSTM carry
        # (C, n) is dropped must miss the forward by more than the tolerance
        dropped = [{k: type(c)(torch.zeros_like(c.C), torch.zeros_like(c.n),
                               c.m) if k == "pos0" else c
                    for k, c in rep.items()} for rep in caches]
        no_carry, _ = m32.decode_step(
            p32, dropped, {"token": prompts[:, XL_SPLIT:XL_SPLIT + 1]})
        del dropped
        no_carry_ratio = worst(no_carry, want_steps[:, 1])
        no_carry_err = float((no_carry - want_steps[:, 1]).abs().max())
        for t in range(XL_SPLIT, XL_PROMPT):
            logits, caches = m32.decode_step(
                p32, caches, {"token": prompts[:, t:t + 1]})
            want = want_steps[:, t - XL_SPLIT + 1]
            ratios.append(worst(logits, want))
            errs.append(float((logits - want).abs().max()))
        full, _ = m32.prefill(p32, {"tokens": prompts}, XL_PROMPT)
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t1
    last_err = float((logits - full).abs().max())
    last_ratio = worst(logits, full)
    counts32 = dict(ops.DISPATCH_COUNTS)
    profile = {i: round(errs[i], 7) for i in (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)
               if i < len(errs)}
    print(f"xLSTM float32 gate (TF32 off): prefill {XL_SPLIT} then "
          f"{XL_PROMPT - XL_SPLIT} decode_steps vs prefill {XL_PROMPT}: last "
          f"logits max abs err {last_err:.3g} ({last_ratio:.3g} of the "
          f"tolerance; max |logit| {float(full.abs().max()):.3g}); every "
          f"decoded position vs the full forward: max abs err "
          f"{max(errs):.3g} at step {int(np.argmax(errs))} ({max(ratios):.3g} "
          f"of the tolerance), by step {profile}; the first step with the "
          f"mLSTM carry dropped misses by {no_carry_err:.3g} "
          f"({no_carry_ratio:.1f}x the tolerance); rtol = atol = 1e-2; "
          f"{f32_s:.1f} s")
    check(counts32 == {"mlstm_chunk": 3 * n_mlstm},
          f"float32 gate launches {counts32}")
    check(bool(torch.isfinite(full).all() and torch.isfinite(logits).all()),
          "float32 gate: logits not finite")
    check(last_ratio <= 1.0, f"float32 prefill {XL_SPLIT} + "
          f"{XL_PROMPT - XL_SPLIT} decode steps vs prefill {XL_PROMPT}: last "
          f"logits {last_ratio:.3g} of the tolerance")
    check(max(ratios) <= 1.0, f"float32 decode vs forward: worst position "
          f"{int(np.argmax(ratios))} at {max(ratios):.3g} of the tolerance")
    check(no_carry_ratio > 1.0, "float32 gate: dropping the mLSTM carry "
          "does not move the first decoded logits past the tolerance")
    del p32, caches, want_steps
    torch.cuda.empty_cache()
    return {"params": n_params, "prefill_s": stats["prefill_s"],
            "prefill_tokens_per_s": prefill_tps,
            "decode_s": stats["decode_s"],
            "decode_tokens_per_s": stats["tok_per_s"], "run_s": run_s,
            "launches": counts, "peak_memory_gb": peak_gb,
            "extra_prefill_wall_ms": wall * 1e3,
            "extra_prefill_busy_ms": busy_ms,
            "extra_prefill_busy_share": busy, "trace_s": trace_s,
            "top_kernels": top, "f32_last_err": last_err,
            "f32_step_errs": errs, "f32_no_carry_err": no_carry_err,
            "f32_s": f32_s}


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
    phase_s: dict = {}
    mark = [time.perf_counter()]

    def lap(name):     # wall seconds of each phase, for the record
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 2)
        mark[0] = now

    # ---- 1. the card --------------------------------------------------
    card = card_line()
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
    counts = hgmma_counts(_build.library_path("flash_attention_sm90"))
    hgmma = {}
    for entry, kernel in SM90_KERNELS.items():
        mine = {fn: n for fn, n in counts.items() if kernel in fn}
        check(len(mine) == 3 and all(mine.values()),
              f"{entry}: HGMMA per instantiation {mine}, expected three "
              "kernels (hd 32, 64, 128) each with some")
        hgmma[entry] = sorted(mine.values())
    print(f"HGMMA instructions per bf16 flash kernel (hd 32, 64, 128 "
          f"instantiations, cuobjdump -sass): {hgmma}")
    counts = hgmma_counts(_build.library_path("mlstm_chunk_sm90"))
    for kernel in MLSTM_TC_KERNELS:
        mine = [n for fn, n in counts.items() if kernel in fn]
        check(len(mine) == 1 and mine[0] > 0,
              f"mlstm_chunk_sm90: HGMMA in {kernel}: {mine}, expected one "
              "kernel with some")
        hgmma[kernel] = mine[0]
    print("HGMMA instructions per mlstm_chunk_sm90 grid (cuobjdump -sass): "
          + ", ".join(f"{k} {hgmma[k]}" for k in MLSTM_TC_KERNELS))
    record["hgmma"] = hgmma
    grids = mlstm_grid_times(dev)
    record["mlstm_grids"] = grids
    short = [re.sub(r"^void |[(]anonymous namespace[)]::", "", g).split("(")[0]
             for g, _, _ in grids]
    print("mlstm_chunk grids at the prefill's shape (CUDA-only trace): "
          + ", ".join(f"{g} {t * 1e3:.2f} us"
                      for g, (_, t, _) in zip(short, grids)))
    lap("card and build")

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
        busy_ms, _ = device_busy(lambda: (submit_trace(server),
                                          server.serve()), repeats=3)
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
    lap("serving")

    # ---- 6. Fed-TGAN training, the second main path --------------------
    from repro_torch.tabular import make_dataset
    fed_ds = make_dataset("adult", n_rows=N_ROWS, seed=0)
    fed = federated_phase(dev, cfg, fed_ds)
    stack, fe = fed.pop("stack"), fed.pop("fe")
    record["federated"] = fed
    lap("CTGAN training")

    # ---- 7. hierarchical merge -----------------------------------------
    record["edges"] = edges_phase(dev, cfg, fed_ds, stack, fe.weights)
    lap("edges")

    # ---- 8. one train step, card against CPU ---------------------------
    record["step_card_vs_cpu"] = step_phase(dev)
    lap("step card vs CPU")

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

    lap("synthesis card vs CPU")

    # ---- 10. federated LM pre-training, the third main path -----------
    record["lm"] = lm_phase(dev)
    lap("LM training")

    # ---- 11. encode_loop, the path of the single-column encode ---------
    ds_a, enc_a, _, _ = tenants["adult"]
    record["encode_loop"] = encode_loop_phase(dev, enc_a, ds_a)
    lap("encode_loop")

    # ---- 12. the full-width LM's logits, flash against plain -----------
    record["lm_logits"] = logits_phase(dev)
    lap("LM logits")

    # ---- 13. xLSTM serving, the path of the mLSTM kernel ---------------
    record["xlstm"] = xlstm_phase(dev)
    lap("xLSTM serving")

    # ---- 14. each kernel at the main path's shapes --------------------
    record["flash_route"] = flash_route_checks(dev)
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

    # the flash kernels at the LM path's shapes: heads expanded, bf16
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_dkv_cuda,
                                                     flash_dq_cuda,
                                                     flash_fwd_cuda)
    from repro_torch.kernels.vgm_encode import vgm_encode_cuda
    lm_launches = record["lm"]["launches"]
    BH, Sf, hd = LM_BATCH * 9, LM_SEQ, 64
    gf = torch.Generator(dev).manual_seed(13)
    fq, fk, fv, fdo = (torch.randn((LM_BATCH, 9, Sf, hd), device=dev,
                                   generator=gf).bfloat16() for _ in range(4))
    mask = {"causal": True, "window": None, "kv_len": Sf}
    fout, flse = flash_fwd_cuda(fq, fk, fv, **mask)
    fdelta = torch.sum(fdo.float() * fout.float(), dim=-1)
    bwd_args = (fq, fk, fv, fdo, flse, fdelta)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (fq, fk, fv))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

    def lib_bwd():   # the library's dq + dk/dv pair
        return torch.autograd.grad(lib_out, (lq, lk, lv), fdo,
                                   retain_graph=True)
    pairs = BH * Sf * (Sf + 1) // 2          # visible (query, key) pairs
    elems = BH * Sf * hd

    def close_bf16(a, b):    # one bfloat16 ulp where f32 results straddle
        d = (a.float() - b.float()).abs()
        return bool((d <= 2 ** -7 * b.float().abs() + 1e-6).all()), float(d.max())

    def cmp_fwd(got, want):
        ok_o, e_o = close_bf16(got[0], want[0])
        e_l = float((got[1] - want[1]).abs().max())
        return (max(e_o, e_l), ok_o and e_l <= 2e-5,
                "out rtol 2^-7 (one bf16 ulp), lse 2e-5")

    def cmp_grads(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        tols = [1e-4 * max(1.0, float(b.abs().max())) for b in want]
        return (max(errs), all(e <= t for e, t in zip(errs, tols)),
                "1e-4 of max|grad| " + ", ".join(f"{t:.3g}" for t in tols))

    # the single-column encode at the table's shape: intrusion's first
    # continuous column, 40,000 rows
    j0 = plan.cont_cols[0]
    p0 = enc.vgms[j0]
    from repro_torch.tabular.vgm import kernel_log_weights
    cx = x[:, 0].contiguous()
    K0 = int(p0.means.shape[0])
    cg = gumbel[:, :K0].contiguous()
    col_args = (cx, p0.means.float().contiguous(), p0.stds.float().contiguous(),
                kernel_log_weights(p0).contiguous(), cg)

    enc_bytes, enc_ops = encode_bytes_ops(Nq, Q, K)
    col_bytes, col_ops = encode_bytes_ops(Nq, 1, K0)

    def cmp_exact(got, want):
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        return max(errs), max(errs) == 0.0, "0 (exact)"

    cases = [
        # the Pallas call it replaces, launches on its main path, bytes
        # moved and float ops for the bound, tolerance against the plain
        # version, one PyTorch call that computes the same function
        dict(name="vgm_encode_table", stem="vgm_encode",
             kern=lambda: vgm_encode_table_cuda(*enc_args),
             plain=lambda: plain.vgm_encode_table_ref(*enc_args),
             bytes=enc_bytes, ops=enc_ops, tol=0.0,
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
        dict(name="vgm_encode", stem="vgm_encode",
             kern=lambda: vgm_encode_cuda(*col_args),
             plain=lambda: plain.vgm_encode_ref(*col_args),
             compare=cmp_exact,
             bytes=col_bytes, ops=col_ops,
             replaces="src/repro/kernels/vgm_encode.py:89",
             launches=record["encode_loop"]["launches"]["vgm_encode"],
             shape=f"x ({Nq},), K {K0}"),
        dict(name="flash_attention_fwd", stem="flash_attention_sm90",
             products=(4, 2),
             kern=lambda: flash_fwd_cuda(fq, fk, fv, **mask),
             plain=lambda: plain.flash_attention_fwd_ref(fq, fk, fv, **mask),
             library=lambda: F.scaled_dot_product_attention(fq, fk, fv,
                                                            is_causal=True),
             compare=cmp_fwd, bytes=2 * 4 * elems + 4 * BH * Sf,
             ops=2 * 2 * hd * pairs, peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:167",
             launches=lm_launches["flash_attention_fwd"],
             shape=f"({LM_BATCH}, 9, {Sf}, {hd}) bf16, causal"),
        dict(name="flash_attention_dq", stem="flash_attention_sm90",
             products=(4, 3),
             kern=lambda: flash_dq_cuda(*bwd_args, **mask),
             plain=lambda: plain.flash_attention_dq_ref(*bwd_args, **mask),
             library=lib_bwd, compare=cmp_grads,
             bytes=2 * 4 * elems + 8 * BH * Sf + 4 * elems,
             ops=3 * 2 * hd * pairs, peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:199",
             launches=lm_launches["flash_attention_dq"],
             shape=f"({LM_BATCH}, 9, {Sf}, {hd}) bf16, causal"),
        dict(name="flash_attention_dkv", stem="flash_attention_sm90",
             products=(6, 4),
             kern=lambda: flash_dkv_cuda(*bwd_args, **mask),
             plain=lambda: plain.flash_attention_dkv_ref(*bwd_args, **mask),
             library=lib_bwd, compare=cmp_grads,
             bytes=2 * 4 * elems + 8 * BH * Sf + 8 * elems,
             ops=4 * 2 * hd * pairs, peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:216",
             launches=lm_launches["flash_attention_dkv"],
             shape=f"({LM_BATCH}, 9, {Sf}, {hd}) bf16, causal"),
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
    # the LM merge: one launch over the flattened float32 stack of 4
    # smollm-135m clients (random values; the shape is the point)
    Dl = record["lm"]["params"]
    lm_stack = torch.randn((LM_CLIENTS, Dl), device=dev,
                           generator=torch.Generator(dev).manual_seed(17))
    lm_w = torch.as_tensor(record["lm"]["weights"], device=dev)
    lm_merge_case = dict(
        name="weighted_agg (LM merge)", stem="weighted_agg",
        kern=lambda: weighted_agg_cuda(lm_stack[None], lm_w[None])[0],
        plain=lambda: plain.weighted_agg_ref(lm_stack, lm_w),
        library=lambda: (lm_w / torch.sum(lm_w)) @ lm_stack,
        bytes=4 * (LM_CLIENTS * Dl + LM_CLIENTS + Dl), ops=2 * LM_CLIENTS * Dl,
        tol=1e-7 + 1e-6 * float(lm_stack.abs().max()),
        replaces="src/repro/kernels/weighted_agg.py:47", launches=None,
        shape=f"flat ({LM_CLIENTS}, {Dl})")
    # the chunkwise mLSTM at the xLSTM prefill's shape, chunks of 256
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_cuda
    m_args = mlstm_prefill_inputs(dev)
    XB, XS, XD = m_args[0].shape
    XL = XL_CHUNK

    mlstm_gate = {}

    def cmp_mlstm(got, want):
        (h, (C, n, m)), (ph, (pC, pn, pm)) = got, want
        errs = [float((a - b).abs().max()) for a, b in
                ((h, ph), (C, pC), (n, pn), (m, pm))]
        ok = all(torch.allclose(a, b, rtol=1e-4, atol=2e-4)
                 for a, b in ((h, ph), (C, pC), (n, pn)))
        # how close each output comes to its gate: the largest
        # |got - want| / (atol + rtol |want|), 1 at the gate
        mlstm_gate.update(
            {k: float(((a - b).abs() / (2e-4 + 1e-4 * b.abs())).max())
             for k, a, b in (("h", h, ph), ("C", C, pC), ("n", n, pn))},
            m=errs[3] / 1e-5)
        return (max(errs), ok and errs[3] <= 1e-5,
                "h, C, n rtol 1e-4 atol 2e-4; m atol 1e-5 (max abs errs "
                + ", ".join(f"{e:.3g}" for e in errs) + "; of the gate: "
                + ", ".join(f"{k} {v:.3f}" for k, v in mlstm_gate.items())
                + ")")
    nch = XS // XL
    mlstm_ops = XB * (2 * XL * XD * XD * (2 * nch - 1)       # C update, q C
                      + 2 * 2 * XD * nch * XL * (XL + 1) // 2)  # causal q k, S v
    # bound: the bf16 products that the kernel does on the tensor cores
    # (MLSTM_PRODUCTS a float32 product, on the least work); the float32
    # bound of the least work beside it
    cases.append(dict(
        name="mlstm_chunk", stem="mlstm_chunk_sm90",
        f32_bound_ms=bound_ms(0, mlstm_ops)[0],
        kern=lambda: mlstm_chunk_cuda(*m_args, chunk=XL, return_state=True),
        plain=lambda: plain.mlstm_chunk_plain(*m_args, chunk=XL,
                                              return_state=True),
        compare=cmp_mlstm, plain_reps=2,     # ~280 launches per plain call
        bytes=4 * (4 * XB * XS * XD + 2 * XB * XS + XB * XD * XD + XB * XD
                   + XB),
        ops=MLSTM_PRODUCTS * mlstm_ops, peak=PEAK_BF16_OPS_PER_S,
        replaces="src/repro/kernels/mlstm_chunk.py:79",
        launches=record["xlstm"]["launches"]["mlstm_chunk"],
        shape=f"({XB}, {XS}, {XD}), L {XL}, float32, with the final state"))
    kernels, timing, shapes = [], {}, {}
    for case in cases + [edges_case, lm_merge_case]:
        name, kern, ref_fn = case["name"], case["kern"], case["plain"]
        out_k, out_p = kern(), ref_fn()
        torch.cuda.synchronize()
        if "compare" in case:
            err, ok, tol_txt = case["compare"](out_k, out_p)
        else:
            err = float((out_k - out_p).abs().max())
            ok, tol_txt = err <= case["tol"], f"{case['tol']:.3g}"
        check(ok, f"{name}: max abs error {err:.3g}, tolerance {tol_txt}")
        if name == "segment_activations":
            soft = ~layout.pack_pad & (np.repeat(layout.kinds[:, 0],
                                                 layout.wmax) < 0.5)
            soft = torch.as_tensor(soft, device=dev)
            check(torch.equal(out_k[:, soft].round(), out_p[:, soft].round()),
                  f"{name}: hard one-hots differ")
        ms = kernel_ms(kern)
        plain_ms = kernel_ms(ref_fn, reps=case.get("plain_reps", 20))
        source = "device time: CUDA events behind a spin kernel"
        call_ms, plain_call_ms = cuda_ms(kern), cuda_ms(ref_fn)
        lib = case.get("library")
        lib_ms = kernel_ms(lib) if lib is not None else None
        extra = {}
        if case["stem"] == "weighted_agg":
            lib_err = float((lib() - out_p).abs().max())
            extra = {"cold_ms": cold_ms(kern), "library_cold_ms": cold_ms(lib),
                     "library_max_abs_err": lib_err}
        b_ms, b_by = bound_ms(case["bytes"], case["ops"],
                              case.get("peak", PEAK_F32_OPS_PER_S))
        shapes[name] = case["shape"]
        timing[name] = {"source": source,
                        "call_ms": call_ms, "plain_call_ms": plain_call_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **extra}
        if "f32_bound_ms" in case:
            timing[name].update(f32_bound_ms=case["f32_bound_ms"],
                                gate=dict(mlstm_gate))
        if case["launches"] is not None:
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{case['stem']}.cu",
                "replaces": case["replaces"], "launches": case["launches"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                **({"f32_bound_ms": case["f32_bound_ms"]}
                   if "f32_bound_ms" in case else {})})
        lib_txt = ("no single PyTorch call computes it" if lib is None else
                   f"library call {lib_ms * 1e3:.2f} us"
                   + (" (the dq + dk/dv pair)" if lib is lib_bwd else ""))
        cold_txt = ("" if not extra else
                    f"; cold L2: kernel {extra['cold_ms'] * 1e3:.2f} us, "
                    f"library {extra['library_cold_ms'] * 1e3:.2f} us")
        if "f32_bound_ms" in case:
            cold_txt += (f"; bound of {MLSTM_PRODUCTS} bf16 products on the "
                         f"least work; float32 bound "
                         f"{case['f32_bound_ms'] * 1e3:.2f} us")
        if "products" in case:
            done, least = case["products"]
            timing[name]["products"] = [done, least]
            cold_txt += (f"; products {done} against the least {least} "
                         f"({done / least:.2f}x), bound on the least")
        print(f"kernel {name} [{case['shape']}]: {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us ({source}); per call with launch "
              f"{call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us "
              f"(CUDA events); bound {b_ms * 1e3:.2f} us ({b_by}); max abs "
              f"err {err:.3g} (tol {tol_txt}); launches {case['launches']}; "
              f"{lib_txt}{cold_txt}")
    sweep = activation_layouts(dev, cfg.tau, (px, pu, kinds))
    print("segment_activations forward by layout (device time per call, "
          "hard): " + "; ".join(
              f"{r['inputs']} {r['shape']}: tile {r['tile_ms'] * 1e3:.2f} us, "
              f"warp {r['warp_ms'] * 1e3:.2f} us" for r in sweep))
    bd = backward_and_decode_layouts(
        dev, cfg.tau, (tpx, tpu, tkinds, tct), dec_args,
        ladder_from_sizes(SIZES).buckets)
    print("segment_activations backward by layout (device time per call; "
          "plain beside): " + "; ".join(
              f"{r['inputs']} {r['shape']}: " + ", ".join(
                  f"{lay} {r[lay + '_ms'] * 1e3:.2f} us"
                  for lay in BWD_SWEEP_LAYOUTS)
              + f", plain {r['plain_ms'] * 1e3:.2f} us"
              + (f", traced launch {r['trace_ms'] * 1e3:.2f} us"
                 if "trace_ms" in r else "")
              for r in bd["backward"]))
    print("vgm_decode_table by serving rung (device time per call; its "
          "traced launch): "
          + "; ".join(f"{r['rows']} rows: {r['ms'] * 1e3:.2f} us, traced "
                      f"{r['trace_ms'] * 1e3:.2f} us, plain "
                      f"{r['plain_ms'] * 1e3:.2f} us" for r in bd["decode"])
          + f"; an empty kernel {bd['empty_kernel_ms'] * 1e3:.2f} us")
    enc_shapes = encode_shapes(dev)
    print_encode_shapes(enc_shapes)
    record.update(kernels=kernels, shapes=shapes, timing=timing,
                  activation_layouts=sweep, backward_decode_layouts=bd,
                  encode_shapes=enc_shapes)
    lap("kernels against plain")
    record["phase_s"] = phase_s
    print(f"phase seconds {phase_s}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encode-shapes", action="store_true",
                    help="run only the card, the build and the encode's "
                    "shape line")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="with --encode-shapes: the checkout whose "
                    "repro_torch to time (default: this one)")
    cli = ap.parse_args()
    sys.exit(encode_shapes_main(cli.tree.resolve()) if cli.encode_shapes
             else main())
