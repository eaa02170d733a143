"""Drive the PyTorch port's serving, federated CTGAN training, federated
LM pre-training and xLSTM LM serving paths, the paper's baseline
architectures, the degraded federation, differentially private
federation with the privacy attacks, the paper's evaluation matrix
with the federation at scale, the MoE, Mamba, cross-attention and
frame-input model families, and the launch tooling (work counts, dry
runs, the sharding policy) once on one CUDA card.

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
   shape line (measured right after the build, where its short traces come
   back whole, and printed here): the table encode at (40,000, 22),
   (40,000, 5), (8,000, 5)
   and (128, 22) and the column encode at 40,000 and 8,000 rows, Kmax 10,
   each equal to its plain version, with its device time, its traced
   launch, the plain version's time and its bound;
15. the paper's architectures (Fig. 8a's split, ``benchmarks/timing.py``):
   ``adult`` at 40,000 rows copied whole to 5 clients, ``ctgan_paper``,
   two epochs of one pass over 40,000 rows at batch 500 (80 steps) each
   of ``run_federated`` (one round an epoch), ``run_mdtgan`` and
   ``run_centralized``, each ending with an evaluation on 40,000 rows:
   the second epoch's seconds, bytes per epoch and their seconds on the
   paper's 943 Mb/s link, calculation + communication and Fed-TGAN's
   speedup over MD-TGAN, avg JSD and WD; every loss and report finite;
   per epoch MD launches 2 x 5 x 80 activation forwards, 5 x 80 backwards
   and no merge, centralized 2 x 80 and 80 (and encodes once), Fed-TGAN
   5 x 80 backwards and one merge;
16. the degraded federation: phase 6's IID split, 4 rounds of 2 local
   steps, a composed ``FaultPlan`` (a dropout in round 1, a NaN update in
   round 2, a x50 update in round 3), participation 0.8, FedProx mu 0.01,
   the default guard, a checkpoint per stretch of 2 rounds: one
   ``weighted_agg`` a round, ``client_ok`` False exactly for the faulted
   clients and those out of the round's cohort, the merged model finite
   and the clients bit-identical after each merge; a fresh ``resume=True``
   run from the round-2 checkpoint ends with the same generator, bit for
   bit; the NaN plan with ``guard=None`` retries once and blocks that
   client; one ``program="host"`` round against one ``program="fed"``
   round within the round tolerance, the host round launching no merge;
17. DP and privacy at full width: phase 6's split and config, 2 rounds of
   2 local steps with an evaluation on 40,000 rows, traced
   (``run_federated(trace=RoundTrace())``) and untraced at one seed: the
   final generators bit-identical, one ``weighted_agg`` a round, the
   recorded stacks equal to each merge's input in the reference's layout,
   ``save`` / ``load`` bit-exact; the attacks on the trace
   (``loss_threshold_mia`` on 2,000 of client 0's rows against 2,000
   holdout rows, ``null_auc``, ``dominant_category_hits``,
   ``leakage_report``): finite scores, AUCs in [0, 1], the encodes on
   ``vgm_encode_table``, each attack's seconds; the same run with
   ``dp=DPConfig(l2_clip=1.0, noise_mult=0.3)``: one merge a round,
   ``epsilon`` equal to ``dp_epsilon(4, 500, 8000, 0.3)``; one DP step's
   per-pack gradients (their memory) with every clipped pack norm within
   the clip, and ms per DP step against a non-private one (median and
   range of 5 alternating windows of 10 steps, and each step's device
   busy time from a CUDA-only trace); one
   smollm-135m round with client-level DP at phase 10's configuration:
   one ``weighted_agg``, the flash launches of a round, a finite loss;
18. the paper's evaluation matrix and the federation at scale, at full
   width: (a) ``run_matrix`` over the five scenarios x (``fedtgan``,
   ``uniform``) on ``adult`` at 40,000 rows, 4 clients, 2 rounds of 2
   local steps, 512 evaluation rows: every cell finite, its client rows
   the partition's, one ``weighted_agg`` a round, the quantity split's
   big client the heaviest under ``fedtgan`` (above 0.25); one
   ``iid / fedtgan / chaos`` cell with ``client_chunk=2, edges=2`` (two
   merges a round); (b) a base federation of 16 IID clients of 2,500
   rows tiled (``tile_federation``) to 128 clients: one round of one step
   dense and chunked (``client_chunk=16``) from clones of one start,
   bit-identical; then to 1,024 clients: one round of one step with
   ``client_chunk=16, edges=32``: 2 merges, one activation backward a
   client, every state finite; seconds, peak memory, the busy share from
   a CUDA-only trace of one more round; (c) an NCCL group of one rank
   (a file store): ``shard_map_global_round`` for one round of 2 local
   steps on client 0 of phase 6's split against ``FederatedProgram.
   global_round`` on a clone, bit-identical; ``broadcast_from(src=0)``
   the identity; the group destroyed;
19. the rest of the model families at their published widths, random
   weights from a seed: (a, b) greedy ``prefill_and_decode`` (2 prompts,
   32 decoded tokens) of mixtral-8x22b (2 of 56 layers, 4,096-token
   prompts: the 4,096 sliding-window ring wraps in decode),
   llama4-maverick (2 of 48 layers: a dense and a 128-expert top-1 FFN),
   jamba (8 of 72 layers: 7 Mamba, 1 attention, 4 MoE FFNs, experts cut
   16 -> 8 to fit one card) and llama-3.2-vision-11b (whole, 8 gated
   cross-attention layers onto 1,600 stub vision tokens, gates 0.7):
   finite logits, tokens in the vocabulary, every prefill MoE call's
   dropped fraction in [0, 1) and aux finite, no drop in one-token
   decode, no kernel launch (the path has none); prefill and decode
   tokens/s, peak memory and the busy share of one more prefill; (c)
   hubert-xlarge whole (48 layers, hd 80, bidirectional, frame inputs,
   bf16): one ``run_federated`` round of 2 clients x 2 local steps of 4 x
   2,048 frames, finite losses, clients bit-identical, gated 384 flash
   forwards, 192 dq, 192 dk/dv and one ``weighted_agg``; frames/s and the
   busy share of one more round; a float32 copy cut to 4 layers, flash
   (the float32 library at hd 80) against ``gqa_attention``; (d) each
   family's smoke config in float32 on the card against the CPU: logits,
   aux, every MoE call's routing, a prefill and 4 greedy decode steps.
   Phase 14 also times the flash kernels at hubert's (4, 16, 2,048, 80)
   bf16, bidirectional (the hd-80 tensor-core instances), with SDPA
   beside.
20. the launch tooling: (a) the LM step at phase 10's shape (smollm-135m,
   flash kernels, bf16, remat, 4 x 2,048 tokens) counted by
   ``repro_torch.counting.OpCounter`` on the card and on the meta device:
   FLOPs by dtype and the card's bytes equal to meta's, the flash work
   equal to the launches times ``kernels.work``'s least work (30 layers,
   forwards x2 for remat); then timed (median of 5 steps after 2, each
   ending in a synchronize), with ``launch.roofline``'s terms,
   ``useful_flops_ratio`` in [0.5, 1] and ``mfu`` in (0, 1]; (b)
   ``launch.dryrun`` (smollm-135m x train_4k, llama3-8b x decode_32k) and
   ``launch.fed_dryrun --arch ctgan-paper --shard-map`` as a user runs
   them, each in its own process on the fake backend, beside (a): OK, and
   the train record's per-rank argument bytes equal to the specs' shards;
   (c) smollm-135m's parameters distributed by
   ``shardings.build_param_specs`` over ``make_host_mesh()`` (NCCL, one
   rank) and one ``Transformer.prefill`` with ``ShardHints`` on 2 x 512
   tokens: logits bit-identical to the plain-tensor prefill.

Phases 3-5 are the serving main path, phase 6 the CTGAN training main
path, phase 10 the LM main path, phase 11 the path of the single-column
encode, phase 13 the xLSTM serving path, and each run of phases 15, 16,
17, 18, 19 and 20: the kernel launch counters are set to 0 just before
each and read just after, every kernel of the path must have launched,
and no plain-version counter may move.  The ``kernels`` line's
``launches`` are the main paths' counts; phases 17's, 18's, 19's and
20's are given apart as ``launches_phase17`` to ``launches_phase20``.
The last two lines of output are the
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
import os
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
# the paper's architectures (Fig. 8a's split): epochs of each run; an epoch
# is one pass over a client's 40,000 rows at the config's batch
ARCH_EPOCHS = 2
# the degraded federation: (round, client) of the dropout, the NaN update
# and the x50 update; the participation rate and FedProx's mu
DROP_AT, NAN_AT, BYZ_AT, BYZ_SCALE = (1, 3), (2, 1), (3, 4), 50.0
PARTICIPATION, PROX_MU = 0.8, 0.01
# DP and privacy: rounds and local steps of the traced / DP runs, one of
# the reference's frontier points (benchmarks/privacy_bench.py), the rows
# of each side of the membership attack, and the steps timed
PRIV_ROUNDS, PRIV_STEPS, PRIV_CLIP, PRIV_NOISE = 2, 2, 1.0, 0.3
PRIV_ATTACK_ROWS, PRIV_TIMED, PRIV_WINDOWS = 2000, 10, 5
# the evaluation matrix and the federation at scale: clients, rounds and
# local steps of a matrix cell and its evaluation rows (the reference's
# run_matrix default); the scale sweep's base federation (16 IID clients
# of 2,500 rows, as benchmarks/fed_bench.py stages it), its tiled sizes,
# chunk and edges; local steps of the collective round
MX_CLIENTS, MX_ROUNDS, MX_STEPS, MX_EVAL = 4, 2, 2, 512
SCALE_BASE, SCALE_CHECK_P, SCALE_P = 16, 128, 1024
SCALE_CHUNK, SCALE_EDGES, COLL_STEPS = 16, 32, 2
# the rest of the model families (phase 19): each served model with its
# cuts (widths kept as published) and prompt length; the batch, the
# decoded tokens and the cross-attention gates' value; hubert's federated
# round (clients, local steps, batch, frames) and its float32 copy's
# depth; the decode steps of the card-vs-CPU check
FAMILY_SERVE = (
    ("mixtral-8x22b", {"n_layers": 2}, 4096),
    ("llama4-maverick-400b-a17b", {"n_layers": 2}, 2048),
    ("jamba-1.5-large-398b", {"n_layers": 8, "n_experts": 8}, 2048),
    ("llama-3.2-vision-11b", {}, 2048),
)
FAMILIES = ("mixtral-8x22b", "llama4-maverick-400b-a17b",
            "jamba-1.5-large-398b", "llama-3.2-vision-11b", "hubert-xlarge")
FAM_BATCH, FAM_GEN, XATTN_GATE = 2, 32, 0.7
HUBERT_CLIENTS, HUBERT_STEPS, HUBERT_BATCH, HUBERT_SEQ = 2, 2, 4, 2048
HUBERT_F32_LAYERS, FAMILY_CPU_STEPS = 4, 4
# the launch tooling (phase 20): warm-up and timed steps of the counted LM
# step; the dry runs as a user runs them, each in its own process; the
# DTensor prefill's prompts and length
LAUNCH_WARMUP, LAUNCH_TIMED = 2, 5
DRYRUNS = (("dryrun_train", "repro_torch.launch.dryrun", "--arch",
            "smollm-135m", "--shape", "train_4k"),
           ("dryrun_decode", "repro_torch.launch.dryrun", "--arch",
            "llama3-8b", "--shape", "decode_32k"),
           ("fed_dryrun", "repro_torch.launch.fed_dryrun", "--arch",
            "ctgan-paper", "--shard-map"))
SHARD_BATCH, SHARD_SEQ = 2, 512


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
    from repro_torch.kernels import work
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
            "bound_ms": bound_ms(*work.vgm_encode(n, q, K))[0]})
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


def host_paths_main(tree: Path, rounds: int = 5, drains: int = 5) -> int:
    """The host-bound main paths alone, for the ``repro_torch`` of the
    checkout at ``tree``: phase 10's LM global round (smollm-135m, flash
    kernels, ``LM_CLIENTS`` x ``LM_STEPS`` steps of ``LM_BATCH`` x
    ``LM_SEQ`` tokens) and phases 3-5's 16-request serving drain under
    both schedulers, each timed on the wall clock after a warm-up.  Run in
    turns on two checkouts in one call (parent, change, change, parent),
    it compares what the host costs each path; the entry points it calls
    are the same in every checkout that has them."""
    import statistics

    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: "
          "this script needs a card")
    check((tree / "src" / "repro_torch").is_dir(),
          f"no src/repro_torch in {tree}")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs import ctgan_paper, get_config
    from repro_torch.data import TokenDatasetSpec, client_token_streams
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_tenant
    from repro_torch.launch.train import (federated_round, lm_optimizer,
                                          run_federated)
    from repro_torch.models import Transformer, make_train_step
    from repro_torch.serve import (StreamingSynthesizer, TableRegistry,
                                   ladder_from_sizes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"tree {tree}; kernel build: {_build.build_all():.2f} s")

    cfg = dataclasses.replace(get_config("smollm-135m"), use_flash_kernel=True)
    states, _, w = run_federated(
        cfg, clients=LM_CLIENTS, rounds=1, local_steps=LM_STEPS,
        batch=LM_BATCH, seq=LM_SEQ, lr=3e-4, iid=False, weighting="fedtgan",
        device=dev)
    step_fn = make_train_step(Transformer(cfg), lm_optimizer(3e-4))
    streams = client_token_streams(TokenDatasetSpec(cfg.vocab, LM_SEQ),
                                   LM_CLIENTS, LM_BATCH, LM_STEPS, iid=False,
                                   seed=7)
    w_dev = torch.as_tensor(w, device=dev)
    lm_ms = []
    for r in range(rounds + 1):                  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        federated_round(states, step_fn, streams, w_dev)
        torch.cuda.synchronize()
        if r:
            lm_ms.append((time.perf_counter() - t0) * 1e3)
    del states, step_fn
    torch.cuda.empty_cache()

    ccfg = ctgan_paper.CONFIG
    registry = TableRegistry()
    for seed, name in enumerate(("adult", "intrusion")):
        _, enc, gen, encoded = make_tenant(name, n_rows=N_ROWS, cfg=ccfg,
                                           seed=seed, device=dev)
        registry.register(name, ccfg, enc, gen,
                          ladder=ladder_from_sizes(SIZES), encoded=encoded,
                          device=dev)
    trace = [("adult" if i % 2 == 0 else "intrusion", SIZES[i % 3],
              1000 + i, i % 4 >= 2) for i in range(16)]
    serve_ms = {}
    for sched in ("fifo", "continuous"):
        server = StreamingSynthesizer(registry, scheduler=sched, device=dev)
        server.warmup(conditional=None)
        times = []
        for d in range(drains + 1):              # the first warms up
            for name, rows, seed, cond in trace:
                server.submit(name, rows, seed=seed, conditional=cond)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resps = server.serve()
            torch.cuda.synchronize()
            check(len(resps) == 16, f"{sched}: {len(resps)} responses")
            if d:
                times.append((time.perf_counter() - t0) * 1e3)
        serve_ms[sched] = times
    out = {"tree": str(tree), "lm_round_ms": lm_ms,
           "lm_round_median_ms": statistics.median(lm_ms),
           **{f"serve_{k}_ms": v for k, v in serve_ms.items()},
           **{f"serve_{k}_median_ms": statistics.median(v)
              for k, v in serve_ms.items()}}
    print(f"LM round ms {[round(x, 3) for x in lm_ms]}; serving drain ms "
          + "; ".join(f"{k} {[round(x, 3) for x in v]}"
                      for k, v in serve_ms.items()))
    print(json.dumps(out))
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


def _launch_delta(before: dict) -> dict:
    """Kernel launches (and plain calls) since the snapshot ``before``."""
    from repro_torch.kernels import ops
    return {k: v - before.get(k, 0) for k, v in ops.DISPATCH_COUNTS.items()
            if v - before.get(k, 0)}


def _no_plain_calls(where: str) -> None:
    from repro_torch.kernels import ops
    refs = {k: v for k, v in ops.DISPATCH_COUNTS.items() if k.endswith("_ref")}
    check(not refs, f"{where}: the plain route ran on the card: {refs}")


def architectures_phase(dev, cfg, ds) -> dict:
    """Phase 15, the paper's architectures at full width (Fig. 8a's split,
    ``benchmarks/timing.py``): 5 full copies of the table, two epochs of
    each of Fed-TGAN (a round of one local epoch), MD-TGAN and
    centralized training, each ending with one evaluation."""
    import numpy as np
    import torch

    from repro_torch.core import comm_model
    from repro_torch.core.architectures import (run_centralized, run_federated,
                                                run_mdtgan)
    from repro_torch.kernels import ops
    from repro_torch.tabular import partition_full_copy

    parts = partition_full_copy(ds, FED_CLIENTS)
    steps = N_ROWS // cfg.batch_size
    out = {}

    def timed(kind, run):
        """Run one architecture with the counters at 0; per epoch: (done,
        checked) times, launches and the finite-loss gate."""
        ops.DISPATCH_COUNTS.clear()
        marks, per_epoch = [], []
        snap = [dict(ops.DISPATCH_COUNTS)]

        def hook(ep, metrics):
            torch.cuda.synchronize()
            done = time.perf_counter()
            per_epoch.append(_launch_delta(snap[0]))
            snap[0] = dict(ops.DISPATCH_COUNTS)
            vals = {k: v.cpu().numpy() for k, v in metrics.items()
                    if k in ("d_loss", "g_loss")}
            check(all(np.isfinite(v).all() for v in vals.values()),
                  f"{kind} epoch {ep}: non-finite loss {vals}")
            marks.append((done, time.perf_counter()))
        t0 = time.perf_counter()
        res = run(hook)
        t_end = time.perf_counter()
        _no_plain_calls(kind)
        check(len(marks) == ARCH_EPOCHS, f"{kind}: {len(marks)} epochs ran")
        [rep] = res.history
        check(all(np.isfinite(v) for k, v in rep.items() if k != "round"),
              f"{kind}: report not finite: {rep}")
        epoch_s = marks[1][0] - marks[0][1]        # the second epoch
        launches = dict(ops.DISPATCH_COUNTS)
        out[kind] = {"epoch_s": epoch_s, "run_s": t_end - t0,
                     "seconds": res.seconds, "launches": launches,
                     "per_epoch_launches": per_epoch,
                     "bytes": res.comm_bytes_per_round,
                     "transfer_s": comm_model.transfer_seconds(
                         res.comm_bytes_per_round),
                     "avg_jsd": rep["avg_jsd"], "avg_wd": rep["avg_wd"]}
        return res, per_epoch, launches

    _, per, total = timed("fed-tgan", lambda hook: run_federated(
        parts, ds.schema, cfg=cfg, rounds=ARCH_EPOCHS, local_steps=steps,
        seed=0, weighting="fedtgan", eval_real=ds.data,
        eval_every=ARCH_EPOCHS, eval_samples=N_ROWS, device=dev,
        on_round=lambda r, st, m: (check(same_params(st),
                                         f"fed-tgan round {r}: clients "
                                         "differ"), hook(r, m))))
    for ep in per:
        check(ep.get("weighted_agg") == 1 and ep.get(
            "segment_activations_bwd") == FED_CLIENTS * steps,
            f"fed-tgan launches per round {ep}")
    _, per, total = timed("md-tgan", lambda hook: run_mdtgan(
        parts, ds.schema, cfg=cfg, epochs=ARCH_EPOCHS, steps_per_epoch=steps,
        seed=0, eval_real=ds.data, eval_every=ARCH_EPOCHS,
        eval_samples=N_ROWS, on_epoch=hook, device=dev))
    for ep in per:
        check(ep.get("segment_activations") == 2 * FED_CLIENTS * steps
              and ep.get("segment_activations_bwd") == FED_CLIENTS * steps
              and "weighted_agg" not in ep,
              f"md-tgan launches per epoch {ep}: want forward "
              f"{2 * FED_CLIENTS * steps}, backward {FED_CLIENTS * steps}, "
              "no merge")
    check("weighted_agg" not in total, f"md-tgan merged: {total}")
    _, per, total = timed("centralized", lambda hook: run_centralized(
        ds.data, ds.schema, cfg=cfg, epoch_steps=steps, epochs=ARCH_EPOCHS,
        seed=0, eval_real=ds.data, eval_every=ARCH_EPOCHS,
        eval_samples=N_ROWS, on_epoch=hook, device=dev))
    for ep in per:
        check(ep.get("segment_activations") == 2 * steps
              and ep.get("segment_activations_bwd") == steps,
              f"centralized launches per epoch {ep}")
    check(total.get("vgm_encode_table") == 1,
          f"centralized encodes {total.get('vgm_encode_table')} times")

    fed, md = out["fed-tgan"], out["md-tgan"]
    tot_fed = fed["epoch_s"] + fed["transfer_s"]
    tot_md = md["epoch_s"] + md["transfer_s"]
    speedup = 100.0 * (tot_md - tot_fed) / tot_fed
    out["split"] = {"fed_total_s": tot_fed, "md_total_s": tot_md,
                    "fed_speedup_pct": speedup, "steps_per_epoch": steps}
    for kind, r in out.items():
        if kind == "split":
            continue
        print(f"{kind}: second epoch {r['epoch_s']:.4f} s ({steps} steps "
              f"of batch {cfg.batch_size} per client); "
              f"{r['bytes'] / 1e6:.3f} MB on the wire per epoch = "
              f"{r['transfer_s']:.4f} s at 943 Mb/s; run {r['run_s']:.2f} s "
              f"with setup and evaluation; avg_jsd {r['avg_jsd']:.4f} "
              f"avg_wd {r['avg_wd']:.4f}; launches per epoch "
              f"{r['per_epoch_launches'][-1]}")
    print(f"Fig. 8a split per epoch (calculation on this card + "
          f"communication on the paper's 943 Mb/s link): Fed-TGAN "
          f"{fed['epoch_s']:.4f} + {fed['transfer_s']:.4f} = {tot_fed:.4f} s, "
          f"MD-TGAN {md['epoch_s']:.4f} + {md['transfer_s']:.4f} = "
          f"{tot_md:.4f} s: Fed-TGAN's speedup over MD-TGAN {speedup:.1f}%")
    return out


def degraded_phase(dev, cfg, ds) -> dict:
    """Phase 16, the degraded federation at full width: the IID 5-client
    split, 4 rounds of 2 local steps, a composed fault plan, partial
    participation, FedProx, the default guard and checkpoints; then a
    resume from the round-2 checkpoint, the NaN plan without a guard
    (retry and blocklist), and one host-oracle round against one fused
    round."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.architectures import (PARTICIPATION_STREAM,
                                                run_federated)
    from repro_torch.core.fedavg import sample_participation
    from repro_torch.device import seeded_generator
    from repro_torch.fed import compose, no_faults
    from repro_torch.kernels import ops
    from repro_torch.tabular import partition_iid

    parts = partition_iid(ds, FED_CLIENTS, seed=0)
    R, P = FED_ROUNDS, FED_CLIENTS

    def single(field, at, value):
        plan = no_faults(R, P)
        leaf = getattr(plan, field).clone()
        leaf[at] = value
        return plan._replace(**{field: leaf})
    drop = single("participate", DROP_AT, False)
    nan = single("nan_mask", NAN_AT, True)
    byz = single("scale", BYZ_AT, BYZ_SCALE)
    plan = compose(drop, nan, byz)
    faulted = ~drop.participate | nan.nan_mask | (byz.scale != 1.0)
    kw = dict(cfg=cfg, rounds=R, local_steps=FED_STEPS, seed=0,
              weighting="fedtgan", device=dev)
    out = {"plan": plan.summary()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        rounds = []
        ops.DISPATCH_COUNTS.clear()
        snap = [dict(ops.DISPATCH_COUNTS)]

        def on_round(r, states, m):
            torch.cuda.synchronize()
            delta = _launch_delta(snap[0])
            snap[0] = dict(ops.DISPATCH_COUNTS)
            check(delta.get("weighted_agg") == 1,
                  f"degraded round {r}: launches {delta}")
            check(same_params(states), f"degraded round {r}: clients differ")
            check(all(bool(torch.isfinite(t).all())
                      for t in states[0].params()),
                  f"degraded round {r}: merged state not finite")
            rounds.append({k: m[k].cpu().numpy().tolist() for k in
                           ("client_ok", "client_suspect", "w_eff",
                            "update_norm", "merged")})
        ckpt = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        full = run_federated(parts, ds.schema, faults=plan,
                             participation=PARTICIPATION, fedprox_mu=PROX_MU,
                             ckpt_dir=ckpt, eval_real=ds.data, eval_every=2,
                             eval_samples=N_ROWS, on_round=on_round, **kw)
        run_s = time.perf_counter() - t0
        _no_plain_calls("degraded run")
        check(len(rounds) == R, f"degraded run: {len(rounds)} rounds")
        w = torch.as_tensor(full.weights, device=dev)
        cohorts = []
        for r, got in enumerate(rounds):
            keep = sample_participation(w, PARTICIPATION, generator=
                                        seeded_generator(dev, 0,
                                                         PARTICIPATION_STREAM,
                                                         r)).cpu().numpy()
            cohort = keep & plan.participate[r].numpy()
            cohorts.append(cohort.tolist())
            want = cohort & ~faulted[r].numpy()
            check(np.array_equal(np.asarray(got["client_ok"]), want),
                  f"degraded round {r}: client_ok {got['client_ok']}, want "
                  f"{want.tolist()} (cohort {cohort.tolist()}, faulted "
                  f"{faulted[r].numpy().tolist()})")
        check(all(np.isfinite(v) for k, v in full.history[-1].items()
                  if k != "round"), f"degraded report {full.history[-1]}")
        print(f"degraded run: {R} rounds x {FED_STEPS} local steps, 5 IID "
              f"clients, plan {out['plan']} (dropout {DROP_AT}, NaN "
              f"{NAN_AT}, x{BYZ_SCALE:g} {BYZ_AT} as (round, client)), "
              f"participation {PARTICIPATION}, FedProx mu {PROX_MU}, default "
              f"guard; {run_s:.2f} s; one weighted_agg per round; cohorts "
              f"{[[int(c) for c in x] for x in cohorts]}; client_ok "
              f"{[[int(c) for c in x['client_ok']] for x in rounds]} (False "
              f"exactly where faulted or out of the cohort); avg_jsd "
              f"{full.history[-1]['avg_jsd']:.4f}")
        out.update(run_s=run_s, rounds=rounds, cohorts=cohorts,
                   report=full.history[-1])

        # resume from the round-2 checkpoint in a fresh run
        for f in os.listdir(ckpt):
            if f.startswith("ckpt_00000004"):
                os.remove(os.path.join(ckpt, f))
        ops.DISPATCH_COUNTS.clear()
        resumed = run_federated(parts, ds.schema, faults=plan,
                                participation=PARTICIPATION,
                                fedprox_mu=PROX_MU, ckpt_dir=ckpt,
                                resume=True, **kw)
        launches = dict(ops.DISPATCH_COUNTS)
        diffs = [float((a - b).detach().abs().max()) for a, b in
                 zip(full.final_g_params.parameters(),
                     resumed.final_g_params.parameters())]
        exact = all(torch.equal(a, b) for a, b in
                    zip(full.final_g_params.parameters(),
                        resumed.final_g_params.parameters()))
        check(launches.get("weighted_agg") == R - 2,
              f"resume ran {launches.get('weighted_agg')} merges, not {R - 2}")
        check(exact, f"resumed run's generator differs: max abs "
              f"{max(diffs):.3g}")
        print(f"resume from the round-2 checkpoint: {R - 2} rounds run, the "
              f"final generator bit-identical to the uninterrupted run's")
        out["resume_exact"] = exact

        # the NaN plan with the guard off: one retry, client 1 blocked
        ops.DISPATCH_COUNTS.clear()
        retry = run_federated(parts, ds.schema, faults=nan, guard=None,
                              eval_every=2, **kw)
        want_blocked = np.zeros(P, bool)
        want_blocked[NAN_AT[1]] = True
        check(retry.retries == 1 and np.array_equal(retry.blocked,
                                                    want_blocked),
              f"guard off: retries {retry.retries}, blocked "
              f"{retry.blocked.tolist()}")
        check(all(bool(torch.isfinite(t).all())
                  for t in retry.final_g_params.parameters()),
              "guard off: final generator not finite")
        print(f"NaN plan, guard off: retries {retry.retries}, blocked "
              f"{retry.blocked.astype(int).tolist()}, final generator finite")
        out.update(retries=retry.retries, blocked=retry.blocked.tolist())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one round of the host oracle against one fused round
    gens = {}
    for program in ("fed", "host"):
        ops.DISPATCH_COUNTS.clear()
        res = run_federated(parts, ds.schema, program=program,
                            **dict(kw, rounds=1))
        gens[program] = (res.final_g_params, dict(ops.DISPATCH_COUNTS))
    _no_plain_calls("host vs fed")
    check(gens["fed"][1].get("weighted_agg") == 1
          and "weighted_agg" not in gens["host"][1],
          f"host vs fed launches {gens['fed'][1]} / {gens['host'][1]}")
    d = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        gens["fed"][0].parameters(), gens["host"][0].parameters())]).detach()
    worst, within = float(d.max()), float((d <= 2e-6).float().mean())
    check(worst <= cfg.lr * FED_STEPS and within >= 0.99,
          f"host vs fed: max abs {worst:.3g}, {within:.4f} within 2e-6")
    print(f"host oracle vs fused program, 1 round: generator max abs diff "
          f"{worst:.3g} (<= lr x steps), {within:.4f} within 2e-6 (>= "
          f"0.99); weighted_agg {gens['fed'][1].get('weighted_agg')} / "
          f"{gens['host'][1].get('weighted_agg', 0)}")
    out["host_vs_fed"] = {"max_abs": worst, "within_2e-6": within}
    return out


def privacy_phase(dev, cfg, ds) -> dict:
    """Phase 17, DP and privacy at full width: phase 6's IID split and
    config, a traced run and an untraced one (the same seed), the attacks
    on the trace, the same run with DP, one checked and timed DP step, and
    one LM round with client-level DP."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.architectures import run_federated
    from repro_torch.fed import setup_federation
    from repro_torch.gan import dp as gdp
    from repro_torch.gan.ctgan import init_discriminator
    from repro_torch.gan.trainer import draw_step_noise, make_train_steps
    from repro_torch.interop import (flat_from_reference, flat_to_reference,
                                     gan_flat_index)
    from repro_torch.kernels import ops
    from repro_torch.launch import train as lm_train
    from repro_torch.privacy import (RoundTrace, dominant_category_hits,
                                     leakage_report, loss_threshold_mia,
                                     null_auc)
    from repro_torch.synth import draw_batch
    from repro_torch.tabular import make_dataset, partition_iid

    parts = partition_iid(ds, FED_CLIENTS, seed=0)
    R, E = PRIV_ROUNDS, PRIV_STEPS
    kw = dict(cfg=cfg, rounds=R, local_steps=E, seed=0, weighting="fedtgan",
              program="fed", eval_real=ds.data, eval_every=R,
              eval_samples=N_ROWS, device=dev)
    out: dict = {}
    counts: dict = {}

    def run(name, **extra):
        """One run with the counters at 0; each round's merge input is
        kept (the ``weighted_agg`` wrapper's argument) and the round's
        launches checked: one merge."""
        ops.DISPATCH_COUNTS.clear()
        inputs, per_round, snap = [], [], [{}]
        real_merge = ops.weighted_average_flat

        def merge(flat, w):
            inputs.append(flat.detach().clone())
            return real_merge(flat, w)

        def on_round(r, states, m):
            torch.cuda.synchronize()
            per_round.append(_launch_delta(snap[0]))
            snap[0] = dict(ops.DISPATCH_COUNTS)
            check(same_params(states), f"{name} round {r}: clients differ")
            vals = {k: m[k].cpu().numpy() for k in ("d_loss", "g_loss")}
            check(all(np.isfinite(v).all() for v in vals.values()),
                  f"{name} round {r}: losses {vals}")
        ops.weighted_average_flat = merge
        t0 = time.perf_counter()
        try:
            res = run_federated(parts, ds.schema, on_round=on_round,
                                **dict(kw, **extra))
        finally:
            ops.weighted_average_flat = real_merge
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _no_plain_calls(name)
        for r, c in enumerate(per_round):
            check(c.get("weighted_agg") == 1, f"{name} round {r}: {c}")
        check(len(per_round) == R, f"{name}: {len(per_round)} rounds")
        [rep] = res.history
        check(all(np.isfinite(v) for k, v in rep.items() if k != "round"),
              f"{name}: report not finite: {rep}")
        for k, v in ops.DISPATCH_COUNTS.items():
            counts[k] = counts.get(k, 0) + v
        out[name] = {"seconds": seconds, "launches": dict(ops.DISPATCH_COUNTS),
                     "avg_jsd": rep["avg_jsd"], "avg_wd": rep["avg_wd"]}
        return res, inputs

    # (a) traced and untraced, the same seed
    trace = RoundTrace()
    traced, inputs = run("traced", trace=trace)
    plain, _ = run("untraced")
    diffs = {n: float((a - b).detach().abs().max()) for (n, a), b in zip(
        traced.final_g_params.named_parameters(),
        plain.final_g_params.parameters())}
    exact = not any(diffs.values())
    check(exact, f"traced run's generator differs from the untraced run's: "
          f"max abs by parameter {diffs}")
    enc = traced.encoders
    index = gan_flat_index(traced.final_g_params, init_discriminator(
        cfg, enc.cond_dim, enc.encoded_dim, device=dev,
        generator=torch.Generator(dev).manual_seed(0)))
    check(trace.n_rounds == R and len(inputs) == R,
          f"trace: {trace.n_rounds} rounds, {len(inputs)} merges")
    for r, flat in enumerate(inputs):
        want = flat_to_reference(flat, index).cpu().numpy()
        check(np.array_equal(trace.updates[r], want),
              f"trace round {r}: the stack is not the merge input")
        back = flat_from_reference(torch.as_tensor(trace.updates[r],
                                                   device=dev), index)
        check(torch.equal(back, flat), f"trace round {r}: no round trip")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = str(Path(tmp) / "trace.npz")
        trace.save(path)
        loaded = RoundTrace.load(path)
        check(loaded.equals(trace), "trace save/load is not bit-exact")
        trace_mb = Path(path).stat().st_size / 1e6
    print(f"traced run: {R} rounds x {E} local steps, 5 IID clients, "
          f"{out['traced']['seconds']:.2f} s (untraced "
          f"{out['untraced']['seconds']:.2f} s); one weighted_agg a round; "
          f"final generator bit-identical to the untraced run's; the "
          f"recorded stacks ({trace.updates[0].shape}) equal the merge "
          f"inputs in the reference's layout; save/load bit-exact "
          f"({trace_mb:.1f} MB)")
    out["traced"].update(exact=exact, trace_mb=trace_mb)

    # (b) the attacks on that trace, encodes on the card
    holdout = make_dataset("adult", n_rows=PRIV_ATTACK_ROWS, seed=100).data
    members = parts[0][:PRIV_ATTACK_ROWS]
    attacks = {}

    def attack(name, fn):
        ops.DISPATCH_COUNTS.clear()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        attacks[name] = {"seconds": time.perf_counter() - t0,
                         "launches": dict(ops.DISPATCH_COUNTS)}
        _no_plain_calls(f"attack {name}")
        for k, v in ops.DISPATCH_COUNTS.items():
            counts[k] = counts.get(k, 0) + v
        return value
    mia = attack("loss_threshold_mia", lambda: loss_threshold_mia(
        trace, cfg, enc, members, holdout))
    null = attack("null_auc", lambda: null_auc(trace, cfg, enc, holdout))
    hits = attack("dominant_category_hits", lambda: dominant_category_hits(
        trace, cfg, enc))
    report = attack("leakage_report", lambda: leakage_report(trace, cfg, enc))
    scores = np.concatenate([mia["member_scores"], mia["holdout_scores"]])
    check(np.isfinite(scores).all(), "attack scores not finite")
    check(all(0.0 <= a <= 1.0 for a in (mia["auc"], null,
                                        hits["hit_rate"])),
          f"AUCs {mia['auc']}, {null}, hit rate {hits['hit_rate']}")
    check(attacks["loss_threshold_mia"]["launches"].get("vgm_encode_table")
          == 2 * 2 * R, f"MIA encodes {attacks['loss_threshold_mia']}")
    check(all(np.isfinite(v).all() for col in
              report["setup_moments"].values() for v in col.values()),
          "leakage report's moments not finite")
    out["attacks"] = {"runs": attacks, "mia_auc": mia["auc"],
                      "null_auc": null, "hit_rate": hits["hit_rate"]}
    print(f"attacks on the trace ({len(members)} of client 0's rows against "
          f"{len(holdout)} holdout rows): MIA AUC {mia['auc']:.4f}, null AUC "
          f"{null:.4f}, probe hit rate {hits['hit_rate']:.4f}; seconds "
          + ", ".join(f"{k} {v['seconds']:.2f}" for k, v in attacks.items())
          + f"; the MIA's launches {attacks['loss_threshold_mia']['launches']}")

    # (c) the same run with DP
    conf = gdp.DPConfig(l2_clip=PRIV_CLIP, noise_mult=PRIV_NOISE)
    private, _ = run("dp", dp=conf)
    n_min = N_ROWS // FED_CLIENTS
    want_eps = gdp.dp_epsilon(R * E, cfg.batch_size, n_min, PRIV_NOISE)
    check(private.epsilon == want_eps,
          f"epsilon {private.epsilon}, want {want_eps}")
    print(f"DP run (clip {PRIV_CLIP}, noise {PRIV_NOISE}): "
          f"{out['dp']['seconds']:.2f} s, one weighted_agg a round, epsilon "
          f"{private.epsilon:.6f} (delta {conf.delta}), avg_jsd "
          f"{out['dp']['avg_jsd']:.4f} (non-private "
          f"{out['traced']['avg_jsd']:.4f})")
    out["dp"]["epsilon"] = private.epsilon

    # one DP step checked, and DP against non-private steps timed
    fe = setup_federation(parts, ds.schema, cfg, 1, "fedtgan", device=dev)
    state = fe.states[0]
    batch = draw_batch(fe.tables[0], cfg.batch_size, fe.enc.cond_dim,
                       generator=torch.Generator(dev).manual_seed(5))
    cond, _, real = batch
    noise = gdp.draw_dp_step_noise(torch.Generator(dev).manual_seed(6), cfg,
                                   state.disc, cfg.batch_size,
                                   real.shape[1], dev)
    with torch.no_grad():
        fake = ops.segment_activations(state.gen(noise.z_d, cond), fe.spans,
                                       noise.u_d, cfg.tau)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads, _ = gdp.per_pack_critic_grads(
        state.disc, cfg, torch.cat([real, cond], 1),
        torch.cat([fake, cond], 1), noise)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    grads_mb = sum(g.numel() * g.element_size() for g in grads) / 1e6
    n_packs = cfg.batch_size // cfg.pac

    def pack_norms(gs):
        return torch.sqrt(sum(torch.sum(g.reshape(n_packs, -1).double() ** 2,
                                        dim=1) for g in gs))
    raw_norms = pack_norms(grads)
    clipped = pack_norms(gdp.clip_packs(grads, PRIV_CLIP))
    check(float(clipped.max()) <= PRIV_CLIP * (1 + 1e-6),
          f"clipped pack norms up to {float(clipped.max())}")
    del grads

    def stepper(step, draw):
        """A window of PRIV_TIMED steps on one replica, each on its own
        draw of the noise (drawn before any clock starts), run once to warm
        up."""
        st = state.replica(torch.Generator(dev).manual_seed(7))
        noises = [draw(st) for _ in range(PRIV_TIMED)]

        def window():
            for nz in noises:
                step(st, batch, nz)
        window()
        return window

    windows = {
        "plain": stepper(make_train_steps(cfg, fe.spans, fe.cond_spans),
                         lambda st: draw_step_noise(
                             st.rng, cfg, st.disc, cfg.batch_size,
                             real.shape[1], dev)),
        "dp": stepper(gdp.make_dp_train_steps(cfg, fe.spans, fe.cond_spans,
                                              l2_clip=PRIV_CLIP,
                                              noise_mult=PRIV_NOISE),
                      lambda st: gdp.draw_dp_step_noise(
                          st.rng, cfg, st.disc, cfg.batch_size,
                          real.shape[1], dev))}
    step_ms = {"plain": [], "dp": []}
    for i in range(PRIV_WINDOWS):      # plain, dp, dp, plain, ...
        for k in ("plain", "dp") if i % 2 == 0 else ("dp", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            windows[k]()
            torch.cuda.synchronize()
            step_ms[k].append((time.perf_counter() - t0) * 1e3 / PRIV_TIMED)
    busy_ms = {k: device_busy(w, repeats=3)[0] / PRIV_TIMED
               for k, w in windows.items()}
    plain_ms, dp_ms = (statistics.median(step_ms[k]) for k in ("plain", "dp"))
    idle = {k: 1 - busy_ms[k] / statistics.median(step_ms[k])
            for k in step_ms}
    n_params = sum(p.numel() for p in state.disc.parameters())
    print(f"DP step at batch {cfg.batch_size}, pac {cfg.pac} ({n_packs} "
          f"packs, critic {n_params:,} parameters), ms per step, median of "
          f"{PRIV_WINDOWS} windows of {PRIV_TIMED} steps (min-max): DP "
          f"{dp_ms:.3f} ({min(step_ms['dp']):.3f}-{max(step_ms['dp']):.3f}),"
          f" non-private {plain_ms:.3f} ({min(step_ms['plain']):.3f}-"
          f"{max(step_ms['plain']):.3f}), {dp_ms / plain_ms:.2f}x; device "
          f"busy per step {busy_ms['dp']:.3f} / {busy_ms['plain']:.3f} ms "
          f"(idle share {idle['dp']:.3f} / {idle['plain']:.3f}); per-pack "
          f"gradients {grads_mb:.1f} MB, peak {peak_mb:.1f} MB above the "
          f"state while taking them; pack norms {float(raw_norms.min()):.3f}"
          f"-{float(raw_norms.max()):.3f} before the clip, at most "
          f"{float(clipped.max()):.6f} after (clip {PRIV_CLIP})")
    out["step"] = {"dp_ms": dp_ms, "plain_ms": plain_ms,
                   "windows_ms": step_ms, "busy_ms": busy_ms, "idle": idle,
                   "grads_mb": grads_mb, "peak_mb": peak_mb,
                   "critic_params": n_params,
                   "pack_norms": [float(raw_norms.min()),
                                  float(raw_norms.max())],
                   "clipped_max": float(clipped.max())}

    # (d) one LM round with client-level DP at phase 10's configuration
    lm_cfg = dataclasses.replace(get_config("smollm-135m"),
                                 use_flash_kernel=True)
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    _, hist, _ = lm_train.run_federated(
        lm_cfg, clients=LM_CLIENTS, rounds=1, local_steps=LM_STEPS,
        batch=LM_BATCH, seq=LM_SEQ, lr=3e-4, iid=False, weighting="fedtgan",
        dp=conf, device=dev)
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    _no_plain_calls("LM DP round")
    lm_counts = dict(ops.DISPATCH_COUNTS)
    for k, v in lm_counts.items():
        counts[k] = counts.get(k, 0) + v
    per_round = LM_CLIENTS * LM_STEPS * lm_cfg.n_layers
    want = {"weighted_agg": 1, "flash_attention_dq": per_round,
            "flash_attention_dkv": per_round,
            "flash_attention_fwd": per_round * (2 if lm_cfg.remat else 1)}
    check({k: lm_counts.get(k) for k in want} == want,
          f"LM DP round launches {lm_counts}, want {want}")
    # the round's losses come before its merge: phase 10's first round's
    check(np.isfinite(hist[0]["loss"])
          and abs(hist[0]["loss"] - LM_LOSSES[0]) <= 1e-2,
          f"LM DP loss {hist[0]['loss']}, phase 10's {LM_LOSSES[0]}")
    print(f"LM DP round: smollm-135m, {LM_CLIENTS} clients x {LM_STEPS} "
          f"steps, clip {PRIV_CLIP}, noise {PRIV_NOISE}: mean loss "
          f"{hist[0]['loss']:.4f} (within 1e-2 of {LM_LOSSES[0]}), "
          f"{lm_s:.2f} s; launches {want} (gated)")
    out["lm_dp"] = {"loss": hist[0]["loss"], "seconds": lm_s,
                    "launches": lm_counts}

    on_path = ("vgm_encode_table", "segment_activations",
               "segment_activations_bwd", "vgm_decode_table", "weighted_agg",
               "flash_attention_fwd", "flash_attention_dq",
               "flash_attention_dkv")
    check(all(counts.get(k, 0) > 0 for k in on_path),
          f"phase 17: a kernel of the path never launched: {counts}")
    out["launches"] = counts
    print(f"phase 17 launches {counts}")
    return out


def matrix_scale_phase(dev, cfg, ds) -> dict:
    """Phase 18: the paper's evaluation matrix (``run_matrix``), the
    federation tiled to 128 and 1,024 clients with the chunked client axis
    and the two-tier merge, and the collective round on an NCCL group of
    one rank."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.aggregation import broadcast_from
    from repro_torch.core.architectures import _clone_states
    from repro_torch.fed import (FederatedProgram, setup_federation,
                                 shard_map_global_round, tile_federation)
    from repro_torch.fed.scenarios import (SCENARIOS, partition, print_table,
                                           run_matrix)
    from repro_torch.kernels import ops
    from repro_torch.tabular import partition_iid

    out: dict = {}
    counts: dict = {}

    def tally(name):
        """This part's launches since the counters were cleared, checked
        for plain calls and added to the phase's."""
        torch.cuda.synchronize()
        _no_plain_calls(name)
        got = dict(ops.DISPATCH_COUNTS)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return got

    # (a) the matrix: five scenarios x two weightings, then a chaos cell
    t0 = time.perf_counter()
    ops.DISPATCH_COUNTS.clear()
    recs = run_matrix(("adult",), tuple(SCENARIOS), ("fedtgan", "uniform"),
                      ("none",), n_clients=MX_CLIENTS, rows=N_ROWS,
                      rounds=MX_ROUNDS, local_steps=MX_STEPS, cfg=cfg,
                      eval_samples=MX_EVAL, device=dev)
    matrix_s = time.perf_counter() - t0
    got = tally("matrix")
    cells = len(recs)
    check(cells == 2 * len(SCENARIOS), f"matrix: {cells} records")
    check(got.get("weighted_agg") == cells * MX_ROUNDS,
          f"matrix: weighted_agg {got.get('weighted_agg')}, not one a round")
    check(got.get("segment_activations_bwd")
          == cells * MX_CLIENTS * MX_ROUNDS * MX_STEPS,
          f"matrix: segment_activations_bwd {got}")
    for r in recs:
        check(r["finite"], f"matrix cell not finite: {r}")
        want = [len(p) for p in partition(r["scenario"], ds, MX_CLIENTS)]
        check(r["client_rows"] == want,
              f"{r['scenario']}: client rows {r['client_rows']} != {want}")
    by = {(r["scenario"], r["weighting"]): r for r in recs}
    wq = by[("quantity", "fedtgan")]["weights"]
    check(int(np.argmax(wq)) == MX_CLIENTS - 1 and wq[-1] > 1 / MX_CLIENTS,
          f"quantity skew: fedtgan weights {wq} do not favour the big client")
    print(f"evaluation matrix: adult at {N_ROWS} rows, {MX_CLIENTS} clients,"
          f" {MX_ROUNDS} rounds x {MX_STEPS} local steps, {cells} cells in "
          f"{matrix_s:.2f} s ({matrix_s / cells:.3f} s a cell with setup; "
          f"rounds and evaluation "
          f"{[round(r['seconds'], 3) for r in recs]} s); launches {got}")
    print_table(recs)
    mal = {w: by[("malicious", w)]["weights"][-1] for w in ("fedtgan",
                                                            "uniform")}
    print(f"malicious client's weight (recorded, not gated): fedtgan "
          f"{mal['fedtgan']}, uniform {mal['uniform']}")
    t0 = time.perf_counter()
    ops.DISPATCH_COUNTS.clear()
    [chaos] = run_matrix(("adult",), ("iid",), ("fedtgan",), ("chaos",),
                         n_clients=MX_CLIENTS, rows=N_ROWS, rounds=MX_ROUNDS,
                         local_steps=MX_STEPS, cfg=cfg, eval_samples=MX_EVAL,
                         client_chunk=2, edges=2, device=dev)
    chaos_s = time.perf_counter() - t0
    got = tally("chaos cell")
    check(chaos["finite"], f"chaos cell not finite: {chaos}")
    check(got.get("weighted_agg") == 2 * MX_ROUNDS,
          f"chaos cell: weighted_agg {got.get('weighted_agg')}, not 2 a "
          "round")
    print(f"chaos cell (iid, fedtgan, client_chunk=2, edges=2): finite, "
          f"retries {chaos['retries']}, faults {chaos['fault_summary']}, "
          f"{chaos_s:.2f} s; launches {got}")
    out["matrix"] = {"records": recs, "seconds": matrix_s,
                     "chaos": chaos, "chaos_s": chaos_s,
                     "malicious_weight": mal}

    # (b) scale: 16 IID clients of 2,500 rows, tiled
    parts = partition_iid(ds, SCALE_BASE, seed=0)
    t0 = time.perf_counter()
    ops.DISPATCH_COUNTS.clear()
    base = setup_federation(parts, ds.schema, cfg, 0, "fedtgan", device=dev)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0

    def program(**kw):
        return FederatedProgram(cfg, base.spans, base.cond_spans,
                                batch=cfg.batch_size, local_steps=1, **kw)
    mid = tile_federation(base, SCALE_CHECK_P)
    runs = {}
    for chunk in (None, SCALE_CHUNK):
        states = _clone_states(mid.states)
        t0 = time.perf_counter()
        program(client_chunk=chunk).weighted_round(states, mid.tables,
                                                   mid.weights)
        torch.cuda.synchronize()
        runs[chunk] = (states, time.perf_counter() - t0)
    same = all(torch.equal(a, b) for x, y in zip(runs[None][0],
                                                 runs[SCALE_CHUNK][0])
               for a, b in zip(x.params(), y.params()))
    check(same, f"P={SCALE_CHECK_P}: the chunked round differs from the "
          "dense round")
    print(f"scale: base {SCALE_BASE} IID clients x {len(parts[0])} rows "
          f"set up in {base_s:.2f} s; P={SCALE_CHECK_P}, one round of one "
          f"step: dense {runs[None][1]:.2f} s, client_chunk={SCALE_CHUNK} "
          f"{runs[SCALE_CHUNK][1]:.2f} s, bit-identical")
    del runs, mid, states
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)     # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    big = tile_federation(base, SCALE_P)
    torch.cuda.synchronize()
    tile_s = time.perf_counter() - t0
    prog = program(client_chunk=SCALE_CHUNK, n_edges=SCALE_EDGES)
    before = dict(ops.DISPATCH_COUNTS)
    t0 = time.perf_counter()
    prog.weighted_round(big.states, big.tables, big.weights)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    delta = _launch_delta(before)
    check(delta.get("weighted_agg") == 2,
          f"P={SCALE_P}: weighted_agg {delta.get('weighted_agg')}, not 2")
    check(delta.get("segment_activations_bwd") == SCALE_P,
          f"P={SCALE_P}: segment_activations_bwd "
          f"{delta.get('segment_activations_bwd')}, not {SCALE_P}")
    finite = torch.stack([torch.isfinite(t).all() for st in big.states
                          for t in st.params()]).all()
    check(bool(finite), f"P={SCALE_P}: a state is not finite")
    busy_ms, top = device_busy(lambda: prog.weighted_round(
        big.states, big.tables, big.weights))
    busy = busy_ms / (round_s * 1e3)
    got = tally("scale")
    print(f"P={SCALE_P} (tiled in {tile_s:.2f} s), one round of one step, "
          f"client_chunk={SCALE_CHUNK}, edges={SCALE_EDGES}: {round_s:.2f} s,"
          f" peak {peak / 1e9:.2f} GB allocated ({(peak - held) / 1e9:.2f} "
          f"GB above the {held / 1e9:.2f} GB held before the tiling), "
          f"device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy:.3f}, CUDA-only trace "
          f"of one more round); launches {delta}; every state finite")
    out["scale"] = {"base_s": base_s, "check_p": SCALE_CHECK_P,
                    "P": SCALE_P, "tile_s": tile_s, "round_s": round_s,
                    "peak_bytes": peak, "held_bytes": held,
                    "busy_ms": busy_ms,
                    "busy_share": busy, "top_kernels": top,
                    "launches": delta}
    del big, prog
    torch.cuda.empty_cache()

    # (c) the collective round: NCCL, one rank
    ops.DISPATCH_COUNTS.clear()
    fe1 = setup_federation(partition_iid(ds, FED_CLIENTS, seed=0)[:1],
                           ds.schema, cfg, 0, "fedtgan", device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            coll = shard_map_global_round(cfg, fe1.spans, fe1.cond_spans,
                                          batch=cfg.batch_size,
                                          local_steps=COLL_STEPS)
            fused = FederatedProgram(cfg, fe1.spans, fe1.cond_spans,
                                     batch=cfg.batch_size,
                                     local_steps=COLL_STEPS)
            times = {"collective": [], "fused": []}
            # twice: the first collective call also creates the NCCL
            # communicator
            for _ in range(2):
                states = _clone_states(fe1.states)
                t0 = time.perf_counter()
                coll(states, fe1.tables, fe1.S, fe1.n_rows)
                torch.cuda.synchronize()
                times["collective"].append(time.perf_counter() - t0)
                ref = _clone_states(fe1.states)
                t0 = time.perf_counter()
                fused.global_round(ref, fe1.tables, fe1.S, fe1.n_rows)
                torch.cuda.synchronize()
                times["fused"].append(time.perf_counter() - t0)
                check(all(torch.equal(a, b) for a, b in zip(
                    states[0].params(), ref[0].params(), strict=True)),
                    "collective round differs from the fused round at P=1")
            kept = [t.detach().clone() for t in states[0].params()]
            broadcast_from(states[0].params(), src=0)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(
                kept, states[0].params())), "broadcast_from(src=0) at one "
                "rank is not the identity")
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    got = tally("collective round")
    check(not dist.is_initialized(), "the process group outlived phase 18")
    ms = {k: [round(t * 1e3, 3) for t in v] for k, v in times.items()}
    print(f"collective round ({backend}, world size 1): "
          f"shard_map_global_round, {COLL_STEPS} local steps on client 0 of "
          f"phase 6's split, twice from one start: {ms['collective']} ms "
          f"(the first creates the communicator) against the fused "
          f"global_round's {ms['fused']} ms: bit-identical; "
          f"broadcast_from(src=0) the identity; launches {got}")
    out["collective"] = {"backend": backend, "ms": ms}

    on_path = ("vgm_encode_table", "segment_activations",
               "segment_activations_bwd", "vgm_decode_table", "weighted_agg")
    check(all(counts.get(k, 0) > 0 for k in on_path),
          f"phase 18: a kernel of the path never launched: {counts}")
    out["launches"] = counts
    print(f"phase 18 launches {counts}")
    return out


def _gates_on(params) -> None:
    """Every cross-attention gate to ``XATTN_GATE``: at its initial 0,
    ``tanh`` switches cross-attention off."""
    import torch
    with torch.no_grad():
        for rep in params["layers"]:
            for blk in rep.values():
                if "xattn_gate" in blk:
                    blk["xattn_gate"].fill_(XATTN_GATE)


class MoERecorder:
    """For the span of a ``with`` block, every ``moe_ffn`` call of
    ``Transformer`` as (tokens per row, metrics, routing or None): the
    model module's ``moe_ffn`` wrapped, the routing recomputed by
    ``moe_route`` when asked."""

    def __init__(self, routing: bool = False):
        self.routing, self.calls = routing, []

    def __enter__(self):
        from repro_torch.models import model as model_mod
        from repro_torch.models.moe import moe_route
        self.real = model_mod.moe_ffn

        def record(p, x, cfg, **kw):
            out, m = self.real(p, x, cfg, **kw)
            self.calls.append((x.shape[1], m, moe_route(p, x, cfg)
                               if self.routing else None))
            return out, m
        model_mod.moe_ffn = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as model_mod
        model_mod.moe_ffn = self.real
        return False


def _n_moe(cfg) -> int:
    return sum(cfg.ffn_is_moe(p) for p in range(len(cfg.pattern))) * cfg.n_rep


def serve_family(dev, name: str, cuts: dict, prompt_len: int,
                 seed: int) -> dict:
    """Phase 19 (a, b): ``prefill_and_decode`` of one model at its
    published widths (depth or experts cut by ``cuts``), greedy, with
    random weights from ``seed`` (cross-attention gates at
    ``XATTN_GATE``), then one more prefill for the card's busy share."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prefill_and_decode
    from repro_torch.models import Transformer, tree_leaves

    cfg = dataclasses.replace(get_config(name), **cuts)
    model = Transformer(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=seed, device=dev)
    _gates_on(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weights_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    g = torch.Generator(dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (FAM_BATCH, prompt_len),
                            device=dev, generator=g)
    extras = {}
    if cfg.xattn_tokens:
        extras["vision"] = torch.randn(
            (FAM_BATCH, cfg.xattn_tokens, cfg.d_model), device=dev,
            generator=g).bfloat16()
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    with MoERecorder() as rec:
        gen, stats = prefill_and_decode(
            cfg, batch=FAM_BATCH, prompt_len=prompt_len, gen_tokens=FAM_GEN,
            temperature=0, seed=seed, device=dev, params=params,
            prompts=prompts, vision=extras.get("vision"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(ops.DISPATCH_COUNTS)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    # no hand-written kernel is on this path (the prefill attends through
    # gqa_attention, as the reference's does), and no plain route may run
    check(not counts, f"{name} serving: launches {counts}, expected none")
    check(stats["logits_finite"], f"{name} serving: a logit is not finite")
    check(gen.shape == (FAM_BATCH, FAM_GEN)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"{name} serving: tokens {gen.shape} outside the vocabulary")
    n_moe = _n_moe(cfg)
    pre = [(float(m.dropped_fraction), float(m.aux_loss))
           for s, m, _ in rec.calls if s > 1]
    dec = [float(m.dropped_fraction) for s, m, _ in rec.calls if s == 1]
    check(len(pre) == n_moe and len(dec) == n_moe * FAM_GEN,
          f"{name}: {len(pre)} prefill and {len(dec)} decode MoE calls, "
          f"expected {n_moe} and {n_moe * FAM_GEN}")
    check(all(0.0 <= d < 1.0 and np.isfinite(a) for d, a in pre),
          f"{name}: prefill MoE (dropped, aux) {pre}")
    check(all(d == 0.0 for d in dec),
          f"{name}: one-token decode dropped {max(dec, default=0)}")
    prefill_tps = FAM_BATCH * prompt_len / stats["prefill_s"]

    def one_prefill():
        with torch.no_grad():
            model.prefill(params, {"tokens": prompts, **extras},
                          prompt_len + FAM_GEN)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    one_prefill()
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    busy_ms, top = device_busy(one_prefill, top=4)
    check(busy_ms > 0.0, f"{name}: the profiler saw no device time")
    busy = busy_ms / (wall * 1e3)
    moe_txt = ("" if not n_moe else
               f"; MoE on the prefill: dropped {[round(d, 4) for d, _ in pre]}"
               f", aux {[round(a, 4) for _, a in pre]}; decode dropped 0 "
               f"({len(dec)} calls)")
    print(f"family serve: {name} {cuts or 'whole'}, {n_params} parameters "
          f"({weights_gb:.2f} GB, drawn in {init_s:.2f} s), bf16, "
          f"{FAM_BATCH} x {prompt_len}-token greedy prefill in "
          f"{stats['prefill_s']:.3f} s = {prefill_tps:.0f} tokens/s; "
          f"{FAM_GEN} decode steps in {stats['decode_s']:.3f} s = "
          f"{stats['tok_per_s']:.1f} tokens/s; peak memory {peak_gb:.2f} GB "
          f"above the phase's start; one more prefill {wall * 1e3:.1f} ms "
          f"wall, device busy {busy_ms:.1f} ms (busy share {busy:.3f}); "
          f"launches {counts} (none on this path); logits finite{moe_txt}; "
          f"top kernels: "
          + "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in top))
    del params, model
    torch.cuda.empty_cache()
    return {"cuts": cuts, "params": n_params, "weights_gb": weights_gb,
            "init_s": init_s, "prefill_s": stats["prefill_s"],
            "prefill_tokens_per_s": prefill_tps,
            "decode_s": stats["decode_s"],
            "decode_tokens_per_s": stats["tok_per_s"], "run_s": run_s,
            "peak_memory_gb": peak_gb, "extra_prefill_wall_ms": wall * 1e3,
            "extra_prefill_busy_ms": busy_ms,
            "extra_prefill_busy_share": busy, "moe_prefill": pre,
            "top_kernels": top}


def hubert_phase(dev) -> dict:
    """Phase 19 (c): one federated round of hubert-xlarge at full width and
    depth (frame inputs, bidirectional, hd 80, bf16, the flash kernels)
    through ``run_federated``, one more round for the busy share, then a
    float32 copy cut to ``HUBERT_F32_LAYERS`` layers: its logits through
    the flash kernels against the plain ``gqa_attention`` route."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDatasetSpec, client_token_streams
    from repro_torch.kernels import ops
    from repro_torch.launch.train import (batch_maker, federated_round,
                                          lm_optimizer, run_federated)
    from repro_torch.models import Transformer, make_train_step, tree_leaves

    cfg = dataclasses.replace(get_config("hubert-xlarge"),
                              use_flash_kernel=True)
    check(cfg.hd == 80 and not cfg.causal and not cfg.embed_inputs,
          f"hubert-xlarge: hd {cfg.hd}, causal {cfg.causal}")
    per_round = HUBERT_CLIENTS * HUBERT_STEPS
    want = {"flash_attention_fwd": cfg.n_layers * per_round
            * (2 if cfg.remat else 1),
            "flash_attention_dq": cfg.n_layers * per_round,
            "flash_attention_dkv": cfg.n_layers * per_round,
            "weighted_agg": 1}
    seen = {}

    def on_round(r, states, m):
        torch.cuda.synchronize()
        seen["done"] = time.perf_counter()
        seen["counts"] = dict(ops.DISPATCH_COUNTS)
        ref = tree_leaves(states[0].params)
        check(all(torch.equal(a, b) for st in states[1:]
                  for a, b in zip(ref, tree_leaves(st.params), strict=True)),
              "hubert round: clients differ after the merge")
        lv = m["loss"].cpu().numpy()
        check(lv.shape == (HUBERT_CLIENTS, HUBERT_STEPS)
              and np.isfinite(lv).all(), f"hubert round: losses {lv}")
        seen["losses"] = lv.tolist()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    states, hist, w = run_federated(
        cfg, clients=HUBERT_CLIENTS, rounds=1, local_steps=HUBERT_STEPS,
        batch=HUBERT_BATCH, seq=HUBERT_SEQ, lr=3e-4, iid=False,
        weighting="fedtgan", device=dev, on_round=on_round)
    round_s = seen["done"] - t0
    counts = {k: seen["counts"].get(k, 0) for k in want}
    refs = {k: v for k, v in seen["counts"].items() if k.endswith("_ref")}
    check(not refs, f"hubert round: the plain route ran on the card: {refs}")
    check(counts == want, f"hubert round: launches {counts}, expected {want}")
    check(abs(float(w.sum()) - 1.0) < 1e-5, f"hubert weights sum {w.sum()}")
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    frames = per_round * HUBERT_BATCH * HUBERT_SEQ
    n_params = sum(t.numel() for t in tree_leaves(states[0].params))

    step_fn = make_train_step(Transformer(cfg), lm_optimizer(3e-4))
    streams = client_token_streams(TokenDatasetSpec(cfg.vocab, HUBERT_SEQ),
                                   HUBERT_CLIENTS, HUBERT_BATCH, HUBERT_STEPS,
                                   iid=False, seed=7)
    w_dev = torch.as_tensor(w, device=dev)
    make = batch_maker(cfg, dev, 7)

    def one_round():
        return federated_round(states, step_fn, streams, w_dev,
                               make_batch=make)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    busy_ms, top = device_busy(one_round, top=6)
    check(busy_ms > 0.0, "hubert: the profiler saw no device time")
    busy = busy_ms / (wall * 1e3)
    print(f"hubert round: hubert-xlarge, {n_params} parameters, "
          f"{cfg.n_layers} layers, "
          f"hd {cfg.hd}, bidirectional, frame inputs, bf16, remat; "
          f"{HUBERT_CLIENTS} clients x {HUBERT_STEPS} local steps of "
          f"{HUBERT_BATCH} x {HUBERT_SEQ} frames, fedtgan weights "
          f"{np.round(w, 6).tolist()}; losses {seen['losses']}; "
          f"{round_s:.2f} s for the round with its setup, "
          f"{frames / round_s:.0f} frames/s; launches {counts} (gated); "
          f"clients bit-identical after the merge; peak memory "
          f"{peak_gb:.2f} GB above the phase's start; one more round "
          f"{wall * 1e3:.1f} ms wall = {frames / wall:.0f} frames/s, device "
          f"busy {busy_ms:.1f} ms (busy share {busy:.3f}); top kernels: "
          + "; ".join(f"{n} {ms:.1f} ms x{c}" for n, ms, c in top))
    del states, step_fn
    torch.cuda.empty_cache()

    # float32, cut to HUBERT_F32_LAYERS layers: the float32 library's hd-80
    # instance, non-causal, against the plain route
    cfg32 = dataclasses.replace(get_config("hubert-xlarge"), dtype="float32",
                                n_layers=HUBERT_F32_LAYERS)
    params = Transformer(cfg32).init(seed=19, device=dev)
    g = torch.Generator(dev).manual_seed(19)
    feats = torch.randn((1, HUBERT_SEQ, cfg32.d_model), device=dev,
                        generator=g)
    batch = {"features": feats}
    with torch.no_grad():
        plain, _ = Transformer(cfg32).forward(params, batch)
        with ops.dispatch_scope() as d:
            flash, _ = Transformer(dataclasses.replace(
                cfg32, use_flash_kernel=True)).forward(params, batch)
            torch.cuda.synchronize()
    check(dict(d) == {"flash_attention_fwd": cfg32.n_layers},
          f"hubert float32: launches {dict(d)}")
    err = float((flash - plain).abs().max())
    scale = float(plain.abs().max())
    tol = 1e-5 * max(1.0, scale) * cfg32.n_layers
    check(bool(torch.isfinite(flash).all()), "hubert float32: not finite")
    check(err <= tol, f"hubert float32 flash vs plain logits: {err:.3g} > "
          f"{tol:.3g}")
    print(f"hubert float32 ({cfg32.n_layers} layers, 1 x {HUBERT_SEQ} "
          f"frames, TF32 off): flash kernels (float32 library, hd 80, "
          f"bidirectional) vs gqa_attention max abs err {err:.3g} (tol "
          f"{tol:.3g}: 1e-5 of max|logit| {scale:.3g} per layer)")
    del params
    torch.cuda.empty_cache()
    return {"params": n_params, "round_s": round_s,
            "frames_per_round": frames, "frames_per_s": frames / round_s,
            "losses": seen["losses"], "weights": w.tolist(),
            "launches": counts, "peak_memory_gb": peak_gb,
            "extra_round_wall_ms": wall * 1e3, "extra_round_busy_ms": busy_ms,
            "extra_round_busy_share": busy, "top_kernels": top,
            "f32_max_abs_err": err, "f32_tol": tol}


def families_card_vs_cpu(dev) -> dict:
    """Phase 19 (d): each family's smoke config in float32 (TF32 off) with
    the same parameters and inputs on the card and on the CPU: the
    forward's logits and aux loss, every MoE call's routing, a prefill
    and ``FAMILY_CPU_STEPS`` greedy decode steps."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer, tree_leaves, tree_unflatten

    cpu = torch.device("cpu")
    out = {}
    ops.DISPATCH_COUNTS.clear()
    for name in FAMILIES:
        cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
        model = Transformer(cfg)
        p_cpu = model.init(seed=3, device=cpu)
        _gates_on(p_cpu)
        p_dev = tree_unflatten(p_cpu, [t.detach().to(dev)
                                       for t in tree_leaves(p_cpu)])
        g = torch.Generator().manual_seed(3)
        B, S = 2, 24
        arrays = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g)}
        if not cfg.embed_inputs:
            arrays["features"] = torch.randn((B, S + FAMILY_CPU_STEPS,
                                              cfg.d_model), generator=g)
        if cfg.xattn_tokens:
            arrays["vision"] = torch.randn((B, cfg.xattn_tokens, cfg.d_model),
                                           generator=g)
        # (a prefill of the first S positions, frames S.. for the decode)
        tol = (dict(rtol=5e-3, atol=5e-3) if "mamba" in cfg.pattern
               else dict(rtol=1e-4, atol=1e-4))
        res = {}
        for where, params in (("cpu", p_cpu), ("card", p_dev)):
            dv = cpu if where == "cpu" else dev
            a = {k: v.to(dv) for k, v in arrays.items()}
            fwd = {"labels": a["tokens"]}
            if cfg.embed_inputs:
                fwd["tokens"] = a["tokens"]
            else:
                fwd["features"] = a["features"][:, :S]
            if "vision" in a:
                fwd["vision"] = a["vision"]
            with torch.no_grad(), MoERecorder(routing=True) as rec:
                logits, aux = model.forward(params, fwd)
                pre = {k: v for k, v in fwd.items() if k != "labels"}
                last, caches = model.prefill(params, pre, S + FAMILY_CPU_STEPS)
                steps, toks = [last], []
                for t in range(FAMILY_CPU_STEPS):
                    tok = torch.argmax(last, dim=-1)[:, None]
                    toks.append(tok[:, 0].cpu())
                    step = ({"token": tok} if cfg.embed_inputs else
                            {"features": a["features"][:, S + t:S + t + 1]})
                    if "vision" in a:
                        step["vision"] = a["vision"]
                    last, caches = model.decode_step(params, caches, step)
                    steps.append(last)
            res[where] = (logits.cpu(), aux.cpu(), [s.cpu() for s in steps],
                          torch.stack(toks, 1),
                          [(r.expert_idx.cpu(), r.keep.cpu())
                           for _, _, r in rec.calls])
        (lc, ac, sc, tc, rc), (lg, ag, sg, tg, rg) = res["cpu"], res["card"]
        err = float((lg - lc).abs().max())
        check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-4),
              f"{name} card vs CPU logits: {err:.3g}")
        check(torch.allclose(ag, ac, rtol=1e-5, atol=1e-7),
              f"{name} card vs CPU aux {float(ag)} / {float(ac)}")
        check(len(rg) == len(rc) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(rg, rc)), f"{name}: MoE routing differs")
        step_err = max(float((x - y).abs().max()) for x, y in zip(sg, sc))
        check(all(torch.allclose(x, y, **tol) for x, y in zip(sg, sc)),
              f"{name} card vs CPU prefill / decode logits: {step_err:.3g}")
        check(torch.equal(tg, tc) or not cfg.embed_inputs,
              f"{name}: greedy tokens differ: {tg} / {tc}")
        print(f"family card vs CPU: {name} smoke, float32: logits max abs "
              f"err {err:.3g} (rtol = atol = 1e-4), aux {float(ag):.6g} / "
              f"{float(ac):.6g}, {len(rg)} MoE calls' routing equal, prefill "
              f"+ {FAMILY_CPU_STEPS} decode steps max abs err {step_err:.3g} "
              f"(rtol = atol = {tol['atol']:g}), greedy tokens equal")
        out[name] = {"logits_err": err, "step_err": step_err,
                     "moe_calls": len(rg)}
    refs = {k: v for k, v in ops.DISPATCH_COUNTS.items() if k.endswith("_ref")}
    cards = {k: v for k, v in ops.DISPATCH_COUNTS.items()
             if not k.endswith("_ref")}
    check(not cards, f"families card vs CPU: kernel launches {cards}")
    return {"families": out, "plain_calls": refs}


def families_phase(dev) -> dict:
    """Phase 19, the rest of the model families at full width: MoE and
    hybrid serving, cross-attention serving, hubert's federated round
    with the flash kernels at hd 80, and each family's card against the
    CPU."""
    from repro_torch.kernels import ops
    out = {"serve": {}}
    for i, (name, cuts, prompt_len) in enumerate(FAMILY_SERVE):
        out["serve"][name] = serve_family(dev, name, cuts, prompt_len, 40 + i)
    ops.DISPATCH_COUNTS.clear()
    out["hubert"] = hubert_phase(dev)
    out["launches"] = out["hubert"]["launches"]
    out["card_vs_cpu"] = families_card_vs_cpu(dev)
    print(f"phase 19 launches {out['launches']}")
    return out


def launch_phase(dev) -> dict:
    """Phase 20, the launch tooling on the card: (a) the roofline of the LM
    step at full width, counted on the card and on meta, timed, with its
    ``mfu``; (b) the dry runs as a user runs them; (c) the sharding policy
    on a real CUDA mesh of one rank."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.counting import OpCounter
    from repro_torch.kernels import ops, work
    from repro_torch.launch import shardings
    from repro_torch.launch.dryrun import spec_argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import (HLOStats, model_flops_for,
                                             roofline_from_stats)
    from repro_torch.launch.train import lm_optimizer
    from repro_torch.models import (INPUT_SHAPES, InputShape, ShardHints,
                                    TrainState, Transformer, make_train_step,
                                    tree_leaves)
    out: dict = {}
    card = card_line()

    # (b) first, in the background: three CPU processes, no card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    procs = {}
    for name, *argv in DRYRUNS:
        path = out_dir / f"phase20_{name}.jsonl"
        path.unlink(missing_ok=True)
        with open(path.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", *argv, "--out", str(path)], env=env,
                stdout=log, stderr=subprocess.STDOUT), path)

    # (a) the LM step: smollm-135m, the flash kernels, bf16, remat, one
    # local step of LM_BATCH x LM_SEQ tokens (phase 10's shape)
    cfg = dataclasses.replace(get_config("smollm-135m"), use_flash_kernel=True)
    model = Transformer(cfg)
    opt = lm_optimizer(3e-4)
    step = make_train_step(model, opt)

    def state_and_batch(device):
        params = model.init(seed=0, device=device)
        state = TrainState(params, opt.init(tree_leaves(params)), 0)
        shape = (LM_BATCH, LM_SEQ)
        tokens = (torch.empty(shape, dtype=torch.int32, device="meta")
                  if device == "meta" else torch.randint(
                      0, cfg.vocab, shape, dtype=torch.int32, device=device,
                      generator=torch.Generator(device).manual_seed(11)))
        return state, {"tokens": tokens, "labels": tokens}

    state, batch = state_and_batch(dev)
    torch.cuda.synchronize()
    ops.DISPATCH_COUNTS.clear()
    t0 = time.perf_counter()
    with OpCounter() as card_c:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    launches = dict(ops.DISPATCH_COUNTS)
    check(not any(k.endswith("_ref") for k in launches),
          f"phase 20: the plain route ran on the card: {launches}")
    mstate, mbatch = state_and_batch("meta")
    with OpCounter() as meta_c:
        step(mstate, mbatch)
    on_card, on_meta = (HLOStats.from_counter(card_c),
                        HLOStats.from_counter(meta_c))

    def device_bytes(stats, device):     # the card's traffic, or meta's
        return (stats.bytes_by_device.get(device, 0)
                + stats.bytes_by_device.get("kernels", 0))
    host_bytes = on_card.bytes_by_device.get("cpu", 0)
    if (on_card.flops_by_dtype != on_meta.flops_by_dtype
            or device_bytes(on_card, "cuda") != device_bytes(on_meta, "meta")):
        diff = {k: card_c.bytes_by_op.get(k, 0) - meta_c.bytes_by_op.get(k, 0)
                for k in set(card_c.bytes_by_op) | set(meta_c.bytes_by_op)}
        fail(f"phase 20: the card's count {on_card.flops_by_dtype} FLOPs, "
             f"{device_bytes(on_card, 'cuda')} bytes differs from meta's "
             f"{on_meta.flops_by_dtype}, {device_bytes(on_meta, 'meta')}; "
             f"bytes by op, card - meta: "
             f"{ {k: v for k, v in diff.items() if v} }")
    reps = 2 if cfg.remat else 1
    want = {"flash_attention_fwd": cfg.n_layers * reps,
            "flash_attention_dq": cfg.n_layers,
            "flash_attention_dkv": cfg.n_layers}
    mask = {"causal": cfg.causal, "window": cfg.sliding_window,
            "kv_len": LM_SEQ}
    for name, n in want.items():
        n_bytes, flops = work.flash_attention(
            name.rsplit("_", 1)[1], LM_BATCH * cfg.n_heads, LM_SEQ, cfg.hd,
            torch.bfloat16, **mask)
        got = on_card.kernels.get(name, {})
        check(launches.get(name) == n == got.get("launches")
              and got.get("flops") == n * flops
              and got.get("bytes") == n * n_bytes,
              f"phase 20: {name}: {launches.get(name)} launches, counted "
              f"{got}, expected {n} x ({flops} FLOPs, {n_bytes} bytes)")
    times = []
    for _ in range(LAUNCH_WARMUP + LAUNCH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times[LAUNCH_WARMUP:])
    shape = InputShape("train", LM_SEQ, LM_BATCH, "train")
    rep = roofline_from_stats(on_card, arch="smollm-135m",
                              shape=f"train {LM_BATCH}x{LM_SEQ}", mesh="1",
                              chips=1, model_flops=model_flops_for(
                                  cfg, shape, "train"))
    roof = rep.as_dict(seconds=step_s)
    check(0.5 <= roof["useful_flops_ratio"] <= 1.0,
          f"phase 20: useful_flops_ratio {roof['useful_flops_ratio']}")
    check(0.0 < roof["mfu"] <= 1.0, f"phase 20: mfu {roof['mfu']}")
    print(f"LM step roofline: smollm-135m, {LM_BATCH} x {LM_SEQ} tokens, "
          f"bf16, remat, flash kernels; FLOPs by dtype "
          f"{on_card.flops_by_dtype} (card = meta, gated), model_flops "
          f"{rep.model_flops:.6g} (6 N_active tokens), useful_flops_ratio "
          f"{roof['useful_flops_ratio']:.4f}, HBM bytes "
          f"{device_bytes(on_card, 'cuda'):.6g} (card = meta, gated; "
          f"{host_bytes} bytes of host copies beside), compute_s "
          f"{rep.compute_s * 1e3:.3f} ms, memory_s {rep.memory_s * 1e3:.3f} "
          f"ms, flash launches {want} (work = launches x least work, "
          f"gated); measured step {step_s * 1e3:.3f} ms (median of "
          f"{LAUNCH_TIMED} after {LAUNCH_WARMUP} warm-up, each ending in a "
          f"synchronize; steps {[round(t * 1e3, 3) for t in times]} ms); "
          f"mfu {roof['mfu']:.5f}; the counted step took {count_s:.2f} s; "
          f"{card}")
    out["lm_step"] = {"roofline": roof, "flops_by_dtype":
                      on_card.flops_by_dtype,
                      "hbm_bytes": device_bytes(on_card, "cuda"),
                      "host_bytes": host_bytes, "step_ms": step_s * 1e3,
                      "steps_ms": [t * 1e3 for t in times],
                      "kernels": on_card.kernels, "count_s": count_s,
                      "card": card}
    out["launches"] = launches
    del state, mstate, batch
    torch.cuda.empty_cache()

    # (c) the sharding policy on a CUDA mesh: NCCL, one rank
    pcfg = get_config("smollm-135m")        # plain attention, as served
    plain_model = Transformer(pcfg)
    params = plain_model.init(seed=0, device=dev)
    tokens = torch.randint(0, pcfg.vocab, (SHARD_BATCH, SHARD_SEQ),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(dev).manual_seed(12))
    with torch.no_grad():
        want_logits, _ = plain_model.prefill(params, {"tokens": tokens},
                                             SHARD_SEQ)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh()
            pol = shardings.ShardPolicy(mesh)
            dparams = shardings.distribute(
                params, mesh,
                shardings.build_param_specs(params, pol, pcfg.n_experts))
            batch = {"tokens": tokens}
            dbatch = shardings.distribute(
                batch, mesh, shardings.build_batch_specs(batch, pol))
            sharded = Transformer(pcfg, shard=ShardHints(dp=pol.dp,
                                                         tp=pol.tp))
            with (torch.no_grad(), implicit_replication(),
                  shardings.ReshardFallbacks() as fallbacks):
                got, _ = sharded.prefill(dparams, dbatch, SHARD_SEQ)
            placements = [str(p) for p in got.placements]
            got = got.full_tensor()
            mesh_txt = f"{mesh.device_type} {tuple(mesh.shape)}"
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 20")
    check(torch.equal(got, want_logits),
          f"phase 20: the DTensor prefill differs from the plain one by "
          f"{float((got.float() - want_logits.float()).abs().max())}")
    print(f"DTensor prefill: smollm-135m, {SHARD_BATCH} x {SHARD_SEQ} tokens "
          f"on make_host_mesh() ({mesh_txt}, NCCL), parameters distributed "
          f"by shardings.build_param_specs, ShardHints on; logits "
          f"{placements} bit-identical to the plain-tensor prefill (gated); "
          f"ops DTensor refused, run by ReshardFallbacks: "
          f"{dict(fallbacks.fallbacks)}")
    out["dtensor_prefill"] = {"mesh": mesh_txt, "placements": placements,
                              "bit_identical": True,
                              "fallbacks": dict(fallbacks.fallbacks)}
    del params, dparams
    torch.cuda.empty_cache()

    # (b) the dry runs' records
    out["dryruns"] = {}
    for name, (proc, path) in procs.items():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log = path.with_suffix(".log").read_text()
        check(proc.returncode == 0 and path.exists(),
              f"phase 20: {name} exited {proc.returncode}: {log[-1500:]}")
        rec = json.loads(path.read_text().splitlines()[-1])
        check(rec["status"] == "OK", f"phase 20: {name}: {rec}")
        out["dryruns"][name] = rec
        if rec.get("mode") == "train":
            want_bytes = spec_argument_bytes(
                get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]],
                (16, 16))
            got_bytes = rec["memory"]["argument_size_in_bytes"]
            check(got_bytes == want_bytes, f"phase 20: {name}: argument "
                  f"bytes {got_bytes}, the specs' shards {want_bytes}")
        r = rec.get("roofline", {})
        print(f"{name}: {rec['arch']} {rec.get('shape', rec.get('mode'))} "
              f"[{rec['mesh']}] OK; "
              + (f"compute_s {r['compute_s'] * 1e3:.3f} ms, memory_s "
                 f"{r['memory_s'] * 1e3:.3f} ms, collective_s "
                 f"{r['collective_s'] * 1e3:.3f} ms, dominant "
                 f"{r['dominant']}, useful_flops_ratio "
                 f"{r['useful_flops_ratio']:.4f}, memory {rec['memory']}, "
                 f"fallbacks {rec.get('fallbacks')}" if r else
                 f"{rec['clients']} clients, collectives "
                 f"{rec['collectives']}, kernels {rec['kernels']}")
              + f", {rec.get('trace_s', rec.get('t_s'))} s")
    print(f"phase 20 launches {launches}")
    return out


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
    from repro_torch.kernels import _build, ops, work
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
        check(len(mine) == 4 and all(mine.values()),
              f"{entry}: HGMMA per instantiation {mine}, expected four "
              "kernels (hd 32, 64, 80, 128) each with some")
        hgmma[entry] = sorted(mine.values())
    print(f"HGMMA instructions per bf16 flash kernel (hd 32, 64, 80, 128 "
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
    # the encode's shape line traces 20-call windows; taken early, as the
    # mLSTM grids are: such short traces late in the run came back empty
    # (three in a row once, after the xLSTM phase); printed in phase 14
    enc_shapes = encode_shapes(dev)
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
    # the flash kernels at hubert-xlarge's shape: hd 80, bidirectional,
    # bf16
    B8, H8, hd8 = HUBERT_BATCH, 16, 80
    BH8 = B8 * H8
    f8q, f8k, f8v, f8do = (torch.randn((B8, H8, Sf, hd8), device=dev,
                                       generator=gf).bfloat16()
                           for _ in range(4))
    mask8 = {"causal": False, "window": None, "kv_len": Sf}
    f8out, f8lse = flash_fwd_cuda(f8q, f8k, f8v, **mask8)
    f8delta = torch.sum(f8do.float() * f8out.float(), dim=-1)
    bwd8 = (f8q, f8k, f8v, f8do, f8lse, f8delta)
    l8 = [t.detach().clone().requires_grad_() for t in (f8q, f8k, f8v)]
    lib8_out = F.scaled_dot_product_attention(*l8)

    def lib8_bwd():  # the library's dq + dk/dv pair at hd 80
        return torch.autograd.grad(lib8_out, l8, f8do, retain_graph=True)

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

    # each case's least work: repro_torch.kernels.work, the formulas the
    # roofline's count of a step uses too
    enc_bytes, enc_ops = work.vgm_encode(Nq, Q, K)
    col_bytes, col_ops = work.vgm_encode(Nq, 1, K0)
    act_bytes, act_ops = work.segment_activations(B, S, W)
    bwd_bytes, bwd_ops = work.segment_activations(Bt, St, Wt, backward=True)
    dec_bytes, dec_ops = work.vgm_decode_table(B, Qd, K)
    agg_bytes, agg_ops = work.weighted_agg(1, P, D)
    bf16 = torch.bfloat16
    causal = {"causal": True, "window": None, "kv_len": Sf}
    bidir = {"causal": False, "window": None, "kv_len": Sf}
    flash = {kind: work.flash_attention(kind, BH, Sf, hd, bf16, **causal)
             for kind in ("fwd", "dq", "dkv")}
    flash8 = {kind: work.flash_attention(kind, BH8, Sf, hd8, bf16, **bidir)
              for kind in ("fwd", "dq", "dkv")}

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
             bytes=act_bytes, ops=act_ops, tol=2e-6,
             replaces="src/repro/kernels/segment_activations.py:134",
             launches=launches["segment_activations"],
             shape=f"({B}, {S} spans x Wmax {W}), hard"),
        dict(name="vgm_decode_table", stem="vgm_decode",
             kern=lambda: vgm_decode_table_cuda(*dec_args),
             plain=lambda: plain.vgm_decode_table_ref(*dec_args),
             bytes=dec_bytes, ops=dec_ops, tol=0.0,
             replaces="src/repro/kernels/vgm_decode.py:62",
             launches=launches["vgm_decode_table"],
             shape=f"slots ({B}, {Qd} x {1 + K})"),
        dict(name="weighted_agg", stem="weighted_agg",
             kern=lambda: weighted_agg_cuda(stack[None], w[None])[0],
             plain=lambda: plain.weighted_agg_ref(stack, w),
             library=lambda: (w / torch.sum(w)) @ stack,
             bytes=agg_bytes, ops=agg_ops,
             tol=1e-7 + 1e-6 * float(stack.abs().max()),
             replaces="src/repro/kernels/weighted_agg.py:47",
             launches=fed_launches["weighted_agg"],
             shape=f"flat ({P}, {D})"),
        dict(name="segment_activations_bwd", stem="segment_activations",
             kern=lambda: segment_activations_bwd_cuda(tpx, tpu, tkinds, tct,
                                                       cfg.tau),
             plain=lambda: plain.segment_activations_bwd_ref(
                 tpx, tpu, tkinds, tct, cfg.tau),
             bytes=bwd_bytes, ops=bwd_ops, tol=3e-5,
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
             compare=cmp_fwd, bytes=flash["fwd"][0], ops=flash["fwd"][1],
             peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:167",
             launches=lm_launches["flash_attention_fwd"],
             shape=f"({LM_BATCH}, 9, {Sf}, {hd}) bf16, causal"),
        dict(name="flash_attention_dq", stem="flash_attention_sm90",
             products=(4, 3),
             kern=lambda: flash_dq_cuda(*bwd_args, **mask),
             plain=lambda: plain.flash_attention_dq_ref(*bwd_args, **mask),
             library=lib_bwd, compare=cmp_grads,
             bytes=flash["dq"][0], ops=flash["dq"][1],
             peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:199",
             launches=lm_launches["flash_attention_dq"],
             shape=f"({LM_BATCH}, 9, {Sf}, {hd}) bf16, causal"),
        dict(name="flash_attention_dkv", stem="flash_attention_sm90",
             products=(6, 4),
             kern=lambda: flash_dkv_cuda(*bwd_args, **mask),
             plain=lambda: plain.flash_attention_dkv_ref(*bwd_args, **mask),
             library=lib_bwd, compare=cmp_grads,
             bytes=flash["dkv"][0], ops=flash["dkv"][1],
             peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:216",
             launches=lm_launches["flash_attention_dkv"],
             shape=f"({LM_BATCH}, 9, {Sf}, {hd}) bf16, causal"),
        dict(name="flash_attention_fwd (hd 80)", stem="flash_attention_sm90",
             products=(4, 2),
             kern=lambda: flash_fwd_cuda(f8q, f8k, f8v, **mask8),
             plain=lambda: plain.flash_attention_fwd_ref(f8q, f8k, f8v,
                                                         **mask8),
             library=lambda: F.scaled_dot_product_attention(f8q, f8k, f8v),
             compare=cmp_fwd, bytes=flash8["fwd"][0], ops=flash8["fwd"][1],
             peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:167",
             launches=None,
             shape=f"({B8}, {H8}, {Sf}, {hd8}) bf16, bidirectional"),
        dict(name="flash_attention_dq (hd 80)", stem="flash_attention_sm90",
             products=(4, 3),
             kern=lambda: flash_dq_cuda(*bwd8, **mask8),
             plain=lambda: plain.flash_attention_dq_ref(*bwd8, **mask8),
             library=lib8_bwd, compare=cmp_grads,
             bytes=flash8["dq"][0], ops=flash8["dq"][1],
             peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:199",
             launches=None,
             shape=f"({B8}, {H8}, {Sf}, {hd8}) bf16, bidirectional"),
        dict(name="flash_attention_dkv (hd 80)", stem="flash_attention_sm90",
             products=(6, 4),
             kern=lambda: flash_dkv_cuda(*bwd8, **mask8),
             plain=lambda: plain.flash_attention_dkv_ref(*bwd8, **mask8),
             library=lib8_bwd, compare=cmp_grads,
             bytes=flash8["dkv"][0], ops=flash8["dkv"][1],
             peak=PEAK_BF16_OPS_PER_S,
             replaces="src/repro/kernels/flash_attention.py:216",
             launches=None,
             shape=f"({B8}, {H8}, {Sf}, {hd8}) bf16, bidirectional"),
    ]
    edges_case = dict(
        name="weighted_agg (edges)", stem="weighted_agg",
        kern=lambda: weighted_agg_cuda(stack4, w4),
        plain=lambda: plain.weighted_agg_edges_ref(stack4, w4),
        library=lambda: torch.bmm((w4 / torch.sum(w4, 1, keepdim=True))[:, None],
                                  stack4)[:, 0],
        bytes=work.weighted_agg(2, 2, D)[0], ops=work.weighted_agg(2, 2, D)[1],
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
        bytes=work.weighted_agg(1, LM_CLIENTS, Dl)[0],
        ops=work.weighted_agg(1, LM_CLIENTS, Dl)[1],
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
    mlstm_bytes, mlstm_ops = work.mlstm_chunk(XB, XS, XD, XL)
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
        bytes=mlstm_bytes, ops=MLSTM_PRODUCTS * mlstm_ops,
        peak=PEAK_BF16_OPS_PER_S,
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
                   + (" (the dq + dk/dv pair)" if lib in (lib_bwd, lib8_bwd)
                      else ""))
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
            cold_txt += (f"; products {done:g} against the least {least} "
                         f"({done / least:.2f}x), bound on the least")
        n_txt = ("off the main path" if case["launches"] is None
                 else case["launches"])
        print(f"kernel {name} [{case['shape']}]: {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us ({source}); per call with launch "
              f"{call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us "
              f"(CUDA events); bound {b_ms * 1e3:.2f} us ({b_by}); max abs "
              f"err {err:.3g} (tol {tol_txt}); launches {n_txt}; "
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
    print_encode_shapes(enc_shapes)
    record.update(kernels=kernels, shapes=shapes, timing=timing,
                  activation_layouts=sweep, backward_decode_layouts=bd,
                  encode_shapes=enc_shapes)
    lap("kernels against plain")

    # ---- 15. the paper's architectures (Fig. 8a's split) ---------------
    record["architectures"] = architectures_phase(dev, cfg, fed_ds)
    lap("architectures")

    # ---- 16. the degraded federation -----------------------------------
    record["degraded"] = degraded_phase(dev, cfg, fed_ds)
    lap("degraded federation")

    # ---- 17. DP and privacy --------------------------------------------
    record["privacy"] = privacy_phase(dev, cfg, fed_ds)
    for k in kernels:                  # this path's launches beside the main
        k["launches_phase17"] = record["privacy"]["launches"].get(k["name"], 0)
    lap("DP and privacy")

    # ---- 18. the evaluation matrix and the federation at scale ---------
    record["matrix_scale"] = matrix_scale_phase(dev, cfg, fed_ds)
    for k in kernels:
        k["launches_phase18"] = record["matrix_scale"]["launches"].get(
            k["name"], 0)
    lap("matrix and scale")

    # ---- 19. the rest of the model families ---------------------------
    record["families"] = families_phase(dev)
    for k in kernels:
        k["launches_phase19"] = record["families"]["launches"].get(
            k["name"], 0)
    lap("model families")

    # ---- 20. the launch tooling ----------------------------------------
    record["launch"] = launch_phase(dev)
    for k in kernels:
        k["launches_phase20"] = record["launch"]["launches"].get(k["name"], 0)
    lap("launch tooling")
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
    ap.add_argument("--host-paths", action="store_true",
                    help="run only the LM round and the serving drains, "
                    "timed")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="with --encode-shapes or --host-paths: the "
                    "checkout whose repro_torch to time (default: this one)")
    cli = ap.parse_args()
    if cli.encode_shapes:
        sys.exit(encode_shapes_main(cli.tree.resolve()))
    sys.exit(host_paths_main(cli.tree.resolve()) if cli.host_paths
             else main())
