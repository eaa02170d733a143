"""Streaming synthesis server: queue -> buckets -> overlapped pipeline.

``StreamingSynthesizer`` turns the one-shot
:func:`repro_torch.synth.engine.synthesize_table` into a serving loop, as
the JAX package's ``serve/server.py`` does:

* **Request queue + buckets.**  ``submit`` enqueues ``(table, rows,
  seed)`` requests; each is bound at admission to the smallest rung of its
  table's :class:`~repro_torch.serve.bucketing.BucketLadder`.  Requests
  are not merged: the generator batch-normalizes over the batch, so a
  request is answered with ``synthesize_table(..., generator=
  torch.Generator(device).manual_seed(seed), n_samples=bucket)[:rows]``.
* **Continuous batching** (``scheduler="continuous"``): per-tenant queues
  assembled into dispatch cycles by deficit round robin
  (:class:`~repro_torch.serve.scheduling.ContinuousScheduler`).
* **Double buffering.**  ``_generate`` only enqueues device work (the
  sampler draws, the generator, the activation kernel) and never waits
  for the device; ``_finish`` decodes and its ``.cpu()`` copies are where
  the host waits.  With ``pipeline=True`` request *i+1*'s generation is
  enqueued before request *i* is finished.  Everything runs on the
  current stream.
* **First-run accounting.**  PyTorch runs eagerly, so there is no jit
  cache to watch; the counterpart of a compile is the first execution of
  a (tenant uid, bucket, hard, conditional) combination, which builds the
  kernels, sizes the allocator's blocks and the BLAS workspace.  One
  first executed by ``warmup`` or ``refit_ladder`` counts in
  ``warmup_compiles``; one first executed by a request counts in
  ``serving_compiles``.  The stats keys are the reference's.
* **Dispatch accounting.**  Every response records its decode kernel
  dispatches through :func:`repro_torch.kernels.ops.dispatch_scope`.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..gan.trainer import sample_synthetic
from ..kernels import ops
from ..synth.engine import sample_synthetic_conditional
from .bucketing import BucketLadder, ladder_from_sizes
from .registry import TableEntry, TableRegistry
from .scheduling import ContinuousScheduler


class ServerOverloaded(RuntimeError):
    """The server's bounded request queue is full: shed load or retry."""


@dataclasses.dataclass(frozen=True)
class SynthesisRequest:
    """One table-synthesis request.  ``seed`` is its random identity:
    resubmitting the same (table, rows, seed, hard, conditional) returns
    identical rows.  ``deadline_at`` (monotonic-clock time, None = none)
    is the latest instant the request is still worth serving."""
    rid: int
    table: str
    rows: int
    seed: int
    hard: bool = True
    conditional: bool = False
    deadline_at: float | None = None


@dataclasses.dataclass
class SynthesisResponse:
    rid: int
    table: str
    rows: int
    bucket: int
    data: np.ndarray                   # (rows, Q) float64 raw table
    decode_dispatches: int             # decode kernels this request
    cache_hit: bool                    # its combination had run before


@dataclasses.dataclass
class _Pending:
    """In-flight request: generation enqueued, decode not yet run."""
    req: SynthesisRequest
    entry: TableEntry
    bucket: int
    encoded: torch.Tensor
    first_run: bool


class StreamingSynthesizer:
    """The serving loop over a :class:`TableRegistry` on ``device``."""

    def __init__(self, registry: TableRegistry, *, pipeline: bool = True,
                 max_queue: int | None = None, clock=time.monotonic,
                 scheduler: str = "fifo", quantum: int = 512,
                 device: torch.device | str = "cuda"):
        if scheduler not in ("fifo", "continuous"):
            raise ValueError(f"scheduler must be 'fifo' or 'continuous', "
                             f"got {scheduler!r}")
        self.registry = registry
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.max_queue = max_queue
        self.clock = clock
        self.scheduler = scheduler
        self.rejected_overload = 0
        self.expired_admission = 0
        self.expired_dispatch = 0
        self._queue: collections.deque[
            tuple[SynthesisRequest, TableEntry, int]] = collections.deque()
        self._sched = (ContinuousScheduler(quantum)
                       if scheduler == "continuous" else None)
        # combinations executed at least once, keyed by registration uid
        self._executed: set[tuple[int, int, bool, bool]] = set()
        self._next_rid = 0
        self.warmup_compiles = 0
        self.serving_compiles = 0
        self.cache_hits = 0
        self.decode_dispatch_counts: list[int] = []

    @property
    def expired(self) -> int:
        """Total expired requests (admission + dispatch expiries)."""
        return self.expired_admission + self.expired_dispatch

    # ---- queue -------------------------------------------------------
    def submit(self, table: str, rows: int, *, seed: int | None = None,
               hard: bool = True, conditional: bool = False,
               deadline: float | None = None) -> int:
        """Enqueue a request; returns its id (also its seed when ``seed``
        is None).  Validates table, device and bucket now, so bad requests
        fail at submit.  With ``max_queue`` set, a full queue raises
        :class:`ServerOverloaded`.  ``deadline`` (seconds from now on the
        server's clock) makes the request droppable once it passes."""
        if self.max_queue is not None and len(self) >= self.max_queue:
            self.rejected_overload += 1
            raise ServerOverloaded(
                f"queue depth {len(self)} >= max_queue "
                f"{self.max_queue}; retry later")
        entry = self.registry.get(table)
        if entry.device != self.device:
            raise ValueError(f"table {table!r} lives on {entry.device}, the "
                             f"server on {self.device}")
        bucket = entry.ladder.bucket_for(rows)     # raises RequestTooLarge
        if conditional and entry.tables is None:
            raise ValueError(f"table {table!r} registered without sampler "
                             "tables: conditional serving unavailable")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be positive, got {deadline}")
        rid = self._next_rid
        self._next_rid += 1
        deadline_at = None if deadline is None else self.clock() + deadline
        entry.size_histogram[int(rows)] += 1
        entry.offered_rows += int(rows)
        req = SynthesisRequest(rid, table, int(rows),
                               rid if seed is None else int(seed), hard,
                               conditional, deadline_at)
        if self._sched is not None:
            self._sched.push(table, (req, entry), bucket,
                             deadline_at=deadline_at)
        else:
            self._queue.append((req, entry, bucket))
        return rid

    def __len__(self) -> int:
        if self._sched is not None:
            return len(self._sched)
        return len(self._queue)

    # ---- pipeline stages ---------------------------------------------
    def _generate(self, req: SynthesisRequest, entry: TableEntry,
                  bucket: int) -> _Pending:
        """Stage 1: enqueue the sampler draws, the generator and the
        activation kernel at bucket size; returns without waiting."""
        combo = (entry.uid, bucket, req.hard, req.conditional)
        first_run = combo not in self._executed
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        if req.conditional:
            encoded = sample_synthetic_conditional(
                entry.gen, entry.cfg, entry.spans, entry.tables,
                entry.cond_dim, bucket, req.hard, generator=gen)
        else:
            encoded = sample_synthetic(
                entry.gen, entry.cfg, entry.spans, entry.cond_dim, bucket,
                req.hard, generator=gen)
        self._executed.add(combo)
        return _Pending(req, entry, bucket, encoded, first_run)

    def _finish(self, p: _Pending) -> SynthesisResponse:
        """Stage 2: decode (ONE kernel dispatch) and slice to the
        requested rows; the host waits here for this request."""
        with ops.dispatch_scope() as d:
            raw = p.entry.decode_plan.decode(p.encoded)
        decode_disp = ops.stage_dispatches(d, "vgm_decode_table")
        self.decode_dispatch_counts.append(decode_disp)
        if p.first_run:
            self.serving_compiles += 1
        else:
            self.cache_hits += 1
        p.entry.served_requests += 1
        p.entry.served_rows += p.req.rows
        # copy when sliced: a view would pin the whole bucket-sized buffer
        data = raw if p.req.rows == p.bucket else raw[:p.req.rows].copy()
        return SynthesisResponse(p.req.rid, p.req.table, p.req.rows,
                                 p.bucket, data, decode_disp,
                                 not p.first_run)

    # ---- serving ------------------------------------------------------
    def stream(self) -> Iterator[SynthesisResponse]:
        """Drain the queue, yielding responses as they finish: submission
        order with ``scheduler="fifo"``, dispatch-cycle order (FIFO within
        a tenant) with ``"continuous"``.  Submits made while consuming the
        iterator join the same drain."""
        if self._sched is not None:
            yield from self._stream_continuous()
        else:
            yield from self._stream_fifo()

    def _stream_fifo(self) -> Iterator[SynthesisResponse]:
        pending: _Pending | None = None
        while self._queue or pending is not None:
            nxt = None
            if self._queue:
                req, entry, bucket = self._queue.popleft()
                if (req.deadline_at is not None
                        and self.clock() > req.deadline_at):
                    self.expired_dispatch += 1
                    continue
                nxt = self._generate(req, entry, bucket)
                if not self.pipeline:
                    yield self._finish(nxt)
                    continue
            if pending is not None:
                yield self._finish(pending)
            pending = nxt

    def _stream_continuous(self) -> Iterator[SynthesisResponse]:
        """Assemble a dispatch cycle by DRR, drain it through the
        double-buffered pipeline, re-assemble.  Deadlines are checked at
        admission (``expired_admission``) and at dispatch
        (``expired_dispatch``)."""

        def count_admission_expiry(_adm):
            self.expired_admission += 1

        cycle: collections.deque = collections.deque()
        pending: _Pending | None = None
        while True:
            if not cycle:
                while not cycle and len(self._sched):
                    cycle.extend(self._sched.assemble(
                        now=self.clock(), on_expired=count_admission_expiry))
            if not cycle and pending is None:
                break
            nxt = None
            if cycle:
                adm = cycle.popleft()
                req, entry = adm.item
                if (req.deadline_at is not None
                        and self.clock() > req.deadline_at):
                    self.expired_dispatch += 1
                    continue
                nxt = self._generate(req, entry, adm.cost)
                if not self.pipeline:
                    yield self._finish(nxt)
                    continue
            if pending is not None:
                yield self._finish(pending)
            pending = nxt

    def serve(self) -> list[SynthesisResponse]:
        """Drain the whole queue; list of responses in serving order."""
        return list(self.stream())

    def warmup(self, *, names: list[str] | None = None,
               hard: bool | None = True, conditional: bool | None = None,
               force: bool = False) -> int:
        """Run every (tenant, bucket, mode) combination once, off the
        request path (the first call on the card builds the kernels
        here).  Returns the number of combinations run for the first
        time; after this a ladder-shaped trace in the warmed modes serves
        with zero ``serving_compiles``.  ``hard``/``conditional`` None
        warm every mode the tenant supports; ``force`` re-runs warm
        combinations."""
        built = 0
        for name in names if names is not None else self.registry.names():
            entry = self.registry.get(name)
            hard_modes, cond_modes = self._resolve_modes(name, entry, hard,
                                                         conditional)
            built += self._warm_buckets(name, entry, entry.ladder.buckets,
                                        hard_modes, cond_modes, force)
        self.warmup_compiles += built
        return built

    def _resolve_modes(self, name: str, entry: TableEntry,
                       hard: bool | None, conditional: bool | None
                       ) -> tuple[tuple[bool, ...], tuple[bool, ...]]:
        hard_modes = (False, True) if hard is None else (bool(hard),)
        has_cond = entry.tables is not None
        if conditional is None:
            cond_modes = (False, True) if has_cond else (False,)
        elif conditional:
            if not has_cond:
                raise ValueError(
                    f"table {name!r} registered without sampler "
                    "tables: conditional warmup is meaningless")
            cond_modes = (True,)
        else:
            cond_modes = (False,)
        return hard_modes, cond_modes

    def _warm_buckets(self, name: str, entry: TableEntry,
                      buckets: tuple[int, ...],
                      hard_modes: tuple[bool, ...],
                      cond_modes: tuple[bool, ...],
                      force: bool = False) -> int:
        """Run every (bucket, mode) combination once through both stages;
        returns how many ran for the first time."""
        built = 0
        for bucket in buckets:
            for h in hard_modes:
                for cond in cond_modes:
                    combo = (entry.uid, bucket, h, cond)
                    if combo in self._executed and not force:
                        continue
                    built += combo not in self._executed
                    req = SynthesisRequest(-1, name, bucket, 0, h, cond)
                    p = self._generate(req, entry, bucket)
                    p.entry.decode_plan.decode(p.encoded)
        return built

    def refit_ladder(self, table: str, *, sizes=None, min_bucket: int = 64,
                     hard: bool | None = True,
                     conditional: bool | None = None
                     ) -> BucketLadder | None:
        """Refit ``table``'s bucket ladder to its live size histogram (or
        ``sizes``), run the new rungs once off the request path, then swap
        the ladder in one assignment.  Returns None (and runs nothing)
        when the rungs would not change.  Requests already admitted keep
        the bucket they bound at submit."""
        entry = self.registry.get(table)
        observed = tuple(sizes) if sizes is not None \
            else entry.observed_sizes()
        candidate = ladder_from_sizes(observed, min_bucket=min_bucket)
        if candidate.buckets == entry.ladder.buckets:
            return None
        hard_modes, cond_modes = self._resolve_modes(table, entry, hard,
                                                     conditional)
        self.warmup_compiles += self._warm_buckets(
            table, entry, candidate.buckets, hard_modes, cond_modes)
        entry.ladder = candidate
        return candidate

    def stats(self) -> dict:
        """Serving counters: the zero-first-run-after-warmup and
        one-decode-dispatch-per-request contracts as numbers."""
        per_table = {
            name: {"requests": self.registry.get(name).served_requests,
                   "rows": self.registry.get(name).served_rows,
                   "offered_rows": self.registry.get(name).offered_rows}
            for name in self.registry.names()}
        return {
            "scheduler": self.scheduler,
            "requests": len(self.decode_dispatch_counts),
            "rows": sum(t["rows"] for t in per_table.values()),
            "warmup_compiles": self.warmup_compiles,
            "serving_compiles": self.serving_compiles,
            "cache_hits": self.cache_hits,
            "rejected_overload": self.rejected_overload,
            "expired": self.expired,
            "expired_admission": self.expired_admission,
            "expired_dispatch": self.expired_dispatch,
            "decode_dispatches": dict(collections.Counter(
                self.decode_dispatch_counts)),
            "tables": per_table,
        }
