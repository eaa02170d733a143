"""CTGAN's training-by-sampling index and sampler (host side, numpy), the
port's own copy of the JAX package's ``gan/sampler.py``.

Indexes encoded rows by (condition span, category): per span a CSR index
of the rows sorted stably by their category and the cumulative
log-frequency table of the categories.  :class:`repro_torch.synth.sampler.
DeviceSampler` moves these tables to the card and draws from them there.

The host draws are the presampled baseline the device sampler replaced:
``sample`` (one vectorized numpy pass), ``sample_loop`` (the per-row
distribution oracle) and ``presample_rounds`` (whole ``rounds x steps x
batch`` stacks for :func:`repro_torch.gan.trainer.make_round_batches`).
They are numpy on both sides, so a seed draws the reference's arrays
exactly.
"""
from __future__ import annotations

import numpy as np

from ..tabular.encoders import SpanInfo, TableEncoders


class ConditionalSampler:
    def __init__(self, encoded: np.ndarray, encoders: TableEncoders,
                 seed: int = 0):
        self.encoded = np.asarray(encoded, np.float32)
        self.spans: list[SpanInfo] = encoders.condition_spans()
        self.cond_dim = sum(s.width for s in self.spans)
        self.n_spans = len(self.spans)
        self.rng = np.random.default_rng(seed)
        N = self.encoded.shape[0]

        # Per span: rows CSR-indexed by argmax category, log-frequency probs.
        self._widths = np.array([s.width for s in self.spans], np.int64)
        cmax = int(self._widths.max()) if self.n_spans else 0
        self._counts = np.zeros((self.n_spans, cmax), np.int64)
        self._starts = np.zeros((self.n_spans, cmax + 1), np.int64)
        self._order = np.empty((self.n_spans, N), np.int64)
        self.cat_logfreq: list[np.ndarray] = []
        for si, s in enumerate(self.spans):
            cat = self.encoded[:, s.start:s.start + s.width].argmax(axis=1)
            self._counts[si, :s.width] = np.bincount(cat, minlength=s.width)
            self._starts[si, 1:] = np.cumsum(self._counts[si])
            self._order[si] = np.argsort(cat, kind="stable")
            logf = np.log(self._counts[si, :s.width] + 1.0)
            self.cat_logfreq.append(logf / max(logf.sum(), 1e-12))
        probs = np.zeros((self.n_spans, cmax), np.float64)
        for si, p in enumerate(self.cat_logfreq):
            probs[si, :len(p)] = p
        self._cum = np.cumsum(probs, axis=1)
        self._fallback = np.zeros(self.n_spans, np.int64)
        if self.n_spans:
            self._cum[:, -1] = 1.0           # guard fp drift at the tail
            self._fallback = self._counts.argmax(axis=1)

        self._span_offsets = np.cumsum([0] + [s.width for s in self.spans])

    def sample(self, batch: int):
        """Returns (cond, mask, real_rows):
          cond (B, cond_dim) float32, mask (B, n_spans) float32,
          real (B, data_dim) float32 rows consistent with cond.

        One vectorized pass: uniform span pick, inverse-CDF category pick
        from the log-frequency table, uniform row pick within the
        (span, category) CSR bucket."""
        span_ids = self.rng.integers(self.n_spans, size=batch)
        u = self.rng.random(batch)
        cum = self._cum[span_ids]                          # (B, Cmax)
        c = (cum < u[:, None]).sum(axis=1)
        c = np.minimum(c, self._widths[span_ids] - 1)
        # guard empty category (possible on tiny client shards)
        cnt = self._counts[span_ids, c]
        c = np.where(cnt == 0, self._fallback[span_ids], c)
        cnt = self._counts[span_ids, c]
        pos = (self.rng.random(batch) * cnt).astype(np.int64)
        pos = np.minimum(pos, np.maximum(cnt - 1, 0))
        rows = self._order[span_ids, self._starts[span_ids, c] + pos]

        b = np.arange(batch)
        cond = np.zeros((batch, self.cond_dim), np.float32)
        cond[b, self._span_offsets[span_ids] + c] = 1.0
        mask = np.zeros((batch, self.n_spans), np.float32)
        mask[b, span_ids] = 1.0
        return cond, mask, self.encoded[rows]

    def sample_loop(self, batch: int):
        """The per-row implementation: the distribution oracle for
        :meth:`sample` and the benchmark baseline."""
        cond = np.zeros((batch, self.cond_dim), np.float32)
        mask = np.zeros((batch, self.n_spans), np.float32)
        rows = np.empty(batch, np.int64)
        span_ids = self.rng.integers(self.n_spans, size=batch)
        for i, si in enumerate(span_ids):
            probs = self.cat_logfreq[si]
            c = self.rng.choice(len(probs), p=probs)
            cnt = self._counts[si, c]
            if cnt == 0:
                c = int(self._fallback[si])
                cnt = self._counts[si, c]
            r = self.rng.integers(cnt)
            rows[i] = self._order[si, self._starts[si, c] + r]
            cond[i, self._span_offsets[si] + c] = 1.0
            mask[i, si] = 1.0
        return cond, mask, self.encoded[rows]

    def sample_uniform_rows(self, batch: int) -> np.ndarray:
        idx = self.rng.integers(self.encoded.shape[0], size=batch)
        return self.encoded[idx]

    def presample_rounds(self, rounds: int, steps_per_round: int, batch: int):
        """(rounds, steps, batch, ...) arrays of every draw of a run, in ONE
        vectorized :meth:`sample` pass."""
        total = rounds * steps_per_round * batch
        cond, mask, real = self.sample(total)

        def pack(a):
            return a.reshape(rounds, steps_per_round, batch, *a.shape[1:])
        return pack(cond), pack(mask), pack(real)
