"""CTGAN's training-by-sampling index (host side, numpy), the port's own
copy of the JAX package's ``gan/sampler.py``.

Indexes encoded rows by (condition span, category): per span a CSR index
of the rows sorted stably by their category and the cumulative
log-frequency table of the categories.  :class:`repro_torch.synth.sampler.
DeviceSampler` moves these tables to the card and draws from them there.
"""
from __future__ import annotations

import numpy as np

from ..tabular.encoders import SpanInfo, TableEncoders


class ConditionalSampler:
    def __init__(self, encoded: np.ndarray, encoders: TableEncoders):
        self.encoded = np.asarray(encoded, np.float32)
        self.spans: list[SpanInfo] = encoders.condition_spans()
        self.cond_dim = sum(s.width for s in self.spans)
        self.n_spans = len(self.spans)
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
