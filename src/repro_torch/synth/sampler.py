"""Device-resident conditional sampler (CTGAN training-by-sampling).

Moves :class:`repro_torch.gan.sampler.ConditionalSampler`'s tables (the
per-span cumulative log-frequency CDFs and the CSR row index) onto the
device as :class:`SamplerTables` and draws (cond, mask, real-row) batches
there: a uniform span pick, an inverse-CDF category pick and a uniform row
pick within the (span, category) bucket, as the JAX package's
``synth/sampler.py`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..gan.sampler import ConditionalSampler
from ..tabular.encoders import TableEncoders


class SamplerTables(NamedTuple):
    """Shapes: ``encoded (N, D)``, ``cum/counts (n_spans, Cmax)``,
    ``starts (n_spans, Cmax+1)``, ``order (n_spans, N)``,
    ``widths/fallback/offsets (n_spans,)``."""
    encoded: torch.Tensor
    cum: torch.Tensor
    counts: torch.Tensor
    starts: torch.Tensor
    order: torch.Tensor
    widths: torch.Tensor
    fallback: torch.Tensor
    offsets: torch.Tensor


class SamplerDraws(NamedTuple):
    """The random inputs of one :func:`draw_batch`: ``span_ids`` (B,) int in
    ``[0, n_spans)``, ``u_cat`` and ``u_row`` (B,) float32 in [0, 1)."""
    span_ids: torch.Tensor
    u_cat: torch.Tensor
    u_row: torch.Tensor


def draw_conditions(tables: SamplerTables, batch: int, cond_dim: int, *,
                    generator: torch.Generator | None = None,
                    draws: SamplerDraws | None = None):
    """One batch of condition vectors, entirely on the tables' device.
    ``draws`` injects the random inputs; when not given they are drawn
    from ``generator`` (span ids, then category uniforms, then row
    uniforms).  Returns (cond (B, cond_dim), mask (B, n_spans), the
    matching real rows' indices (B,))."""
    dev = tables.cum.device
    n_spans = tables.cum.shape[0]
    if draws is None:
        draws = SamplerDraws(
            torch.randint(0, n_spans, (batch,), generator=generator, device=dev),
            torch.rand(batch, generator=generator, device=dev),
            torch.rand(batch, generator=generator, device=dev))
    span_ids = draws.span_ids.to(dev, torch.int64)
    u = draws.u_cat.to(dev, torch.float32)
    c = torch.sum(tables.cum[span_ids] < u[:, None], dim=1)
    c = torch.minimum(c, tables.widths[span_ids] - 1)
    # guard empty category (possible on tiny client shards)
    cnt = tables.counts[span_ids, c]
    c = torch.where(cnt == 0, tables.fallback[span_ids], c)
    cnt = tables.counts[span_ids, c]
    pos = (draws.u_row.to(dev, torch.float32) * cnt.float()).long()
    pos = torch.minimum(pos, torch.clamp(cnt - 1, min=0))
    rows = tables.order[span_ids, tables.starts[span_ids, c] + pos]

    cond_pos = tables.offsets[span_ids] + c
    cond = (torch.arange(cond_dim, device=dev)[None, :]
            == cond_pos[:, None]).float()
    mask = (torch.arange(n_spans, device=dev)[None, :]
            == span_ids[:, None]).float()
    return cond, mask, rows


def draw_batch(tables: SamplerTables, batch: int, cond_dim: int, *,
               generator: torch.Generator | None = None,
               draws: SamplerDraws | None = None):
    """:func:`draw_conditions` plus the real rows: (cond (B, cond_dim),
    mask (B, n_spans), real (B, D))."""
    cond, mask, rows = draw_conditions(tables, batch, cond_dim,
                                       generator=generator, draws=draws)
    return cond, mask, tables.encoded[rows]


class DeviceSampler:
    """Builds :class:`SamplerTables` on ``device`` from encoded rows and the
    table's encoders (one numpy pass on the host)."""

    def __init__(self, encoded: np.ndarray, encoders: TableEncoders,
                 device: torch.device | str):
        host = ConditionalSampler(np.asarray(encoded), encoders)

        def dev(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)
        self.tables = SamplerTables(
            encoded=dev(host.encoded, torch.float32),
            cum=dev(host._cum, torch.float32),
            counts=dev(host._counts, torch.int64),
            starts=dev(host._starts, torch.int64),
            order=dev(host._order, torch.int64),
            widths=dev(host._widths, torch.int64),
            fallback=dev(host._fallback, torch.int64),
            offsets=dev(host._span_offsets[:-1], torch.int64))



def stack_sampler_tables(samplers: Sequence[DeviceSampler]) -> SamplerTables:
    """Per-client tables stacked on a leading client axis (the reference's
    vmap-ready layout, the input of the presampled baseline's benchmark).
    Clients with fewer rows are zero-padded to the largest N; padded rows
    are unreachable (the CSR starts and counts address real rows only),
    so a draw from row p of the stack equals the draw from client p's own
    tables."""
    n_max = max(int(s.tables.encoded.shape[0]) for s in samplers)

    def pad(t: SamplerTables) -> SamplerTables:
        n = int(t.encoded.shape[0])
        return t._replace(
            encoded=torch.nn.functional.pad(t.encoded, (0, 0, 0, n_max - n)),
            order=torch.nn.functional.pad(t.order, (0, n_max - n)))

    padded = [pad(s.tables) for s in samplers]
    return SamplerTables(*(torch.stack(xs) for xs in zip(*padded)))
