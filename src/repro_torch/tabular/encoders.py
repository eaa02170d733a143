"""Column encoders and the table-wide encode/decode plans.

A table schema is a list of :class:`ColumnSpec`.  Categorical columns use
one-hot label encoders; continuous columns the VGM mode-specific
normalization of :mod:`repro_torch.tabular.vgm`.  The encoded row is the
CTGAN layout: per continuous column ``[alpha, beta_1..beta_K]`` (tanh +
softmax activations), per categorical column ``[d_1..d_C]`` (softmax).

:class:`EncodePlan` encodes all continuous columns in ONE
``vgm_encode_table`` dispatch; :class:`DecodePlan` decodes them in ONE
``vgm_decode_table`` dispatch.  Categorical ranks stay float64
``searchsorted`` on the host: float32 would merge category ids of 2**24
and above.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import NEG_INF
from .vgm import VGMParams, fit_vgm, kernel_log_weights, pack_vgm_params


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str                      # "categorical" | "continuous"
    n_categories: int = 0          # categorical only (global, post-union)
    max_modes: int = 10            # continuous only


@dataclasses.dataclass(frozen=True)
class SpanInfo:
    """Activation span in the encoded row."""
    start: int
    width: int
    activation: str                # "tanh" | "softmax"
    column: int                    # index into schema
    is_condition: bool             # eligible for the conditional vector


@dataclasses.dataclass
class LabelEncoder:
    """Maps raw category ids to their global one-hot rank (sorted order of
    the union of ids, Fed-TGAN §4.1)."""
    categories: np.ndarray         # (C,) sorted raw ids

    @property
    def n(self) -> int:
        return int(self.categories.shape[0])


@dataclasses.dataclass
class TableEncoders:
    """Global encoders for one table; VGM params live on ``device``."""
    schema: list[ColumnSpec]
    label_encoders: dict[int, LabelEncoder]    # by column index
    vgms: dict[int, VGMParams]                 # by column index
    device: torch.device

    def spans(self) -> list[SpanInfo]:
        out, pos = [], 0
        for j, col in enumerate(self.schema):
            if col.kind == "continuous":
                out.append(SpanInfo(pos, 1, "tanh", j, False))
                pos += 1
                k = int(self.vgms[j].means.shape[0])
                out.append(SpanInfo(pos, k, "softmax", j, True))
                pos += k
            else:
                c = self.label_encoders[j].n
                out.append(SpanInfo(pos, c, "softmax", j, True))
                pos += c
        return out

    @property
    def encoded_dim(self) -> int:
        s = self.spans()
        return s[-1].start + s[-1].width if s else 0

    def condition_spans(self) -> list[SpanInfo]:
        """Spans eligible for CTGAN's conditional vector (categorical
        one-hots and continuous mode indicators)."""
        return [s for s in self.spans() if s.is_condition]

    @property
    def cond_dim(self) -> int:
        return sum(s.width for s in self.condition_spans())

    def plan(self) -> "EncodePlan":
        """The one-dispatch encode plan (built once, then cached)."""
        p = getattr(self, "_plan", None)
        if p is None:
            p = self._plan = make_encode_plan(self)
        return p

    def decode_plan(self) -> "DecodePlan":
        """The one-dispatch decode plan (built once, then cached)."""
        p = getattr(self, "_decode_plan", None)
        if p is None:
            p = self._decode_plan = make_decode_plan(self)
        return p

    def encode(self, table: np.ndarray, *, gumbel: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """(N, Q) raw table -> (N, encoded_dim) on ``device``; see
        :meth:`EncodePlan.encode`."""
        return self.plan().encode(table, gumbel=gumbel, generator=generator)

    def decode(self, encoded: torch.Tensor) -> np.ndarray:
        """(N, encoded_dim) activations -> (N, Q) float64 raw table."""
        return self.decode_plan().decode(encoded)

    def encode_loop(self, table: np.ndarray, *,
                    gumbel: torch.Tensor | None = None,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
        """The per-column path, kept as the oracle of :meth:`encode`: one
        ``vgm_encode`` dispatch per continuous column, one one-hot per
        categorical column, concatenated.  ``gumbel`` and ``generator``
        are :meth:`EncodePlan.encode`'s (column q reads its lanes ``[q*Kmax,
        q*Kmax + K_q)``), so the two paths agree exactly."""
        plan = self.plan()
        table = np.asarray(table)
        n, dev = table.shape[0], self.device
        if gumbel is None and plan.cont_cols:
            gumbel = plan.draw_gumbel(n, generator)
        parts, q = [], 0
        for j, col in enumerate(self.schema):
            if col.kind == "continuous":
                p = self.vgms[j]
                k = int(p.means.shape[0])
                x = torch.as_tensor(np.ascontiguousarray(table[:, j]),
                                    dtype=torch.float32, device=dev)
                g = gumbel[:, q * plan.kmax:q * plan.kmax + k].to(
                    dev, torch.float32).contiguous()
                alpha, beta = ops.vgm_encode(x, p.means.float(),
                                             p.stds.float(),
                                             kernel_log_weights(p), g)
                parts += [alpha[:, None], beta]
                q += 1
            else:
                cats = self.label_encoders[j].categories
                ranks = torch.as_tensor(np.searchsorted(cats, table[:, j]),
                                        device=dev)
                parts.append(torch.nn.functional.one_hot(
                    ranks, len(cats)).float())
        return torch.cat(parts, dim=1)


def _cont_cat(schema):
    cont = tuple(j for j, c in enumerate(schema) if c.kind == "continuous")
    cat = tuple(j for j, c in enumerate(schema) if c.kind == "categorical")
    return cont, cat


@dataclasses.dataclass
class EncodePlan:
    """Table-wide encode derived once from a :class:`TableEncoders`: packed
    mode params, the categorical one-hot tables and the gather into the
    final row layout, all on ``device``.  Each encode is one host
    ``searchsorted`` pass, one ``vgm_encode_table`` dispatch and one
    gather."""
    cont_cols: tuple[int, ...]
    cat_cols: tuple[int, ...]
    kmax: int
    means: torch.Tensor                # (Q_cont, Kmax) packed
    stds: torch.Tensor
    logw: torch.Tensor                 # -1e30 padding
    cat_categories: list[np.ndarray]
    pos_cat_col: torch.Tensor          # (sum C,) categorical column
    pos_cat_rank: torch.Tensor         # (sum C,) rank within it
    perm: torch.Tensor                 # (encoded_dim,) final-layout gather
    device: torch.device

    def cat_ranks(self, table: np.ndarray) -> np.ndarray:
        """(n, Q_cat) int ranks, float64 ``searchsorted`` on the host."""
        if not self.cat_cols:
            return np.zeros((table.shape[0], 0), np.int64)
        return np.stack([np.searchsorted(self.cat_categories[q], table[:, j])
                         for q, j in enumerate(self.cat_cols)], axis=1)

    def draw_gumbel(self, n: int,
                    generator: torch.Generator | None) -> torch.Tensor:
        """Packed ``(n, Q_cont*Kmax)`` standard Gumbel noise on ``device``."""
        u = torch.rand((n, len(self.cont_cols) * self.kmax),
                       generator=generator, device=self.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def encode(self, table: np.ndarray, *, gumbel: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Encode a raw (n, Q) table.  ``gumbel`` is the packed
        ``(n, Q_cont*Kmax)`` noise (column q at lanes ``[q*Kmax,
        (q+1)*Kmax)``; padded lanes are never selected); when not given it
        is drawn from ``generator`` on ``device``."""
        table = np.asarray(table)
        n = table.shape[0]
        dev = self.device
        ranks = torch.as_tensor(self.cat_ranks(table), device=dev)
        if self.cont_cols:
            x = torch.as_tensor(
                np.ascontiguousarray(table[:, list(self.cont_cols)]),
                dtype=torch.float32, device=dev)
            if gumbel is None:
                gumbel = self.draw_gumbel(n, generator)
            slots = ops.vgm_encode_table(
                x, self.means, self.stds, self.logw,
                gumbel.to(dev, torch.float32).contiguous())
        else:
            slots = torch.zeros((n, 0), device=dev)
        onehot = (ranks[:, self.pos_cat_col]
                  == self.pos_cat_rank[None, :]).float()
        return torch.cat([slots, onehot], dim=1).index_select(1, self.perm)


def make_encode_plan(enc: TableEncoders) -> EncodePlan:
    """Build the encode plan from fitted per-column encoders."""
    cont_cols, cat_cols = _cont_cat(enc.schema)
    vgms = [enc.vgms[j] for j in cont_cols]
    col_modes = [int(p.means.shape[0]) for p in vgms]
    kmax = max(col_modes, default=0)
    slot = 1 + kmax                                  # [alpha, beta_0..)
    means, stds, logw = pack_vgm_params(vgms, kmax, device=enc.device)

    cat_widths = [enc.label_encoders[j].n for j in cat_cols]
    pos_cat_col = np.concatenate(
        [np.full(w, q) for q, w in enumerate(cat_widths)] + [np.zeros(0)])
    pos_cat_rank = np.concatenate(
        [np.arange(w) for w in cat_widths] + [np.zeros(0)])

    # encoded position -> index into [cont slots | categorical one-hots]
    n_slot = len(cont_cols) * slot
    perm, cont_seen, cat_seen = [], 0, 0
    for j, col in enumerate(enc.schema):
        if col.kind == "continuous":
            base = cont_seen * slot
            perm.extend([base] + [base + 1 + m for m in range(col_modes[cont_seen])])
            cont_seen += 1
        else:
            w = enc.label_encoders[j].n
            perm.extend(range(n_slot + cat_seen, n_slot + cat_seen + w))
            cat_seen += w
    if len(perm) != enc.encoded_dim:
        raise AssertionError("encode plan does not cover the encoded row")

    def dev_long(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=enc.device)
    return EncodePlan(
        cont_cols=cont_cols, cat_cols=cat_cols, kmax=kmax,
        means=means, stds=stds, logw=logw,
        cat_categories=[enc.label_encoders[j].categories for j in cat_cols],
        pos_cat_col=dev_long(pos_cat_col), pos_cat_rank=dev_long(pos_cat_rank),
        perm=dev_long(perm), device=enc.device)


@dataclasses.dataclass
class DecodePlan:
    """Table-wide decode, the inverse of :class:`EncodePlan`.  Each decode
    is one gather into the packed ``(Q_cont, 1+Kmax)`` slots (-1e30 beta
    padding) plus one argmax over all categorical spans, ONE
    ``vgm_decode_table`` dispatch, and one host lookup of the raw ids."""
    schema: list[ColumnSpec]
    cont_cols: tuple[int, ...]
    cat_cols: tuple[int, ...]
    means: torch.Tensor                # (Q_cont, Kmax) packed
    stds: torch.Tensor
    src: torch.Tensor                  # (Q_cont*(1+Kmax),) slot gather
    pad: torch.Tensor                  # (Q_cont*(1+Kmax),) padded beta lanes
    cat_src: torch.Tensor              # (Q_cat*Cmax,) categorical gather
    cat_pad: torch.Tensor              # (Q_cat, Cmax)
    cat_table: np.ndarray              # (Q_cat, Cmax) raw ids, float64

    def decode(self, encoded: torch.Tensor) -> np.ndarray:
        """(n, encoded_dim) on the plan's device -> (n, Q) float64 numpy.
        The two ``.cpu()`` copies at the end are where the host waits."""
        n = encoded.shape[0]
        enc_f = encoded.float()
        out = np.empty((n, len(self.schema)), np.float64)
        ranks = None
        if self.cat_cols:
            seg = enc_f.index_select(1, self.cat_src).reshape(
                n, len(self.cat_cols), -1)
            ranks = torch.argmax(torch.where(self.cat_pad[None], NEG_INF, seg),
                                 dim=2)
        if self.cont_cols:
            slots = torch.where(self.pad[None], NEG_INF,
                                enc_f.index_select(1, self.src))
            x = ops.vgm_decode_table(slots, self.means, self.stds)
            out[:, list(self.cont_cols)] = x.cpu().numpy()
        if ranks is not None:
            out[:, list(self.cat_cols)] = self.cat_table[
                np.arange(len(self.cat_cols))[None, :], ranks.cpu().numpy()]
        return out


def make_decode_plan(enc: TableEncoders) -> DecodePlan:
    """Build the decode plan from fitted per-column encoders."""
    cont_cols, cat_cols = _cont_cat(enc.schema)
    vgms = [enc.vgms[j] for j in cont_cols]
    col_modes = [int(p.means.shape[0]) for p in vgms]
    kmax = max(col_modes, default=0)
    slot = 1 + kmax
    means, stds, _ = pack_vgm_params(vgms, kmax, device=enc.device)

    spans = enc.spans()
    alpha_start = {s.column: s.start for s in spans if s.activation == "tanh"}
    span_of = {s.column: s for s in spans if s.activation == "softmax"}
    src = np.zeros(len(cont_cols) * slot, np.int64)
    pad = np.zeros(len(cont_cols) * slot, bool)
    for q, j in enumerate(cont_cols):
        base, k = q * slot, col_modes[q]
        src[base] = alpha_start[j]
        src[base + 1:base + 1 + k] = span_of[j].start + np.arange(k)
        pad[base + 1 + k:base + slot] = True

    cat_widths = [enc.label_encoders[j].n for j in cat_cols]
    cmax = max(cat_widths, default=0)
    cat_src = np.zeros((len(cat_cols), cmax), np.int64)
    cat_pad = np.zeros((len(cat_cols), cmax), bool)
    cat_table = np.zeros((len(cat_cols), cmax), np.float64)
    for q, j in enumerate(cat_cols):
        w = cat_widths[q]
        cat_src[q, :w] = span_of[j].start + np.arange(w)
        cat_pad[q, w:] = True
        cat_table[q, :w] = enc.label_encoders[j].categories

    dev = enc.device
    return DecodePlan(
        schema=list(enc.schema), cont_cols=cont_cols, cat_cols=cat_cols,
        means=means, stds=stds,
        src=torch.as_tensor(src, device=dev),
        pad=torch.as_tensor(pad, device=dev),
        cat_src=torch.as_tensor(cat_src.reshape(-1), device=dev),
        cat_pad=torch.as_tensor(cat_pad, device=dev), cat_table=cat_table)


def fit_centralized_encoders(table: np.ndarray, schema: Sequence[ColumnSpec],
                             *, jitters: dict[int, torch.Tensor] | None = None,
                             generator: torch.Generator | None = None,
                             device: torch.device | str = "cuda"
                             ) -> TableEncoders:
    """Fit all encoders on pooled data, the VGMs on ``device``.
    ``jitters[j]`` is column ``j``'s injected :func:`fit_vgm` jitter;
    columns without one draw it from ``generator``."""
    dev = resolve_device(device)
    les, vgms = {}, {}
    for j, col in enumerate(schema):
        if col.kind == "categorical":
            les[j] = LabelEncoder(np.unique(np.asarray(table[:, j])))
        else:
            x = torch.as_tensor(np.asarray(table[:, j]), dtype=torch.float32,
                                device=dev)
            vgms[j] = fit_vgm(x, max_modes=col.max_modes,
                              jitter=None if jitters is None else jitters.get(j),
                              generator=generator)
    return TableEncoders(list(schema), les, vgms, dev)
