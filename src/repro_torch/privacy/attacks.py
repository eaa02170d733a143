"""Adversarial probes against the recorded federation surface, the port's
copy of the JAX package's ``privacy/attacks.py``.

Two attack families, both run from a :class:`repro_torch.privacy.
RoundTrace` (nothing here touches client data the protocol did not
transmit):

**Membership inference**: the transmitted critic was trained to score the
client's REAL rows above everything else, so its score on a candidate row
is a membership signal (the loss-threshold form of Yeom et al.).
:func:`loss_threshold_mia` ranks member against holdout rows by the
transmitted critic's score, calibrated by the round-start global critic,
and reports the rank AUC; :func:`shadow_model_mia` transfers a threshold
from shadow (known non-member) rows; :func:`null_auc` is the control: two
disjoint non-member splits must score an AUC near 0.5.

**Update leakage**: each round transmits every client's post-local-
training model, all started from the same broadcast global, so the
per-client differences are local-data signal.
:func:`category_probe_scores` probes each client's critic with one
synthetic row per category; de-meaned across clients, the matrix tracks
which categories over-index on each client, and
:func:`dominant_category_hits` checks that claim against the true skews.
:func:`category_update_energy` is the naive first-layer delta-energy
readout kept as a baseline.  :func:`setup_marginals` and
:func:`vgm_client_moments` read the §4.1 statistics the protocol ships in
the clear.

Models are rebuilt from a trace's flat rows through the interop layout
map (:func:`repro_torch.interop.gan_flat_index`) into the port's modules
on the encoders' device.  Every encode of candidate rows is one
``vgm_encode_table`` launch on the card; its Gumbel noise is drawn from a
generator seeded 0 unless injected (``gumbel`` for one call,
``encode_gumbel(n) -> (n, Q_cont*Kmax)`` for the membership attacks), so
that the same rows always get the same encoding, as the reference's fixed
key gives.  Scores and AUCs are numpy on the host.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from scipy.stats import rankdata

from ..device import seeded_generator
from ..fed.merge import unflatten_merged
from ..gan.ctgan import init_discriminator, init_generator
from ..interop import flat_from_reference, gan_flat_index


class AttackError(ValueError):
    """An attack asked for a surface the trace doesn't carry (unknown
    column, empty score sets, no recorded rounds)."""


# ---------------------------------------------------------------------------
# scoring machinery
# ---------------------------------------------------------------------------

def attack_auc(member_scores, nonmember_scores) -> float:
    """Rank AUC of the membership scores: P(member score > non-member
    score), ties split.  0.5 = no signal, 1.0 = perfect separation."""
    pos = np.asarray(member_scores, np.float64).ravel()
    neg = np.asarray(nonmember_scores, np.float64).ravel()
    if pos.size == 0 or neg.size == 0:
        raise AttackError("attack_auc needs non-empty member AND "
                          "non-member score sets")
    ranks = rankdata(np.concatenate([pos, neg]))
    return float((ranks[:pos.size].sum() - pos.size * (pos.size + 1) / 2.0)
                 / (pos.size * neg.size))


def _models(flat_ref: np.ndarray, cfg, enc) -> dict:
    """Fresh port modules on the encoders' device holding the flat
    reference-layout parameters ``flat_ref`` (D,)."""
    dev = enc.device
    init = seeded_generator(dev, 0)        # overwritten below
    gen = init_generator(cfg, enc.cond_dim, enc.encoded_dim, generator=init,
                         device=dev)
    disc = init_discriminator(cfg, enc.cond_dim, enc.encoded_dim,
                              generator=init, device=dev)
    like = list(gen.parameters()) + list(disc.parameters())
    flat = torch.as_tensor(np.ascontiguousarray(flat_ref, np.float32),
                           device=dev)
    port = flat_from_reference(flat, gan_flat_index(gen, disc))
    with torch.no_grad():
        for p, v in zip(like, unflatten_merged(port, like), strict=True):
            p.copy_(v)
    return {"g": gen, "d": disc}


def client_params(trace, cfg, enc, *, client: int, index: int = -1) -> dict:
    """One client's transmitted generator and critic, ``{"g": Generator,
    "d": Discriminator}``, rebuilt from the recorded flat stack (the
    attacker's model surgery; the layout is architecture data, public to
    the federator)."""
    flat = np.asarray(trace.update_stack(index))
    if not 0 <= client < flat.shape[0]:
        raise AttackError(f"client {client} outside the trace's "
                          f"{flat.shape[0]} clients")
    return _models(flat[client], cfg, enc)


def global_params(trace, cfg, enc, *, index: int = -1) -> dict:
    """The broadcast global model every client STARTED the ``index``-th
    recorded round from (:meth:`RoundTrace.global_before`), as ``{"g",
    "d"}`` modules."""
    return _models(trace.global_before(index), cfg, enc)


@torch.no_grad()
def discriminator_scores(disc, rows: np.ndarray, enc, cfg, *,
                         gumbel: torch.Tensor | None = None) -> np.ndarray:
    """Transmitted-critic membership scores for raw ``rows``: encode through
    the victim's (public, §4.1-agreed) encoders, pair each row with ITS
    OWN conditional vector read off the encoding, replicate it ``pac``
    times so that every row forms one pack, and run the critic with
    dropout off.  Higher = "more real" under WGAN = more member-like.
    ``gumbel`` injects the encode's noise."""
    encoded = enc.encode(rows, gumbel=gumbel,
                         generator=seeded_generator(enc.device, 0))
    cond_spans = enc.condition_spans()
    cond = torch.cat([encoded[:, s.start:s.start + s.width]
                      for s in cond_spans], dim=1) if cond_spans else \
        encoded[:, :0]
    x = torch.cat([encoded, cond], dim=1)
    packed = x.repeat_interleave(cfg.pac, dim=0)     # each row = one pack
    return disc(packed, train=False).cpu().numpy()


def _round_indices(trace, rounds) -> list[int]:
    if trace.n_rounds == 0:
        raise AttackError("trace has no recorded rounds")
    if rounds is None:
        return list(range(trace.n_rounds))
    return [r % trace.n_rounds for r in rounds]


def _membership_scores(trace, cfg, enc, rows, *, client, idxs, calibrated,
                       encode_gumbel):
    """Mean over the rounds of the client critic's score for ``rows``,
    minus (when ``calibrated``) the round-start global critic's score on
    the same row: the difference isolates what THIS client's local
    training did for the row (difficulty calibration, Watson et al.)."""
    gumbel = None if encode_gumbel is None else encode_gumbel(len(rows))
    out = np.zeros(len(rows))
    for i in idxs:
        d_c = client_params(trace, cfg, enc, client=client, index=i)["d"]
        out += discriminator_scores(d_c, rows, enc, cfg, gumbel=gumbel)
        if calibrated:
            d_g = global_params(trace, cfg, enc, index=i)["d"]
            out -= discriminator_scores(d_g, rows, enc, cfg, gumbel=gumbel)
    return out / len(idxs)


# ---------------------------------------------------------------------------
# membership inference
# ---------------------------------------------------------------------------

def loss_threshold_mia(trace, cfg, enc, member_rows: np.ndarray,
                       holdout_rows: np.ndarray, *, client: int = 0,
                       rounds=None, calibrated: bool = True,
                       encode_gumbel: Callable | None = None) -> dict:
    """Loss-threshold membership inference against one client's
    transmitted critics: every candidate row scored by the client's
    post-local-training critic of each recorded round (all by default),
    calibrated against the round-start global critic unless
    ``calibrated=False``; the member-vs-holdout rank AUC (~0.5: the wire
    leaks no membership)."""
    idxs = _round_indices(trace, rounds)
    kw = dict(client=client, idxs=idxs, calibrated=calibrated,
              encode_gumbel=encode_gumbel)
    m = _membership_scores(trace, cfg, enc, member_rows, **kw)
    h = _membership_scores(trace, cfg, enc, holdout_rows, **kw)
    return {"auc": attack_auc(m, h), "member_scores": m,
            "holdout_scores": h, "rounds_used": idxs}


def null_auc(trace, cfg, enc, nonmember_rows: np.ndarray, *,
             client: int = 0, rounds=None, calibrated: bool = True,
             encode_gumbel: Callable | None = None) -> float:
    """Calibration control: the SAME scoring on two disjoint halves of
    known non-members.  An honest attack statistic sits near 0.5 here."""
    n = len(nonmember_rows) // 2
    if n < 2:
        raise AttackError("null_auc needs at least 4 non-member rows")
    res = loss_threshold_mia(trace, cfg, enc, nonmember_rows[:n],
                             nonmember_rows[n:2 * n], client=client,
                             rounds=rounds, calibrated=calibrated,
                             encode_gumbel=encode_gumbel)
    return res["auc"]


def shadow_model_mia(trace, cfg, enc, member_rows: np.ndarray,
                     holdout_rows: np.ndarray, shadow_rows: np.ndarray, *,
                     client: int = 0, rounds=None, calibrated: bool = True,
                     encode_gumbel: Callable | None = None) -> dict:
    """Shadow-calibrated membership inference: every candidate z-scored
    against the shadow (known non-member) rows' scores, membership claimed
    above z = 0.  The AUC equals the loss-threshold attack's (z-scoring is
    monotone); ``accuracy`` is the transferred threshold's."""
    idxs = _round_indices(trace, rounds)
    kw = dict(client=client, idxs=idxs, calibrated=calibrated,
              encode_gumbel=encode_gumbel)
    m = _membership_scores(trace, cfg, enc, member_rows, **kw)
    h = _membership_scores(trace, cfg, enc, holdout_rows, **kw)
    s = _membership_scores(trace, cfg, enc, shadow_rows, **kw)
    mu, sd = float(s.mean()), float(s.std() + 1e-12)
    zm, zh = (m - mu) / sd, (h - mu) / sd
    acc = 0.5 * (float((zm > 0).mean()) + float((zh <= 0).mean()))
    return {"auc": attack_auc(zm, zh), "accuracy": acc,
            "threshold": mu, "member_z": zm, "holdout_z": zh}


# ---------------------------------------------------------------------------
# update leakage
# ---------------------------------------------------------------------------

def _categorical_span(enc, column: int):
    """The encoded span + conditional-vector offset of a categorical
    column (every categorical span is condition-eligible)."""
    cond_off = 0
    for s in enc.condition_spans():
        if s.column == column and s.activation == "softmax":
            return s, cond_off
        cond_off += s.width
    raise AttackError(f"column {column} has no categorical span")


def category_update_energy(trace, cfg, enc, *, column: int, client: int = 0,
                           index: int = -1) -> np.ndarray:
    """Per-category energy of one client's transmitted update (its delta
    from :meth:`RoundTrace.global_before`) in the first-layer rows a
    category's one-hot drives: the ``pac`` data and cond-copy rows of the
    critic's first layer and the cond row of the generator's first block,
    summed per category and normalized to a distribution."""
    delta = (np.asarray(trace.update_stack(index)[client], np.float64)
             - np.asarray(trace.global_before(index), np.float64))
    models = _models(delta.astype(np.float32), cfg, enc)
    span, cond_off = _categorical_span(enc, column)
    feat = enc.encoded_dim + enc.cond_dim
    # the reference's (fan_in, fan_out) layout: one row per input
    d_fc0 = models["d"].fc[0].weight.detach().T.double().cpu().numpy()
    g_fc0 = models["g"].res[0].fc.weight.detach().T.double().cpu().numpy()
    energy = np.zeros(span.width)
    for c in range(span.width):
        for slot in range(cfg.pac):
            base = slot * feat
            energy[c] += np.square(d_fc0[base + span.start + c]).sum()
            energy[c] += np.square(
                d_fc0[base + enc.encoded_dim + cond_off + c]).sum()
        energy[c] += np.square(g_fc0[cfg.z_dim + cond_off + c]).sum()
    total = energy.sum()
    return energy / total if total > 0 else energy


@torch.no_grad()
def category_probe_scores(trace, cfg, enc, *, column: int,
                          rounds=None) -> np.ndarray:
    """(P, C) critic probe matrix for one categorical column: each
    client's transmitted critic (dropout off, averaged over the recorded
    rounds) scores, for every category, a synthetic pack of the
    category's one-hot in the data span AND its conditional copy, zeros
    elsewhere.  The C probe packs of a critic run in one call."""
    span, cond_off = _categorical_span(enc, column)
    idxs = _round_indices(trace, rounds)
    probes = torch.zeros((span.width, enc.encoded_dim + enc.cond_dim),
                         device=enc.device)
    cats = torch.arange(span.width, device=enc.device)
    probes[cats, span.start + cats] = 1.0
    probes[cats, enc.encoded_dim + cond_off + cats] = 1.0
    packs = probes.repeat_interleave(cfg.pac, dim=0)
    P = trace.n_clients
    S = np.zeros((P, span.width))
    for i in idxs:
        for p in range(P):
            d = client_params(trace, cfg, enc, client=p, index=i)["d"]
            S[p] += d(packs, train=False).double().cpu().numpy()
    return S / len(idxs)


def dominant_category_hits(trace, cfg, enc, *, rounds=None) -> dict:
    """For every (client, categorical column), predict the category that
    OVER-indexes on that client (argmax of the de-meaned probe matrix)
    and check it against the true skew (argmax of the client's §4.1
    marginal minus the federation mean).  Returns the hit rate and, per
    column, the predictions, the truths and the de-meaned scores."""
    cols = sorted(trace.cat_freqs)
    if not cols:
        raise AttackError("trace carries no categorical setup stats")
    hits, total, detail = 0, 0, {}
    for j in cols:
        S = category_probe_scores(trace, cfg, enc, column=j, rounds=rounds)
        rel = S - S.mean(axis=0, keepdims=True)
        freqs = np.asarray(trace.cat_freqs[j], np.float64)
        rel_true = freqs - freqs.mean(axis=0, keepdims=True)
        pred = np.argmax(rel, axis=1)
        true = np.argmax(rel_true, axis=1)
        hits += int((pred == true).sum())
        total += pred.size
        detail[j] = {"predicted": pred, "true": true, "rel_scores": rel}
    return {"hit_rate": hits / total, "columns": detail}


# ---------------------------------------------------------------------------
# setup-statistic leakage (§4.1, transmitted in the clear)
# ---------------------------------------------------------------------------

def setup_marginals(trace, column: int) -> np.ndarray:
    """The per-client categorical marginal of ``column``, read straight
    off the setup-time transmission: (P, C), rows summing to 1.  Untouched
    by update DP."""
    if column not in trace.cat_freqs:
        raise AttackError(f"no categorical setup stats for column {column}")
    return np.asarray(trace.cat_freqs[column], np.float64)


def vgm_client_moments(trace, column: int) -> dict:
    """Each client's continuous-column mean and std, from the transmitted
    VGM mixture (mean = sum w_k mu_k; variance from the mixture's second
    moment)."""
    if column not in trace.vgm_means:
        raise AttackError(f"no VGM setup stats for column {column}")
    mu = np.asarray(trace.vgm_means[column], np.float64)     # (P, K)
    sd = np.asarray(trace.vgm_stds[column], np.float64)
    w = np.asarray(trace.vgm_weights[column], np.float64)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    mean = (w * mu).sum(axis=1)
    second = (w * (sd ** 2 + mu ** 2)).sum(axis=1)
    var = np.maximum(second - mean ** 2, 0.0)
    return {"mean": mean, "std": np.sqrt(var)}


def leakage_report(trace, cfg, enc, *, client: int = 0,
                   rounds=None) -> dict:
    """Everything the wire gave away about one client: the probe
    reconstruction's hit rate over all clients and columns, the exact
    setup-time categorical marginals, and the reconstructed continuous
    moments."""
    rep = {"client": client,
           "update": dominant_category_hits(trace, cfg, enc, rounds=rounds)}
    rep["setup_marginals"] = {j: setup_marginals(trace, j)[client]
                              for j in sorted(trace.cat_freqs)}
    rep["setup_moments"] = {
        j: {k: float(v[client]) for k, v in
            vgm_client_moments(trace, j).items()}
        for j in sorted(trace.vgm_means)}
    return rep
