"""Plain reference of the Fed-TGAN set-up (§4.1 and §4.2), torch and
numpy only, float32 as the paper's model.

From the raw client tables and the run's seed it works out again what
the program's set-up derives: each client's category frequencies and
VGMs, the federator's label encoders and global VGMs, the divergence
matrix and the §4.2 weights, each client's encoded rows and its
training-by-sampling tables.  It follows the program's documented
seeding: every random stream of a federation's set-up is a
``torch.Generator`` seeded from ``SeedSequence([seed, stream, index])``,
with the streams numbered as below; within a stream the draws come in the
order the set-up's documentation gives.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# the set-up's streams: client statistics, encoder init, weights, model,
# encode, client generators
STATS, INIT, WEIGHTS, MODEL, ENCODE, CLIENT_RNG = range(6)
NEG_INF = -1e30
_LOG2PI = math.log(2.0 * math.pi)


def seeded_generator(device, *ids: int) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(i) for i in ids]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------- VGMs

def fit_vgm(x: torch.Tensor, jitter: torch.Tensor, max_modes: int = 10,
            n_iter: int = 60, weight_threshold: float = 5e-3):
    """EM fit of a 1-D Gaussian mixture: means from the 2%..98% quantiles
    plus ``1e-4 * std * jitter``, a Dirichlet-style weight floor, pruning
    below ``weight_threshold`` (the heaviest mode always kept).  Returns
    (weights, means, stds, valid)."""
    x = x.float()
    n = x.shape[0]
    std = torch.clamp(torch.std(x, correction=0), min=1e-6)
    qs = torch.linspace(0.02, 0.98, max_modes, device=x.device)
    means = torch.quantile(x, qs) + 1e-4 * std * jitter.float()
    stds = std.expand(max_modes).clone()
    weights = torch.full((max_modes,), 1.0 / max_modes, device=x.device)
    min_std = 1e-4 * std + 1e-9
    for _ in range(n_iter):
        log_w = torch.log(torch.clamp(weights, min=1e-12))
        z = (x[:, None] - means[None, :]) / stds[None, :]
        log_joint = (-0.5 * (z * z) - torch.log(stds)[None, :]
                     - 0.5 * _LOG2PI) + log_w[None, :]
        resp = torch.exp(log_joint - torch.logsumexp(log_joint, dim=1,
                                                     keepdim=True))
        nk = torch.sum(resp, dim=0)
        weights = (nk + 1e-6) / (n + max_modes * 1e-6)
        new_means = (torch.sum(resp * x[:, None], dim=0)
                     / torch.clamp(nk, min=1e-8))
        var = torch.sum(resp * (x[:, None] - new_means[None, :]) ** 2, dim=0)
        stds = torch.sqrt(var / torch.clamp(nk, min=1e-8) + min_std ** 2)
        means = new_means
    valid = weights > weight_threshold
    valid[torch.argmax(weights)] = True
    return weights, means, stds, valid


def sample_vgm(vgm, n: int, g: torch.Generator) -> torch.Tensor:
    """``n`` draws: a mode from the valid modes' renormalized weights, then
    ``mean + std * eps``; the modes first, then the normals."""
    weights, means, stds, valid = vgm
    w = torch.where(valid, weights, 0.0)
    w = w / torch.sum(w)
    comp = torch.multinomial(torch.clamp(w, min=1e-12), n, replacement=True,
                             generator=g)
    eps = torch.randn(n, generator=g, device=means.device)
    return means[comp] + stds[comp] * eps


# ------------------------------------------------------- divergences

def _kl_bits(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p = p / torch.clamp(torch.sum(p), min=1e-12)
    q = q / torch.clamp(torch.sum(q), min=1e-12)
    ratio = (torch.log2(torch.clamp(p, min=1e-12))
             - torch.log2(torch.clamp(q, min=1e-12)))
    return torch.sum(torch.where(p > 0, p * ratio, 0.0))


def jsd(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon distance (base 2) of two frequency vectors, float32
    on the host."""
    p = torch.tensor(p).float()
    q = torch.tensor(q).float()
    p = p / torch.clamp(torch.sum(p), min=1e-12)
    q = q / torch.clamp(torch.sum(q), min=1e-12)
    m = 0.5 * (p + q)
    return float(torch.sqrt(torch.clamp(
        0.5 * (_kl_bits(p, m) + _kl_bits(q, m)), min=0.0)))


def wasserstein_1d(u: torch.Tensor, v: torch.Tensor) -> float:
    """W1 of two samples in quantile-coupling form on the grid (i + .5)/n,
    interpolating between order statistics."""
    u, v = torch.sort(u.float())[0], torch.sort(v.float())[0]
    n = max(u.shape[0], v.shape[0])
    t = (torch.arange(n, dtype=torch.float32, device=u.device) + 0.5) / n
    return float(torch.mean(torch.abs(torch.quantile(u, t)
                                      - torch.quantile(v, t))))


def weights_from_divergence(S: torch.Tensor,
                            n_rows: torch.Tensor) -> torch.Tensor:
    """Fig. 4, steps 1-4: normalize S's columns, sum each client's row,
    ``SD = 1 - SS / sum(SS) + N_i / N``, softmax."""
    P = S.shape[0]
    col = torch.sum(S, dim=0, keepdim=True)
    s_norm = torch.where(col > 0, S / torch.clamp(col, min=1e-12), 1.0 / P)
    ss = torch.sum(s_norm, dim=1)
    sd = (1.0 - ss / torch.clamp(torch.sum(ss), min=1e-12)
          + n_rows / torch.clamp(torch.sum(n_rows), min=1e-12))
    return torch.softmax(sd, dim=0)


# ------------------------------------------------------------ encoders

class Encoders:
    """The global encoders of one table: per categorical column the sorted
    category ids, per continuous column its VGM.  The encoded row is, per
    column in schema order, ``[alpha, beta_1..beta_K]`` (continuous) or the
    one-hot (categorical)."""

    def __init__(self, kinds, categories: dict, vgms: dict, max_modes: int):
        self.kinds = list(kinds)
        self.categories = categories
        self.vgms = vgms
        self.kmax = max_modes
        self.cont = [j for j, k in enumerate(self.kinds) if k == "continuous"]

    def spans(self) -> list[tuple[int, int, str, bool]]:
        """(start, width, "tanh" | "softmax", condition span) per span."""
        out, pos = [], 0
        for j, kind in enumerate(self.kinds):
            if kind == "continuous":
                out.append((pos, 1, "tanh", False))
                out.append((pos + 1, self.kmax, "softmax", True))
                pos += 1 + self.kmax
            else:
                c = len(self.categories[j])
                out.append((pos, c, "softmax", True))
                pos += c
        return out

    @property
    def cond_dim(self) -> int:
        return sum(w for _, w, _, c in self.spans() if c)

    def packed(self, device):
        """(Q_cont, K) means, stds and log-weights (pruned modes -1e30)."""
        means = torch.stack([self.vgms[j][1] for j in self.cont]).to(device)
        stds = torch.stack([self.vgms[j][2] for j in self.cont]).to(device)
        logw = torch.stack([torch.where(
            self.vgms[j][3],
            torch.log(torch.clamp(self.vgms[j][0], min=1e-12)), NEG_INF)
            for j in self.cont]).to(device)
        return means.float(), stds.float(), logw.float()

    def draw_gumbel(self, n: int, g: torch.Generator, device) -> torch.Tensor:
        u = torch.rand((n, len(self.cont) * self.kmax), generator=g,
                       device=device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def encode(self, table: np.ndarray, gumbel: torch.Tensor) -> torch.Tensor:
        """Mode-specific normalization with the mode drawn by Gumbel-max
        over the log-weighted normal densities; one-hot categories."""
        dev = gumbel.device
        n, K = table.shape[0], self.kmax
        means, stds, logw = self.packed(dev)
        x = torch.as_tensor(np.ascontiguousarray(table[:, self.cont]),
                            dtype=torch.float32, device=dev)
        z = (x[:, :, None] - means[None]) / stds[None]
        log_pdf = (-0.5 * z * z - torch.log(stds)[None]
                   - 0.5 * math.log(2 * math.pi))
        comp = torch.argmax(log_pdf + logw[None]
                            + gumbel.reshape(n, len(self.cont), K), dim=2)
        mu = torch.gather(means.expand(n, -1, -1), 2, comp[:, :, None])[..., 0]
        sd = torch.gather(stds.expand(n, -1, -1), 2, comp[:, :, None])[..., 0]
        alpha = torch.clamp((x - mu) / (4.0 * sd), -1.0, 1.0)
        beta = torch.nn.functional.one_hot(comp, K).float()
        parts, q = [], 0
        for j, kind in enumerate(self.kinds):
            if kind == "continuous":
                parts += [alpha[:, q:q + 1], beta[:, q]]
                q += 1
            else:
                cats = self.categories[j]
                ranks = torch.as_tensor(np.searchsorted(cats, table[:, j]),
                                        device=dev)
                parts.append(torch.nn.functional.one_hot(
                    ranks, len(cats)).float())
        return torch.cat(parts, dim=1)

    def decode(self, encoded: torch.Tensor) -> np.ndarray:
        """Activations -> raw (n, Q) float64: argmax category ids; for a
        continuous column the argmax mode k and ``clip(alpha) * 4 * std_k
        + mean_k``."""
        out = np.empty((encoded.shape[0], len(self.kinds)), np.float64)
        pos = 0
        for j, kind in enumerate(self.kinds):
            if kind == "continuous":
                _, means, stds, _ = self.vgms[j]
                k = torch.argmax(encoded[:, pos + 1:pos + 1 + self.kmax],
                                 dim=1)
                a = torch.clamp(encoded[:, pos], -1.0, 1.0)
                out[:, j] = (a * 4.0 * stds.float()[k]
                             + means.float()[k]).cpu().numpy()
                pos += 1 + self.kmax
            else:
                cats = self.categories[j]
                r = torch.argmax(encoded[:, pos:pos + len(cats)], dim=1)
                out[:, j] = cats[r.cpu().numpy()]
                pos += len(cats)
        return out


def fit_table_encoders(table: np.ndarray, kinds, jitters: dict,
                       max_modes: int, device) -> Encoders:
    """Encoders fitted on one pooled table; ``jitters[j]`` is continuous
    column j's mean jitter."""
    cats, vgms = {}, {}
    for j, kind in enumerate(kinds):
        if kind == "continuous":
            x = torch.as_tensor(np.asarray(table[:, j]), dtype=torch.float32,
                                device=device)
            vgms[j] = fit_vgm(x, jitters[j].to(device), max_modes)
        else:
            cats[j] = np.unique(np.asarray(table[:, j]))
    return Encoders(kinds, cats, vgms, max_modes)


# --------------------------------------------- training-by-sampling

def sampler_tables(encoded: np.ndarray, enc: Encoders, device) -> dict:
    """Per condition span: the rows sorted stably by their argmax category
    (a CSR index), the category counts and the cumulative log-frequency
    CDF, as CTGAN's training-by-sampling draws from them."""
    spans = [(s, w) for s, w, _, c in enc.spans() if c]
    n = encoded.shape[0]
    widths = np.array([w for _, w in spans], np.int64)
    cmax = int(widths.max())
    counts = np.zeros((len(spans), cmax), np.int64)
    starts = np.zeros((len(spans), cmax + 1), np.int64)
    order = np.empty((len(spans), n), np.int64)
    probs = np.zeros((len(spans), cmax), np.float64)
    for si, (s, w) in enumerate(spans):
        cat = encoded[:, s:s + w].argmax(axis=1)
        counts[si, :w] = np.bincount(cat, minlength=w)
        starts[si, 1:] = np.cumsum(counts[si])
        order[si] = np.argsort(cat, kind="stable")
        logf = np.log(counts[si, :w] + 1.0)
        probs[si, :w] = logf / max(logf.sum(), 1e-12)
    cum = np.cumsum(probs, axis=1)
    cum[:, -1] = 1.0

    def dev(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return {"encoded": dev(encoded, torch.float32),
            "cum": dev(cum, torch.float32),
            "counts": dev(counts, torch.int64),
            "starts": dev(starts, torch.int64),
            "order": dev(order, torch.int64),
            "widths": dev(widths, torch.int64),
            "fallback": dev(counts.argmax(axis=1), torch.int64),
            "offsets": dev(np.cumsum([0] + list(widths))[:-1], torch.int64)}


def draw_conditions(t: dict, span_ids: torch.Tensor, u_cat: torch.Tensor,
                    u_row: torch.Tensor, cond_dim: int):
    """A uniform span pick (given), an inverse-CDF category pick and a
    uniform row pick within the (span, category) bucket.  Returns (cond,
    mask, row indices)."""
    dev = t["cum"].device
    span_ids = span_ids.to(dev, torch.int64)
    c = torch.sum(t["cum"][span_ids] < u_cat.to(dev)[:, None], dim=1)
    c = torch.minimum(c, t["widths"][span_ids] - 1)
    cnt = t["counts"][span_ids, c]
    c = torch.where(cnt == 0, t["fallback"][span_ids], c)
    cnt = t["counts"][span_ids, c]
    pos = (u_row.to(dev) * cnt.float()).long()
    pos = torch.minimum(pos, torch.clamp(cnt - 1, min=0))
    rows = t["order"][span_ids, t["starts"][span_ids, c] + pos]
    n_spans = t["cum"].shape[0]
    cond = (torch.arange(cond_dim, device=dev)[None, :]
            == (t["offsets"][span_ids] + c)[:, None]).float()
    mask = (torch.arange(n_spans, device=dev)[None, :]
            == span_ids[:, None]).float()
    return cond, mask, rows


# -------------------------------------------------------- federation

def federation(parts: list[np.ndarray], kinds, seed: int, max_modes: int,
               device, samples_cap: int = 20_000, wd_samples: int = 4096
               ) -> dict:
    """The whole set-up of a federation of ``parts`` under ``fedtgan``
    weighting.  Returns the encoders, the per-client encoded rows and
    sampler tables, S and the weights."""
    P = len(parts)
    n_rows = [int(p.shape[0]) for p in parts]
    cont = [j for j, k in enumerate(kinds) if k == "continuous"]
    cat = [j for j, k in enumerate(kinds) if k != "continuous"]

    # step 1: each client's frequencies and VGMs
    freqs, client_vgms = [], []
    for i, d in enumerate(parts):
        g = seeded_generator(device, seed, STATS, i)
        f, v = {}, {}
        for j, kind in enumerate(kinds):
            if kind == "continuous":
                x = torch.as_tensor(np.ascontiguousarray(d[:, j]),
                                    dtype=torch.float32, device=device)
                jit = torch.randn(max_modes, generator=g, device=device)
                v[j] = fit_vgm(x, jit, max_modes)
            else:
                vals, cnt = np.unique(d[:, j], return_counts=True)
                f[j] = dict(zip(vals.tolist(), cnt.astype(float).tolist()))
        freqs.append(f)
        client_vgms.append(v)

    # step 2: the federator's label encoders and global VGMs
    categories, global_f, client_f = {}, {}, [dict() for _ in range(P)]
    for j in cat:
        support = np.asarray(sorted({c for f in freqs for c in f[j]}))
        categories[j] = support
        per = np.zeros((P, len(support)), np.float64)
        for i, f in enumerate(freqs):
            for raw, cnt in f[j].items():
                per[i, int(np.searchsorted(support, raw))] = cnt
        tot = per.sum(axis=0)
        global_f[j] = tot / max(tot.sum(), 1.0)
        for i in range(P):
            client_f[i][j] = per[i] / max(per[i].sum(), 1.0)
    g = seeded_generator(device, seed, INIT)
    total = sum(n_rows)
    vgms = {}
    for j in cont:
        draws = [sample_vgm(client_vgms[i][j],
                            max(1, int(round(samples_cap * n_rows[i]
                                             / max(total, 1)))), g)
                 for i in range(P)]
        jit = torch.randn(max_modes, generator=g, device=device)
        vgms[j] = fit_vgm(torch.cat(draws), jit, max_modes)
    enc = Encoders(kinds, categories, vgms, max_modes)

    # §4.2 step 0: the divergence matrix, then the weights
    g = seeded_generator(device, seed, WEIGHTS)
    S = np.zeros((P, len(kinds)), np.float32)
    for i in range(P):
        for j in range(len(kinds)):
            if j in categories:
                S[i, j] = jsd(client_f[i][j], global_f[j])
                continue
            d_ij = sample_vgm(client_vgms[i][j], wd_samples, g)
            d_j = sample_vgm(vgms[j], wd_samples, g)
            lo, hi = float(torch.min(d_j)), float(torch.max(d_j))
            scale = max(hi - lo, 1e-9)
            S[i, j] = wasserstein_1d((d_ij - lo) / scale, (d_j - lo) / scale)
    S_t = torch.as_tensor(S, device=device)
    w = weights_from_divergence(S_t, torch.tensor(n_rows, dtype=torch.float32,
                                                  device=device))

    # each client's rows under the global encoders, and its sampler tables
    encoded, tables = [], []
    for i, d in enumerate(parts):
        gum = enc.draw_gumbel(d.shape[0], seeded_generator(device, seed,
                                                           ENCODE, i), device)
        e = enc.encode(d, gum)
        encoded.append(e)
        tables.append(sampler_tables(e.cpu().numpy(), enc, device))
    return {"enc": enc, "encoded": encoded, "tables": tables, "S": S_t,
            "weights": w, "n_rows": n_rows}
