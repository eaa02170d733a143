"""Variational-Gaussian-Mixture (VGM) encoder for continuous columns.

A PyTorch counterpart of the JAX package's ``tabular/vgm.py``: an EM-fitted
Gaussian mixture with up to ``max_modes`` components per column, whose
components below ``weight_threshold`` mixture weight are pruned.  The
initial jitter of the means is injectable, so a test can hand both
packages the same draw.  ``sample_vgm`` and ``merge_client_vgms[_table]``
are the federator's side of the §4.1 encoder initialization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..kernels import ops
from ..kernels.ref import NEG_INF

_LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class VGMParams:
    """A fitted per-column Gaussian mixture; ``valid`` masks the modes that
    survived pruning.  Shapes stay at ``max_modes``."""
    weights: torch.Tensor  # (K,)
    means: torch.Tensor    # (K,)
    stds: torch.Tensor     # (K,)
    valid: torch.Tensor    # (K,) bool


def _log_prob_matrix(x, means, stds, log_weights):
    """(N, K) log p(x_i, z=k)."""
    z = (x[:, None] - means[None, :]) / stds[None, :]
    log_pdf = -0.5 * (z * z) - torch.log(stds)[None, :] - 0.5 * _LOG2PI
    return log_pdf + log_weights[None, :]


def fit_vgm(x: torch.Tensor, *, max_modes: int = 10, n_iter: int = 60,
            weight_threshold: float = 5e-3,
            jitter: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> VGMParams:
    """Fit a GMM to 1-D data ``x`` by EM with weight-floor pruning, on
    ``x``'s device.

    The means start at quantiles 0.02..0.98 (linear interpolation) plus
    ``1e-4 * std(x) * jitter``; ``jitter`` is a standard-normal
    ``(max_modes,)`` draw, taken from ``generator`` when not given."""
    x = x.float()
    n = x.shape[0]
    dev = x.device
    data_std = torch.clamp(torch.std(x, correction=0), min=1e-6)
    if jitter is None:
        jitter = torch.randn(max_modes, generator=generator, device=dev)
    qs = torch.linspace(0.02, 0.98, max_modes, device=dev)
    means = torch.quantile(x, qs) + 1e-4 * data_std * jitter.to(dev).float()
    stds = data_std.expand(max_modes).clone()
    weights = torch.full((max_modes,), 1.0 / max_modes, device=dev)
    min_std = 1e-4 * data_std + 1e-9

    for _ in range(n_iter):
        log_w = torch.log(torch.clamp(weights, min=1e-12))
        log_joint = _log_prob_matrix(x, means, stds, log_w)       # (N, K)
        log_norm = torch.logsumexp(log_joint, dim=1, keepdim=True)
        resp = torch.exp(log_joint - log_norm)
        nk = torch.sum(resp, dim=0)
        # Dirichlet-style floor keeps dead components alive at ~zero weight
        weights = (nk + 1e-6) / (n + max_modes * 1e-6)
        new_means = torch.sum(resp * x[:, None], dim=0) / torch.clamp(nk, min=1e-8)
        var = torch.sum(resp * (x[:, None] - new_means[None, :]) ** 2, dim=0)
        stds = torch.sqrt(var / torch.clamp(nk, min=1e-8) + min_std ** 2)
        means = new_means

    valid = weights > weight_threshold
    valid[torch.argmax(weights)] = True        # at least one valid mode
    return VGMParams(weights=weights, means=means, stds=stds, valid=valid)


def sample_vgm(params: VGMParams, n: int, *,
               generator: torch.Generator | None = None,
               comp: torch.Tensor | None = None,
               eps: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` draws from a fitted VGM on its device: a mode ``comp`` (n,)
    from the valid modes' renormalized weights (a floor of 1e-12, as the
    reference's log-weights), then ``means[comp] + stds[comp] * eps`` with
    ``eps`` (n,) standard normal.  ``comp`` and ``eps`` are drawn from
    ``generator`` (in that order) when not given."""
    dev = params.means.device
    w = torch.where(params.valid, params.weights, 0.0)
    w = w / torch.sum(w)
    if comp is None:
        comp = torch.multinomial(torch.clamp(w, min=1e-12), n,
                                 replacement=True, generator=generator)
    if eps is None:
        eps = torch.randn(n, generator=generator, device=dev)
    comp = comp.to(dev)
    return params.means[comp] + params.stds[comp] * eps.to(dev).float()


def merge_client_vgms(client_params: Sequence[VGMParams],
                      client_rows: Sequence[int], *, max_modes: int = 10,
                      samples_cap: int = 20_000,
                      generator: torch.Generator | None = None) -> VGMParams:
    """The federator's global VGM of one continuous column (Fed-TGAN §4.1):
    about ``samples_cap`` draws in all from the clients' VGMs, each
    client's share proportional to its rows, and one VGM fitted to their
    union.  No client row is touched."""
    total = sum(client_rows)
    parts = [sample_vgm(p, max(1, int(round(samples_cap * n_i
                                               / max(total, 1)))),
                        generator=generator)
             for p, n_i in zip(client_params, client_rows)]
    return fit_vgm(torch.cat(parts), max_modes=max_modes,
                   generator=generator)


def merge_client_vgms_table(client_params: Sequence[Sequence[VGMParams]],
                            client_rows: Sequence[int], *,
                            max_modes: int = 10, samples_cap: int = 20_000,
                            generator: torch.Generator | None = None
                            ) -> list[VGMParams]:
    """:func:`merge_client_vgms` for every continuous column at once:
    ``client_params[i][q]`` is client i's VGM of column q; returns one
    global VGM per column.  A one-off on the federator, so the columns
    are merged one after another."""
    return [merge_client_vgms([c[q] for c in client_params], client_rows,
                              max_modes=max_modes, samples_cap=samples_cap,
                              generator=generator)
            for q in range(len(client_params[0]) if client_params else 0)]


def kernel_log_weights(params: VGMParams) -> torch.Tensor:
    """Log mixture weights in the kernel convention: pruned modes carry
    -1e30 so a Gumbel-argmax never selects them."""
    return torch.where(params.valid,
                       torch.log(torch.clamp(params.weights, min=1e-12)),
                       NEG_INF)


def pack_vgm_params(vgms: Sequence[VGMParams], kmax: int | None = None,
                    device: torch.device | str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack per-column VGMs into ``(Q, Kmax)`` means, stds and log-weights.
    Padding: log-weight -1e30 (never selected), mean 0, std 1 (keeps the
    log-pdf finite)."""
    ks = [int(p.means.shape[0]) for p in vgms]
    kmax = max(ks, default=0) if kmax is None else kmax
    if device is None:
        device = vgms[0].means.device if vgms else "cpu"
    Q = len(vgms)
    means = torch.zeros((Q, kmax), device=device)
    stds = torch.ones((Q, kmax), device=device)
    logw = torch.full((Q, kmax), NEG_INF, device=device)
    for q, (p, k) in enumerate(zip(vgms, ks)):
        means[q, :k] = p.means.float()
        stds[q, :k] = p.stds.float()
        logw[q, :k] = kernel_log_weights(p)
    return means, stds, logw


def encode_column(x: torch.Tensor, params: VGMParams, *,
                  gumbel: torch.Tensor | None = None,
                  generator: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """CTGAN mode-specific normalization of one column with a *sampled*
    mode, through the single-column ``vgm_encode`` kernel route.

    Returns ``alpha`` (N,), ``clip((x - mu_k) / (4 sigma_k), -1, 1)``, and
    ``beta`` (N, K), the one-hot of the mode ``k`` drawn by Gumbel-max over
    the log-weighted normal log-densities.  Unlike the table encode, a
    pruned mode keeps the log-weight ``log(1e-12)``, as the reference's
    does, so it can be drawn.  ``gumbel`` is the (N, K) noise; when not
    given it is drawn as ``-log(-log(U))`` from ``generator`` on ``x``'s
    device."""
    x = x.float().contiguous()
    means = params.means.float().contiguous()
    stds = params.stds.float().contiguous()
    log_w = torch.log(torch.where(params.valid,
                                  torch.clamp(params.weights.float(),
                                              min=1e-12),
                                  1e-12)).contiguous()
    if gumbel is None:
        u = torch.rand((x.shape[0], means.shape[0]), generator=generator,
                       device=x.device)
        gumbel = -torch.log(-torch.log(u))
    return ops.vgm_encode(x, means, stds, log_w,
                          gumbel.float().contiguous())


def decode_column(alpha: torch.Tensor, beta: torch.Tensor,
                  params: VGMParams) -> torch.Tensor:
    """Invert the mode-specific normalization of one column (the
    per-column oracle of the fused decode)."""
    comp = torch.argmax(beta, dim=1)
    return (torch.clamp(alpha, -1.0, 1.0) * 4.0 * params.stds[comp]
            + params.means[comp])
