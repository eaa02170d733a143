"""The table-similarity-aware weighting of Fed-TGAN (§4.2, Fig.4), the
port's copy of the JAX package's ``core/weighting.py``.

Given the (P, Q) divergence matrix S of each client against the global
statistics, column by column:

  Step 1: normalize each column of S to sum 1;
  Step 2: sum each row -> the client's score SS_i;
  Step 3: SD_i = (1 - SS_i / sum(SS)) + N_i / N_all;
  Step 4: W = softmax(SD).

``build_divergence_matrix`` computes S from the protocol's own statistics
(§4.1): the JSD of category frequencies and the Wasserstein distance
between samples of the client's and the global VGM.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..tabular.encoders import ColumnSpec, TableEncoders
from ..tabular.vgm import VGMParams, sample_vgm
from . import divergence as dv

__all__ = ["weights_from_divergence", "build_divergence_matrix",
           "fedtgan_weights", "uniform_weights", "quantity_only_weights"]


def weights_from_divergence(S: torch.Tensor,
                            n_rows: torch.Tensor) -> torch.Tensor:
    """Fig.4 steps 1-4: S (P, Q) divergences and (P,) local row counts ->
    (P,) weights summing to 1.  An all-zero column counts 1/P for every
    client."""
    S = torch.as_tensor(S).float()
    n_rows = torch.as_tensor(n_rows).float().to(S.device)
    col_sum = torch.sum(S, dim=0, keepdim=True)
    P = S.shape[0]
    S_norm = torch.where(col_sum > 0, S / torch.clamp(col_sum, min=1e-12),
                         1.0 / P)
    SS = torch.sum(S_norm, dim=1)
    sim = 1.0 - SS / torch.clamp(torch.sum(SS), min=1e-12)
    SD = sim + n_rows / torch.clamp(torch.sum(n_rows), min=1e-12)
    return torch.softmax(SD, dim=0)


def uniform_weights(n_clients: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """Vanilla FL-TGAN: every client weighs 1/P."""
    return torch.full((n_clients,), 1.0 / n_clients, dtype=torch.float32,
                      device=device)


def quantity_only_weights(n_rows: torch.Tensor) -> torch.Tensor:
    """The Fed\\SW ablation (§5.3.3): softmax of the data-quantity ratios."""
    n_rows = torch.as_tensor(n_rows).float()
    return torch.softmax(n_rows / torch.clamp(torch.sum(n_rows), min=1e-12),
                         dim=0)


def build_divergence_matrix(
        schema: Sequence[ColumnSpec],
        client_cat_freqs: Sequence[Mapping[int, np.ndarray]],
        client_vgms: Sequence[Mapping[int, VGMParams]],
        global_enc: TableEncoders,
        global_cat_freqs: Mapping[int, np.ndarray], *,
        generator: torch.Generator | None = None,
        wd_samples: int = 4096,
        samples: Mapping[tuple[int, int], tuple] | None = None
        ) -> torch.Tensor:
    """S[i, j] of §4.2 Step 0, a (P, Q) float32 tensor on the encoders'
    device.

    Categorical j: JSD of client i's category frequencies against the
    global ones, on the global support.  Continuous j: the Wasserstein
    distance between ``wd_samples`` draws of client i's VGM and of the
    global VGM, both min-max scaled by the global sample's range.
    ``samples[(i, j)] = (client_draw, global_draw)`` injects the draws;
    the rest come from ``generator`` (client's, then global's, in (i, j)
    order)."""
    P, Q = len(client_cat_freqs), len(schema)
    S = np.zeros((P, Q), np.float32)
    for i in range(P):
        for j, col in enumerate(schema):
            if col.kind == "categorical":
                S[i, j] = float(dv.jsd(client_cat_freqs[i][j],
                                       global_cat_freqs[j]))
                continue
            if samples is not None and (i, j) in samples:
                d_ij, d_j = (dv._f32(a) for a in samples[i, j])
            else:
                d_ij = sample_vgm(client_vgms[i][j], wd_samples,
                                  generator=generator)
                d_j = sample_vgm(global_enc.vgms[j], wd_samples,
                                 generator=generator)
            lo, hi = float(torch.min(d_j)), float(torch.max(d_j))
            scale = max(hi - lo, 1e-9)
            S[i, j] = float(dv.wasserstein_1d((d_ij - lo) / scale,
                                              (d_j - lo) / scale))
    return torch.as_tensor(S, device=global_enc.device)


def fedtgan_weights(schema, client_cat_freqs, client_vgms, global_enc,
                    global_cat_freqs, n_rows, *,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """End to end: the Step 0 matrix, then Steps 1-4."""
    S = build_divergence_matrix(schema, client_cat_freqs, client_vgms,
                                global_enc, global_cat_freqs,
                                generator=generator)
    return weights_from_divergence(S, torch.as_tensor(n_rows))
