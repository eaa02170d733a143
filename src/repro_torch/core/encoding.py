"""Privacy-preserving multi-source feature encoding (Fed-TGAN §4.1), the
port's copy of the JAX package's ``core/encoding.py``.

Step 1 (clients -> federator): per categorical column each client sends
its category-frequency table, per continuous column its locally fitted
VGM, and its row count.  Step 2 (federator -> clients): the federator
unions the categories into global label encoders, merges the client VGMs
into one global VGM per continuous column (:func:`merge_client_vgms_table`)
and sends the encoders back, so every client builds the same model input
and output layout.  The federator never sees a raw row.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..tabular.encoders import ColumnSpec, LabelEncoder, TableEncoders
from ..tabular.vgm import VGMParams, fit_vgm, merge_client_vgms_table


@dataclasses.dataclass
class ClientStats:
    """What one client ships to the federator (the whole privacy surface)."""
    cat_freqs: dict[int, dict[float, float]]   # col -> {raw category: count}
    vgms: dict[int, VGMParams]                 # col -> local VGM
    n_rows: int


def compute_client_stats(data: np.ndarray, schema: Sequence[ColumnSpec], *,
                         generator: torch.Generator | None = None,
                         jitters: dict[int, torch.Tensor] | None = None,
                         device: torch.device | str = "cuda") -> ClientStats:
    """Client side of Step 1; the VGMs are fitted on ``device``.
    ``jitters[j]`` injects column j's :func:`fit_vgm` jitter; the others
    are drawn from ``generator``."""
    dev = resolve_device(device)
    cat_freqs: dict[int, dict[float, float]] = {}
    vgms: dict[int, VGMParams] = {}
    for j, col in enumerate(schema):
        if col.kind == "categorical":
            vals, counts = np.unique(data[:, j], return_counts=True)
            cat_freqs[j] = {float(v): float(c) for v, c in zip(vals, counts)}
        else:
            x = torch.as_tensor(np.ascontiguousarray(data[:, j]),
                                dtype=torch.float32, device=dev)
            vgms[j] = fit_vgm(x, max_modes=col.max_modes,
                              jitter=None if jitters is None else jitters.get(j),
                              generator=generator)
    return ClientStats(cat_freqs, vgms, int(data.shape[0]))


@dataclasses.dataclass
class FederatedInit:
    """The federator's result of the initialization protocol."""
    encoders: TableEncoders
    global_cat_freqs: dict[int, np.ndarray]          # col -> (C,) on the LE support
    client_cat_freqs: list[dict[int, np.ndarray]]    # per client, same support
    n_rows: list[int]

    @property
    def n_total(self) -> int:
        return sum(self.n_rows)


def federated_encoder_init(stats: Sequence[ClientStats],
                           schema: Sequence[ColumnSpec], *,
                           generator: torch.Generator | None = None,
                           max_modes: int = 10, samples_cap: int = 20_000,
                           device: torch.device | str = "cuda"
                           ) -> FederatedInit:
    """Federator side of Steps 1 and 2: the global label encoders, the
    global and per-client category frequencies on their support, and the
    global VGMs (bootstrap draws from ``generator``)."""
    dev = resolve_device(device)
    P = len(stats)
    n_rows = [s.n_rows for s in stats]
    les: dict[int, LabelEncoder] = {}
    global_freqs: dict[int, np.ndarray] = {}
    client_freqs: list[dict[int, np.ndarray]] = [dict() for _ in range(P)]
    for j, col in enumerate(schema):
        if col.kind != "categorical":
            continue
        support = sorted({c for s in stats for c in s.cat_freqs[j]})
        le = LabelEncoder(np.asarray(support))
        les[j] = le
        per_client = np.zeros((P, le.n), np.float64)
        for i, s in enumerate(stats):
            for raw, cnt in s.cat_freqs[j].items():
                per_client[i, int(np.searchsorted(le.categories, raw))] = cnt
        total = per_client.sum(axis=0)
        global_freqs[j] = total / max(total.sum(), 1.0)
        for i in range(P):
            row = per_client[i]
            client_freqs[i][j] = row / max(row.sum(), 1.0)

    cont = [j for j, col in enumerate(schema) if col.kind == "continuous"]
    merged = merge_client_vgms_table(
        [[s.vgms[j] for j in cont] for s in stats], n_rows,
        max_modes=max_modes, samples_cap=samples_cap, generator=generator)
    vgms = {j: VGMParams(*(t.to(dev) for t in (m.weights, m.means, m.stds,
                                               m.valid)))
            for j, m in zip(cont, merged)}
    enc = TableEncoders(list(schema), les, vgms, dev)
    return FederatedInit(enc, global_freqs, client_freqs, n_rows)


def client_vgm_dicts(stats: Sequence[ClientStats]) -> list[dict[int, VGMParams]]:
    return [s.vgms for s in stats]
