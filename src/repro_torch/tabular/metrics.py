"""The evaluation metrics of §5.2, Avg-JSD (categorical columns) and
Avg-WD (continuous columns), the port's copy of the JAX package's
``tabular/metrics.py``.  Raw numpy tables in, floats out; they share the
JSD and Wasserstein code of the §4.2 weighting
(:mod:`repro_torch.core.divergence`)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import divergence as dv
from .encoders import ColumnSpec


def _category_freq(x: np.ndarray, n_cat: int) -> np.ndarray:
    counts = np.bincount(x.astype(int), minlength=n_cat).astype(np.float64)
    return counts / max(counts.sum(), 1.0)


def avg_jsd(real: np.ndarray, synth: np.ndarray,
            schema: Sequence[ColumnSpec]) -> float:
    """The mean JSD over the categorical columns (0 = identical)."""
    vals = []
    for j, col in enumerate(schema):
        if col.kind != "categorical":
            continue
        n_cat = int(max(real[:, j].max(), synth[:, j].max())) + 1
        vals.append(float(dv.jsd(_category_freq(real[:, j], n_cat),
                                 _category_freq(synth[:, j], n_cat))))
    return float(np.mean(vals)) if vals else 0.0


def avg_wd(real: np.ndarray, synth: np.ndarray,
           schema: Sequence[ColumnSpec]) -> float:
    """The mean 1-D Wasserstein distance over the continuous columns, both
    tables min-max scaled by the REAL column's range (§5.2)."""
    vals = []
    for j, col in enumerate(schema):
        if col.kind != "continuous":
            continue
        lo, hi = real[:, j].min(), real[:, j].max()
        scale = max(hi - lo, 1e-9)
        vals.append(float(dv.wasserstein_1d((real[:, j] - lo) / scale,
                                            (synth[:, j] - lo) / scale)))
    return float(np.mean(vals)) if vals else 0.0


def similarity_report(real: np.ndarray, synth: np.ndarray,
                      schema: Sequence[ColumnSpec]) -> dict[str, float]:
    return {"avg_jsd": avg_jsd(real, synth, schema),
            "avg_wd": avg_wd(real, synth, schema)}
