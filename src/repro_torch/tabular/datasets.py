"""Synthetic stand-ins for the paper's four datasets (Tab.1), the port's
own copy of the JAX package's ``tabular/datasets.py`` (pure numpy).

The tables have the SAME column counts and types as Tab.1 and realistic
marginals: multi-modal Gaussian mixtures for continuous columns and
Zipf-distributed categories.  Row count defaults to the paper's 40k
subsample.  ``make_dataset`` gives arrays equal to the reference's for the
same name, rows and seed.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .encoders import ColumnSpec

#                 rows  cat  cont
_TABLE1 = {
    "adult":     (40_000, 9, 5),
    "covertype": (40_000, 45, 10),
    "credit":    (40_000, 1, 30),
    "intrusion": (40_000, 20, 22),
}


@dataclasses.dataclass
class TabularDataset:
    name: str
    schema: list[ColumnSpec]
    data: np.ndarray               # (N, Q) float64; categorical cols hold int ids

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])


def _continuous_column(rng: np.random.Generator, n: int, col_seed: int) -> np.ndarray:
    """Random 1-4 mode Gaussian mixture, occasionally heavy-tailed."""
    r = np.random.default_rng(col_seed)
    k = int(r.integers(1, 5))
    means = r.uniform(-50, 50, size=k)
    stds = r.uniform(0.5, 8.0, size=k)
    w = r.dirichlet(np.ones(k) * 2.0)
    comp = rng.choice(k, size=n, p=w)
    x = rng.normal(means[comp], stds[comp])
    if r.uniform() < 0.25:                       # exp tail like 'capital-gain'
        mask = rng.uniform(size=n) < 0.1
        x = np.where(mask, x + rng.exponential(30.0, size=n), x)
    return x


def _categorical_column(rng: np.random.Generator, n: int, col_seed: int) -> np.ndarray:
    r = np.random.default_rng(col_seed)
    c = int(r.integers(2, 20))
    w = 1.0 / np.arange(1, c + 1) ** r.uniform(0.5, 1.5)    # Zipf-ish
    w = w / w.sum()
    return rng.choice(c, size=n, p=w).astype(np.float64)


def make_dataset(name: str, *, n_rows: int | None = None,
                 seed: int = 0) -> TabularDataset:
    if name not in _TABLE1:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(_TABLE1)}")
    default_rows, n_cat, n_cont = _TABLE1[name]
    n = n_rows or default_rows
    rng = np.random.default_rng(seed)
    # crc32, not hash(): str hashing is salted per process
    base = zlib.crc32(name.encode()) % (2 ** 31)

    cols, schema = [], []
    for j in range(n_cat):
        cols.append(_categorical_column(rng, n, base + j))
        schema.append(ColumnSpec(f"{name}_cat{j}", "categorical"))
    for j in range(n_cont):
        cols.append(_continuous_column(rng, n, base + 1000 + j))
        schema.append(ColumnSpec(f"{name}_cont{j}", "continuous"))
    return TabularDataset(name, schema, np.stack(cols, axis=1))


# ---------------------------------------------------------------------------
# Federated partitioners, the paper's client scenarios (§5.3)
# ---------------------------------------------------------------------------

def partition_full_copy(ds: TabularDataset, n_clients: int) -> list[np.ndarray]:
    """§5.3.1 ideal case: every client holds the complete dataset."""
    return [ds.data.copy() for _ in range(n_clients)]


def partition_iid(ds: TabularDataset, n_clients: int,
                  seed: int = 0) -> list[np.ndarray]:
    """Equal-size IID shards: one permutation dealt round-robin."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n_rows)
    return [ds.data[np.sort(perm[i::n_clients])] for i in range(n_clients)]


def partition_quantity_skew(ds: TabularDataset, n_clients: int,
                            small_rows: int = 500, seed: int = 0) -> list[np.ndarray]:
    """§5.3.2: clients 0..P-2 get ``small_rows`` IID rows, last client all."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_clients - 1):
        idx = rng.choice(ds.n_rows, size=small_rows, replace=False)
        parts.append(ds.data[idx])
    parts.append(ds.data.copy())
    return parts


def partition_malicious(ds: TabularDataset, n_clients: int,
                        good_rows: int = 10_000, bad_rows: int = 40_000,
                        seed: int = 0) -> list[np.ndarray]:
    """§5.3.3 ablation: P-1 honest clients with IID samples; one 'malicious'
    client holding a single row repeated ``bad_rows`` times."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_clients - 1):
        idx = rng.choice(ds.n_rows, size=good_rows, replace=False)
        parts.append(ds.data[idx])
    one = ds.data[rng.integers(ds.n_rows)]
    parts.append(np.tile(one[None, :], (bad_rows, 1)))
    return parts


def partition_label_skew(ds: TabularDataset, n_clients: int, cat_col: int = 0,
                         alpha: float = 0.3, seed: int = 0) -> list[np.ndarray]:
    """Dirichlet Non-IID split on a categorical column (standard FL split)."""
    rng = np.random.default_rng(seed)
    labels = ds.data[:, cat_col].astype(int)
    classes = np.unique(labels)
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        splits = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, splits)):
            client_idx[ci].extend(part.tolist())
    return [ds.data[np.array(sorted(ix), dtype=int)] if ix else
            ds.data[:1] for ix in client_idx]
