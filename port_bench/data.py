"""The benchmark's frozen table generator and partitioner (numpy only).

A table follows its configuration's schema: each categorical column
(``categorical``: a name and the counts of its categories in the
published data) draws its categories with those shares, and every
category is placed at least once, so that every seed gives the same
encoded width; each continuous column (``continuous``: names) is a
multi-modal Gaussian mixture, sometimes with an exponential tail, its
shape seeded from ``zlib.crc32`` of the table's name.  The continuous
columns are a copy of the port's ``tabular/datasets.py`` stand-ins as they
stood when the benchmark was defined (a CPU test holds them equal); the
benchmark keeps its own copy so that a change to the program cannot
change the data it is measured on.
"""
from __future__ import annotations

import zlib

import numpy as np


def _continuous_column(rng: np.random.Generator, n: int,
                       col_seed: int) -> np.ndarray:
    r = np.random.default_rng(col_seed)
    k = int(r.integers(1, 5))
    means = r.uniform(-50, 50, size=k)
    stds = r.uniform(0.5, 8.0, size=k)
    w = r.dirichlet(np.ones(k) * 2.0)
    comp = rng.choice(k, size=n, p=w)
    x = rng.normal(means[comp], stds[comp])
    if r.uniform() < 0.25:
        mask = rng.uniform(size=n) < 0.1
        x = np.where(mask, x + rng.exponential(30.0, size=n), x)
    return x


def _categorical_column(rng: np.random.Generator, n: int,
                        counts) -> np.ndarray:
    """Category ids drawn with the published shares; each category then
    put in at least one row at a random place."""
    p = np.asarray(counts, np.float64)
    c = len(p)
    if n < c:
        raise ValueError(f"{n} rows cannot hold {c} categories")
    ids = rng.choice(c, size=n, p=p / p.sum())
    ids[rng.choice(n, size=c, replace=False)] = np.arange(c)
    return ids.astype(np.float64)


def make_table(config: dict, n_rows: int, seed: int
               ) -> tuple[np.ndarray, list[tuple[str, str]]]:
    """(N, Q) float64 rows of the configuration's table (categorical columns
    first, holding integer ids) and the schema as ``(column name,
    "categorical" | "continuous")`` pairs."""
    rng = np.random.default_rng(seed)
    base = zlib.crc32(config["table"].encode()) % (2 ** 31)
    cols, schema = [], []
    for col in config["categorical"]:
        cols.append(_categorical_column(rng, n_rows, col["counts"]))
        schema.append((col["name"], "categorical"))
    for j, name in enumerate(config["continuous"]):
        cols.append(_continuous_column(rng, n_rows, base + 1000 + j))
        schema.append((name, "continuous"))
    return np.stack(cols, axis=1), schema


def partition_iid(data: np.ndarray, n_clients: int,
                  seed: int) -> list[np.ndarray]:
    """Equal-size IID shards: one permutation dealt round-robin."""
    perm = np.random.default_rng(seed).permutation(data.shape[0])
    return [data[np.sort(perm[i::n_clients])] for i in range(n_clients)]


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's random streams, from ``--seed``
    (any whole number) and the stream's index."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
