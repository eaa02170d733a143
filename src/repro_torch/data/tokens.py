"""Token data and the Fed-TGAN weighting adapted to token data, the port's
copy of the JAX package's ``data/tokens.py``.

Each client's "column statistics" are its unigram token distribution,
bucketed into ``n_bins`` vocab shards; the federator computes the JSD of
every client's bin share against the global one and runs Fig.4 steps 1-4
unchanged (:func:`repro_torch.core.weighting.weights_from_divergence`).
Synthetic streams are Zipf-distributed, with per-client exponent and
vocab-rank skew in the non-IID case.  The streams are numpy and equal to
the reference's for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import divergence as dv
from ..core.weighting import weights_from_divergence


@dataclasses.dataclass(frozen=True)
class TokenDatasetSpec:
    vocab: int
    seq_len: int
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float, shift: int = 0) -> np.ndarray:
    ranks = (np.arange(vocab) + shift) % vocab + 1
    p = 1.0 / ranks ** a
    return p / p.sum()


def synthetic_token_batches(spec: TokenDatasetSpec, batch: int, steps: int,
                            *, seed: int = 0, zipf_a: float | None = None,
                            shift: int = 0) -> np.ndarray:
    """(steps, batch, seq_len) int32 token ids."""
    rng = np.random.default_rng(seed)
    p = _zipf_probs(spec.vocab, zipf_a or spec.zipf_a, shift)
    return rng.choice(spec.vocab, size=(steps, batch, spec.seq_len),
                      p=p).astype(np.int32)


def client_token_streams(spec: TokenDatasetSpec, n_clients: int, batch: int,
                         steps: int, *, iid: bool = True, seed: int = 0
                         ) -> list[np.ndarray]:
    """Per-client streams; non-IID clients get skewed Zipf exponents and
    rotated vocab ranks."""
    out = []
    for i in range(n_clients):
        a = spec.zipf_a if iid else spec.zipf_a * (0.7 + 0.2 * i)
        shift = 0 if iid else i * (spec.vocab // max(n_clients, 1))
        out.append(synthetic_token_batches(spec, batch, steps,
                                           seed=seed + i, zipf_a=a,
                                           shift=shift))
    return out


def token_frequency_stats(stream: np.ndarray, vocab: int,
                          n_bins: int = 64) -> np.ndarray:
    """Client -> federator payload: the unigram distribution binned into
    ``n_bins`` vocab shards (the paper's (P, Q) columns)."""
    counts = np.bincount(stream.reshape(-1), minlength=vocab).astype(np.float64)
    edges = np.linspace(0, vocab, n_bins + 1).astype(int)
    binned = np.add.reduceat(counts, edges[:-1])
    return binned / max(binned.sum(), 1.0)


def fed_weights_from_token_stats(client_stats: list[np.ndarray],
                                 n_tokens: list[int]) -> torch.Tensor:
    """Fed-TGAN §4.2 on token-frequency columns: S[i, b] is the JSD of
    client i's bin-b share against the global one in a 2-bucket (bin vs
    rest) view; returns the (P,) float32 weights on the CPU."""
    P = len(client_stats)
    stats = np.stack(client_stats)                       # (P, n_bins)
    n = np.asarray(n_tokens, np.float64)
    global_freq = (stats * n[:, None]).sum(0)
    global_freq = global_freq / max(global_freq.sum(), 1e-12)
    n_bins = stats.shape[1]
    S = np.zeros((P, n_bins), np.float32)
    for i in range(P):
        for b in range(n_bins):
            p = np.array([stats[i, b], 1.0 - stats[i, b]])
            q = np.array([global_freq[b], 1.0 - global_freq[b]])
            S[i, b] = float(dv.jsd(p, q))
    return weights_from_divergence(torch.from_numpy(S),
                                   torch.tensor(n, dtype=torch.float32))
