"""Static bucket ladder: the set of batch sizes the server executes.

Each request is assigned the smallest configured bucket that fits; the
generator runs at bucket size with the request's own seed and the
response is the first ``rows`` rows.  Because the CTGAN generator
batch-normalizes over the batch axis, values depend on the batch size,
so the serving contract is defined at bucket granularity: a request
``(seed, rows)`` is answered with
``synthesize_table(..., n_samples=bucket)[:rows]``.  The port's own copy
of the JAX package's ``serve/bucketing.py``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Sequence


class RequestTooLarge(ValueError):
    """Request rows exceed the ladder's top bucket (split the request or
    register the table with a taller ladder)."""


class LadderFitError(ValueError):
    """``ladder_from_sizes`` was given nothing to fit to (empty or
    non-positive size sample)."""


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Sorted, static set of batch sizes the server may execute."""
    buckets: tuple[int, ...]

    def __post_init__(self):
        b = tuple(sorted(int(x) for x in self.buckets))
        if not b or b[0] <= 0:
            raise ValueError(f"ladder needs positive buckets, got {b}")
        if len(set(b)) != len(b):
            raise ValueError(f"duplicate buckets: {b}")
        object.__setattr__(self, "buckets", b)

    @property
    def max_rows(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket >= rows (raises :class:`RequestTooLarge` past
        the top: never a silent new shape)."""
        if rows <= 0:
            raise ValueError(f"rows must be positive, got {rows}")
        i = bisect.bisect_left(self.buckets, rows)
        if i == len(self.buckets):
            raise RequestTooLarge(
                f"{rows} rows > max bucket {self.max_rows}")
        return self.buckets[i]


def default_ladder(max_rows: int = 4096, min_bucket: int = 64) -> BucketLadder:
    """Powers-of-two ladder ``min_bucket..>=max_rows``."""
    if max_rows < min_bucket:
        return BucketLadder((min_bucket,))
    sizes, b = [], int(min_bucket)
    while b < max_rows:
        sizes.append(b)
        b *= 2
    sizes.append(b)
    return BucketLadder(tuple(sizes))


def ladder_from_sizes(sizes: Sequence[int], *,
                      min_bucket: int = 64) -> BucketLadder:
    """Fit a ladder to an expected trace: one power-of-two bucket per
    distinct size class observed, deduplicated."""
    sizes = [int(s) for s in sizes]
    if not sizes:
        raise LadderFitError("ladder_from_sizes needs at least one "
                             "observed size; got an empty sample")
    if min(sizes) <= 0:
        raise LadderFitError(
            f"sizes must be positive rows, got min {min(sizes)}")
    full = default_ladder(max(sizes), min_bucket)
    return BucketLadder(tuple(sorted({full.bucket_for(s) for s in sizes})))
