"""Vertical feature partitioners.

The paper partitions features "based on the source of the features" when a
natural grouping exists (Bank Marketing: client data vs. socio-economic
attributes) and "arbitrarily" otherwise (Give Me Some Credit, PhraseBank).
We support both plus strided/random schemes for ablations.

numpy only: the port's copy of the JAX package's ``core/partition.py``,
slice for slice (``random_partition`` draws the same permutation from the
same seed).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FeatureSlice:
    """Indices of one client's vertical slice of the feature space."""

    client: int
    indices: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.indices)


def contiguous_partition(num_features: int, num_clients: int) -> list[FeatureSlice]:
    """Arbitrary contiguous split (paper: GiveMeCredit / PhraseBank)."""
    base = num_features // num_clients
    rem = num_features % num_clients
    out, start = [], 0
    for c in range(num_clients):
        size = base + (1 if c < rem else 0)
        out.append(FeatureSlice(c, tuple(range(start, start + size))))
        start += size
    return out


def by_source_partition(group_sizes: tuple[int, ...]) -> list[FeatureSlice]:
    """Semantic split by feature source (paper: Bank Marketing)."""
    out, start = [], 0
    for c, size in enumerate(group_sizes):
        out.append(FeatureSlice(c, tuple(range(start, start + size))))
        start += size
    return out


def strided_partition(num_features: int, num_clients: int) -> list[FeatureSlice]:
    """Round-robin split — every client sees every feature neighbourhood."""
    return [
        FeatureSlice(c, tuple(range(c, num_features, num_clients)))
        for c in range(num_clients)
    ]


def random_partition(
    num_features: int, num_clients: int, seed: int = 0
) -> list[FeatureSlice]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_features)
    base = num_features // num_clients
    rem = num_features % num_clients
    out, start = [], 0
    for c in range(num_clients):
        size = base + (1 if c < rem else 0)
        out.append(FeatureSlice(c, tuple(sorted(int(i) for i in perm[start:start + size]))))
        start += size
    return out


PARTITIONERS = {
    "contiguous": contiguous_partition,
    "strided": strided_partition,
    "random": random_partition,
}


def validate_partition(slices: list[FeatureSlice], num_features: int) -> None:
    """Partition invariant: slices are disjoint and cover every feature."""
    seen: set[int] = set()
    for s in slices:
        overlap = seen & set(s.indices)
        if overlap:
            raise ValueError(f"client {s.client} overlaps features {sorted(overlap)}")
        seen |= set(s.indices)
    if seen != set(range(num_features)):
        missing = set(range(num_features)) - seen
        raise ValueError(f"partition misses features {sorted(missing)}")
