"""Boolean hypercube with multiplicative-group (LFSR) ordering (the port's
copy of halo2_lasso_tpu/poly/bh.py: the iteration order for Lagrange
leaves and witness rows, and the rotation maps).

Semantics match the reference (util/arithmetic/bh.rs): the 2^k hypercube is
iterated as 0 followed by the orbit of 1 under the GF(2)-LFSR step
    next(b) = (b << 1) ^ ((b >> k) * PRIMITIVE_k,
which gives the cyclic row ordering used for witness layout, and halo2
`Rotation(i)` becomes i applications of next/prev.

The Rust reference computes the iteration order by a sequential 2^k-step
loop (bh.rs:122-137). Here the orbit is produced in
log2(2^k) numpy doubling steps: the LFSR step is GF(2)-linear, so
seq[m:2m] = L^m(seq[0:m]) where L^m is represented by its images of the k
basis vectors — each doubling is k vectorized XOR-selects. This keeps index-
map construction off the critical path even at k=26.
"""

from __future__ import annotations

import functools

import numpy as np

# Primitive polynomials over GF(2), degree k (index = k), bh.rs:5-39.
PRIMITIVES = [
    1, 3, 7, 11, 19, 37, 67, 131, 285, 529, 1033, 2053, 4179, 8219, 16427,
    32771, 65581, 131081, 262183, 524327, 1048585, 2097157, 4194307, 8388641,
    16777243, 33554441, 67108935, 134217767, 268435465, 536870917, 1073741907,
    2147483657,
]

# Integer representation of 1/X in GF(2)[X]/(primitive), bh.rs:41-75.
X_INVS = [
    0, 1, 3, 5, 9, 18, 33, 65, 142, 264, 516, 1026, 2089, 4109, 8213, 16385,
    32790, 65540, 131091, 262163, 524292, 1048578, 2097153, 4194320, 8388621,
    16777220, 33554467, 67108883, 134217732, 268435458, 536870953, 1073741828,
]


class BooleanHypercube:
    def __init__(self, num_vars: int):
        assert 0 <= num_vars < 32
        self.num_vars = num_vars
        self.primitive = PRIMITIVES[num_vars]
        self.x_inv = X_INVS[num_vars]

    def next_idx(self, b):
        """Vectorized LFSR step (multiply by X)."""
        b = np.asarray(b, dtype=np.int64)
        b = b << 1
        return b ^ ((b >> self.num_vars) * self.primitive)

    def prev_idx(self, b):
        """Vectorized inverse step (multiply by 1/X)."""
        b = np.asarray(b, dtype=np.int64)
        return (b >> 1) ^ ((b & 1) * self.x_inv)

    def rotate(self, b, rotation: int):
        """Apply rotation (possibly negative) to index/indices b."""
        step = self.next_idx if rotation >= 0 else self.prev_idx
        for _ in range(abs(rotation)):
            b = step(b)
        return b

    def _orbit(self) -> np.ndarray:
        return _orbit_cached(self.num_vars)

    def iter_indices(self) -> np.ndarray:
        """Index sequence of the bh iteration order, length 2^k (starts at 0)."""
        return np.concatenate([np.zeros(1, dtype=np.int64), self._orbit()])

    def nth_map(self) -> np.ndarray:
        """nth_map[b] = position of b in iteration order (bh.rs:131-137)."""
        out = np.zeros(1 << self.num_vars, dtype=np.int64)
        out[self.iter_indices()] = np.arange(1 << self.num_vars, dtype=np.int64)
        return out

    def rotation_map(self, rotation: int) -> np.ndarray:
        """rotation_map[b] = rotate(b, rotation) for all b (bh.rs:139-141)."""
        return self.rotate(np.arange(1 << self.num_vars, dtype=np.int64), rotation)


@functools.lru_cache(maxsize=None)
def _orbit_cached(k: int) -> np.ndarray:
    """[1, next(1), next^2(1), ...] of length 2^k - 1, via GF(2) doubling."""
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    bh = BooleanHypercube(k)
    # images[i] = L(e_i) where e_i = 1 << i (single LFSR step)
    images = bh.next_idx(np.array([1 << i for i in range(k)]))

    def apply(images_, b):
        out = np.zeros_like(b)
        for i in range(k):
            out ^= np.where((b >> i) & 1 == 1, images_[i], 0)
        return out

    seq = np.array([1], dtype=np.int64)
    total = (1 << k) - 1
    while len(seq) < total:
        take = min(len(seq), total - len(seq))
        seq = np.concatenate([seq, apply(images, seq[:take])])
        images = apply(images, images)
    return seq
