"""The port's Poseidon (halo2_lasso_tpu_torch.ops.poseidon, its own copy
of halo2_lasso_tpu/ops/poseidon.py) against the JAX package on the CPU:
the Grain-generated round constants and MDS matrix, the round counts, and
``poseidon_hash`` of seeded inputs of lengths 0 to 5 at widths 3 and 5,
streamed absorbs included."""

import numpy as np
import pytest

from halo2_lasso_tpu.ops import poseidon as jposeidon
from halo2_lasso_tpu_torch.ops import poseidon
from halo2_lasso_tpu_torch.ops.bn254 import Fr

P = Fr.modulus


@pytest.mark.parametrize("t", [3, 5])
def test_constants_match_jax(t):
    mine, theirs = poseidon.Poseidon(t=t), jposeidon.Poseidon(t=t)
    assert (mine.t, mine.r_f, mine.r_p) == (theirs.t, theirs.r_f, theirs.r_p)
    assert mine.rc == theirs.rc and mine.mds == theirs.mds
    assert all(0 <= v < P for row in mine.rc for v in row)


@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("n", range(6))
def test_hash_matches_jax(t, n):
    rng = np.random.RandomState(100 * t + n)
    xs = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]
    assert poseidon.poseidon_hash(xs, t=t) == jposeidon.poseidon_hash(xs, t=t)
    # absorbed one element at a time, the same state and output
    mine = poseidon.Poseidon(t=t)
    for v in xs:
        mine.update([v])
    assert mine.squeeze() == jposeidon.poseidon_hash(xs, t=t)
