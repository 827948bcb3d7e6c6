"""An MSM of 2^12 BN254 G1 points split over a port mesh of D virtual CPU
shards (``sharding.sharded_msm``: ``msm_planes`` on each shard's points and
scalars, the shards' Jacobian totals added on the host), D = 2 and 4,
against the port's single-device MSM of the same points and against the
host's scalar multiple of the generator: every point is a known multiple
k_i G, so the MSM is (sum s_i k_i) G, exactly.

The JAX package's sharded_msm is not run here: on an 8-core CPU its
Pippenger module (ops/ec.py _msm_impl under shard_map) compiled for more
than five minutes, and its double-and-add path took 45 s at 2^12.
tests/test_torch_msm.py holds the port's single-device MSM to the JAX
package's at 2^10.
"""

import numpy as np
import pytest
import torch

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fq, Fr
from halo2_lasso_tpu_torch.parallel import sharding as sh

Q = FQ_MODULUS
N = 1 << 12
torch.set_num_threads(1)  # the suite's workers share the cores


def host_mul(k):
    acc, base = (0, 0, 0), (1, 2, 1)
    while k:
        if k & 1:
            acc = MJ.host_jac_add(acc, base, Q)
        base = MJ.host_jac_double(base, Q)
        k >>= 1
    return acc


@pytest.fixture(scope="module")
def job():
    """2^12 points k_i G (16 multiples, each in another Jacobian scale),
    scalars from a seed with a few zeros, and the expected affine point."""
    rng = np.random.RandomState(12)
    ks = [int(rng.randint(1, 1 << 30)) for _ in range(16)]
    base = [host_mul(k) for k in ks]
    pts, mult = [], []
    for i in range(N):
        lam = int(rng.randint(2, 1 << 30))
        x, y, z = base[i % 16]
        pts.append((x * lam * lam % Q, y * lam**3 % Q, z * lam % Q))
        mult.append(ks[i % 16])
    scal = [int.from_bytes(rng.bytes(40), "little") % Fr.modulus for _ in range(N)]
    scal[::97] = [0] * len(scal[::97])
    want = MJ.host_batch_affine([host_mul(sum(s * k for s, k in zip(scal, mult)) % Fr.modulus)], Q)[0]
    points = {c: Fq.encode([p[i] for p in pts]) for i, c in enumerate(ec.COORDS)}
    return points, Fr.encode(scal), want


@pytest.fixture(scope="module")
def single(job):
    points, scal, _ = job
    return ec.msm_to_affine_int(points, scal)


def test_single_device_msm_is_the_known_multiple(job, single):
    assert single == job[2]


@pytest.mark.parametrize("d", [2, 4])
def test_split_msm_matches_single_device(job, single, d, monkeypatch):
    points, scal, want = job
    sizes = []
    planes = MJ.msm_planes
    monkeypatch.setattr(MJ, "msm_planes", lambda p, s, *a: sizes.append(s.shape[0]) or planes(p, s, *a))
    total = sh.sharded_msm(sh.Mesh(["cpu"] * d), points, scal)
    assert sizes == [N // d] * d
    assert MJ.host_batch_affine([total], Q)[0] == single == want
