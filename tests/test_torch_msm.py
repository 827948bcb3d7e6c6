"""Port curve layer (halo2_lasso_tpu_torch.ops.ec, ops.msm_jacobian) against
the JAX package on the CPU: the complete add on the five lane cases and
MSMs at n = 64 and 2^10, compared as affine (x, y) ints. The SRS and KZG
tests share the JAX SRS with the Lasso proof in tests/test_torch_lasso.py. The ec_add kernel is held to its
plain version on the card by tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import ec as jec
from halo2_lasso_tpu.ops.bn254 import Fq as JFq
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fq, Fr

P = Fr.modulus
Q = FQ_MODULUS
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(5)


def rand_fes(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


def host_mul(k):
    acc, base = (0, 0, 0), (1, 2, 1)
    while k:
        if k & 1:
            acc = MJ.host_jac_add(acc, base, Q)
        base = MJ.host_jac_double(base, Q)
        k >>= 1
    return acc


def rescale(pt, lam):
    return (pt[0] * lam * lam % Q, pt[1] * lam**3 % Q, pt[2] * lam % Q)


def five_cases(n):
    """Jacobian pairs: generic, P = Q (other coordinates), P = -Q, P = O, Q = O."""
    base = [host_mul(int(RNG.randint(1, 1 << 40))) for _ in range(8)]
    ps, qs = [], []
    for i in range(n):
        a = rescale(base[i % 8], int(RNG.randint(2, 1 << 40)))
        b = rescale(base[(i + 3) % 8], int(RNG.randint(2, 1 << 40)))
        b = [b, rescale(a, 5), (a[0], (-a[1]) % Q, a[2]), b, (1, 1, 0)][i % 5]
        a = (1, 1, 0) if i % 5 == 3 else a
        ps.append(a)
        qs.append(b)
    return ps, qs


def to_port(pts, device="cpu"):
    return {k: Fq.encode([pt[i] for pt in pts], device) for i, k in enumerate(ec.COORDS)}


def jac_ints(coords, decode):
    return list(zip(*(decode(coords[k]) for k in ec.COORDS)))


def affine(jac):
    return MJ.host_batch_affine(jac, Q)


def test_ec_add_five_cases_match_jax():
    ps, qs = five_cases(20)
    jp = {k: jnp.asarray(JFq.encode([pt[i] for pt in ps])) for i, k in enumerate(ec.COORDS)}
    jq = {k: jnp.asarray(JFq.encode([pt[i] for pt in qs])) for i, k in enumerate(ec.COORDS)}
    want = affine(jac_ints(jec.ec_add(jp, jq), lambda a: [int(v) for v in JFq.decode(np.asarray(a))]))
    got = ec.ec_add({k: F.from_jax_limbs(np.asarray(v)) for k, v in jp.items()},
                    {k: F.from_jax_limbs(np.asarray(v)) for k, v in jq.items()})
    assert affine(jac_ints(got, Fq.decode_ints)) == want
    assert ec.jacobian_to_affine(got) == want
    assert want[2::5] == [(0, 0)] * 4 and want[3::5] == affine(qs[3::5])


@pytest.mark.parametrize("n", [64, 1 << 10])
def test_msm_matches_jax(n, monkeypatch):
    # the JAX package's double-and-add path of variable_base_msm gives the
    # same group element at 2^10 in seconds on the CPU, where its halving
    # tree runs op by op for minutes
    monkeypatch.setattr(jec, "SMALL_MSM_MAX", 1 << 10)
    pts = [host_mul(int(RNG.randint(1, 1 << 30))) for _ in range(8)]
    pts = [rescale(pts[i % 8], int(RNG.randint(2, 1 << 30))) for i in range(n)]
    pts[1] = (1, 1, 0)
    scal = rand_fes(n)
    scal[2] = 0
    jpts = {k: jnp.asarray(JFq.encode([pt[i] for pt in pts])) for i, k in enumerate(ec.COORDS)}
    jscal = jnp.asarray(JFr.encode(scal))
    want = jec.msm_to_affine_int(jpts, jscal)
    got = ec.msm_to_affine_int({k: F.from_jax_limbs(np.asarray(v)) for k, v in jpts.items()},
                               F.from_jax_limbs(np.asarray(jscal)))
    assert got == want
