"""The comparison MSM engines of the port against the JAX package on the
CPU: the batched-affine MSM (ops/msm_affine.py), the scan MSM
(ops/msm_scan.py, the counterpart of ops/pallas_ec.py:206-366), the
segmented pipeline behind HALO2_LASSO_TPU_MSM_GROUP_LANES, the
HALO2_LASSO_TPU_MSM=affine switch, ``batch_msm``, ``_msm_small`` and the
fixed-base MSM's identity base and slices.

tests/test_msm_affine.py's five tests through the port, for both engines
(random points, duplicate points for the doubling lanes, zero scalars and
identity points for the infinity lanes, opposite points for the
cancellations; the batch inversion with its parameters); every result is
also the JAX package's ``variable_base_msm`` / ``msm_list_to_affine_int``
affine point (its per-lane ladder path, SMALL_MSM_MAX raised as in
tests/test_torch_msm.py). The engines are held on the card at 2^16 by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import ec as jec
from halo2_lasso_tpu.ops import pallas_ec as jpallas_ec
from halo2_lasso_tpu.ops.bn254 import Fq as JFq
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_affine, msm_scan
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fq, Fr

P = Fr.modulus
Q = FQ_MODULUS
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(3)
ENGINES = {"affine": msm_affine.msm_affine, "scan": msm_scan.msm_pallas}


@pytest.fixture(autouse=True)
def small_jax_msm(monkeypatch):
    # the JAX package's per-lane ladder path of variable_base_msm gives the
    # same group element in seconds on the CPU (tests/test_torch_msm.py)
    monkeypatch.setattr(jec, "SMALL_MSM_MAX", 1 << 10)


def host_mul(k):
    acc, base = (0, 0, 0), (1, 2, 1)
    while k:
        if k & 1:
            acc = MJ.host_jac_add(acc, base, Q)
        base = MJ.host_jac_double(base, Q)
        k >>= 1
    return acc


def rand_points(n, dup=False):
    """n Jacobian ints: multiples of G, each in its own projective form."""
    ks = [int(v) for v in RNG.randint(1, 1 << 30, size=n)]
    if dup:
        ks = [ks[0]] * n
    out = []
    for k in ks:
        lam = int(RNG.randint(2, 1 << 30))
        x, y, z = host_mul(k)
        out.append((x * lam * lam % Q, y * lam**3 % Q, z * lam % Q))
    return out


def rand_scalars(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


def both(pts, scal):
    """The same inputs for the port and for the JAX package."""
    port = ({k: Fq.encode([pt[i] for pt in pts]) for i, k in enumerate(ec.COORDS)}, Fr.encode(scal))
    jax_ = ({k: jnp.asarray(JFq.encode([pt[i] for pt in pts])) for i, k in enumerate(ec.COORDS)},
            jnp.asarray(JFr.encode(scal)))
    return port, jax_


def run(engine, pts, scal):
    (p, s), (jp, js) = both(pts, scal)
    got = ec.jacobian_to_affine(ENGINES[engine](p, s))[0]
    assert got == ec.msm_to_affine_int(p, s)
    assert got == jec.msm_to_affine_int(jp, js)
    return got


@pytest.mark.parametrize("engine", list(ENGINES))
def test_basic(engine):
    run(engine, rand_points(64), rand_scalars(64))


@pytest.fixture
def narrow_windows(monkeypatch):
    """4-bit windows for the affine engine (the JAX package's sweep switch,
    HALO2_LASSO_TPU_MSM_C): the edge lanes at a tenth of the CPU time."""
    monkeypatch.setenv("HALO2_LASSO_TPU_MSM_C", "4")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_duplicate_points(engine, narrow_windows):
    run(engine, rand_points(64, dup=True), rand_scalars(64))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_zero_scalars(engine, narrow_windows):
    pts, scal = rand_points(64), rand_scalars(64)
    for i in range(0, 64, 3):
        scal[i] = 0
    pts[1] = (1, 1, 0)  # an identity point
    run(engine, pts, scal)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_opposite_points_cancel(engine, narrow_windows):
    # P and -P with equal scalars: forces cancellation lanes
    pts = rand_points(4)
    neg = [(x, (-y) % Q, z) for x, y, z in pts]
    assert run(engine, pts + neg, [5, 7, 11, 13] * 2) == (0, 0)


@pytest.mark.parametrize("m", [64, 2048, 4096, 12288, 2816])
def test_batch_inv_lanes(m):
    """The batch inversion of the affine levels: a * inv(a) == 1 below and
    above the Fermat bound and at the non-power-of-two widths the levels
    give (12288 = 3 * 2^12, 2816 = 11 * 2^8)."""
    vals = [(int.from_bytes(RNG.bytes(40), "little") % (Q - 1)) + 1 for _ in range(m)]
    a = Fq.encode(vals)
    inv = msm_affine._batch_inv_lanes(a, Fq)
    assert torch.equal(msm_affine.mul_lf(a, inv, Fq), Fq.one().expand(m, F.LIMBS))
    assert torch.equal(msm_affine.batch_inv_lf(torch.cat([a[:5], Fq.zeros(1)]), Fq)[-1], Fq.zeros(1)[0])


def test_engine_switch_and_variable_base_msm(monkeypatch):
    """HALO2_LASSO_TPU_MSM=affine routes msm_to_affine_int and
    variable_base_msm above SMALL_MSM_MAX (32 here) through msm_affine; at
    most that the per-lane ladder (_msm_small). Each is the JAX package's
    point."""
    monkeypatch.setattr(ec, "SMALL_MSM_MAX", 32)
    pts, scal = rand_points(64), rand_scalars(64)
    (p, s), (jp, js) = both(pts, scal)
    want = jec.msm_to_affine_int(jp, js)
    calls = []
    real = msm_affine.msm_affine
    monkeypatch.setattr(msm_affine, "msm_affine", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("HALO2_LASSO_TPU_MSM", "affine")
    assert ec.msm_to_affine_int(p, s) == want and calls == [1]
    monkeypatch.delenv("HALO2_LASSO_TPU_MSM")
    assert ec.jacobian_to_affine(ec.variable_base_msm(p, s))[0] == want
    small = {k: v[:20] for k, v in p.items()}
    assert ec.jacobian_to_affine(ec.variable_base_msm(small, s[:20]))[0] == \
        jec.msm_to_affine_int({k: v[:20] for k, v in jp.items()}, js[:20])


def test_segmented_grouping_matches_jax(monkeypatch):
    """Jobs of mixed sizes grouped into segmented pipelines (a lane budget
    of three 64-point jobs) give msm_list_to_affine_int's points unchanged,
    and the JAX package's."""
    sizes = [64, 50, 64, 3, 32, 64]
    jobs = [both(rand_points(n), rand_scalars(n)) for n in sizes]
    want = jec.msm_list_to_affine_int([j for _, j in jobs])
    ungrouped = ec.msm_list_to_affine_int([p for p, _ in jobs])
    seg_calls = []
    real = MJ.device_partials_seg
    monkeypatch.setattr(MJ, "device_partials_seg", lambda jb, *a: seg_calls.append(len(jb)) or real(jb, *a))
    monkeypatch.setenv("HALO2_LASSO_TPU_MSM_GROUP_LANES", str(26 * 64 * 3))
    grouped = ec.msm_list_to_affine_int([p for p, _ in jobs])
    assert grouped == ungrouped == want
    assert sorted(seg_calls) == [3, 3]


def test_segment_planes_split_as_single_pipelines():
    """Each segment's plane sums in a segmented pipeline are that MSM's own."""
    jobs = [both(rand_points(n), rand_scalars(n))[0] for n in (64, 64, 32)]
    planes, c, W = MJ.device_partials_seg(jobs, Fq, Fr, 64)
    flat = Fq.decode_ints(torch.cat([planes[k] for k in ec.COORDS]))
    m = len(flat) // 3
    segs = MJ.finish_host_segments(list(zip(flat[:m], flat[m : 2 * m], flat[2 * m :])), c, W, 3, Q)
    assert MJ.host_batch_affine(segs, Q) == ec.msm_list_to_affine_int(jobs)


def test_batch_msm_matches_jax():
    pts = rand_points(16)
    scal = [rand_scalars(16) for _ in range(2)]
    (p, _), (jp, _) = both(pts, scal[0])
    got = ec.batch_msm(p, torch.stack([Fr.encode(s) for s in scal]))
    want = jec.batch_msm(jp, jnp.stack([jnp.asarray(JFr.encode(s)) for s in scal]))
    assert got == [(int(x), int(y)) for x, y in want]


def test_msm_small_rows():
    pts = rand_points(16)
    scal = [rand_scalars(16) for _ in range(2)]
    (p, _), _ = both(pts, scal[0])
    rows = ec._msm_small(p, torch.stack([F.from_mont(Fr, Fr.encode(s)) for s in scal]))
    assert ec.jacobian_to_affine(rows) == [ec.msm_to_affine_int(p, Fr.encode(s)) for s in scal]


def test_fixed_base_identity_and_slices(monkeypatch):
    from halo2_lasso_tpu_torch.ops.bn254 import G1_GEN

    scal = Fr.encode(rand_scalars(48))
    assert ec.jacobian_to_affine(ec.fixed_base_msm((0, 0), scal)) == [(0, 0)] * 48
    scal = Fr.encode(rand_scalars(150))
    whole = ec.jacobian_to_affine(ec.fixed_base_msm(G1_GEN, scal))
    monkeypatch.setattr(ec, "FIXED_BASE_GATHER_ROWS", 64 * 32)  # slices of 64 scalars
    assert ec.jacobian_to_affine(ec.fixed_base_msm(G1_GEN, scal)) == whole


def test_scan_pieces_match_jax():
    """The scan MSM's window choice and digits are the JAX package's, and
    its prefix scan gives the prefix sums."""
    for n in (1 << 8, 1 << 12, 1 << 16, 1 << 20):
        assert msm_scan._best_c(n) == jpallas_ec._best_c(n)
    scal = rand_scalars(16)
    canon = F.from_mont(Fr, Fr.encode(scal))
    for w, c in ((0, 13), (2, 13), (19, 13), (3, 10)):
        want = [(v >> (c * w)) & ((1 << c) - 1) for v in scal]
        assert msm_scan._digits_for_window(canon, w, c).tolist() == want
    pts = rand_points(8)
    (p, _), _ = both(pts, rand_scalars(8))
    acc, prefix = (0, 0, 0), []
    for pt in pts:
        acc = MJ.host_jac_add(acc, pt, Q)
        prefix.append(acc)
    assert ec.jacobian_to_affine(msm_scan.ec_prefix_scan(p)) == MJ.host_batch_affine(prefix, Q)
