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


def level_inputs(digits, pts, W, B, bucket_pts):
    """Slot arrays of one level (W windows of len(digits) / W slots) and a
    bucket table of W * B + 1 rows (the last one the plain version's dump)."""
    slots = to_port(pts)
    dig = torch.tensor(digits, dtype=torch.int32)
    bucket = to_port(bucket_pts + [(1, 1, 0)])
    return slots, dig, bucket


def host_level(digits, pts, W, bucket_pts):
    """The level by host arithmetic: survivors and buckets as Jacobian ints."""
    m = len(digits) // W
    B = len(bucket_pts) // W
    buckets = list(bucket_pts)
    surv = []
    for w in range(W):
        for i in range(0, m, 2) if m > 1 else [0]:
            s = w * m + i
            if m > 1 and digits[s] == digits[s + 1]:
                surv.append(MJ.host_jac_add(pts[s], pts[s + 1], Q))
                continue
            slot = w * B + digits[s]
            buckets[slot] = MJ.host_jac_add(buckets[slot], pts[s], Q)
            if m > 1:
                surv.append(pts[s + 1])
    return surv, buckets


def test_msm_level_edge_lanes_match_host():
    """One level over the lane cases: equal digits (A + B), flushes into an
    empty bucket, into a bucket holding the same point (P = Q, the
    doubling) and into one holding its negation (P = -Q, the identity),
    identity slots, and the final flush of each window's survivor."""
    base = [host_mul(int(RNG.randint(1, 1 << 40))) for _ in range(6)]
    a, b, c, d, e, f = (rescale(p, int(RNG.randint(2, 1 << 40))) for p in base)
    W, B = 2, 4
    digits = [3, 2, 2, 1,   # window 0: two flushes (into buckets 3 and 2)
              2, 2, 1, 1]   # window 1: two equal-digit pairs
    pts = [a, b, c, d,
           e, (1, 1, 0), f, rescale(f, 3)]  # an identity slot; f + f
    bucket_pts = [(1, 1, 0)] * (W * B)
    bucket_pts[3] = rescale(a, 7)  # P = Q
    bucket_pts[2] = (c[0], (-c[1]) % Q, c[2])  # P = -Q
    slots, dig, bucket = level_inputs(digits, pts, W, B, bucket_pts)
    surv, sdig = MJ.msm_level_plain(slots, dig, bucket, W, B)
    want_surv, want_buckets = host_level(digits, pts, W, bucket_pts)
    assert sdig.tolist() == [2, 1, 2, 1]
    assert affine(jac_ints(surv, Fq.decode_ints)) == affine(want_surv)
    got_buckets = jac_ints({k: v[: W * B] for k, v in bucket.items()}, Fq.decode_ints)
    assert affine(got_buckets) == affine(want_buckets)
    assert affine(got_buckets)[2] == (0, 0) and affine(got_buckets)[3] == affine([MJ.host_jac_double(a, Q)])[0]
    # the final flush: one survivor per window into its bucket
    final, _ = MJ.msm_level_plain(surv := {k: v[::2].contiguous() for k, v in surv.items()}, sdig[::2].contiguous(),
                                  bucket, W, B)
    assert final["x"].shape[0] == 0
    flushed = affine(jac_ints({k: v[: W * B] for k, v in bucket.items()}, Fq.decode_ints))
    want = affine([MJ.host_jac_add(want_buckets[w * B + 2], jac_ints(surv, Fq.decode_ints)[w], Q) for w in range(W)])
    assert [flushed[w * B + 2] for w in range(W)] == want


def test_msm_first_level_reads_through_the_sort():
    """The first level reads the points through the sort's permutation, and
    digit-0 slots are the identity (their points never reach a bucket)."""
    n, W, B = 8, 2, 8
    pts = [host_mul(int(RNG.randint(1, 1 << 30))) for _ in range(n)]
    digits = torch.tensor([[5, 0, 5, 3, 0, 7, 3, 3], [1, 1, 1, 1, 0, 0, 2, 0]], dtype=torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = to_port([(1, 1, 0)] * (W * B + 1))
    surv, sdig = MJ.msm_level_plain(to_port(pts), digits, bucket, W, B, order=order)
    sorted_pts = [pts[i] if digits[w, i] else (pts[i][0], pts[i][1], 0) for w in range(W) for i in order[w].tolist()]
    sorted_dig = torch.gather(digits, 1, order).reshape(-1).tolist()
    want_surv, want_buckets = host_level(sorted_dig, sorted_pts, W, [(1, 1, 0)] * (W * B))
    assert affine(jac_ints(surv, Fq.decode_ints)) == affine(want_surv)
    assert affine(jac_ints({k: v[: W * B] for k, v in bucket.items()}, Fq.decode_ints)) == affine(want_buckets)
    assert sdig.tolist() == [5, 3, 3, 0, 1, 1, 0, 0]  # each pair's right slot


def test_no_level_writes_one_bucket_twice():
    """Over every level of an MSM whose windows repeat digits often (c = 3),
    the flushed buckets of a level are distinct and are the only bucket rows
    that change."""
    n = 32
    pts = [host_mul(int(RNG.randint(1, 1 << 30))) for _ in range(8)]
    points = to_port([rescale(pts[i % 8], int(RNG.randint(2, 1 << 30))) for i in range(n)])
    scal = Fr.encode(rand_fes(n))
    c = MJ.best_c(n)
    B, W = 1 << c, -(-Fr.num_bits // c)
    digits = MJ.digits_all(F.from_mont(Fr, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = ec.identity_point(W * B + 1)
    slot_dig = torch.gather(digits, 1, order).reshape(-1)
    level_pts, level_dig, levels = points, digits, 0
    while True:
        m = slot_dig.shape[0] // W
        if m == 1:
            da, flush = slot_dig, torch.ones(W, dtype=torch.bool)
        else:
            da, db = slot_dig.view(-1, 2).unbind(1)
            flush = da != db
        lane_w = torch.arange(da.shape[0]) // (da.shape[0] // W)
        slots = (lane_w * B + da)[flush]
        assert slots.unique().numel() == slots.numel()
        before = {k: v[: W * B].clone() for k, v in bucket.items()}
        level_pts, level_dig = MJ.msm_level_plain(level_pts, level_dig, bucket, W, B,
                                                  order=order if levels == 0 else None)
        changed = torch.zeros(W * B, dtype=torch.bool)
        for k in ec.COORDS:
            changed |= (bucket[k][: W * B] != before[k]).any(1)
        assert set(changed.nonzero().flatten().tolist()) <= set(slots.tolist())
        levels += 1
        if m == 1:
            break
        slot_dig = level_dig
    assert levels == n.bit_length()  # log2(n) halving levels and the final flush


@pytest.mark.parametrize("fault", ["int64 digits", "strided digits", "strided rows", "int32 order"])
def test_msm_level_refuses_what_the_kernel_cannot_read(fault):
    """The wrapper checks its inputs on either device as the kernel reads
    them (contiguous int32 rows and digits, a contiguous int64 order), so a
    CPU call refuses what a card call could not read correctly."""
    W, B, n = 2, 4, 4
    pts = ec.identity_point(n)
    digits = torch.tensor([[3, 1, 0, 2], [1, 1, 2, 0]], dtype=torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = ec.identity_point(W * B + 1)
    MJ.msm_level(pts, digits, bucket, W, B, order=order)  # the well-formed call runs
    if fault == "int64 digits":
        digits = digits.to(torch.int64)
    elif fault == "strided digits":
        digits = torch.zeros((W, 2 * n), dtype=torch.int32)[:, ::2]
    elif fault == "strided rows":
        pts = {k: torch.cat([v, v]).view(n, 2 * F.LIMBS)[:, : F.LIMBS] for k, v in pts.items()}
    else:
        order = order.to(torch.int32)
    with pytest.raises(ValueError, match="msm_level"):
        MJ.msm_level(pts, digits, bucket, W, B, order=order)


# The bit-plane tree: the plane tree (csrc/ec_add.cu, bucket_planes_plain)
# adds only the buckets each plane keeps, in the nesting of the gathered
# tree it replaced, whose other leaves were masked to the identity. The
# complete add passes a non-identity operand through unchanged when the
# other is the identity and gives (R, R, 0) for two identities, and every
# identity among the buckets is (R, R, 0), so dropping the masked leaves
# changes no plane sum, not even in its Jacobian limbs.


def gathered_tree(bucket, c, W, base):
    """The plane sums as the gathered tree computed them: 2^c c W rows, row
    v c W + j W + w bucket w 2^c + v with z = 0 unless bit j of v is set,
    halved c times (rows r and r + rows / 2) by the complete add."""
    B = 1 << c
    v = torch.arange(B)[:, None, None]
    j = torch.arange(c)[None, :, None]
    w = torch.arange(W)[None, None, :]
    idx = (w * B + v).expand(B, c, W).reshape(-1)
    keep = ((v >> j) & 1).bool().expand(B, c, W).reshape(-1, 1)
    tree = {k: bucket[k][idx] for k in ec.COORDS}
    tree["z"] = torch.where(keep, tree["z"], torch.zeros_like(tree["z"]))
    rows = tree["x"].shape[0]
    while rows > c * W:
        rows //= 2
        tree = ec.ec_add_plain({k: v[:rows] for k, v in tree.items()}, {k: v[rows:] for k, v in tree.items()}, base)
    return tree


@pytest.mark.parametrize("curve_name", ["BN254_G1", "GRUMPKIN"], ids=["bn254", "grumpkin"])
@pytest.mark.parametrize("c, W", [(3, 3), (4, 2)])
def test_plane_tree_order_matches_gathered_tree(curve_name, c, W):
    """bucket_planes_plain bit for bit against the gathered tree over the
    same buckets: empty buckets, equal points and negations among them."""
    import chip_smoke
    from halo2_lasso_tpu_torch.ops import curves

    curve = getattr(curves, curve_name)
    rng = np.random.RandomState(60 + c)
    bucket = chip_smoke.msm_edge_points(np, rng, MJ, curve.base.modulus, "cpu", n=W << c, curve=curve)
    empty = ec.identity_point(1, "cpu", curve.base)
    for r in (1, 2, 7, (W << c) - 3):
        for k in ec.COORDS:
            bucket[k][r] = empty[k][0]
    got = MJ.bucket_planes_plain(bucket, c, W, curve.base)
    want = gathered_tree(bucket, c, W, curve.base)
    assert all(torch.equal(got[k], want[k]) for k in ec.COORDS)
    assert all(torch.equal(MJ.bucket_planes(bucket, c, W, curve.base)[k], got[k]) for k in ec.COORDS)


def test_plane_tree_nesting_at_full_width():
    """The same claim over symbolic labels at an MSM's c = 10 and W = 26,
    None the identity and an add a pair (first operand, second): the
    gathered tree with the masked leaves and the plane tree's halving over
    the kept buckets give the same nested sums, with some buckets empty."""
    c, W = 10, 26
    B = 1 << c

    def add(a, b):
        return b if a is None else a if b is None else (a, b)

    def halve(t):
        while len(t) > 1:
            h = len(t) // 2
            t = [add(t[i], t[i + h]) for i in range(h)]
        return t[0]

    rows = MJ._tree_rows(c, W, "cpu").tolist()
    for j in range(c):
        for w in range(W):
            label = [None if (w * 7 + v) % 37 == 0 else (w, v) for v in range(B)]  # some empty
            old = halve([label[v] if (v >> j) & 1 else None for v in range(B)])
            new = halve([label[r - w * B] for r in rows[j * W + w]])
            assert old == new, (j, w)
