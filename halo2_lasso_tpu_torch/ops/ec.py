"""Curve arithmetic over BN254 G1, grumpkin, Pallas and Vesta (the port of
halo2_lasso_tpu/ops/ec.py).

A point batch is a dict {"x", "y", "z"} of (n, 8) tensors over the curve's
coordinate field ``spec`` in Jacobian coordinates; the identity has z = 0
(and x = y = R mod p when this module makes it). As in the JAX package the
field is an argument, BN254 G1's Fq by default; grumpkin's is Fr, Pallas'
and Vesta's their base fields (ops/curves.py; every curve has a = 0).
``ec_add`` is the port of the TPU kernel _ec_add_kernel
(ops/pallas_ec.py:144) and, for the other curves, of the add the TPU builds
from Montgomery-product launches (msm_jacobian.jac_add_lf): on a CUDA
tensor it launches csrc/ec_add.cu's instance for the field or raises; only
CPU tensors take ``ec_add_plain``, the same formulas in plain field ops,
bit for bit. ``ec_double`` is that add of a batch to itself.
``ec_ladder`` (and ``scalar_mul_bits`` over it) scales a batch in one
launch of csrc/ec_add.cu's ladder, where the TPU ran two ``ec_add``
launches a bit; ``scalar_mul_bits_plain`` is that loop in plain field ops.

MSMs run the halving-tree Pippenger of ops/msm_jacobian.py; commitments
leave the device as affine (x, y) canonical ints, (0, 0) for the identity.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec

Points = Dict[str, torch.Tensor]
COORDS = ("x", "y", "z")


def identity_point(n: int, device="cpu", spec: FieldSpec = Fq) -> Points:
    one = spec.one(device).expand(n, F.LIMBS).contiguous()
    return {"x": one, "y": one.clone(), "z": spec.zeros(n, device)}


def affine_to_jacobian(pts_xy: Sequence[Tuple[int, int]], device="cpu", spec: FieldSpec = Fq) -> Points:
    """Canonical affine ints ((0, 0) = identity) -> Jacobian point batch."""
    is_id = [x == 0 and y == 0 for x, y in pts_xy]
    xs = [1 if i else x for (x, _), i in zip(pts_xy, is_id)]
    ys = [1 if i else y for (_, y), i in zip(pts_xy, is_id)]
    zs = [0 if i else 1 for i in is_id]
    return {"x": spec.encode(xs, device), "y": spec.encode(ys, device), "z": spec.encode(zs, device)}


def jacobian_to_affine(pts: Points, spec: FieldSpec = Fq) -> List[Tuple[int, int]]:
    """Device Jacobian batch -> host affine ints, one batch inversion."""
    zinv = F.batch_inv(spec, pts["z"])
    zinv2 = F.mont_mul(spec, zinv, zinv)
    ax = spec.decode_ints(F.mont_mul(spec, pts["x"], zinv2))
    ay = spec.decode_ints(F.mont_mul(spec, pts["y"], F.mont_mul(spec, zinv2, zinv)))
    zero = F.is_zero(pts["z"]).tolist()
    return [(0, 0) if z else (x, y) for x, y, z in zip(ax, ay, zero)]


# ---------------------------------------------------------------------------
# complete Jacobian add: kernel wrapper + plain version
# ---------------------------------------------------------------------------


def _ec_add_host(p: Points, q: Points, spec: FieldSpec) -> Points:
    """``ec_add_plain`` in host ints, lane by lane, for a small CPU batch
    (see ops/field.py HOST_PLAIN_ROWS): the same formulas on the same
    Montgomery-form numbers, so the same coordinates bit for bit."""
    m, rinv, one = spec.modulus, spec.Rinv, spec.R
    cols = [F.u32_to_ints(F.to_numpy_u32(t)) for t in (p["x"], p["y"], p["z"], q["x"], q["y"], q["z"])]
    out = []
    for x1, y1, z1, x2, y2, z2 in zip(*cols):
        if z1 == 0:
            out.append((one, one, 0) if z2 == 0 else (x2, y2, z2))
            continue
        if z2 == 0:
            out.append((x1, y1, z1))
            continue
        z1z1, z2z2 = z1 * z1 * rinv % m, z2 * z2 * rinv % m
        u1, u2 = x1 * z2z2 * rinv % m, x2 * z1z1 * rinv % m
        s1 = y1 * z2 * rinv % m * z2z2 * rinv % m
        s2 = y2 * z1 * rinv % m * z1z1 * rinv % m
        h, r = (u2 - u1) % m, (s2 - s1) % m
        if h == 0:
            if r:
                out.append((one, one, 0))
                continue
            a, b = x1 * x1 * rinv % m, y1 * y1 * rinv % m
            c = b * b * rinv % m
            xb = (x1 + b) % m
            d = 2 * ((xb * xb * rinv - a - c) % m) % m
            e = 3 * a % m
            xd = (e * e * rinv - 2 * d) % m
            out.append((xd, (e * ((d - xd) % m) * rinv - 8 * c) % m, 2 * y1 % m * z1 * rinv % m))
            continue
        hh = h * h * rinv % m
        hhh, v = hh * h * rinv % m, u1 * hh * rinv % m
        x3 = (r * r * rinv - hhh - 2 * v) % m
        y3 = (r * ((v - x3) % m) * rinv - s1 * hhh * rinv) % m
        out.append((x3, y3, z1 * z2 * rinv % m * h * rinv % m))
    return {k: F.from_numpy_u32(F.ints_to_u32([pt[i] for pt in out])).reshape(-1, F.LIMBS)
            for i, k in enumerate(COORDS)}


def ec_add_plain(p: Points, q: Points, spec: FieldSpec = Fq) -> Points:
    """add-2007-bl with the dbl-2009-l doubling (a = 0) for P = Q and the
    same lane selection as the kernel (ops/pallas_ec.py:85-141), over the
    coordinate field `spec`: the plain version of both K3 instances. As the
    kernel's warp vote does, the doubling is computed only when some lane
    needs it, and alone for a batch added to itself (the same dict: the
    ladder's doubling step). A small CPU batch takes the same formulas in
    host ints."""
    if p["x"].device.type == "cpu" and p["x"].shape[0] <= F.HOST_PLAIN_ROWS:
        return _ec_add_host(p, q, spec)
    s = spec
    mul = functools.partial(F.mont_mul_plain, s)
    add = functools.partial(F.add_plain, s)
    sub = functools.partial(F.sub_plain, s)
    x1, y1, z1, x2, y2, z2 = p["x"], p["y"], p["z"], q["x"], q["y"], q["z"]

    def double():
        a, b = mul(x1, x1), mul(y1, y1)
        c = mul(b, b)
        xb = add(x1, b)
        t = sub(sub(mul(xb, xb), a), c)
        d = add(t, t)
        e = add(add(a, a), a)
        xd = sub(mul(e, e), add(d, d))
        c8 = add(add(c, c), add(c, c))
        c8 = add(c8, c8)
        yd = sub(mul(e, sub(d, xd)), c8)
        return xd, yd, mul(add(y1, y1), z1)

    p_id, q_id = F.is_zero(z1), F.is_zero(z2)
    if p is q:
        # P + P: h = r = 0 on every lane but the identity's, so no lane takes
        # the sum below; the doubling alone gives the same coordinates
        x3, y3, z3 = double()
        take_q = take_p = use_id = torch.zeros_like(p_id)
        take_id = p_id
    else:
        z1z1, z2z2 = mul(z1, z1), mul(z2, z2)
        u1, u2 = mul(x1, z2z2), mul(x2, z1z1)
        s1, s2 = mul(mul(y1, z2), z2z2), mul(mul(y2, z1), z1z1)
        h, r = sub(u2, u1), sub(s2, s1)
        hh = mul(h, h)
        hhh = mul(hh, h)
        v = mul(u1, hh)
        x3 = sub(sub(mul(r, r), hhh), add(v, v))
        y3 = sub(mul(r, sub(v, x3)), mul(s1, hhh))
        z3 = mul(mul(z1, z2), h)
        both = ~p_id & ~q_id
        use_dbl = both & F.is_zero(h) & F.is_zero(r)
        use_id = both & F.is_zero(h) & ~F.is_zero(r)
        take_q, take_id, take_p = p_id & ~q_id, p_id & q_id, q_id & ~p_id
        if bool(use_dbl.any()):
            xd, yd, zd = double()
            dbl = use_dbl[:, None]
            x3, y3, z3 = torch.where(dbl, xd, x3), torch.where(dbl, yd, y3), torch.where(dbl, zd, z3)
    one = s.one(x1.device)
    zero = torch.zeros_like(one)

    def pick(add_v, idp_v, p_v, q_v):
        out = torch.where(take_p[:, None], p_v, add_v)
        out = torch.where(take_q[:, None], q_v, out)
        return torch.where((use_id | take_id)[:, None], idp_v, out)

    return {
        "x": pick(x3, one, x1, x2),
        "y": pick(y3, one, y1, y2),
        "z": pick(z3, zero, z1, z2),
    }


def curve_instance(spec: FieldSpec) -> str:
    """K3's instance for the coordinate field `spec` (grumpkin, BN254 G1,
    Pallas, Vesta); a field of no curve kernel raises."""
    if spec.kernel_id not in native.CURVES:
        raise ValueError(f"ec: no curve kernel over {spec.name}")
    return native.CURVES[spec.kernel_id]


def ec_add(p: Points, q: Points, spec: FieldSpec = Fq) -> Points:
    """Lane-wise complete Jacobian add of two (n,) batches over the
    coordinate field `spec` (Fq: BN254 G1, Fr: grumpkin, curves.Fp_pallas:
    Pallas, curves.Fq_vesta: Vesta). Kernel: csrc/ec_add.cu and its Pasta
    instances in csrc/ec_pasta.cu (port of pallas_ec._ec_add_kernel)."""
    if p["x"].device.type == "cpu":
        return ec_add_plain(p, q, spec)
    instance = curve_instance(spec)
    fid = native.field_id("ec_add", spec)
    ins = [t.contiguous() for t in (p["x"], p["y"], p["z"], q["x"], q["y"], q["z"])]
    n = ins[0].shape[0]
    if any(t.shape != (n, F.LIMBS) for t in ins):
        raise ValueError("ec_add: coordinates must be (n, 8) tensors of one length")
    native.require_cuda("ec_add", *ins)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    native.launch(
        "ec_add", ins[0].device, fid, *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], n,
    )
    native.count("ec_add", instance)
    return dict(zip(COORDS, outs))


def ec_double(p: Points, spec: FieldSpec = Fq) -> Points:
    """2P lane-wise (the port of ops/ec.py:115, dbl-2009-l): one launch of
    K3's complete add of the batch to itself, whose P = Q lanes take the
    same doubling formulas; the identity stays the identity."""
    return ec_add(p, p, spec)


def ec_neg(p: Points, spec: FieldSpec = Fq) -> Points:
    """-P lane-wise: y negated in one launch of csrc/mont_mul.cu."""
    return {"x": p["x"], "y": F.neg(spec, p["y"]), "z": p["z"]}


def ec_select(cond: torch.Tensor, p: Points, q: Points) -> Points:
    """where(cond, p, q) lane-wise, cond a bool (n,) or (1,) tensor."""
    return {k: torch.where(cond[:, None], p[k], q[k]) for k in COORDS}


def scalar_mul_bits_plain(p: Points, bits, spec: FieldSpec = Fq) -> Points:
    """The ladder in plain field ops: double-and-add from the top bit, each
    step a complete add of the accumulator to itself and one of the point
    (``ec_add_plain``), the sum kept where the bit is set. ``bits`` is one
    host sequence of nbits bits shared by every lane (the add is then made
    only for a set bit), or an (n, nbits) 0/1 tensor, both little-endian.
    The CPU path and the oracle of csrc/ec_add.cu's ladder."""
    n = p["x"].shape[0]
    shared = not isinstance(bits, torch.Tensor)
    nbits = len(bits) if shared else bits.shape[-1]
    acc = identity_point(n, p["x"].device, spec)
    for i in range(nbits):
        acc = ec_add_plain(acc, acc, spec)
        if not shared:
            acc = ec_select(bits[:, nbits - 1 - i] == 1, ec_add_plain(acc, p, spec), acc)
        elif bits[nbits - 1 - i]:
            acc = ec_add_plain(acc, p, spec)
    return acc


def scalars_to_bits(scalars_canonical: torch.Tensor, nbits: int) -> torch.Tensor:
    """(n, 8) canonical limbs -> (n, nbits) 0/1 bits, little-endian, nbits
    at most 256 (the port of ops/ec.py:231)."""
    limbs = scalars_canonical.to(torch.int64) & 0xFFFFFFFF
    i = torch.arange(nbits, device=scalars_canonical.device)
    return ((limbs[:, i // 32] >> (i % 32)) & 1).to(torch.uint8)


def _bits_to_limbs(bits: torch.Tensor) -> torch.Tensor:
    """(n, nbits) 0/1 bits, nbits <= 256 -> (n, 8) int32 limbs."""
    n, nbits = bits.shape
    padded = torch.zeros((n, 32 * F.LIMBS), dtype=torch.int64, device=bits.device)
    padded[:, :nbits] = bits.to(torch.int64)
    words = (padded.view(n, F.LIMBS, 32) << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _ladder_bits(scalar, nbits: int):
    """A ladder's scalar (a host int, or (n, 8) limbs) as
    ``scalar_mul_bits_plain`` takes it: nbits host bits, or an (n, nbits)
    0/1 tensor."""
    if isinstance(scalar, int):
        return [(scalar >> i) & 1 for i in range(nbits)]
    return scalars_to_bits(scalar, nbits)


def ec_ladder(p: Points, scalar, nbits: int, spec: FieldSpec = Fq) -> Points:
    """k * P lane-wise over the low ``nbits`` bits of the scalar, from the
    top, for an (n,) batch over the coordinate field `spec`: one launch of
    csrc/ec_add.cu's ladder (the port of ops/ec.py:216's loop of complete
    adds). ``scalar`` is a host int shared by every lane (passed by value),
    or an (n, 8) int32 tensor of canonical limbs on the points' device, one
    a lane. A CPU batch takes ``scalar_mul_bits_plain``, bit for bit the
    same; a CUDA batch launches or raises."""
    if not 0 <= nbits <= 256:
        raise ValueError("ec_ladder: at most 256 bits")
    shared = isinstance(scalar, int)
    if shared and not 0 <= scalar < 1 << 256:
        raise ValueError("ec_ladder: the scalar must lie in [0, 2^256)")
    if p["x"].device.type == "cpu":
        return scalar_mul_bits_plain(p, _ladder_bits(scalar, nbits), spec)
    instance = curve_instance(spec)
    fid = native.field_id("ec_ladder", spec)
    ins = [p[k].contiguous() for k in COORDS]
    n = ins[0].shape[0]
    if any(t.shape != (n, F.LIMBS) for t in ins) or (not shared and scalar.shape != (n, F.LIMBS)):
        raise ValueError("ec_ladder: coordinates and per-lane scalars must be (n, 8) tensors of one length")
    native.require_cuda("ec_ladder", *ins, *([] if shared else [scalar]))
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError("ec_ladder: coordinates must start on 16-byte boundaries")
    outs = [torch.empty_like(ins[0]) for _ in COORDS]
    if n:
        words = np.ascontiguousarray(F.ints_to_u32([scalar if shared else 0])[0])
        native.launch(
            "ec_ladder", ins[0].device, fid, *[t.data_ptr() for t in ins],
            None if shared else scalar.data_ptr(), words.ctypes.data, nbits, *[t.data_ptr() for t in outs], n,
        )
        native.count("ec_ladder", instance)
    return dict(zip(COORDS, outs))


def scalar_mul_bits(p: Points, bits, spec: FieldSpec = Fq) -> Points:
    """Lane-wise scalar multiple of an (n,) batch by double-and-add from the
    top bit (the port of ops/ec.py:216): ``ec_ladder`` over the scalar the
    bits spell, little-endian, at most 256 of them. ``bits`` is one host
    sequence shared by every lane, or an (n, nbits) 0/1 tensor on the
    points' device, one row a lane (``scalars_to_bits``), as the JAX
    package takes them."""
    if isinstance(bits, torch.Tensor):
        return ec_ladder(p, _bits_to_limbs(bits), bits.shape[-1], spec)
    return ec_ladder(p, sum(1 << i for i, b in enumerate(bits) if b), len(bits), spec)


def curve_generator(curve, device="cuda") -> Points:
    """The generator of a catalogued curve (ops/curves.py) as a one-point
    batch on `device`: BN254 G1, grumpkin, Pallas or Vesta, the curves with
    device group ops (a curve over a field without a curve kernel
    raises)."""
    curve_instance(curve.base)
    return affine_to_jacobian([curve.generator], device, curve.base)


def cat_points(*batches: Points) -> Points:
    return {k: torch.cat([b[k] for b in batches]) for k in COORDS}


def split_points(pts: Points, sizes: Sequence[int]) -> List[Points]:
    parts = {k: pts[k].split(list(sizes)) for k in COORDS}
    return [{k: parts[k][i] for k in COORDS} for i in range(len(sizes))]


# ---------------------------------------------------------------------------
# MSM entry points
# ---------------------------------------------------------------------------


SMALL_MSM_MAX = 1 << 9  # the JAX package's bound of the per-lane ladder MSM (ops/ec.py:265)


def _scalar_mul_lanes(points: Points, scalars_canonical: torch.Tensor, nbits: int, spec: FieldSpec = Fq) -> Points:
    """(M,) points x (M, 8) canonical scalars -> (M,) per-lane s_i * P_i
    (reference ops/ec.py:287): one launch of K3's ladder, a scalar a lane."""
    return ec_ladder(points, scalars_canonical, nbits, spec)


def _row_sum(pts_flat: Points, B: int, n: int, spec: FieldSpec = Fq) -> Points:
    """(B n,) flat point batch -> (B,) row sums, a K3 add a column
    (reference :302)."""
    rows = {k: v.view(B, n, F.LIMBS) for k, v in pts_flat.items()}
    acc = identity_point(B, pts_flat["x"].device, spec)
    for i in range(n):
        acc = ec_add(acc, {k: v[:, i] for k, v in rows.items()}, spec)
    return acc


def _msm_small(points: Points, scalars_canonical: torch.Tensor, spec: FieldSpec = Fq, nbits: int = None) -> Points:
    """(n,) points and (B, n, 8) canonical scalars -> (B,) points
    (reference :316): every lane's multiple in one ladder over the B n
    lanes (at least 64, padded with the identity), then the row sums."""
    nbits = nbits or Fr.num_bits
    B, n = scalars_canonical.shape[:2]
    device = scalars_canonical.device
    M = max(64, B * n)
    pts = {k: v.expand(B, n, F.LIMBS).reshape(B * n, F.LIMBS) for k, v in points.items()}
    scal = scalars_canonical.reshape(B * n, F.LIMBS)
    if M != B * n:
        pts = cat_points(pts, identity_point(M - B * n, device, spec))
        scal = torch.cat([scal, scal.new_zeros((M - B * n, F.LIMBS))])
    per_lane = {k: v[: B * n] for k, v in _scalar_mul_lanes(pts, scal, nbits, spec).items()}
    return _row_sum(per_lane, B, n, spec)


def _pad_msm_inputs(points: Points, scalars_mont: torch.Tensor, min_n: int = 16, spec: FieldSpec = Fq):
    """Identity points and zero scalars up to a power of two, at least
    min_n (reference :411)."""
    n = scalars_mont.shape[0]
    target = max(min_n, 1 << (n - 1).bit_length()) if n > 1 else min_n
    if target == n:
        return points, scalars_mont
    pad = target - n
    return (cat_points(points, identity_point(pad, scalars_mont.device, spec)),
            torch.cat([scalars_mont, scalars_mont.new_zeros((pad, F.LIMBS))]))


def _msm_engine() -> str:
    """The JAX package's switch of the large-MSM engine (ops/ec.py:461):
    HALO2_LASSO_TPU_MSM=affine takes ops/msm_affine.py; unset, the
    production Jacobian MSM."""
    return os.environ.get("HALO2_LASSO_TPU_MSM", "")


def variable_base_msm(points: Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
                      scalar: FieldSpec = Fr) -> Points:
    """sum_i s_i P_i as a one-point Jacobian batch (reference :440, msm.rs:84
    semantics), the inputs padded to a power of two (at least 16): above
    SMALL_MSM_MAX points the production Jacobian MSM, or under
    HALO2_LASSO_TPU_MSM=affine the batched-affine one; at most that, the
    per-lane ladder and a row sum."""
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ

    points, scalars_mont = _pad_msm_inputs(points, scalars_mont, spec=base)
    n = scalars_mont.shape[0]
    if n > SMALL_MSM_MAX:
        if _msm_engine() == "affine":
            from halo2_lasso_tpu_torch.ops.msm_affine import msm_affine

            return msm_affine(points, scalars_mont, base, scalar)
        X, Y, Z = MJ.msm(points, scalars_mont, base, scalar)
        device = scalars_mont.device
        return {k: base.encode([v], device) for k, v in zip(COORDS, (X, Y, Z))}
    return _msm_small(points, F.from_mont(scalar, scalars_mont)[None], base, scalar.num_bits)


def batch_msm(points: Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
              scalar: FieldSpec = Fr) -> List[Tuple[int, int]]:
    """B MSMs over one point set, scalars (B, n, 8) Montgomery -> B affine
    (x, y) ints (reference :492): padded to a power of two (at least 16),
    up to SMALL_MSM_MAX points one ladder over all B n lanes and the row
    sums, above it the production MSMs with one read for all."""
    B, n = scalars_mont.shape[:2]
    if B == 0:
        return []
    target = max(16, 1 << (n - 1).bit_length()) if n > 1 else 16
    if target != n:
        points = cat_points(points, identity_point(target - n, scalars_mont.device, base))
        scalars_mont = torch.cat([scalars_mont, scalars_mont.new_zeros((B, target - n, F.LIMBS))], 1)
    if target <= SMALL_MSM_MAX:
        return jacobian_to_affine(_msm_small(points, F.from_mont(scalar, scalars_mont), base, scalar.num_bits), base)
    return msm_list_to_affine_int([(points, s) for s in scalars_mont.unbind(0)], base, scalar)


def msm_to_affine_int(points: Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
                      scalar: FieldSpec = Fr) -> Tuple[int, int]:
    """sum_i s_i * P_i for (n,) points over `base` and (n, 8) Montgomery
    scalars over `scalar` (BN254 G1 and Fr by default; grumpkin: Fr, Fq).
    Under HALO2_LASSO_TPU_MSM=affine through ``variable_base_msm``, as the
    JAX package routes it."""
    if _msm_engine() == "affine":
        return jacobian_to_affine(variable_base_msm(points, scalars_mont, base, scalar), base)[0]
    return msm_list_to_affine_int([(points, scalars_mont)], base, scalar)[0]


def msm_list_to_affine_int(jobs: Sequence[Tuple[Points, torch.Tensor]], base: FieldSpec = Fq,
                           scalar: FieldSpec = Fr) -> List[Tuple[int, int]]:
    """Independent MSMs (any sizes) -> affine ints, one inversion in all.
    With HALO2_LASSO_TPU_MSM_GROUP_LANES set above 0 (the JAX package's
    switch, ops/ec.py:584-640; 0 by default), jobs padded to powers of two
    are grouped, largest first, while a group's W * n_pad * members stays
    within that many lanes, and each group of two or more runs as one
    segmented pipeline (``msm_jacobian.device_partials_seg``); the rest, and
    every job under an active mesh, go through ``msm_jacobian.msm_many``."""
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.parallel import sharding

    budget = int(os.environ.get("HALO2_LASSO_TPU_MSM_GROUP_LANES", "0"))
    if budget <= 0 or sharding.active_mesh() is not None:
        return MJ.host_batch_affine(MJ.msm_many(jobs, base, scalar), base.modulus)
    w_est = -(-scalar.num_bits // 10)
    sized = sorted(((i, *MJ._pad_pow2(p, s, base)) for i, (p, s) in enumerate(jobs)),
                   key=lambda t: -t[2].shape[0])
    groups: List[List] = []
    singles: List = []
    for job in sized:
        n = job[2].shape[0]
        if w_est * n > budget:
            singles.append(job)
            continue
        for g in groups:  # the first member of a group is its largest
            if w_est * g[0][2].shape[0] * (len(g) + 1) <= budget:
                g.append(job)
                break
        else:
            groups.append([job])
    singles += [g[0] for g in groups if len(g) == 1]
    totals = [None] * len(jobs)
    for g in (g for g in groups if len(g) > 1):
        for i, t in zip([j[0] for j in g], MJ.msm_segments([(p, s) for _, p, s in g], base, scalar)):
            totals[i] = t
    for i, t in zip([j[0] for j in singles], MJ.msm_many([(p, s) for _, p, s in singles], base, scalar)):
        totals[i] = t
    return MJ.host_batch_affine(totals, base.modulus)


# the windowed gather materialises Wp * n rows of each coordinate: at most
# this many a slice (2^26 rows of 96 bytes, 6.4 GB of the card's 80 GB; the
# JAX package's (1 << 23) // Wp bound was the TPU's HBM, ops/ec.py:720)
FIXED_BASE_GATHER_ROWS = 1 << 26


def fixed_base_msm(base_xy: Tuple[int, int], scalars_mont: torch.Tensor, c: int = 8, base: FieldSpec = Fq,
                   scalar: FieldSpec = Fr) -> Points:
    """[s_i] * G for (n, 8) Montgomery scalars (msm.rs:67 semantics): a
    per-base window table T[w, v] = v * 2^(c w) * G built once on the host,
    one gather per window and a halving tree of adds over the windows, in
    slices of at most FIXED_BASE_GATHER_ROWS gathered rows. The identity
    base ((0, 0), no affine form) takes the per-lane ladder, as the
    reference's ``_fixed_base_msm_impl`` (ops/ec.py:677) does."""
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ

    device = scalars_mont.device
    n = scalars_mont.shape[0]
    if tuple(base_xy) == (0, 0):
        return ec_ladder(identity_point(n, device, base), F.from_mont(scalar, scalars_mont), scalar.num_bits, base)
    W = -(-scalar.num_bits // c)
    Wp = 1 << (W - 1).bit_length()
    limit = max(64, FIXED_BASE_GATHER_ROWS // Wp)
    if n > limit:
        return cat_points(*(fixed_base_msm(base_xy, scalars_mont[off : off + limit], c, base, scalar)
                            for off in range(0, n, limit)))
    table = MJ.fixed_base_table(base_xy, c, W, Wp, str(device), base)
    digits = MJ.digits_all(F.from_mont(scalar, scalars_mont), c, Wp)  # (Wp, n)
    woff = (torch.arange(Wp, device=device) << c)[:, None]
    idx = (digits + woff).reshape(-1)
    pts = {k: table[k][idx] for k in COORDS}
    while pts["x"].shape[0] > n:
        half = pts["x"].shape[0] // 2
        lo, hi = split_points(pts, [half, half])
        pts = ec_add(lo, hi, base)
    return pts
