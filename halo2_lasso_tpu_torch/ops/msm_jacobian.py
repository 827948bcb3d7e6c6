"""Halving-tree Pippenger MSM over complete Jacobian adds (the port of
halo2_lasso_tpu/ops/msm_jacobian.py).

  1. prologue: canonical scalars, c-bit digits for all W windows at once,
     and each window's descending sort (a permutation, not a gather);
  2. halving levels, one launch of the ``msm_level`` kernel each: adjacent
     slots (2i, 2i+1) of a window with equal digits are added; at a digit
     boundary the left slot ends its digit's run and is added into bucket
     (w, digit) in place, and the right one survives. One add per lane; at
     most one flush per digit per window per level, so the bucket scatter
     never collides. The first level reads the points through the sort's
     permutation; a last launch flushes each window's survivor;
  3. bit-plane bucket reduction: U_{w,j} = sum of bucket (w, v) over the v
     with bit j set, all c W planes in one launch of the ``plane_tree``
     kernel, which reads the buckets in place and adds only the ones each
     plane keeps;
  4. host: sum_{w,j} 2^(c w + j) U_{w,j} by double-and-add in Python ints.

The points' coordinate field is ``base`` and the scalars' field ``scalar``
(BN254 G1 over Fq with Fr scalars by default; grumpkin is base Fr, scalar
Fq; Pallas base Fp_pallas, scalar Fq_vesta, and Vesta the other way round,
255-bit scalars, so W = ceil(255 / c) windows), as in the JAX package
(msm_jacobian.py:691-765). No torch op runs
between the level launches and nothing syncs with the host until the plane
sums are read. ``msm_level_plain`` is the same level in
plain torch, for CPU tensors and as the kernel's oracle. The TPU's
2^18-point slicing, index-scatter detour, whole-bucket add per level and
bit-reversed slot storage are policies of that machine and are not carried
over.

Under a mesh (``parallel/sharding.py``) a BN254 G1 MSM of at least
SHARD_MIN_POINTS points a shard is split over the shards: steps 1-3 run on
each shard's points, and step 4 adds the shards' totals (``msm_many``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.parallel import sharding


def best_c(n: int) -> int:
    """Window bits: 10 at the sizes that matter (as the reference pins),
    fewer for small MSMs so the bucket tables stay in proportion."""
    return max(3, min(10, n.bit_length() - 5))


def digits_all(scal: torch.Tensor, c: int, num_windows: int) -> torch.Tensor:
    """(n, 8) canonical limbs -> (W, n) c-bit digits (int64), every window in
    one pass: window w takes bits c*w .. c*w + c - 1, across a limb edge where
    it straddles one (bits above the 256th are 0)."""
    limbs = scal.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.cat([limbs, torch.zeros_like(limbs[:, :1])], 1)  # limb 8 = 0
    lo_bit = torch.arange(num_windows, device=scal.device) * c
    lo = (lo_bit // 32).clamp(max=F.LIMBS)
    off = lo_bit % 32
    val = (limbs[:, lo] >> off) | (limbs[:, (lo + 1).clamp(max=F.LIMBS)] << (32 - off))
    return (val & ((1 << c) - 1)).T.contiguous()


def _pad_pow2(points: ec.Points, scal: torch.Tensor, base: FieldSpec):
    n = scal.shape[0]
    return _pad(points, scal, base, max(2, 1 << (n - 1).bit_length()))


def _pad(points: ec.Points, scal: torch.Tensor, base: FieldSpec, target: int):
    """Identity points with zero scalars up to `target` rows."""
    n = scal.shape[0]
    if target == n:
        return points, scal
    idp = ec.identity_point(target - n, scal.device, base)
    return ec.cat_points(points, idp), torch.cat([scal, scal.new_zeros((target - n, F.LIMBS))])


# ---------------------------------------------------------------------------
# one halving level: kernel wrapper + plain version
# ---------------------------------------------------------------------------


def msm_level_plain(
    pts: ec.Points, dig: torch.Tensor, bucket: ec.Points, W: int, B: int,
    order: Optional[torch.Tensor] = None, base: FieldSpec = Fq,
) -> Tuple[ec.Points, torch.Tensor]:
    """One level in plain torch, bit for bit what csrc/msm_level.cu does.

    pts, dig: the level's W * m slots and their digits (int32), or with
    ``order`` ((W, n) int64, the first level) the n points and the (W, n)
    digits before the sort. bucket: W * B + 1 rows, updated in place; the
    last row takes the writes of lanes that flush nothing. With m = 1 the
    call is the final flush. Returns the W * m / 2 survivors and digits."""
    if order is not None:
        dig = torch.gather(dig, 1, order).reshape(-1)
        pts = {k: pts[k][order.reshape(-1)] for k in ec.COORDS}
        pts["z"] = torch.where((dig == 0)[:, None], torch.zeros_like(pts["z"]), pts["z"])
    m = dig.shape[0] // W
    if m == 1:  # final flush: each window's survivor goes to its bucket
        a = b = pts
        da = db = dig
        same = torch.zeros_like(dig, dtype=torch.bool)
    else:
        half = dig.shape[0] // 2
        a, b = {}, {}
        for k in ec.COORDS:
            a[k], b[k] = pts[k].view(half, 2, F.LIMBS).unbind(1)
        da, db = dig.view(half, 2).unbind(1)
        same = da == db
    lanes = da.shape[0]
    slot = torch.arange(lanes, device=dig.device) // (lanes // W) * B + da
    sm = same[:, None]
    p = {k: torch.where(sm, a[k], bucket[k][slot]) for k in ec.COORDS}
    q = {k: torch.where(sm, b[k], a[k]) for k in ec.COORDS}
    r = ec.ec_add_plain(p, q, base)
    dump = torch.where(same, W * B, slot)
    for k in ec.COORDS:
        bucket[k][dump] = r[k]
    if m == 1:
        return {k: v[:0] for k, v in pts.items()}, dig[:0]
    return {k: torch.where(sm, r[k], b[k]) for k in ec.COORDS}, db.contiguous()


def msm_level(
    pts: ec.Points, dig: torch.Tensor, bucket: ec.Points, W: int, B: int,
    order: Optional[torch.Tensor] = None, base: FieldSpec = Fq,
) -> Tuple[ec.Points, torch.Tensor]:
    """One halving level (see ``msm_level_plain``) in one launch of
    csrc/msm_level.cu's instance for the coordinate field `base`: the port
    of the TPU's _ec_add_kernel with the level step around it
    (msm_jacobian._level_step). The inputs are checked on either device, as
    the kernel reads them: contiguous int32 rows and digits, a contiguous
    int64 ``order``."""
    coords = [pts[k] for k in ec.COORDS] + [bucket[k] for k in ec.COORDS]
    for t in (dig, *coords):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("msm_level: digits and coordinates must be contiguous int32 tensors")
    if any(t.dim() != 2 or t.shape[1] != F.LIMBS for t in coords):
        raise ValueError("msm_level: coordinates must be (n, 8) rows")
    if any(bucket[k].shape[0] != W * B + 1 for k in ec.COORDS):
        raise ValueError("msm_level: the bucket holds W * B + 1 rows")
    if order is not None:
        if order.dtype != torch.int64 or not order.is_contiguous() or order.shape != dig.shape:
            raise ValueError("msm_level: order must be a contiguous int64 (W, n) like the digits")
        m = order.shape[1]
    else:
        m = dig.shape[0] // W
    if m & (m - 1) or dig.numel() != W * m or pts["x"].shape[0] != (dig.shape[1] if order is not None else W * m):
        raise ValueError("msm_level: W windows of a power-of-two number of slots")
    if dig.device.type == "cpu":
        return msm_level_plain(pts, dig, bucket, W, B, order, base)
    instance = ec.curve_instance(base)
    fid = native.field_id("msm_level", base)
    native.require_cuda("msm_level", dig, *coords)
    if any(t.data_ptr() % 16 for t in coords):
        raise ValueError("msm_level: coordinates must start on 16-byte boundaries")
    pairs = m // 2
    device = dig.device
    out = [torch.empty((W * pairs, F.LIMBS), dtype=torch.int32, device=device) for _ in ec.COORDS]
    odig = torch.empty(W * pairs, dtype=torch.int32, device=device)
    native.launch(
        "msm_level", device, fid, *[t.data_ptr() for t in coords[:3]], dig.data_ptr(),
        None if order is None else order.data_ptr(),
        pairs, W, B, *[t.data_ptr() for t in coords[3:]], *[t.data_ptr() for t in out], odig.data_ptr(),
    )
    native.count("msm_level", instance)
    return dict(zip(ec.COORDS, out)), odig


# ---------------------------------------------------------------------------
# the MSM
# ---------------------------------------------------------------------------


def msm_planes(points: ec.Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
               scalar: FieldSpec = Fr) -> Tuple[ec.Points, int, int]:
    """The device part of a variable-base MSM: the c * W plane sums
    U_{w,j}, plane-major ([j * W + w]), with c and W."""
    bucket, c, W = msm_buckets(points, scalars_mont, base, scalar)
    return bucket_planes(bucket, c, W, base), c, W


def msm_buckets(points: ec.Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
                scalar: FieldSpec = Fr) -> Tuple[ec.Points, int, int]:
    """Steps 1 and 2 of the MSM: the W * 2^c (+ 1) bucket rows after the
    halving levels and the final flush, with c and W."""
    points, scalars_mont = _pad_pow2({k: v.contiguous() for k, v in points.items()}, scalars_mont, base)
    n = scalars_mont.shape[0]
    c = best_c(n)
    B = 1 << c
    W = -(-scalar.num_bits // c)
    digits = digits_all(F.from_mont(scalar, scalars_mont), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = ec.identity_point(W * B + 1, scalars_mont.device, base)
    pts, dig = msm_level(points, digits, bucket, W, B, order=order, base=base)
    while dig.shape[0] > W:
        pts, dig = msm_level(pts, dig, bucket, W, B, base=base)
    msm_level(pts, dig, bucket, W, B, base=base)  # final flush
    return bucket, c, W


TREE_MAX_C = 10  # csrc/ec_add.cu's TREE_MAX_C: 2^(c-2) shared slots a plane


@functools.lru_cache(maxsize=None)
def _tree_rows(c: int, W: int, device: str) -> torch.Tensor:
    """(c W, 2^(c-1)) bucket rows: row [j W + w, k] is bucket w 2^c + v, v
    the c-bit number with bit j set and its other c - 1 bits those of k."""
    k = torch.arange(1 << (c - 1), device=device)[None, None, :]
    j = torch.arange(c, device=device)[:, None, None]
    w = torch.arange(W, device=device)[None, :, None]
    v = ((k >> j) << (j + 1)) | (1 << j) | (k & ((1 << j) - 1))
    return ((w << c) + v).reshape(c * W, -1)


def bucket_planes_plain(bucket: ec.Points, c: int, W: int, base: FieldSpec = Fq) -> ec.Points:
    """The plane sums in plain field ops, bit for bit what csrc/ec_add.cu's
    plane tree computes: for each plane (j, w) its 2^(c-1) kept buckets, a
    halving over them (position k with k + 2^(c-1) / 2, the lower the first
    operand) until one is left. The nesting is that of the old gathered
    tree over all 2^c buckets with the others masked to the identity, less
    the masked leaves, which change no sum (tests/test_torch_msm.py)."""
    rows = _tree_rows(c, W, str(bucket["x"].device))
    tree = {k: bucket[k][rows] for k in ec.COORDS}  # (c W, 2^(c-1), 8)
    while tree["x"].shape[1] > 1:
        half = tree["x"].shape[1] // 2
        r = ec.ec_add_plain({k: v[:, :half].reshape(-1, F.LIMBS) for k, v in tree.items()},
                            {k: v[:, half:].reshape(-1, F.LIMBS) for k, v in tree.items()}, base)
        tree = {k: v.view(c * W, half, F.LIMBS) for k, v in r.items()}
    return {k: v[:, 0].contiguous() for k, v in tree.items()}


def bucket_planes(bucket: ec.Points, c: int, W: int, base: FieldSpec = Fq) -> ec.Points:
    """U_{j,w} = sum of the buckets (w, v) with bit j of v set, for all (j, w),
    plane-major ([j W + w]), from the W 2^c bucket rows read in place: one
    launch of csrc/ec_add.cu's plane tree (the port of the bit-plane tree
    of msm_jacobian.py:299-318). A CPU bucket takes ``bucket_planes_plain``;
    a CUDA one launches or raises."""
    if bucket["x"].device.type == "cpu":
        return bucket_planes_plain(bucket, c, W, base)
    instance = ec.curve_instance(base)
    fid = native.field_id("plane_tree", base)
    coords = [bucket[k] for k in ec.COORDS]
    if not 2 <= c <= TREE_MAX_C:
        raise ValueError(f"plane_tree: the kernel takes 2 <= c <= {TREE_MAX_C}")
    if any(t.dim() != 2 or t.shape[1] != F.LIMBS or t.shape[0] < W << c for t in coords):
        raise ValueError("plane_tree: the bucket holds at least W * 2^c rows of 8 limbs")
    native.require_cuda("plane_tree", *coords)
    if any(t.data_ptr() % 16 for t in coords):
        raise ValueError("plane_tree: coordinates must start on 16-byte boundaries")
    out = [torch.empty((c * W, F.LIMBS), dtype=torch.int32, device=coords[0].device) for _ in ec.COORDS]
    native.launch("plane_tree", coords[0].device, fid, *[t.data_ptr() for t in coords], c, W,
                  *[t.data_ptr() for t in out])
    native.count("plane_tree", instance)
    return dict(zip(ec.COORDS, out))


def msm(points: ec.Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
        scalar: FieldSpec = Fr) -> Tuple[int, int, int]:
    """Variable-base MSM -> Jacobian (X, Y, Z) canonical ints."""
    return msm_many([(points, scalars_mont)], base, scalar)[0]


# points a shard at least before an MSM is split over the active mesh (a
# policy of the card's occupancy; the result is the same point either way)
SHARD_MIN_POINTS = 4096


def _job_mesh(n: int, base: FieldSpec):
    """The active mesh where a BN254 G1 MSM of n points is split over it."""
    mesh = sharding.active_mesh()
    if mesh is None or base is not Fq or n < SHARD_MIN_POINTS * mesh.size:
        return None
    return mesh


def msm_many(jobs: Sequence[Tuple[ec.Points, torch.Tensor]], base: FieldSpec = Fq,
             scalar: FieldSpec = Fr, mesh=None) -> List[Tuple[int, int, int]]:
    """Independent MSMs -> Jacobian canonical ints, with one read of the card
    for all of them. Under `mesh`, or under the active mesh for a BN254 G1
    job of at least SHARD_MIN_POINTS points a shard, a job is split over the
    mesh's shards (the port of sharding.py:298-322): ``msm_planes`` on each
    shard's points and scalars, the shards' Jacobian totals added on the
    host, across processes too. The planes of every job and shard come to
    one device for that one read."""
    planes, meshes = [], []  # planes: (job, plane sums, c, W) a job or a shard
    for i, (points, scal) in enumerate(jobs):
        m = mesh if mesh is not None else _job_mesh(scal.shape[0], base)
        meshes.append(m)
        if m is None:
            planes.append((i, *msm_planes(points, scal, base, scalar)))
            continue
        n = scal.shape[0]
        points, scal = _pad(points, scal, base, -(-n // m.size) * m.size)
        parts = {k: m.split(v) for k, v in points.items()}
        for j, s in enumerate(m.split(scal)):
            planes.append((i, *msm_planes({k: parts[k][j] for k in ec.COORDS}, s, base, scalar)))
    if not planes:
        return []
    first = planes[0][1]["x"].device
    flat = base.decode_ints(torch.cat([u[k].to(first) for _, u, _, _ in planes for k in ec.COORDS]))
    out, at = [(0, 0, 0)] * len(jobs), 0
    for i, _, c, W in planes:
        cw = c * W
        xs, ys, zs = flat[at : at + cw], flat[at + cw : at + 2 * cw], flat[at + 2 * cw : at + 3 * cw]
        at += 3 * cw
        out[i] = host_jac_add(out[i], finish_host(list(zip(xs, ys, zs)), c, W, base.modulus), base.modulus)
    across = [i for i, m in enumerate(meshes) if m is not None and m.world > 1]  # one mesh: given or active
    if across:
        everyone = meshes[across[0]].gather_ints([v for i in across for v in out[i]])
        for j, i in enumerate(across):
            out[i] = (0, 0, 0)
            for vals in everyone:
                out[i] = host_jac_add(out[i], tuple(vals[3 * j : 3 * j + 3]), base.modulus)
    return out


# ---------------------------------------------------------------------------
# the segmented pipeline: S MSMs as S W windows of one pipeline
# ---------------------------------------------------------------------------


def prologue_seg(points: ec.Points, scalars_mont: torch.Tensor, c: int, W: int, S: int, n_pad: int,
                 scalar: FieldSpec = Fr) -> Tuple[ec.Points, torch.Tensor]:
    """The segmented prologue (the port of msm_jacobian.py:557
    ``_prologue_seg_fn``): S MSMs of n_pad points each, concatenated, as S W
    windows; window row s W + w holds segment s's digits of window w,
    sorted descending. Returns the S W n_pad slots (gathered through each
    row's sort, a digit-0 slot made the identity) and their digits."""
    digits = digits_all(F.from_mont(scalar, scalars_mont), c, W)  # (W, S n_pad)
    d = digits.view(W, S, n_pad).transpose(0, 1).reshape(S * W, n_pad)
    order = torch.argsort(-d, dim=1, stable=True)
    seg_off = (torch.arange(S * W, device=d.device) // W * n_pad)[:, None]
    flat = (order + seg_off).reshape(-1)
    dig = torch.gather(d, 1, order).reshape(-1).to(torch.int32)
    pts = {k: points[k][flat] for k in ec.COORDS}
    pts["z"] = torch.where((dig == 0)[:, None], 0, pts["z"])
    return pts, dig


def device_partials_seg(jobs: Sequence[Tuple[ec.Points, torch.Tensor]], base: FieldSpec, scalar: FieldSpec,
                        n_pad: int) -> Tuple[ec.Points, int, int]:
    """S MSMs, each padded to n_pad points, through ONE pipeline of S W
    windows (the port of msm_jacobian.py:591 ``_device_partials_seg``):
    the prologue, the halving levels and the final flush in ``msm_level``
    launches at W' = S W, and the bit-plane tree in one ``plane_tree``
    launch. Returns the c S W plane sums, plane-major ([j S W + s W + w]),
    with c and W. One pipeline's launches stand for S."""
    S = len(jobs)
    c = best_c(n_pad)
    B = 1 << c
    W = -(-scalar.num_bits // c)
    Wt = S * W
    padded = [_pad({k: v.contiguous() for k, v in p.items()}, s, base, n_pad) for p, s in jobs]
    points = ec.cat_points(*(p for p, _ in padded))
    scal = torch.cat([s for _, s in padded])
    pts, dig = prologue_seg(points, scal, c, W, S, n_pad, scalar)
    bucket = ec.identity_point(Wt * B + 1, scal.device, base)
    while dig.shape[0] > Wt:
        pts, dig = msm_level(pts, dig, bucket, Wt, B, base=base)
    msm_level(pts, dig, bucket, Wt, B, base=base)  # final flush
    return bucket_planes(bucket, c, Wt, base), c, W


def finish_host_segments(u: List[Tuple[int, int, int]], c: int, W: int, S: int, mod: int):
    """Each segment's power-of-two recombination from a segmented plane
    stack [j S W + s W + w] (the port of msm_jacobian.py:645): segment s
    reads the (c, W) sub-grid of its windows."""
    Wt = S * W
    return [finish_host([u[j * Wt + s * W + w] for j in range(c) for w in range(W)], c, W, mod) for s in range(S)]


def msm_segments(jobs: Sequence[Tuple[ec.Points, torch.Tensor]], base: FieldSpec = Fq,
                 scalar: FieldSpec = Fr) -> List[Tuple[int, int, int]]:
    """Independent MSMs through one segmented pipeline, padded to the
    largest power of two among them -> Jacobian canonical ints, one read."""
    n_pad = max(2, max(1 << (s.shape[0] - 1).bit_length() for _, s in jobs))
    planes, c, W = device_partials_seg(jobs, base, scalar, n_pad)
    flat = base.decode_ints(torch.cat([planes[k] for k in ec.COORDS]))
    m = len(flat) // 3
    return finish_host_segments(list(zip(flat[:m], flat[m : 2 * m], flat[2 * m :])), c, W, len(jobs), base.modulus)


def finish_host(u: List[Tuple[int, int, int]], c: int, W: int, mod: int) -> Tuple[int, int, int]:
    """sum_{w,j} 2^(c w + j) U_{w,j}, U in plane-major order [j * W + w]:
    the sequential power-of-two recombination, in host ints."""
    by_bit = {}
    for j in range(c):
        for w in range(W):
            pt = u[j * W + w]
            if pt[2] != 0:
                by_bit[c * w + j] = pt
    total = (0, 0, 0)
    for b in range(max(by_bit) if by_bit else -1, -1, -1):
        total = host_jac_double(total, mod)
        if b in by_bit:
            total = host_jac_add(total, by_bit[b], mod)
    return total


# ---------------------------------------------------------------------------
# host Jacobian arithmetic (Python ints)
# ---------------------------------------------------------------------------


def host_jac_add(p, q, mod):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % mod
    Z2Z2 = Z2 * Z2 % mod
    U1 = X1 * Z2Z2 % mod
    U2 = X2 * Z1Z1 % mod
    S1 = Y1 * Z2 * Z2Z2 % mod
    S2 = Y2 * Z1 * Z1Z1 % mod
    if U1 == U2:
        if S1 != S2:
            return (0, 0, 0)
        return host_jac_double(p, mod)
    H = (U2 - U1) % mod
    R = (S2 - S1) % mod
    HH = H * H % mod
    HHH = HH * H % mod
    V = U1 * HH % mod
    X3 = (R * R - HHH - 2 * V) % mod
    Y3 = (R * (V - X3) - S1 * HHH) % mod
    Z3 = Z1 * Z2 * H % mod
    return (X3, Y3, Z3)


def host_jac_double(p, mod):
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return (0, 0, 0)
    A = X1 * X1 % mod
    B = Y1 * Y1 % mod
    C = B * B % mod
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % mod
    E = 3 * A % mod
    Fv = E * E % mod
    X3 = (Fv - 2 * D) % mod
    Y3 = (E * (D - X3) - 8 * C) % mod
    Z3 = 2 * Y1 * Z1 % mod
    return (X3, Y3, Z3)


def host_batch_affine(pts, mod):
    """[(X, Y, Z)] Jacobian ints -> [(x, y)] affine ((0, 0) for identity),
    one modular inversion total (Montgomery's trick)."""
    pref = [1]
    for p in pts:
        pref.append(pref[-1] * (p[2] or 1) % mod)
    inv = pow(pref[-1], mod - 2, mod)
    out = [None] * len(pts)
    for i in range(len(pts) - 1, -1, -1):
        z = pts[i][2]
        if z == 0:
            out[i] = (0, 0)
            continue
        zi = inv * pref[i] % mod
        inv = inv * z % mod
        zi2 = zi * zi % mod
        out[i] = (pts[i][0] * zi2 % mod, pts[i][1] * zi2 * zi % mod)
    return out


@functools.lru_cache(maxsize=None)
def _fixed_base_rows(base_xy: Tuple[int, int], c: int, W: int, Wp: int, mod: int):
    rows = []
    g = (base_xy[0], base_xy[1], 1)
    for w in range(Wp):
        row = [(0, 0, 0)]
        for _ in range(1, 1 << c):
            row.append(host_jac_add(row[-1], g, mod) if w < W else (0, 0, 0))
        rows.extend(row)
        for _ in range(c):
            g = host_jac_double(g, mod)
    return host_batch_affine(rows, mod)


@functools.lru_cache(maxsize=None)
def fixed_base_table(base_xy: Tuple[int, int], c: int, W: int, Wp: int, device: str, base: FieldSpec = Fq) -> Dict:
    """T[w * 2^c + v] = v * 2^(c w) * G as a device point batch over the
    coordinate field `base` (built once per base on the host; msm.rs:16-65
    semantics)."""
    return ec.affine_to_jacobian(_fixed_base_rows(base_xy, c, W, Wp, base.modulus), device, base)
