"""Halving-tree Pippenger MSM over complete Jacobian adds (the port of
halo2_lasso_tpu/ops/msm_jacobian.py).

Every point operation is one launch of the ``ec_add`` kernel over many
lanes; the rest is sorting and gathering in plain torch.

  1. prologue: canonical scalars, c-bit digits for all W windows at once,
     per-window descending sort, gather of the points (digit-0 lanes
     become the identity);
  2. halving levels: adjacent slots (2i, 2i+1) of a window with equal
     digits are added; at a digit boundary the left slot ends its digit's
     run and is flushed into bucket (w, digit), the right one survives. At
     most one flush per digit per level, so the bucket scatter never
     collides; pair adds and bucket adds of a level share one launch;
  3. bit-plane bucket reduction: U_{w,j} = sum of bucket (w, v) over the v
     with bit j set, by a halving tree of adds;
  4. host: sum_{w,j} 2^(c w + j) U_{w,j} by double-and-add in Python ints.

The TPU's 2^18-point slicing, index-scatter detour and bit-reversed slot
storage are policies of that machine and are not carried over.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr


def best_c(n: int) -> int:
    """Window bits: 10 at the sizes that matter (as the reference pins),
    fewer for small MSMs so the bucket tables stay in proportion."""
    return max(3, min(10, n.bit_length() - 5))


def digits_all(scal: torch.Tensor, c: int, num_windows: int) -> torch.Tensor:
    """(n, 8) canonical limbs -> (W, n) c-bit digits (int64)."""
    limbs = scal.to(torch.int64) & 0xFFFFFFFF
    outs = []
    for w in range(num_windows):
        lo_bit = c * w
        lo, off = divmod(lo_bit, 32)
        val = limbs[:, lo] >> off if lo < F.LIMBS else torch.zeros_like(limbs[:, 0])
        if off + c > 32 and lo + 1 < F.LIMBS:
            val = val | (limbs[:, lo + 1] << (32 - off))
        outs.append(val & ((1 << c) - 1))
    return torch.stack(outs)


def _pad_pow2(points: ec.Points, scal: torch.Tensor):
    n = scal.shape[0]
    target = max(2, 1 << (n - 1).bit_length())
    if target == n:
        return points, scal
    idp = ec.identity_point(target - n, scal.device)
    return ec.cat_points(points, idp), torch.cat([scal, scal.new_zeros((target - n, F.LIMBS))])


def msm(points: ec.Points, scalars_mont: torch.Tensor) -> Tuple[int, int, int]:
    """Variable-base MSM -> Jacobian (X, Y, Z) canonical ints."""
    points, scalars_mont = _pad_pow2(points, scalars_mont)
    n = scalars_mont.shape[0]
    device = scalars_mont.device
    c = best_c(n)
    B = 1 << c
    W = -(-Fr.num_bits // c)

    # prologue
    digits = digits_all(F.from_mont(Fr, scalars_mont), c, W)
    order = torch.argsort(-digits, dim=1, stable=True)
    dig = torch.gather(digits, 1, order).reshape(-1)
    flat = order.reshape(-1)
    x, y, z = (points[k][flat] for k in ec.COORDS)
    z = torch.where((dig == 0)[:, None], torch.zeros_like(z), z)
    bucket = ec.identity_point(W * B, device)
    wslot = torch.arange(W, device=device) * B

    # halving levels
    m = n
    while m > 1:
        half = W * (m // 2)
        xa, xb = x.view(half, 2, F.LIMBS).unbind(1)
        ya, yb = y.view(half, 2, F.LIMBS).unbind(1)
        za, zb = z.view(half, 2, F.LIMBS).unbind(1)
        da, db = dig.view(half, 2).unbind(1)
        same = (da == db)[:, None]
        # same digit: A + B survives; boundary: A + O = A passes (and is
        # flushed), B survives
        q = {"x": torch.where(same, xb, xa), "y": torch.where(same, yb, ya),
             "z": torch.where(same, zb, torch.zeros_like(za))}
        flush = ec.identity_point(W * B, device)
        bnd = ~same[:, 0]
        slot = (wslot[:, None].expand(W, m // 2).reshape(-1) + da)[bnd]
        for k, v in (("x", xa), ("y", ya), ("z", za)):
            flush[k][slot] = v[bnd]
        out = ec.ec_add(
            ec.cat_points({"x": xa, "y": ya, "z": za}, bucket), ec.cat_points(q, flush)
        )
        r, bucket = ec.split_points(out, [half, W * B])
        x = torch.where(same, r["x"], xb)
        y = torch.where(same, r["y"], yb)
        z = torch.where(same, r["z"], zb)
        dig = db
        m //= 2

    # final flush of each window's last run
    flush = ec.identity_point(W * B, device)
    slot = wslot + dig
    for k, v in (("x", x), ("y", y), ("z", z)):
        flush[k][slot] = v
    bucket = ec.ec_add(bucket, flush)

    # bit-plane reduction: plane j keeps bucket v iff bit j of v is set
    v = torch.arange(B, device=device).repeat(W)
    keep = torch.cat([(v >> j) & 1 for j in range(c)]).bool()[:, None]
    tree = {k: bucket[k].repeat(c, 1) for k in ec.COORDS}
    tree["z"] = torch.where(keep, tree["z"], torch.zeros_like(tree["z"]))
    groups = c * W
    size = B
    while size > 1:
        size //= 2
        lo, hi = {}, {}
        for k in ec.COORDS:
            t = tree[k].view(groups, 2, size, F.LIMBS)
            lo[k] = t[:, 0].reshape(-1, F.LIMBS)
            hi[k] = t[:, 1].reshape(-1, F.LIMBS)
        tree = ec.ec_add(lo, hi)
    u = [Fq.decode_ints(tree[k]) for k in ec.COORDS]
    return finish_host(list(zip(*u)), c, W, Fq.modulus)


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
def _fixed_base_rows(base_xy: Tuple[int, int], c: int, W: int, Wp: int):
    mod = Fq.modulus
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
def fixed_base_table(base_xy: Tuple[int, int], c: int, W: int, Wp: int, device: str) -> Dict:
    """T[w * 2^c + v] = v * 2^(c w) * G as a device point batch (built once
    per base on the host; msm.rs:16-65 semantics)."""
    return ec.affine_to_jacobian(_fixed_base_rows(base_xy, c, W, Wp), device)
