"""The scan MSM: Pippenger windows over prefix scans of complete adds, the
port of halo2_lasso_tpu/ops/pallas_ec.py:206-366 (``ec_prefix_scan`` :215,
``_window_total`` :252, ``_horner_step`` :317, ``_digits_for_window`` :325,
``_best_c`` :336, ``msm_pallas`` :348). The JAX package calls none of it;
the port keeps it as a comparison engine beside the production Jacobian
MSM (ops/msm_jacobian.py), reached from the tests and from chip_smoke.py.

A window sorts its points by digit, descending, and takes their inclusive
prefix sums: at the last slot of each digit d the prefix is
T_d = sum of the points with digit >= d. Each bucket row takes its T_d, an
empty one the T of the nearest present digit above it (a select, no field
work), and sum_{v >= 1} T_v = sum_b b S_b is the window's total: one more
prefix scan over the 2^c rows less T_0. Windows combine by Horner's rule
with c doublings. Every add is one launch of K3 (csrc/ec_add.cu, the
complete Jacobian add, doublings included), 2 log2 N launches a scan of N
points; the sort, gathers and selects are torch index ops.
"""

from __future__ import annotations

import torch

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec


def _interleave(a: ec.Points, b: ec.Points) -> ec.Points:
    """a[i], b[i] alternating -> (2n, 8)."""
    return {k: torch.stack([a[k], b[k]], 1).reshape(-1, F.LIMBS) for k in ec.COORDS}


def ec_prefix_scan(pts: ec.Points, spec: FieldSpec = Fq) -> ec.Points:
    """Inclusive prefix sums of an (N,) point batch, N a power of two: the
    pairs' scan recursively, then the even positions from the previous
    pair's prefix (reference :215)."""
    n = pts["x"].shape[0]
    if n == 1:
        return pts
    even = {k: v[0::2] for k, v in pts.items()}
    odd = {k: v[1::2] for k, v in pts.items()}
    scanned = ec_prefix_scan(ec.ec_add(even, odd, spec), spec)  # the prefix at the odd positions
    shifted = ec.cat_points(ec.identity_point(1, pts["x"].device, spec), {k: v[:-1] for k, v in scanned.items()})
    return _interleave(ec.ec_add(shifted, even, spec), scanned)


def _window_total(points: ec.Points, digits: torch.Tensor, nbuckets: int, spec: FieldSpec = Fq) -> ec.Points:
    """One window (reference :252): (N,) points and their (N,) digits -> a
    one-point batch worth sum_b b S_b."""
    order = torch.argsort(-digits, stable=True)
    d_sorted = digits[order]
    prefix = ec_prefix_scan({k: v[order] for k, v in points.items()}, spec)
    d_next = torch.cat([d_sorted[1:], d_sorted.new_full((1,), -1)])
    ends = d_sorted != d_next  # the last slot of each present digit
    device = digits.device
    slot = torch.full((nbuckets,), -1, dtype=torch.int64, device=device)  # bucket -> its prefix row
    slot[d_sorted[ends]] = torch.nonzero(ends).flatten()
    # empty buckets take the nearest present digit above them (a suffix
    # minimum over the present bucket indices), or the identity
    present = torch.where(slot >= 0, torch.arange(nbuckets, device=device), nbuckets)
    nearest = torch.flip(torch.cummin(torch.flip(present, (0,)), 0).values, (0,))
    rows = torch.where(nearest < nbuckets, slot[nearest.clamp(max=nbuckets - 1)], prefix["x"].shape[0])
    table = ec.cat_points(prefix, ec.identity_point(1, device, spec))
    filled = {k: v[rows] for k, v in table.items()}
    last = {k: v[-1:] for k, v in ec_prefix_scan(filled, spec).items()}
    first = {k: v[:1] for k, v in filled.items()}
    return ec.ec_add(last, ec.ec_neg(first, spec), spec)  # less T_0: bucket 0 has weight 0


def _horner_step(total: ec.Points, wt: ec.Points, c: int, spec: FieldSpec = Fq) -> ec.Points:
    """total * 2^c + wt (reference :317)."""
    for _ in range(c):
        total = ec.ec_add(total, total, spec)
    return ec.ec_add(total, wt, spec)


def _digits_for_window(scal: torch.Tensor, w: int, c: int) -> torch.Tensor:
    """(n, 8) canonical limbs -> (n,) c-bit digit w, across a limb edge
    (reference :325)."""
    limbs = scal.to(torch.int64) & 0xFFFFFFFF
    lo_bit = c * w
    lo, off = lo_bit // 32, lo_bit % 32
    val = limbs[:, lo] >> off
    if off + c > 32 and lo + 1 < F.LIMBS:
        val = val | (limbs[:, lo + 1] << (32 - off))
    return val & ((1 << c) - 1)


def _best_c(n: int, nbits: int = 254) -> int:
    """The window minimising windows * (2 n point-scan adds + 2 * 2^c
    bucket-scan adds), c in 8..16 (reference :336)."""
    best, best_cost = 8, None
    for c in range(8, 17):
        cost = -(-nbits // c) * (2 * n + 2 * (1 << c))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def msm_pallas(points: ec.Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
               scalar: FieldSpec = Fr) -> ec.Points:
    """Variable-base MSM (reference :348): (n,) Jacobian points over `base`
    and (n, 8) Montgomery scalars over `scalar`, n a power of two, -> one
    Jacobian point as a (1,)-batch. The window loop runs on the host; the
    windows combine by Horner's rule."""
    n = scalars_mont.shape[0]
    if n & (n - 1) or n < 1:
        raise ValueError("msm_pallas: a power-of-two number of points")
    scal = F.from_mont(scalar, scalars_mont)
    c = _best_c(n, scalar.num_bits)
    total = None
    for w in range(-(-scalar.num_bits // c) - 1, -1, -1):
        wt = _window_total(points, _digits_for_window(scal, w, c), 1 << c, base)
        total = wt if total is None else _horner_step(total, wt, c, base)
    return total
