"""Batched-affine Pippenger MSM (window-batched halving), the port of
halo2_lasso_tpu/ops/msm_affine.py: a comparison engine beside the
production Jacobian MSM (ops/msm_jacobian.py), reached through the JAX
package's own switch, ``HALO2_LASSO_TPU_MSM=affine`` (``ec.variable_base_msm``
and ``ec.msm_to_affine_int``), from the tests and from chip_smoke.py.

  * all W windows' digits are taken at once, and per window the points are
    sorted by digit, descending (``_prologue_fn``, reference :447);
  * each halving level (``_level_step``, :254) pairs adjacent slots: equal
    digits are added in affine form, lambda = num / den, every level's
    denominators inverted in one batch; at a digit boundary the left slot
    ends its run and is added into its bucket. Every lane does at most one
    affine add, the two cases sharing it;
  * the buckets end in a Jacobian weighted sum (``_jacobian_bucket_sum``,
    :409) and the windows' totals combine by Horner's rule with c doublings
    (``_epilogue_fn``, :477), the last survivors flushed first
    (``_final_flush``, :540).

The reference keeps its state limbs-first for the TPU's tiles; the port
keeps the card's (lanes, 8) rows. Every field operation on a CUDA tensor
goes through a kernel wrapper that launches or raises: the products, sums
and differences through K4 (csrc/mont_mul.cu; ``mul_lf`` is K4 ``a*b``,
reference :84), the batch inversions through csrc/mont_chain.cu's
``batch_inv`` (the chunked Montgomery trick of ``_batch_inv_lanes`` :146 and
the sequential one of ``_batch_inv_seq`` :212 compute its rows; the port
keeps the first's name) and ``mont_pow`` (the Fermat inversion of
``_inv_fermat_lf`` :189), the Jacobian adds and doublings through K3
(csrc/ec_add.cu). Sorting, gathers, selects and the bucket scatter are
torch index ops.
"""

from __future__ import annotations

import os

import torch

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec


def mul_lf(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = Fq) -> torch.Tensor:
    """(X, 8) elementwise Montgomery product: K4 ``a*b``."""
    return F.mont_mul(spec, a, b)


def _rows_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(X,) bool: equal rows (the field keeps canonical representatives)."""
    return (a == b).all(-1)


def batch_inv_lf(a: torch.Tensor, spec: FieldSpec = Fq) -> torch.Tensor:
    """(X, 8) batched modular inverse, zeros to zeros (reference :127):
    csrc/mont_chain.cu's ``batch_inv``."""
    return F.batch_inv(spec, a)


def _batch_inv_lanes(aa: torch.Tensor, spec: FieldSpec = Fq) -> torch.Tensor:
    """(m, 8) inverses of nonzero rows (reference :146). The TPU's chunked
    Montgomery trick with fixed chunk widths was a compile-shape policy; on
    the card it is one ``batch_inv`` (prefix and suffix products and one
    Fermat inversion), at most _INV_FERMAT_MAX rows by ``_inv_fermat_lf``."""
    if aa.shape[0] <= _INV_FERMAT_MAX:
        return _inv_fermat_lf(aa, spec)
    return F.batch_inv(spec, aa)


_INV_FERMAT_MAX = 256


def _inv_fermat_lf(aa: torch.Tensor, spec: FieldSpec = Fq) -> torch.Tensor:
    """(m, 8) Fermat inversion a^(p-2) (reference :189): csrc/mont_chain.cu's
    ``mont_pow``."""
    return F.pow_fixed(spec, aa, spec.modulus - 2)


# ---------------------------------------------------------------------------
# the affine pair/flush level step
# ---------------------------------------------------------------------------


def _affine_add_with_inv(xa, ya, xb, yb, num, inv, spec: FieldSpec = Fq):
    """lambda = num * inv; returns (x3, y3) (reference :242)."""
    lam = mul_lf(num, inv, spec)
    x3 = F.sub(spec, F.sub(spec, mul_lf(lam, lam, spec), xa), xb)
    y3 = F.sub(spec, mul_lf(lam, F.sub(spec, xa, x3), spec), ya)
    return x3, y3


def _level_step(ax, ay, inf, dig, bx, by, binf, B: int, W: int, spec: FieldSpec = Fq):
    """One halving level (reference :254). ax, ay: (m, 8) slots of the W
    windows, window-major; inf, dig: (m,). The buckets bx, by, binf ((W B,
    8), (W B,)) are updated in place; returns the halved slots.

    Every lane does at most ONE affine add: a same-digit pair combines
    (xa, ya) + (xb, yb), a digit boundary flushes the run-end a into its
    bucket as (gx, gy) + (xa, ya). The two cases share one operand-selected
    add and one batch inversion."""
    m = ax.shape[0]
    half = m // 2
    device = ax.device
    xa, xb, ya, yb = ax[0::2], ax[1::2], ay[0::2], ay[1::2]
    ia, ib, da, db = inf[0::2], inf[1::2], dig[0::2], dig[1::2]
    same = da == db
    a_fin = ~ia
    flush = ~same & a_fin
    widx = torch.arange(half, device=device) // (half // W)
    bslot = torch.where(flush, widx * B + da, W * B)
    safe = bslot.clamp(max=W * B - 1)
    gx, gy, ginf = bx[safe], by[safe], binf[safe]

    # the add's operands: same -> (xa, ya) + (xb, yb); flush -> bucket + (xa, ya)
    sm = same[:, None]
    px, py = torch.where(sm, xa, gx), torch.where(sm, ya, gy)
    qx, qy = torch.where(sm, xb, xa), torch.where(sm, yb, ya)
    act = torch.where(same, a_fin & ~ib, flush & ~ginf)
    x_eq = act & _rows_equal(px, qx)
    y_eq = x_eq & _rows_equal(py, qy)
    dbl = y_eq
    cancel = x_eq & ~y_eq
    comb = (act & ~x_eq) | dbl

    den = torch.where(dbl[:, None], F.add(spec, py, py), F.sub(spec, qx, px))
    den = torch.where(comb[:, None], den, spec.one(device))
    px2 = mul_lf(px, px, spec)
    num = torch.where(dbl[:, None], F.add(spec, F.add(spec, px2, px2), px2), F.sub(spec, qy, py))
    inv = batch_inv_lf(den, spec)
    x3, y3 = _affine_add_with_inv(px, py, qx, qy, num, inv, spec)

    # survivors: same-digit pairs combined (or passed through, or
    # cancelled); at a digit boundary b passes through untouched
    cb = comb[:, None]
    sx = torch.where(sm, torch.where(cb, x3, torch.where(ia[:, None], xb, xa)), xb)
    sy = torch.where(sm, torch.where(cb, y3, torch.where(ia[:, None], yb, ya)), yb)
    sinf = torch.where(same, torch.where(comb, False, torch.where(cancel, True, ia & ib)), ib)

    # bucket updates (flush lanes): bucket + a, a into an empty bucket, or
    # the identity on cancellation
    gi = ginf[:, None]
    ux = torch.where(gi, xa, torch.where(cb, x3, xa))
    uy = torch.where(gi, ya, torch.where(cb, y3, ya))
    uinf = torch.where(flush & ginf, False, torch.where(comb, False, torch.where(cancel, True, ginf)))
    at = bslot[flush]
    bx[at], by[at], binf[at] = ux[flush], uy[flush], uinf[flush]
    return sx, sy, sinf, db


def _best_c(n: int, nbits: int = 254) -> int:
    """Window bits (reference :357): pinned at 10, as the JAX package pins
    it; HALO2_LASSO_TPU_MSM_C overrides it for sweeps."""
    env = os.environ.get("HALO2_LASSO_TPU_MSM_C")
    return int(env) if env else 10


def _sum_seq(seq: ec.Points, spec: FieldSpec = Fq) -> ec.Points:
    """seq: K point batches (K, lanes, 8) -> their sum, a K3 add each."""
    K, lanes = seq["x"].shape[:2]
    acc = ec.identity_point(lanes, seq["x"].device, spec)
    for k in range(K):
        acc = ec.ec_add(acc, {c: seq[c][k] for c in ec.COORDS}, spec)
    return acc


def _weighted_sum_seq(seq: ec.Points, spec: FieldSpec = Fq) -> ec.Points:
    """seq (K, lanes, 8) -> sum_k k P_k: a suffix sum accT and the sum of
    the suffix sums accR over k = K-1 .. 1, two K3 adds a step."""
    K, lanes = seq["x"].shape[:2]
    acc_t = acc_r = ec.identity_point(lanes, seq["x"].device, spec)
    for k in range(K - 1, 0, -1):
        acc_t = ec.ec_add(acc_t, {c: seq[c][k] for c in ec.COORDS}, spec)
        acc_r = ec.ec_add(acc_r, acc_t, spec)
    return acc_r


def _jacobian_bucket_sum(bx, by, binf, W: int, B: int, spec: FieldSpec = Fq) -> ec.Points:
    """(W B, 8) affine buckets -> per-window Jacobian sum_v v S_v (reference
    :409), with v = q T + r (S seen as (G, T)):
        sum_v v S_v = T sum_q q C_q + sum_r r R_r,
    C_q = sum_r S[q, r] and R_r = sum_q S[q, r]."""
    fin = ~binf.view(W, B)
    one = spec.one(bx.device)
    pts = {
        "x": torch.where(fin[..., None], bx.view(W, B, F.LIMBS), one),
        "y": torch.where(fin[..., None], by.view(W, B, F.LIMBS), one),
        "z": torch.where(fin[..., None], one, torch.zeros_like(one)),
    }
    T = min(32, B)
    G = B // T
    s3 = {k: v.reshape(W, G, T, F.LIMBS) for k, v in pts.items()}
    c_q = _sum_seq({k: v.permute(2, 0, 1, 3).reshape(T, W * G, F.LIMBS) for k, v in s3.items()}, spec)
    r_r = _sum_seq({k: v.permute(1, 0, 2, 3).reshape(G, W * T, F.LIMBS) for k, v in s3.items()}, spec)
    wc = _weighted_sum_seq({k: v.view(W, G, F.LIMBS).transpose(0, 1) for k, v in c_q.items()}, spec)
    wr = _weighted_sum_seq({k: v.view(W, T, F.LIMBS).transpose(0, 1) for k, v in r_r.items()}, spec)
    for _ in range(T.bit_length() - 1):
        wc = ec.ec_add(wc, wc, spec)
    return ec.ec_add(wc, wr, spec)


def _prologue_fn(points: ec.Points, scalars_mont: torch.Tensor, c: int, W: int, base: FieldSpec = Fq,
                 scalar: FieldSpec = Fr):
    """Affine points (one batch inversion of z) in each window's descending
    digit order (reference :447): (ax, ay, inf, dig) of W n slots, a
    digit-0 slot marked infinite (bucket 0 has weight 0)."""
    z = points["z"]
    zinv = batch_inv_lf(z, base)
    zi2 = mul_lf(zinv, zinv, base)
    ax0 = mul_lf(points["x"], zi2, base)
    ay0 = mul_lf(points["y"], mul_lf(zi2, zinv, base), base)
    inf0 = F.is_zero(z)
    digits = MJ.digits_all(F.from_mont(scalar, scalars_mont), c, W)  # (W, n)
    order = torch.argsort(-digits, dim=1, stable=True)
    flat = order.reshape(-1)
    dig = torch.gather(digits, 1, order).reshape(-1)
    return ax0[flat], ay0[flat], inf0[flat] | (dig == 0), dig


def _final_flush(ax, ay, inf, dig, bx, by, binf, W: int, B: int, spec: FieldSpec = Fq) -> None:
    """Flush each window's last survivor into its bucket (reference :540):
    a Jacobian add at W lanes (no affine edge cases), back to affine with
    one batch inversion; the buckets updated in place."""
    fin = ~inf
    bslot = torch.arange(W, device=ax.device) * B + dig
    g = {"x": bx[bslot], "y": by[bslot], "z": torch.where(binf[bslot][:, None], 0, spec.one(ax.device))}
    s = {"x": ax, "y": ay, "z": torch.where(inf[:, None], 0, spec.one(ax.device))}
    res = ec.ec_add(g, s, spec)
    rinf = F.is_zero(res["z"])
    zinv = F.batch_inv(spec, res["z"])
    zi2 = F.mont_mul(spec, zinv, zinv)
    rx = F.mont_mul(spec, res["x"], zi2)
    ry = F.mont_mul(spec, res["y"], F.mont_mul(spec, zi2, zinv))
    at = bslot[fin]
    bx[at], by[at], binf[at] = rx[fin], ry[fin], rinf[fin]


def _epilogue_fn(ax, ay, inf, dig, bx, by, binf, W: int, B: int, c: int, spec: FieldSpec = Fq) -> ec.Points:
    """Final flush, bucket sums, and the windows by Horner's rule with c
    doublings (reference :477): a one-point Jacobian batch."""
    _final_flush(ax, ay, inf, dig, bx, by, binf, W, B, spec)
    totals = _jacobian_bucket_sum(bx, by, binf, W, B, spec)
    total = {k: v[W - 1 : W] for k, v in totals.items()}
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            total = ec.ec_add(total, total, spec)
        total = ec.ec_add(total, {k: v[w : w + 1] for k, v in totals.items()}, spec)
    return total


def msm_affine(points: ec.Points, scalars_mont: torch.Tensor, base: FieldSpec = Fq,
               scalar: FieldSpec = Fr) -> ec.Points:
    """Variable-base MSM (reference :491): (n,) Jacobian points over `base`
    and (n, 8) Montgomery scalars over `scalar`, n a power of two, -> one
    Jacobian point as a (1,)-batch (BN254 G1 by default; grumpkin: base Fr,
    scalar Fq)."""
    n = scalars_mont.shape[0]
    if n & (n - 1) or n < 2:
        raise ValueError("msm_affine: a power-of-two number of points, at least 2")
    c = _best_c(n, scalar.num_bits)
    B = 1 << c
    W = -(-scalar.num_bits // c)
    ax, ay, inf, dig = _prologue_fn(points, scalars_mont, c, W, base, scalar)
    device = scalars_mont.device
    bx = torch.zeros((W * B, F.LIMBS), dtype=torch.int32, device=device)
    by = torch.zeros_like(bx)
    binf = torch.ones(W * B, dtype=torch.bool, device=device)
    m = n
    while m > 1:
        ax, ay, inf, dig = _level_step(ax, ay, inf, dig, bx, by, binf, B, W, base)
        m //= 2
    return _epilogue_fn(ax, ay, inf, dig, bx, by, binf, W, B, c, base)
