"""Curve catalogue: BN254, Grumpkin, Pasta (Pallas / Vesta) (the port's
copy of halo2_lasso_tpu/ops/curves.py; halo2_curves bn256 / grumpkin /
pasta).

Host code only. Every curve here has device group ops (ops/ec.py): BN254 G1
and grumpkin over the Fq and the Fr instances of the curve kernels
(grumpkin's fields are BN254's Fr and Fq swapped), Pallas and Vesta over
their own (``kernel_id`` 2 and 3: the Pasta fields are two 255-bit primes,
each curve's base field the other's scalar field, ``TWO_CHAIN``).
``hash_to_curve`` derives the IPA and Hyrax generators; ``host_add`` /
``host_mul`` combine the handful of commitment points a verifier touches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from halo2_lasso_tpu_torch.ops.bn254 import FR_MODULUS, Fq, Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.ops.keccak import keccak256_many
from halo2_lasso_tpu_torch.ops.msm_jacobian import host_batch_affine, host_jac_add, host_jac_double


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec  # coordinates field
    scalar: FieldSpec  # group order field
    b: int  # y^2 = x^3 + b (a = 0 for every curve here)
    generator: Tuple[int, int]


# --- BN254 / Grumpkin 2-cycle ---
# grumpkin: defined over BN254's scalar field with group order BN254's base
# field; y^2 = x^3 - 17, generator (1, sqrt(-16)).
GRUMPKIN_B = FR_MODULUS - 17
GRUMPKIN_GEN = (
    1,
    17631683881184975370165255887551781615748388533673675138860,  # sqrt(-16) mod r
)

BN254_G1 = CurveSpec("bn254_g1", base=Fq, scalar=Fr, b=3, generator=(1, 2))
GRUMPKIN = CurveSpec("grumpkin", base=Fr, scalar=Fq, b=GRUMPKIN_B, generator=GRUMPKIN_GEN)

# --- Pasta 2-cycle ---
PALLAS_MODULUS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
VESTA_MODULUS = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

Fp_pallas = FieldSpec(name="pallas_base", modulus=PALLAS_MODULUS, kernel_id=2)
Fq_vesta = FieldSpec(name="vesta_base", modulus=VESTA_MODULUS, kernel_id=3)

PALLAS = CurveSpec("pallas", base=Fp_pallas, scalar=Fq_vesta, b=5, generator=(PALLAS_MODULUS - 1, 2))
VESTA = CurveSpec("vesta", base=Fq_vesta, scalar=Fp_pallas, b=5, generator=(VESTA_MODULUS - 1, 2))

# TwoChainCurve pairs (util/arithmetic.rs:37-59)
TWO_CHAIN = {"bn254_g1": GRUMPKIN, "grumpkin": BN254_G1, "pallas": VESTA, "vesta": PALLAS}


def on_curve(spec: CurveSpec, x: int, y: int) -> bool:
    p = spec.base.modulus
    return (y * y - x * x * x - spec.b) % p == 0


@functools.lru_cache(maxsize=None)
def _tonelli_shanks_consts(p: int) -> Tuple[int, int, int]:
    """p - 1 = q 2^s with q odd, and c = z^q for the least non-residue z:
    the per-modulus part of Tonelli-Shanks, found once a modulus."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    return q, s, pow(z, q, p)


def sqrt_mod(a: int, p: int):
    """A square root mod the odd prime p, or None for a non-residue: the
    p = 3 (mod 4) shortcut (BN254 Fq; one power, its square compared with
    a in place of Euler's criterion), Tonelli-Shanks otherwise (Fr,
    pasta): one power a^((q-1)/2) gives its root and t, Euler's criterion
    comes from t by squarings, and the split of p - 1 and the
    non-residue's power are computed once a modulus."""
    a %= p
    if a == 0:
        return 0
    if p % 4 == 3:
        r = pow(a, (p + 1) // 4, p)
        return r if r * r % p == a else None
    q, m, c = _tonelli_shanks_consts(p)
    w = pow(a, (q - 1) // 2, p)  # one power: r = a^((q+1)/2), t = a^q
    r = a * w % p
    t = r * w % p
    e = t  # Euler's criterion, a^((p-1)/2) = t^(2^(m-1))
    for _ in range(m - 1):
        e = e * e % p
    if e != 1:
        return None
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        r = r * b % p
        t = t * c % p
    return r


def hash_to_curve(curve: CurveSpec, seed: bytes, n: int) -> np.ndarray:
    """n generators with publicly unknown discrete logs, by try-and-increment:
    x from keccak(seed || i || ctr) mod p, y the smaller root of x^3 + b
    (every catalogued curve has cofactor 1); the intent of the reference's
    hash_to_curve setup (pcs/multilinear/ipa.rs:105,123). Returns an (n, 2)
    object array of affine coordinates. The candidates of every index still
    open are hashed together (``keccak256_many``), one counter at a time."""
    p = curve.base.modulus
    out = np.empty((n, 2), dtype=object)
    pending, ctr = list(range(n)), 0
    while pending:
        msgs = [seed + i.to_bytes(8, "little") + ctr.to_bytes(4, "little") for i in pending]
        missed = []
        for i, h in zip(pending, keccak256_many(msgs)):
            x = int.from_bytes(h, "little") % p
            y = sqrt_mod((x * x % p * x + curve.b) % p, p)
            if y is not None and x != 0:
                out[i, 0] = x
                out[i, 1] = min(y, p - y)
            else:
                missed.append(i)
        pending, ctr = missed, ctr + 1
    return out


# ---------------------------------------------------------------------------
# host affine arithmetic over any catalogued a = 0 curve (Python ints; None
# or (0, 0) is the identity)
# ---------------------------------------------------------------------------


def host_add(curve: CurveSpec, p, q):
    m = curve.base.modulus
    if p is None or p == (0, 0):
        return q
    if q is None or q == (0, 0):
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % m == 0:
            return (0, 0)
        lam = 3 * x1 * x1 * pow(2 * y1, -1, m) % m
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, m) % m
    x3 = (lam * lam - x1 - x2) % m
    y3 = (lam * (x1 - x3) - y1) % m
    return (x3, y3)


def host_mul(curve: CurveSpec, p, k: int):
    """k * p by double-and-add in Jacobian coordinates (the a = 0 formulas
    of ops/msm_jacobian.py, no inversion a step), one inversion at the end."""
    k = k % curve.scalar.modulus
    if p is None or p == (0, 0) or k == 0:
        return (0, 0)
    m = curve.base.modulus
    acc, add = (0, 0, 0), (p[0], p[1], 1)
    while k:
        if k & 1:
            acc = host_jac_add(acc, add, m)
        k >>= 1
        if k:
            add = host_jac_double(add, m)
    return host_batch_affine([acc], m)[0]
