"""BN254 optimal-ate pairing, host-side pure python (the port's copy of
halo2_lasso_tpu/ops/pairing.py).

Used only by verifiers (one multi-pairing per proof — reference calls
`multi_miller_loop` + `final_exponentiation`, util/arithmetic.rs:26-35), so a
clean python-int implementation of the standard algorithm is the right tool;
the prover never touches pairings.

Tower: Fq2 = Fq[u]/(u^2+1); G2 points are twisted into Fq12 represented as
Fq[w]/(w^12 - 18 w^6 + 82) (equivalently w^6 = 9 + u).

ATTRIBUTION: the FQP extension-field class, the twist into the w^12 tower,
the Miller-loop structure (`linefunc`, `ATE_LOOP_COUNT`), and the final-
exponentiation flow are adapted from the Ethereum Foundation's `py_ecc`
library (https://github.com/ethereum/py_ecc, `py_ecc/bn128/`), which is
distributed under the MIT License:

    Copyright (c) 2015 Vitalik Buterin

    Permission is hereby granted, free of charge, to any person obtaining a
    copy of this software and associated documentation files (the
    "Software"), to deal in the Software without restriction, including
    without limitation the rights to use, copy, modify, merge, publish,
    distribute, sublicense, and/or sell copies of the Software, and to
    permit persons to whom the Software is furnished to do so, subject to
    the following conditions: The above copyright notice and this
    permission notice shall be included in all copies or substantial
    portions of the Software.

    THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS
    OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
    MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
    IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY
    CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION OF CONTRACT,
    TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION WITH THE
    SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.

It is not derived from the Rust reference (which delegates pairings to the
halo2_curves crate); it is host-side, verifier-only code.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from halo2_lasso_tpu_torch.ops import bn254

P = bn254.FQ_MODULUS
R = bn254.FR_MODULUS

ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63


# ---------------------------------------------------------------------------
# polynomial extension field FQP (coeffs are python ints mod P)
# ---------------------------------------------------------------------------


class FQP:
    __slots__ = ("coeffs", "modulus_coeffs", "degree")

    def __init__(self, coeffs, modulus_coeffs):
        self.coeffs = [c % P for c in coeffs]
        self.modulus_coeffs = modulus_coeffs
        self.degree = len(modulus_coeffs)
        assert len(coeffs) == self.degree

    def _new(self, coeffs):
        return FQP(coeffs, self.modulus_coeffs)

    def __add__(self, other):
        return self._new([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return self._new([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return self._new([-a for a in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return self._new([a * other for a in self.coeffs])
        d = self.degree
        b = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a == 0:
                continue
            for j, c in enumerate(other.coeffs):
                b[i + j] += a * c
        for exp in range(2 * d - 2, d - 1, -1):
            top = b[exp] % P
            if top:
                b[exp] = 0
                for i, mc in enumerate(self.modulus_coeffs):
                    b[exp - d + i] -= top * mc
        return self._new(b[:d])

    __rmul__ = __mul__

    def __eq__(self, other):
        return self.coeffs == other.coeffs

    def pow(self, n: int):
        result = self.one()
        base = self
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def inv(self):
        # extended euclid over Fq[x] mod modulus poly
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = self.coeffs + [0]
        high = self.modulus_coeffs + [1]

        def deg(poly):
            for i in range(len(poly) - 1, -1, -1):
                if poly[i] % P:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            binv = pow(b[degb], -1, P)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % P
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[c]) % P
            return [x % P for x in o[: deg(o) + 1]]

        while deg(low):
            rq = poly_rounded_div(high, low)
            rq += [0] * (d + 1 - len(rq))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * rq[j]
                    new[i + j] -= low[i] * rq[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_low0 = pow(low[0], -1, P)
        return self._new([(c * inv_low0) % P for c in lm[:d]])

    def one(self):
        return self._new([1] + [0] * (self.degree - 1))

    def zero(self):
        return self._new([0] * self.degree)

    def is_one(self):
        return self.coeffs[0] == 1 and all(c == 0 for c in self.coeffs[1:])


FQ2_MODULUS = [1, 0]  # u^2 = -1
FQ12_MODULUS = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]  # w^12 = 18 w^6 - 82


def fq2(c0, c1):
    return FQP([c0, c1], FQ2_MODULUS)


def fq12(coeffs):
    return FQP(list(coeffs), FQ12_MODULUS)


FQ12_ONE = fq12([1] + [0] * 11)
W = fq12([0, 1] + [0] * 10)
W2 = W * W
W3 = W2 * W


# ---------------------------------------------------------------------------
# curve ops over a generic field (affine; None = identity)
# ---------------------------------------------------------------------------


def _double(pt):
    if pt is None:
        return None
    x, y = pt
    lam = (3 * x * x) * (2 * y).inv() if isinstance(x, FQP) else (3 * x * x) * pow(2 * y, -1, P)
    if isinstance(x, FQP):
        newx = lam * lam - x - x
        newy = lam * (x - newx) - y
    else:
        lam %= P
        newx = (lam * lam - 2 * x) % P
        newy = (lam * (x - newx) - y) % P
    return (newx, newy)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if isinstance(x1, FQP):
        if x1 == x2 and y1 == y2:
            return _double(p1)
        if x1 == x2:
            return None
        lam = (y2 - y1) * (x2 - x1).inv()
        newx = lam * lam - x1 - x2
        newy = lam * (x1 - newx) - y1
        return (newx, newy)
    else:
        if x1 == x2 and y1 == y2:
            return _double(p1)
        if x1 == x2:
            return None
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
        newx = (lam * lam - x1 - x2) % P
        newy = (lam * (x1 - newx) - y1) % P
        return (newx, newy)


def _mul(pt, n):
    acc = None
    while n:
        if n & 1:
            acc = _add(acc, pt)
        pt = _double(pt)
        n >>= 1
    return acc


def _neg(pt):
    if pt is None:
        return None
    x, y = pt
    if isinstance(x, FQP):
        return (x, -y)
    return (x, (-y) % P)


# ---------------------------------------------------------------------------
# twist + pairing
# ---------------------------------------------------------------------------


def twist(pt_fq2: Tuple[FQP, FQP]):
    """G2 (Fq2 affine) -> curve over FQ12 (untwist embedding)."""
    if pt_fq2 is None:
        return None
    x, y = pt_fq2
    xc = [(x.coeffs[0] - 9 * x.coeffs[1]) % P, x.coeffs[1]]
    yc = [(y.coeffs[0] - 9 * y.coeffs[1]) % P, y.coeffs[1]]
    nx = fq12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = fq12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * W2, ny * W3)


def cast_g1_to_fq12(pt: Tuple[int, int]):
    if pt is None or (pt[0] == 0 and pt[1] == 0):
        return None
    x, y = pt
    return (fq12([x] + [0] * 11), fq12([y] + [0] * 11))


def linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all over FQ12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not x1 == x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (3 * (x1 * x1)) * (2 * y1).inv()
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def miller_loop(q, pt):
    """q, pt: points over FQ12 (q from twisted G2, pt from G1). No final exp."""
    if q is None or pt is None:
        return FQ12_ONE
    r_pt = q
    f = FQ12_ONE
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * linefunc(r_pt, r_pt, pt)
        r_pt = _double(r_pt)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * linefunc(r_pt, q, pt)
            r_pt = _add(r_pt, q)
    q1 = (q[0].pow(P), q[1].pow(P))
    nq2 = (q1[0].pow(P), -q1[1].pow(P))
    f = f * linefunc(r_pt, q1, pt)
    r_pt = _add(r_pt, q1)
    f = f * linefunc(r_pt, nq2, pt)
    return f


def final_exponentiation(f: FQP) -> FQP:
    return f.pow((P ** 12 - 1) // R)


def pairing(g1_pt: Tuple[int, int], g2_pt: Tuple[Tuple[int, int], Tuple[int, int]]) -> FQP:
    """e(P, Q) with P affine G1 ints, Q affine G2 ((x0,x1),(y0,y1)) ints."""
    q = twist((fq2(*g2_pt[0]), fq2(*g2_pt[1]))) if g2_pt is not None else None
    p12 = cast_g1_to_fq12(g1_pt)
    return final_exponentiation(miller_loop(q, p12))


def multi_pairing_is_one(terms: Sequence[Tuple[Tuple[int, int], Tuple]]) -> bool:
    """prod e(P_i, Q_i) == 1 — the reference's pairings_product_is_identity
    (util/arithmetic.rs:26-35)."""
    f = FQ12_ONE
    for g1_pt, g2_pt in terms:
        if g1_pt is None or (g1_pt[0] == 0 and g1_pt[1] == 0) or g2_pt is None:
            continue
        q = twist((fq2(*g2_pt[0]), fq2(*g2_pt[1])))
        f = f * miller_loop(q, cast_g1_to_fq12(g1_pt))
    return final_exponentiation(f).is_one()


# G2 scalar mul on host (for SRS generation)
def g2_mul(g2_pt, n: int):
    pt = (fq2(*g2_pt[0]), fq2(*g2_pt[1]))
    out = _mul(pt, n)
    if out is None:
        return None
    return (tuple(out[0].coeffs), tuple(out[1].coeffs))


def g1_mul_host(g1_pt: Tuple[int, int], n: int):
    return _mul(g1_pt, n)
