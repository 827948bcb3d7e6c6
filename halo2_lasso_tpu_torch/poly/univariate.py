"""Univariate polynomials in coefficient basis (the port of
halo2_lasso_tpu/poly/univariate.py; poly/univariate.rs semantics), for the
univariate KZG under Gemini and Zeromorph.

Coefficients are (n, 8) Montgomery tensors, lowest degree first. Points are
host ints, travelling by value in the field kernels. Every step is a few
launches of the K4 family, whatever n:
  * ``powers_array`` is one inclusive product scan (csrc/mont_chain.cu);
  * ``evaluate`` is the powers, one product and one row sum;
  * ``div_by_linear`` is synthetic division as a log-depth suffix scan:
    q_i = c_{i+1} + z q_{i+1}, so the suffix sums a_j = sum_{i >= j} c_i
    z^(i - j) come from ceil(log2 n) levels of a_j += z^k a_{j+k}, one
    a * b + c launch each with z^k by value (the JAX package composes the
    same affine maps with an associative scan);
  * division by a small vanishing polynomial is repeated linear division.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.field import FieldSpec


def powers_array(spec: FieldSpec, x: int, n: int, device) -> torch.Tensor:
    """[1, x, x^2, ..., x^(n-1)] as (n, 8): one product by value and one
    scan launch (3 past SCAN_TILE rows)."""
    one = spec.one(device)[None]
    if n == 1:
        return one.clone()
    xs = F.mont_mul(spec, one.expand(n - 1, F.LIMBS), x)
    return torch.cat([one, F.prefix_products(spec, xs)])


def evaluate(spec: FieldSpec, coeffs: torch.Tensor, x: int) -> torch.Tensor:
    """sum_i coeffs[i] x^i -> (8,)."""
    pw = powers_array(spec, x, coeffs.shape[0], coeffs.device)
    return F.sum_reduce(spec, F.mont_mul(spec, coeffs, pw))


def div_by_linear(spec: FieldSpec, coeffs: torch.Tensor, z: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, r) with f(X) = q(X) (X - z) + r: q the (n - 1, 8) quotient, r =
    f(z) as (8,). The suffix sums a_j = sum_{i >= j} c_i z^(i - j) give
    q_i = a_{i+1} and r = a_0."""
    p = spec.modulus
    a = coeffs
    n, k = coeffs.shape[0], 1
    while k < n:
        a = torch.cat([F.mul_add(spec, a[k:], pow(z, k, p), a[: n - k]), a[n - k :]])
        k *= 2
    return a[1:], a[0]


def mul_small(spec: FieldSpec, coeffs: torch.Tensor, small: Sequence[int]) -> torch.Tensor:
    """coeffs (n, 8) times a small polynomial of host ints (degree d) ->
    (n + d, 8), one a * b + c launch a nonzero coefficient."""
    n = coeffs.shape[0]
    out = spec.zeros(n + len(small) - 1, coeffs.device)
    for k, c in enumerate(small):
        if c % spec.modulus:
            out[k : k + n] = F.mul_add(spec, coeffs, c, out[k : k + n])
    return out


def add_padded(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b with the shorter one padded by zeros: one add over the
    overlap, the longer one's tail copied."""
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    m = b.shape[0]
    return torch.cat([F.add(spec, a[:m], b), a[m:]])


def div_rem_by_vanishing(spec: FieldSpec, coeffs: torch.Tensor, roots: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Divide by prod (X - root_k): repeated linear division. Returns
    (quotient (n - d, 8), remainder coefficients (d, 8))."""
    q = coeffs
    for rt in roots:
        q, _ = div_by_linear(spec, q, rt)
    d = len(roots)
    if d == 0:
        return q, coeffs[:0]
    qv = mul_small(spec, q, vanishing_poly_host(spec.modulus, roots))
    return q, F.sub(spec, coeffs[:d], qv[:d])


def vanishing_poly_host(p: int, roots: Sequence[int]) -> List[int]:
    """Coefficients of prod (X - root) as host ints (low to high)."""
    coeffs = [1]
    for rt in roots:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i + 1] = (nxt[i + 1] + c) % p
            nxt[i] = (nxt[i] - c * rt) % p
        coeffs = nxt
    return coeffs


def evaluate_host(p: int, coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(list(coeffs)):
        acc = (acc * x + c) % p
    return acc
