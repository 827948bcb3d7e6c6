"""Polynomial commitment schemes (the port of halo2_lasso_tpu/pcs/__init__.py).

Commitments cross the host boundary as affine (x, y) canonical int pairs
((0, 0) = identity); the MSMs run on the device. The additive batch open
reduces many (poly, point) claims to one opening through the degree-2
coefficient sumcheck (pcs/multilinear.rs:109-276 semantics), over the PCS's
``FIELD`` (Fr, or Fq for the grumpkin-backed PCS), and combines commitments
on its ``CURVE``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops import curves
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.piop import sum_check
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript
from halo2_lasso_tpu_torch.utils.timer import timed


@dataclasses.dataclass(frozen=True)
class Evaluation:
    """(poly index, point index, claimed value) — pcs.rs:133-155."""

    poly: int
    point: int
    value: int


class PointCommitmentIO:
    """Transcript IO of a PCS whose commitments are single affine points
    (KZG, Gemini, Zeromorph, IPA; pcs.rs:93-101). Hyrax, whose commitment
    is a list of row points, defines its own."""

    @staticmethod
    def write_commitments(comms, transcript) -> None:
        transcript.write_commitments(comms)

    @staticmethod
    def read_commitments(vp, n: int, transcript):
        return transcript.read_commitments(n)

    @staticmethod
    def verifier_commitment(comm):
        """A prover-side commitment in its verifier-side form (the same for
        point commitments)."""
        return comm


def g1_sum_with_scalar(scalars: Sequence[int], bases: Sequence[Tuple[int, int]],
                       curve: curves.CurveSpec = curves.BN254_G1) -> Tuple[int, int]:
    """Host small MSM over commitment points on `curve` (pcs.rs:157-177;
    BN254 G1 unless the PCS's CURVE says)."""
    acc = None
    for s, b in zip(scalars, bases):
        if s % curve.scalar.modulus == 0 or (b[0] == 0 and b[1] == 0):
            continue
        acc = curves.host_add(curve, acc, curves.host_mul(curve, b, s))
    return (0, 0) if acc is None else acc


def _eq_xt(spec, t: Sequence[int], device) -> List[int]:
    if not t:
        return [1]
    return spec.decode_ints(mle.eq_xy(spec, list(t), device))


def additive_batch_open(
    pcs,
    pp,
    num_vars: int,
    polys: Sequence[torch.Tensor],
    points: Sequence[Sequence[int]],
    evals: Sequence[Evaluation],
    transcript: Keccak256Transcript,
) -> None:
    """pcs/multilinear.rs:134-235 semantics. `polys` are (2^k, 8) tensors
    over the PCS's FIELD."""
    spec = getattr(pcs, "FIELD", Fr)
    p = spec.modulus
    device = polys[0].device
    ell = (len(evals) - 1).bit_length() if len(evals) > 1 else 0
    eq_xt = _eq_xt(spec, transcript.squeeze_challenges(ell), device)

    # merge polys per point (scalar bookkeeping mirrors the reference fold);
    # the scalars are host ints, by value in the product kernel
    merged: List = [None] * len(points)  # (scalar, tensor) | None
    for ev, eq_i in zip(evals, eq_xt):
        j = ev.point
        if merged[j] is None:
            merged[j] = (eq_i, polys[ev.poly])
        else:
            coeff, arr = merged[j]
            if coeff != 1:
                arr = F.mont_mul(spec, arr, coeff)
            merged[j] = (1, F.mul_add(spec, polys[ev.poly], eq_i, arr))

    terms = []
    for j, m in enumerate(merged):
        if m is not None:
            scalar, arr = m
            terms.append((scalar, mle.eq_xy(spec, list(points[j]), device), arr, j))

    tilde_gs_sum = sum(ev.value * eq_i for ev, eq_i in zip(evals, eq_xt)) % p
    with timed.scope("batch_open_sumcheck"):
        challenges, _ = sum_check.prove_coeff_products(
            spec, num_vars, [(s, e, a) for s, e, a, _ in terms], tilde_gs_sum, transcript
        )

    # g' = sum_j (scalar_j * eq_xy_eval(challenges, point_j)) * merged_j
    g_prime = None
    for scalar, _, arr, j in terms:
        c = scalar * mle.eq_xy_eval_host(p, challenges, list(points[j])) % p
        g_prime = F.mont_mul(spec, arr, c) if g_prime is None else F.mul_add(spec, arr, c, g_prime)

    with timed.scope("batch_open_pcs_open"):
        pcs.open(pp, g_prime, challenges, None, transcript)


def additive_batch_verify(
    pcs,
    vp,
    num_vars: int,
    comms: Sequence[Tuple[int, int]],
    points: Sequence[Sequence[int]],
    evals: Sequence[Evaluation],
    transcript: Keccak256Transcript,
) -> None:
    """pcs/multilinear.rs:237-275 semantics, over the PCS's FIELD. A PCS
    whose commitments are not single points, or not on BN254 G1, combines
    them with its own ``sum_commitments``."""
    p = getattr(pcs, "FIELD", Fr).modulus
    ell = (len(evals) - 1).bit_length() if len(evals) > 1 else 0
    t = transcript.squeeze_challenges(ell)
    eq_xt = [1] if not t else [mle.lagrange_eval_host(p, t, b) for b in range(1 << ell)]
    tilde_gs_sum = sum(ev.value * eq_i for ev, eq_i in zip(evals, eq_xt)) % p
    g_prime_eval, challenges = sum_check.verify_coeff(p, num_vars, 2, tilde_gs_sum, transcript)
    eq_xy_evals = [mle.eq_xy_eval_host(p, challenges, list(pt)) for pt in points]
    scalars = [eq_xy_evals[ev.point] * eq_i % p for ev, eq_i in zip(evals, eq_xt)]
    bases = [comms[ev.poly] for ev in evals]
    combine = getattr(pcs, "sum_commitments", g1_sum_with_scalar)
    pcs.verify(vp, combine(scalars, bases), challenges, g_prime_eval, transcript)
