"""Multilinear IPA, Bulletproofs-style log-round folding (the port of
halo2_lasso_tpu/pcs/ipa.py; pcs/multilinear/ipa.rs), over BN254 G1 with
polynomials over Fr (``MultilinearIpa``) or over grumpkin with polynomials
over BN254 Fq (``MultilinearIpaGrumpkin``, hyperplonk.rs:422).

commit = MSM(evals, G). open squeezes xi_0, scales H to h' = xi_0 H, then
runs num_vars rounds: the cross terms L = MSM(G_l, c_r) + <c_r, z_l> h' and
R = MSM(G_r, c_l) + <c_l, z_r> h', then the folds G = G_l + xi G_r,
c = c_l + xi^-1 c_r, z = z_l + xi z_r (ipa.rs:170-241). verify recombines
with the tensor-expanded h_coeffs polynomial (ipa.rs:269-337).

A scaling by a host scalar (``_scale_points``) is the double-and-add ladder
over the scalar field's 254 bits, one launch of ops/ec.py ``ec_ladder``
whatever the number of points (the TPU ran two complete-add launches a
bit); each round scales h' by c_l and by c_r in one 2-lane ladder with
per-lane scalars, and b_r by xi in one shared-scalar ladder, then folds
the bases with one ``ec_add`` launch. The generators come from
``hash_to_curve(b"MultilinearIpa::setup")`` on the host (ipa.rs:105,123),
timed apart as ``ipa_hash_to_curve``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.pcs import (
    PointCommitmentIO, additive_batch_open, additive_batch_verify, g1_sum_with_scalar,
)
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import PcsError
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.utils.timer import timed


@dataclasses.dataclass
class IpaParams:
    num_vars: int
    g: dict  # device Jacobian point batch (2^k,)
    h: dict  # one-point batch (1,)

    @property
    def device(self):
        return self.g["x"].device


class MultilinearIpa(PointCommitmentIO):
    CURVE = curves.BN254_G1
    FIELD = Fr  # the curve's scalar field: the polynomial and challenge field

    @classmethod
    def setup(cls, poly_size: int, rng=None, device="cuda") -> IpaParams:
        with timed.scope("ipa_hash_to_curve"):
            affine = curves.hash_to_curve(cls.CURVE, b"MultilinearIpa::setup", poly_size + 1)
        pts = ec.affine_to_jacobian([(int(x), int(y)) for x, y in affine], device, cls.CURVE.base)
        return IpaParams(
            num_vars=poly_size.bit_length() - 1,
            g={k: v[:poly_size] for k, v in pts.items()},
            h={k: v[poly_size:] for k, v in pts.items()},
        )

    @classmethod
    def from_jax_params(cls, params, device="cuda") -> IpaParams:
        """The JAX package's IpaParams (its g batch and its one point h) ->
        the port's."""
        return IpaParams(
            num_vars=params.num_vars,
            g={k: F.from_jax_limbs(np.asarray(params.g[k]), device) for k in ec.COORDS},
            h={k: F.from_jax_limbs(np.asarray(params.h[k]).reshape(1, -1), device) for k in ec.COORDS},
        )

    @classmethod
    def trim(cls, param: IpaParams, poly_size: int):
        num_vars = poly_size.bit_length() - 1
        if param.num_vars < num_vars:
            raise PcsError("too many variates to trim")
        p = IpaParams(num_vars=num_vars, g={k: v[:poly_size] for k, v in param.g.items()}, h=param.h)
        return p, p

    @classmethod
    def batch_commit(cls, pp: IpaParams, polys) -> List[Tuple[int, int]]:
        jobs = []
        for evals in polys:
            n = evals.shape[0]
            if n.bit_length() - 1 > pp.num_vars:
                raise PcsError("poly has too many variates")
            jobs.append(({k: v[:n] for k, v in pp.g.items()}, evals))
        return ec.msm_list_to_affine_int(jobs, cls.CURVE.base, cls.FIELD)

    @classmethod
    def commit(cls, pp: IpaParams, evals: torch.Tensor) -> Tuple[int, int]:
        return cls.batch_commit(pp, [evals])[0]

    @classmethod
    def sum_commitments(cls, scalars, bases) -> Tuple[int, int]:
        return g1_sum_with_scalar(scalars, bases, cls.CURVE)

    @classmethod
    def _scale_points(cls, pts: dict, scalar: int) -> dict:
        """scalar * pts for a host scalar: the ladder over the scalar field's
        bit length (254 for Fr and Fq), the scalar shared by every lane."""
        return ec.ec_ladder(pts, scalar % cls.FIELD.modulus, cls.FIELD.num_bits, cls.CURVE.base)

    @classmethod
    def open(cls, pp: IpaParams, evals: torch.Tensor, point: Sequence[int], eval_, transcript) -> None:
        S, B = cls.FIELD, cls.CURVE.base
        num_vars = len(point)
        xi_0 = transcript.squeeze_challenge()
        h_prime = cls._scale_points(pp.h, xi_0)

        bases = {k: v[: 1 << num_vars] for k, v in pp.g.items()}
        coeffs = evals
        zs = mle.eq_xy(S, list(point), evals.device)
        for i in range(num_vars):
            mid = 1 << (num_vars - i - 1)
            b_l = {k: v[:mid] for k, v in bases.items()}
            b_r = {k: v[mid:] for k, v in bases.items()}
            # c_l and c_r as canonical limbs, left on the card for the ladder
            c_lr = F.from_mont(S, torch.stack([
                F.sum_reduce(S, F.mont_mul(S, coeffs[mid:], zs[:mid])),
                F.sum_reduce(S, F.mont_mul(S, coeffs[:mid], zs[mid:])),
            ]))
            # L = MSM(bases_l, coeffs_r) + c_l h', R = MSM(bases_r, coeffs_l) + c_r h'
            msm_l, msm_r = MJ.msm_many([(b_l, coeffs[mid:]), (b_r, coeffs[:mid])], B, S)
            # c_l h' and c_r h': one ladder over two lanes, a scalar each
            scaled = ec.ec_ladder(ec.cat_points(h_prime, h_prime), c_lr, S.num_bits, B)
            v = B.decode_ints(torch.cat([scaled[k] for k in ec.COORDS]))  # x_l, x_r, y_l, y_r, z_l, z_r
            l_aff, r_aff = MJ.host_batch_affine([
                MJ.host_jac_add(msm_l, tuple(v[0::2]), B.modulus),
                MJ.host_jac_add(msm_r, tuple(v[1::2]), B.modulus),
            ], B.modulus)
            transcript.write_commitment(l_aff)
            transcript.write_commitment(r_aff)

            xi = transcript.squeeze_challenge()
            xi_inv = pow(xi, -1, S.modulus)
            bases = ec.ec_add(b_l, cls._scale_points(b_r, xi), B)
            coeffs = F.mul_add(S, coeffs[mid:], xi_inv, coeffs[:mid])
            zs = F.mul_add(S, zs[mid:], xi, zs[:mid])

        transcript.write_field_element(S.decode_ints(coeffs[:1])[0])

    @classmethod
    def verify(cls, vp: IpaParams, comm, point: Sequence[int], eval_: int, transcript) -> None:
        S = cls.FIELD
        Pm = S.modulus
        num_vars = len(point)
        xi_0 = transcript.squeeze_challenge()
        ls, rs, xis = [], [], []
        for _ in range(num_vars):
            ls.append(transcript.read_commitment())
            rs.append(transcript.read_commitment())
            xis.append(transcript.squeeze_challenge())
        neg_c = (-transcript.read_field_element()) % Pm

        # h_coeffs: neg_c times the product of the xi_i of the set bits
        # (ipa.rs:319-337: the left half duplicated and scaled by xi, xi
        # taken in reverse)
        hc = [neg_c]
        for xi in reversed(xis):
            hc = hc + [c * xi % Pm for c in hc]
        hc_dev = F.encode_dev(S, np.array(hc, dtype=object), vp.device)
        neg_c_h_eval = S.decode_ints(mle.evaluate(S, hc_dev, list(point))[None])[0]
        u = xi_0 * ((neg_c_h_eval + eval_) % Pm) % Pm

        # sum xi_i^-1 L_i + sum xi_i R_i + MSM(g, hc) + u h + comm == O
        acc = None
        for l_c, xi in zip(ls, xis):
            acc = curves.host_add(cls.CURVE, acc, curves.host_mul(cls.CURVE, l_c, pow(xi, -1, Pm)))
        for r_c, xi in zip(rs, xis):
            acc = curves.host_add(cls.CURVE, acc, curves.host_mul(cls.CURVE, r_c, xi))
        g_part = ec.msm_to_affine_int({k: v[: 1 << num_vars] for k, v in vp.g.items()}, hc_dev, cls.CURVE.base, S)
        if g_part != (0, 0):
            acc = curves.host_add(cls.CURVE, acc, g_part)
        if u:
            acc = curves.host_add(cls.CURVE, acc, curves.host_mul(cls.CURVE, ec.jacobian_to_affine(vp.h, cls.CURVE.base)[0], u))
        if comm != (0, 0):
            acc = curves.host_add(cls.CURVE, acc, comm)
        if acc is not None and acc != (0, 0):
            raise PcsError("invalid multilinear IPA open")

    @classmethod
    def batch_open(cls, pp, polys, comms, points, evals, transcript):
        additive_batch_open(cls, pp, pp.num_vars, polys, points, evals, transcript)

    @classmethod
    def batch_verify(cls, vp, comms, points, evals, transcript):
        additive_batch_verify(cls, vp, vp.num_vars, comms, points, evals, transcript)


class MultilinearIpaGrumpkin(MultilinearIpa):
    """IPA over grumpkin, the other half of the BN254 2-cycle: coordinates in
    BN254 Fr, polynomials and challenges over BN254 Fq (the port of
    halo2_lasso_tpu/pcs/ipa.py:222; hyperplonk.rs:422-423)."""

    CURVE = curves.GRUMPKIN
    FIELD = Fq
