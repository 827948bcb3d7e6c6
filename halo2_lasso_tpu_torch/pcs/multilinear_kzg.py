"""Multilinear KZG (PST13-style), the port of
halo2_lasso_tpu/pcs/multilinear_kzg.py (kzg.rs semantics).

  * SRS: random s_1..s_k drawn from the caller's np.random.RandomState
    exactly as the reference draws them, so one seed gives one SRS in both
    packages; G1 tables eqs[j] = { eq(b; s_1..s_j) * G1 } for j <= k;
    G2 points s_i * G2.
  * commit = MSM(evals, eqs[num_vars]).
  * open at x: the k quotients of f - f(x) against (X_i - x_i), one
    fix_var_chain launch binding the highest variable first, each quotient
    committed with the size-matched eq table.
  * verify: e(C - eval*G1, -G2) * prod_i e(Q_i, (s_i - x_i) G2) == 1, on
    the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import pairing as hostec
from halo2_lasso_tpu_torch.ops.bn254 import G1_GEN, G2_GEN_X, G2_GEN_Y, Fr
from halo2_lasso_tpu_torch.pcs import Evaluation, PointCommitmentIO, additive_batch_open, additive_batch_verify
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript
from halo2_lasso_tpu_torch.utils.timer import timed

G2_GEN = (G2_GEN_X, G2_GEN_Y)


class PcsError(Halo2LassoError):
    pass


@dataclasses.dataclass
class KzgParams:
    g1: Tuple[int, int]
    eqs: List[dict]  # eqs[j]: device Jacobian point batch of size 2^j
    g2: Tuple
    ss: List[Tuple]  # s_i * G2 affine (Fq2 coeff tuples)

    @property
    def device(self):
        return self.eqs[0]["x"].device


@dataclasses.dataclass
class KzgProverParams:
    g1: Tuple[int, int]
    eqs: List[dict]

    @property
    def num_vars(self):
        return len(self.eqs) - 1

    @property
    def device(self):
        return self.eqs[0]["x"].device


@dataclasses.dataclass
class KzgVerifierParams:
    g1: Tuple[int, int]
    g2: Tuple
    ss: List[Tuple]

    @property
    def num_vars(self):
        return len(self.ss)


def from_jax_kzg_params(params, device="cuda"):
    """The JAX package's KzgParams / KzgProverParams / KzgVerifierParams
    (numpy-convertible limb arrays and Python ints) -> the port's."""

    def points(d):
        return {k: F.from_jax_limbs(np.asarray(d[k]), device) for k in ec.COORDS}

    name = type(params).__name__
    if name == "KzgParams":
        return KzgParams(params.g1, [points(e) for e in params.eqs], params.g2, list(params.ss))
    if name == "KzgProverParams":
        return KzgProverParams(params.g1, [points(e) for e in params.eqs])
    if name == "KzgVerifierParams":
        return KzgVerifierParams(params.g1, params.g2, list(params.ss))
    raise TypeError(f"not a KZG parameter set: {name}")


class MultilinearKzg(PointCommitmentIO):
    """Namespace-style PCS implementation (stateless staticmethods)."""

    from_jax_params = staticmethod(from_jax_kzg_params)

    @staticmethod
    def setup(poly_size: int, rng: np.random.RandomState, device="cuda") -> KzgParams:
        assert poly_size & (poly_size - 1) == 0
        num_vars = poly_size.bit_length() - 1
        ss = [int.from_bytes(rng.bytes(40), "little") % Fr.modulus for _ in range(num_vars)]
        # all eq tables concatenated: sizes 1, 2, ..., 2^k
        tables = [Fr.one(device)[None]]
        for j in range(1, num_vars + 1):
            tables.append(mle.eq_xy(Fr, ss[:j], device))
        pts = ec.fixed_base_msm(G1_GEN, torch.cat(tables))
        eqs = ec.split_points(pts, [1 << j for j in range(num_vars + 1)])
        ss_g2 = [hostec.g2_mul(G2_GEN, s) for s in ss]
        return KzgParams(g1=G1_GEN, eqs=eqs, g2=G2_GEN, ss=ss_g2)

    @staticmethod
    def trim(param: KzgParams, poly_size: int) -> Tuple[KzgProverParams, KzgVerifierParams]:
        num_vars = poly_size.bit_length() - 1
        if len(param.eqs) - 1 < num_vars:
            raise PcsError(
                f"too many variates to trim (supports up to {len(param.eqs)-1}, got {num_vars})"
            )
        return (
            KzgProverParams(g1=param.g1, eqs=param.eqs[: num_vars + 1]),
            KzgVerifierParams(g1=param.g1, g2=param.g2, ss=param.ss[:num_vars]),
        )

    @staticmethod
    def commit(pp: KzgProverParams, evals: torch.Tensor) -> Tuple[int, int]:
        """evals: (2^k, 8) Montgomery tensor -> affine commitment."""
        return MultilinearKzg.batch_commit(pp, [evals])[0]

    @staticmethod
    def batch_commit(pp: KzgProverParams, polys: Sequence[torch.Tensor]) -> List[Tuple[int, int]]:
        jobs = []
        for poly in polys:
            k = poly.shape[0].bit_length() - 1
            if k > pp.num_vars:
                raise PcsError("poly has too many variates for params")
            jobs.append((pp.eqs[k], poly))
        return ec.msm_list_to_affine_int(jobs)

    @staticmethod
    def quotient_polys(evals: torch.Tensor, point: Sequence[int]):
        """Quotients of f - f(x) against (X_i - x_i), highest variable first;
        returns ([(num_vars_i, quotient)] by increasing i, remainder (8,))
        (pcs/multilinear.rs:72-107)."""
        k = evals.shape[0].bit_length() - 1
        assert len(point) == k
        rem, quot = mle.fix_var_chain(Fr, evals, list(point), last=True, quotients=True)
        return list(enumerate(mle.chain_quotients(quot))), rem[0]

    @staticmethod
    def open(
        pp: KzgProverParams,
        evals: torch.Tensor,
        point: Sequence[int],
        eval_: Optional[int],
        transcript: Keccak256Transcript,
    ) -> None:
        with timed.scope("kzg_quotient_polys"):
            quotients, _ = MultilinearKzg.quotient_polys(evals, point)
        with timed.scope("kzg_quotient_msms"):
            comms = ec.msm_list_to_affine_int([(pp.eqs[i], q) for i, q in quotients])
        transcript.write_commitments(comms)

    @staticmethod
    def verify(
        vp: KzgVerifierParams,
        comm: Tuple[int, int],
        point: Sequence[int],
        eval_: int,
        transcript: Keccak256Transcript,
    ) -> None:
        k = len(point)
        quotients = transcript.read_commitments(k)
        p = Fr.modulus
        # lhs_0 = comm - eval * g1
        lhs0 = hostec._add(
            None if comm == (0, 0) else comm,
            hostec._neg(hostec.g1_mul_host(vp.g1, eval_ % p)) if eval_ % p else None,
        )
        # rhs_0 = -g2 ; rhs_i = (s_i - x_i) * g2
        neg_g2 = (vp.g2[0], tuple((-c) % hostec.P for c in vp.g2[1]))
        terms = [(lhs0, neg_g2)]
        for i in range(k):
            x_g2 = hostec.g2_mul(vp.g2, point[i] % p) if point[i] % p else None
            q = quotients[i]
            terms.append((None if q == (0, 0) else q, _g2_sub(vp.ss[i], x_g2)))
        if not hostec.multi_pairing_is_one(
            [(t0, t1) for t0, t1 in terms if t0 is not None and t1 is not None]
        ):
            raise PcsError("invalid multilinear KZG open")

    @staticmethod
    def batch_open(pp, polys, comms, points, evals: Sequence[Evaluation], transcript):
        num_vars = len(points[0]) if points else pp.num_vars
        additive_batch_open(MultilinearKzg, pp, num_vars, polys, points, evals, transcript)

    @staticmethod
    def batch_verify(vp, comms, points, evals: Sequence[Evaluation], transcript):
        num_vars = len(points[0]) if points else vp.num_vars
        additive_batch_verify(MultilinearKzg, vp, num_vars, comms, points, evals, transcript)


def _g2_sub(a, b):
    """a - b for host G2 affine points in Fq2-coeff-tuple form (None = id)."""
    pa = None if a is None else (hostec.fq2(*a[0]), hostec.fq2(*a[1]))
    pb = None if b is None else (hostec.fq2(*b[0]), hostec.fq2(*b[1]))
    out = hostec._add(pa, hostec._neg(pb) if pb is not None else None)
    if out is None:
        return None
    return (tuple(out[0].coeffs), tuple(out[1].coeffs))
