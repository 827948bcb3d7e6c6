"""Multilinear Hyrax: a matrix commitment over the IPA (the port of
halo2_lasso_tpu/pcs/hyrax.py; pcs/multilinear/hyrax.rs), over BN254 G1
(``MultilinearHyrax``) or grumpkin with polynomials over BN254 Fq
(``MultilinearHyraxGrumpkin``, hyperplonk.rs:423).

The 2^k evaluations are a (num_chunks x row_len) matrix; the commitment is
one MSM a row, all of a batch's rows in one ``msm_list_to_affine_int``. An
open binds the high variables (one K5 chain, highest first) and IPA-opens
the folded row at the low sub-point; the verifier combines the row
commitments with eq(hi) before the IPA verify, and the additive batch
verify combines commitments row by row (``sum_commitments``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.pcs import additive_batch_open, additive_batch_verify
from halo2_lasso_tpu_torch.pcs.ipa import IpaParams, MultilinearIpa, MultilinearIpaGrumpkin
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import PcsError
from halo2_lasso_tpu_torch.poly import multilinear as mle


@dataclasses.dataclass
class HyraxParams:
    num_vars: int
    batch_num_vars: int
    row_num_vars: int
    ipa: IpaParams

    @property
    def row_len(self):
        return 1 << self.row_num_vars

    @property
    def num_chunks(self):
        return 1 << max(self.num_vars - self.row_num_vars, 0)

    @property
    def device(self):
        return self.ipa.device


def _sizes(poly_size: int, batch_size: int):
    num_vars = poly_size.bit_length() - 1
    batch_num_vars = (poly_size * batch_size - 1).bit_length() if batch_size > 1 else num_vars
    return num_vars, batch_num_vars, -(-batch_num_vars // 2)


class MultilinearHyrax:
    IPA = MultilinearIpa
    CURVE = curves.BN254_G1
    FIELD = Fr

    @classmethod
    def setup(cls, poly_size: int, batch_size: int = 1, rng=None, device="cuda") -> HyraxParams:
        num_vars, batch_num_vars, row_num_vars = _sizes(poly_size, batch_size)
        ipa = cls.IPA.setup(1 << row_num_vars, device=device)
        return HyraxParams(num_vars=num_vars, batch_num_vars=batch_num_vars, row_num_vars=row_num_vars, ipa=ipa)

    @classmethod
    def from_jax_params(cls, params, device="cuda") -> HyraxParams:
        """The JAX package's HyraxParams (its sizes and its IPA params) ->
        the port's."""
        return HyraxParams(params.num_vars, params.batch_num_vars, params.row_num_vars,
                           cls.IPA.from_jax_params(params.ipa, device))

    @classmethod
    def trim(cls, param: HyraxParams, poly_size: int, batch_size: int = 1):
        num_vars, batch_num_vars, row_num_vars = _sizes(poly_size, batch_size)
        if param.row_num_vars < row_num_vars:
            raise PcsError("too many variates to trim")
        ipa, _ = cls.IPA.trim(param.ipa, 1 << row_num_vars)
        p = HyraxParams(num_vars=num_vars, batch_num_vars=batch_num_vars, row_num_vars=row_num_vars, ipa=ipa)
        return p, p

    @classmethod
    def batch_commit(cls, pp: HyraxParams, polys) -> List[List[Tuple[int, int]]]:
        """One MSM a row of every poly, one read of the card for them all."""
        jobs, rows = [], []
        for evals in polys:
            n = evals.shape[0]
            row_len = min(pp.row_len, n)
            g = {k: v[:row_len] for k, v in pp.ipa.g.items()}
            rows.append(n // row_len)
            jobs += [(g, evals[r * row_len : (r + 1) * row_len]) for r in range(n // row_len)]
        flat = ec.msm_list_to_affine_int(jobs, cls.CURVE.base, cls.FIELD)
        out, at = [], 0
        for m in rows:
            out.append(flat[at : at + m])
            at += m
        return out

    @classmethod
    def commit(cls, pp: HyraxParams, evals: torch.Tensor) -> List[Tuple[int, int]]:
        return cls.batch_commit(pp, [evals])[0]

    @staticmethod
    def write_commitments(comms: Sequence[List[Tuple[int, int]]], transcript) -> None:
        for comm in comms:
            transcript.write_commitments(comm)

    @staticmethod
    def read_commitments(vp: HyraxParams, n: int, transcript) -> List[List[Tuple[int, int]]]:
        return [transcript.read_commitments(vp.num_chunks) for _ in range(n)]

    @staticmethod
    def verifier_commitment(comm):
        return comm

    @classmethod
    def sum_commitments(cls, scalars: Sequence[int], comms: Sequence[List[Tuple[int, int]]]):
        """Row-wise additive combination (a vector commitment)."""
        return [cls.IPA.sum_commitments(scalars, [c[i] for c in comms]) for i in range(len(comms[0]))]

    @classmethod
    def open(cls, pp: HyraxParams, evals: torch.Tensor, point: Sequence[int], eval_, transcript) -> None:
        row_nv = min(pp.row_num_vars, len(point))
        lo, hi = list(point[:row_nv]), list(point[row_nv:])
        folded = mle.fix_var_chain(cls.FIELD, evals, hi, last=True)[0] if hi else evals
        cls.IPA.open(pp.ipa, folded, lo, eval_, transcript)

    @classmethod
    def verify(cls, vp: HyraxParams, comm: List[Tuple[int, int]], point: Sequence[int], eval_: int,
               transcript) -> None:
        S = cls.FIELD
        row_nv = min(vp.row_num_vars, len(point))
        lo, hi = list(point[:row_nv]), list(point[row_nv:])
        if hi:
            folded_comm = cls.IPA.sum_commitments(S.decode_ints(mle.eq_xy(S, hi, vp.device)), comm)
        else:
            if len(comm) != 1:
                raise PcsError("a Hyrax commitment of one row expected")
            folded_comm = comm[0]
        cls.IPA.verify(vp.ipa, folded_comm, lo, eval_, transcript)

    @classmethod
    def batch_open(cls, pp, polys, comms, points, evals, transcript):
        additive_batch_open(cls, pp, pp.num_vars, polys, points, evals, transcript)

    @classmethod
    def batch_verify(cls, vp, comms, points, evals, transcript):
        additive_batch_verify(cls, vp, vp.num_vars, comms, points, evals, transcript)


class MultilinearHyraxGrumpkin(MultilinearHyrax):
    """Hyrax over grumpkin, polynomials over BN254 Fq (the port of
    halo2_lasso_tpu/pcs/hyrax.py:167; hyperplonk.rs:423)."""

    IPA = MultilinearIpaGrumpkin
    CURVE = curves.GRUMPKIN
    FIELD = Fq
