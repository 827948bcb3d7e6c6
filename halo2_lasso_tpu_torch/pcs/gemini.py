"""Gemini: a multilinear PCS from univariate KZG by the fold-chain
reduction (the port of halo2_lasso_tpu/pcs/gemini.py; pcs/multilinear/
gemini.rs, section 2.4.2 of eprint 2022/420).

The MLE's evaluations are committed as univariate coefficients. An open
commits the fold chain f_1 .. f_{k-1} (f_i binds the lowest variable of
f_{i-1} to x_{i-1}: one K5 launch each, every f_i kept), evaluates f_0 at
beta and -beta and f_i at -beta^(2^i), and batch-opens them with the fflonk
machinery of the univariate KZG; the verifier folds the negative-point
evaluations back to f_0(beta).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.pcs import Evaluation, PointCommitmentIO, additive_batch_open, additive_batch_verify
from halo2_lasso_tpu_torch.pcs.univariate_kzg import UnivariateKzg
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.poly import univariate as uni

P = Fr.modulus


def _pairs(num_vars: int):
    """(poly, point) of the evaluations: f_0 at beta and -beta, f_i at
    -beta^(2^i)."""
    return [(0, 0), (0, 1)] + [(i, i + 1) for i in range(1, num_vars)]


class Gemini(PointCommitmentIO):
    setup = staticmethod(UnivariateKzg.setup)
    trim = staticmethod(UnivariateKzg.trim)
    from_jax_params = staticmethod(UnivariateKzg.from_jax_params)

    @staticmethod
    def commit(pp, evals: torch.Tensor) -> Tuple[int, int]:
        return UnivariateKzg.commit(pp, evals)

    @staticmethod
    def batch_commit(pp, polys) -> List[Tuple[int, int]]:
        return UnivariateKzg.batch_commit(pp, polys)

    @staticmethod
    def open(pp, evals: torch.Tensor, point: Sequence[int], eval_, transcript) -> None:
        num_vars = len(point)
        fs = [evals]
        for i in range(num_vars - 1):
            fs.append(mle.fix_var_chain(Fr, fs[-1], [point[i]], last=False)[0])
        transcript.write_commitments(UnivariateKzg.batch_commit(pp, fs[1:]))

        beta = transcript.squeeze_challenge()
        points = [beta]
        sq = beta
        for _ in range(num_vars):
            points.append((-sq) % P)
            sq = sq * sq % P

        pairs = _pairs(num_vars)
        values = Fr.decode_ints(torch.stack([uni.evaluate(Fr, fs[idx], points[pt]) for idx, pt in pairs]))
        evs = [Evaluation(idx, pt, v) for (idx, pt), v in zip(pairs, values)]
        transcript.write_field_elements(values[1:])
        UnivariateKzg.batch_open(pp, fs, points, evs, transcript)

    @staticmethod
    def verify(vp, comm, point: Sequence[int], eval_: int, transcript) -> None:
        num_vars = len(point)
        comms = [comm] + transcript.read_commitments(num_vars - 1)

        beta = transcript.squeeze_challenge()
        squares_of_beta = []
        sq = beta
        for _ in range(num_vars):
            squares_of_beta.append(sq)
            sq = sq * sq % P

        evals = transcript.read_field_elements(num_vars)

        # fold the negative-point evaluations back to f_0(beta)
        # (gemini.rs:184-190)
        eval_pos = eval_ % P
        for eval_neg, sob, x_i in reversed(list(zip(evals, squares_of_beta, point))):
            denom = ((1 - x_i) * sob + x_i) % P
            eval_pos = ((2 * sob * eval_pos - ((1 - x_i) * sob - x_i) * eval_neg) * pow(denom, -1, P)) % P

        evs = [Evaluation(idx, pt, v) for (idx, pt), v in zip(_pairs(num_vars), [eval_pos] + evals)]
        points = [beta] + [(-s) % P for s in squares_of_beta]
        UnivariateKzg.batch_verify(vp, comms, points, evs, transcript)

    # ---- additive batch (BDFG over sumcheck) ----

    @staticmethod
    def batch_open(pp, polys, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive_batch_open(Gemini, pp, num_vars, polys, points, evals, transcript)

    @staticmethod
    def batch_verify(vp, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive_batch_verify(Gemini, vp, num_vars, comms, points, evals, transcript)
