"""Zeromorph: multilinear-to-univariate KZG by degree-offset quotients (the
port of halo2_lasso_tpu/pcs/zeromorph.py; pcs/multilinear/zeromorph.rs).

The MLE's evaluations are committed as univariate coefficients. An open
commits the k multilinear quotients (the KZG quotient chain, one K5
launch), batches them into q_hat with powers of y at degree offsets,
commits it, and proves that the combined polynomial vanishes at x with the
degree-shifted SRS; verify is a 2-pairing check against s^offset G2
(zeromorph.rs:242-248). The q_hat and f updates are products added into
row slices (``a * b + c``), each written back after it is computed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import pairing as hostec
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.pcs import PointCommitmentIO, additive_batch_open, additive_batch_verify, g1_sum_with_scalar
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg, PcsError, _g2_sub
from halo2_lasso_tpu_torch.pcs.univariate_kzg import UniKzgProverParams, UnivariateKzg

P = Fr.modulus


class ZeromorphProverParams:
    def __init__(self, commit_pp: UniKzgProverParams, open_pp: UniKzgProverParams):
        self.commit_pp = commit_pp
        self.open_pp = open_pp

    @property
    def device(self):
        return self.commit_pp.device


class ZeromorphVerifierParams:
    def __init__(self, vp, s_offset_g2):
        self.vp = vp
        self.s_offset_g2 = s_offset_g2


class Zeromorph(PointCommitmentIO):
    setup = staticmethod(UnivariateKzg.setup)

    @staticmethod
    def trim(param, poly_size: int):
        commit_pp, vp = UnivariateKzg.trim(param, poly_size)
        offset = param.powers_g1["x"].shape[0] - poly_size
        open_pp = UniKzgProverParams(powers_g1={k: v[offset:] for k, v in param.powers_g1.items()})
        s_offset_g2 = param.s_g2_offsets.get(offset)
        if s_offset_g2 is None:
            raise PcsError("setup lacks s^offset G2 for this trim size")
        return ZeromorphProverParams(commit_pp, open_pp), ZeromorphVerifierParams(vp, s_offset_g2)

    @staticmethod
    def from_jax_params(params, device="cuda"):
        """The JAX package's UniKzgParams or Zeromorph prover / verifier
        params (its commit and open halves) -> the port's."""
        name = type(params).__name__
        if name == "ZeromorphProverParams":
            return ZeromorphProverParams(UnivariateKzg.from_jax_params(params.commit_pp, device),
                                         UnivariateKzg.from_jax_params(params.open_pp, device))
        if name == "ZeromorphVerifierParams":
            return ZeromorphVerifierParams(UnivariateKzg.from_jax_params(params.vp, device), params.s_offset_g2)
        return UnivariateKzg.from_jax_params(params, device)

    @staticmethod
    def commit(pp: ZeromorphProverParams, evals: torch.Tensor) -> Tuple[int, int]:
        return UnivariateKzg.commit(pp.commit_pp, evals)

    @staticmethod
    def batch_commit(pp, polys) -> List[Tuple[int, int]]:
        return UnivariateKzg.batch_commit(pp.commit_pp, polys)

    @staticmethod
    def open(pp: ZeromorphProverParams, evals, point, eval_, transcript) -> None:
        num_vars = len(point)
        quotients, rem = MultilinearKzg.quotient_polys(evals, point)
        transcript.write_commitments(UnivariateKzg.batch_commit(pp.commit_pp, [q for _, q in quotients]))
        if eval_ is None:
            eval_ = Fr.decode_ints(rem)[0]

        y = transcript.squeeze_challenge()

        # q_hat = sum_i y^i X^(2^n - 2^i) q_i (degree-offset batching)
        n = 1 << num_vars
        q_hat = Fr.zeros(n, evals.device)
        py = 1
        for nv_i, q in quotients:
            offset = n - (1 << nv_i)
            q_hat[offset:] = F.mul_add(Fr, q, py, q_hat[offset:])
            py = py * y % P
        transcript.write_commitment(UnivariateKzg.commit(pp.commit_pp, q_hat))

        x = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()
        eval_scalar, q_scalars = _eval_and_quotient_scalars(y, x, z, list(point))

        f = F.mul_add(Fr, evals, z, q_hat)
        f[:1] = F.add(Fr, f[:1], eval_scalar * eval_ % P)
        for (nv_i, q), sc in zip(quotients, q_scalars):
            f[: 1 << nv_i] = F.mul_add(Fr, q, sc, f[: 1 << nv_i])
        UnivariateKzg.open(pp.open_pp, f, x, 0, transcript)

    @staticmethod
    def verify(vp: ZeromorphVerifierParams, comm, point, eval_, transcript) -> None:
        num_vars = len(point)
        q_comms = transcript.read_commitments(num_vars)
        y = transcript.squeeze_challenge()
        q_hat_comm = transcript.read_commitment()
        x = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()

        eval_scalar, q_scalars = _eval_and_quotient_scalars(y, x, z, list(point))
        scalars = [1, z, eval_scalar * eval_ % P] + q_scalars
        bases = [q_hat_comm, comm, vp.vp.g1] + q_comms
        c = g1_sum_with_scalar(scalars, bases)

        pi = transcript.read_commitment()
        # e(c, -s^offset g2) * e(pi, s g2 - x g2) == 1
        neg_off = (vp.s_offset_g2[0], tuple((-v) % hostec.P for v in vp.s_offset_g2[1]))
        x_g2 = hostec.g2_mul(vp.vp.g2, x % P) if x % P else None
        terms = [] if c == (0, 0) else [(c, neg_off)]
        terms.append((pi, _g2_sub(vp.vp.s_g2, x_g2)))
        if not hostec.multi_pairing_is_one(terms):
            raise PcsError("invalid Zeromorph KZG open")

    @staticmethod
    def batch_open(pp, polys, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive_batch_open(Zeromorph, pp, num_vars, polys, points, evals, transcript)

    @staticmethod
    def batch_verify(vp, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive_batch_verify(Zeromorph, vp, num_vars, comms, points, evals, transcript)


def _eval_and_quotient_scalars(y: int, x: int, z: int, u: Sequence[int]):
    """zeromorph.rs:263-299 (host ints)."""
    num_vars = len(u)
    squares_of_x = []
    sq = x
    for _ in range(num_vars + 1):
        squares_of_x.append(sq)
        sq = sq * sq % P
    # offsets[i] = prod_{j >= i} x^(2^j) for j < num_vars: a reverse scan
    offsets = []
    state = 1
    for pw in reversed(squares_of_x[:num_vars]):
        state = state * pw % P
        offsets.append(state)
    offsets.reverse()
    v_numer = (squares_of_x[num_vars] - 1) % P
    vs = [v_numer * pow((s - 1) % P, -1, P) % P for s in squares_of_x]
    q_scalars = []
    py = 1
    for i in range(num_vars):
        q_scalars.append((-(py * offsets[i] + z * (squares_of_x[i] * vs[i + 1] - u[i] * vs[i]))) % P)
        py = py * y % P
    return (-vs[0] * z) % P, q_scalars
