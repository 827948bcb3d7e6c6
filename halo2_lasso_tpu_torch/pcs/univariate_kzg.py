"""Univariate KZG with fflonk-style multi-point batch opening (the port of
halo2_lasso_tpu/pcs/univariate_kzg.py; pcs/univariate/kzg.rs semantics).

  * setup: s from the caller's RandomState, drawn as the JAX package draws
    it, so one seed gives one SRS in both packages; powers s^i G1 by the
    fixed-base MSM on the device; s G2 and the s^offset G2 that
    Zeromorph's degree-shifted opens need, on the host;
  * commit = MSM(coeffs, powers); open at z commits (f - f(z)) / (X - z);
  * verify: e(pi z + C - eval G1, -G2) e(pi, s G2) == 1 (kzg.rs:366-378);
  * batch open groups the evaluations into same-point-set ``_eval_sets``
    (kzg.rs:454-512), combines each set with powers of beta and the sets
    with powers of gamma, commits the combined quotient and opens the
    normalised combination at a fresh z (kzg.rs:301-354).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import pairing as hostec
from halo2_lasso_tpu_torch.ops.bn254 import G1_GEN, G2_GEN_X, G2_GEN_Y, Fr
from halo2_lasso_tpu_torch.pcs import Evaluation, g1_sum_with_scalar
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import PcsError
from halo2_lasso_tpu_torch.piop.sum_check import barycentric_interpolate, barycentric_weights
from halo2_lasso_tpu_torch.poly import univariate as uni

G2_GEN = (G2_GEN_X, G2_GEN_Y)
P = Fr.modulus


@dataclasses.dataclass
class UniKzgParams:
    powers_g1: dict  # device Jacobian point batch (n,)
    g2: Tuple
    s_g2: Tuple
    # s^(n - 2^j) G2 for each power-of-two trim size 2^j <= n, keyed by the
    # offset n - 2^j (Zeromorph's degree-shifted opens)
    s_g2_offsets: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self):
        return self.powers_g1["x"].device


@dataclasses.dataclass
class UniKzgProverParams:
    powers_g1: dict

    @property
    def device(self):
        return self.powers_g1["x"].device


@dataclasses.dataclass
class UniKzgVerifierParams:
    g1: Tuple[int, int]
    g2: Tuple
    s_g2: Tuple


def _points(d, device):
    return {k: F.from_jax_limbs(np.asarray(d[k]), device) for k in ec.COORDS}


def _scaled_sum(spec, terms) -> torch.Tensor:
    """sum_i c_i * poly_i over (host int, (n_i, 8) tensor) pairs, the
    shorter polys padded with zeros: one product launch a term."""
    acc = None
    for c, poly in terms:
        if acc is None:
            acc = F.mont_mul(spec, poly, c)
        elif acc.shape == poly.shape:
            acc = F.mul_add(spec, poly, c, acc)
        else:
            acc = uni.add_padded(spec, acc, F.mont_mul(spec, poly, c))
    return acc


class UnivariateKzg:
    @staticmethod
    def setup(poly_size: int, rng: np.random.RandomState, device="cuda") -> UniKzgParams:
        s = int.from_bytes(rng.bytes(40), "little") % P
        pts = ec.fixed_base_msm(G1_GEN, uni.powers_array(Fr, s, poly_size, device))
        s_g2_offsets = {0: G2_GEN}
        size = 1
        while size <= poly_size:
            off = poly_size - size
            s_g2_offsets[off] = hostec.g2_mul(G2_GEN, pow(s, off, P)) if off else G2_GEN
            size <<= 1
        return UniKzgParams(powers_g1=pts, g2=G2_GEN, s_g2=hostec.g2_mul(G2_GEN, s), s_g2_offsets=s_g2_offsets)

    @staticmethod
    def from_jax_params(params, device="cuda"):
        """The JAX package's UniKzgParams / UniKzgProverParams /
        UniKzgVerifierParams (numpy-convertible limbs, Python ints) -> the
        port's."""
        name = type(params).__name__
        if name == "UniKzgParams":
            return UniKzgParams(_points(params.powers_g1, device), params.g2, params.s_g2, dict(params.s_g2_offsets))
        if name == "UniKzgProverParams":
            return UniKzgProverParams(_points(params.powers_g1, device))
        if name == "UniKzgVerifierParams":
            return UniKzgVerifierParams(params.g1, params.g2, params.s_g2)
        raise TypeError(f"not a univariate KZG parameter set: {name}")

    @staticmethod
    def trim(param: UniKzgParams, poly_size: int):
        if param.powers_g1["x"].shape[0] < poly_size:
            raise PcsError("too large poly_size to trim")
        pp = UniKzgProverParams(powers_g1={k: v[:poly_size] for k, v in param.powers_g1.items()})
        return pp, UniKzgVerifierParams(g1=G1_GEN, g2=param.g2, s_g2=param.s_g2)

    @staticmethod
    def batch_commit(pp: UniKzgProverParams, polys: Sequence[torch.Tensor]) -> List[Tuple[int, int]]:
        """One MSM a poly against the first n powers, one read of the card
        for them all."""
        jobs = []
        for coeffs in polys:
            n = coeffs.shape[0]
            if n > pp.powers_g1["x"].shape[0]:
                raise PcsError("poly degree exceeds params")
            jobs.append(({k: v[:n] for k, v in pp.powers_g1.items()}, coeffs))
        return ec.msm_list_to_affine_int(jobs)

    @staticmethod
    def commit(pp: UniKzgProverParams, coeffs: torch.Tensor) -> Tuple[int, int]:
        return UnivariateKzg.batch_commit(pp, [coeffs])[0]

    @staticmethod
    def open(pp, coeffs: torch.Tensor, point: int, eval_, transcript) -> None:
        q, _ = uni.div_by_linear(Fr, coeffs, point)
        transcript.write_commitment(UnivariateKzg.commit(pp, q))

    @staticmethod
    def verify(vp, comm: Tuple[int, int], point: int, eval_: int, transcript) -> None:
        pi = transcript.read_commitment()
        # c = pi * z + comm - eval * g1
        c = hostec._mul(pi, point % P) if point % P else None
        if comm != (0, 0):
            c = hostec._add(c, comm)
        if eval_ % P:
            c = hostec._add(c, hostec._neg(hostec.g1_mul_host(vp.g1, eval_ % P)))
        neg_g2 = (vp.g2[0], tuple((-v) % hostec.P for v in vp.g2[1]))
        terms = [] if c is None else [(c, neg_g2)]
        terms.append((pi, vp.s_g2))
        if not hostec.multi_pairing_is_one(terms):
            raise PcsError("invalid univariate KZG open")

    # ---- fflonk-style batch ----

    @staticmethod
    def batch_open(pp, polys: Sequence[torch.Tensor], points: Sequence[int], evals: Sequence[Evaluation],
                   transcript) -> None:
        sets, superset = _eval_sets(evals)
        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()

        max_set_len = max(len(s["polys"]) for s in sets)
        pow_beta = [pow(beta, i, P) for i in range(max_set_len)]
        pow_gamma = [pow(gamma, i, P) for i in range(len(sets))]

        fs, qs = [], []
        for s in sets:
            f = _scaled_sum(Fr, [(pb, polys[i]) for pb, i in zip(pow_beta, s["polys"])])
            q, _ = uni.div_rem_by_vanishing(Fr, f, [points[i] for i in s["points"]])
            fs.append(f)
            qs.append(q)
        q_comb = _scaled_sum(Fr, list(zip(pow_gamma, qs)))

        transcript.write_commitment(UnivariateKzg.commit(pp, q_comb))
        z = transcript.squeeze_challenge()

        normalized_scalars, normalizer = _set_scalars(sets, pow_gamma, points, z)
        superset_eval = 1
        for i in superset:
            superset_eval = superset_eval * (z - points[i]) % P
        q_scalar = (-superset_eval * normalizer) % P
        f_comb = _scaled_sum(Fr, list(zip(normalized_scalars, fs)) + [(q_scalar, q_comb)])
        UnivariateKzg.open(pp, f_comb, z, 0, transcript)

    @staticmethod
    def batch_verify(vp, comms: Sequence[Tuple[int, int]], points: Sequence[int], evals: Sequence[Evaluation],
                     transcript) -> None:
        sets, superset = _eval_sets(evals)
        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        q_comm = transcript.read_commitment()
        z = transcript.squeeze_challenge()

        max_set_len = max(len(s["polys"]) for s in sets)
        pow_beta = [pow(beta, i, P) for i in range(max_set_len)]
        pow_gamma = [pow(gamma, i, P) for i in range(len(sets))]
        normalized_scalars, normalizer = _set_scalars(sets, pow_gamma, points, z)

        scalars = [0] * len(comms)
        for s, coeff in zip(sets, normalized_scalars):
            for poly_idx, pb in zip(s["polys"], pow_beta):
                scalars[poly_idx] = coeff * pb % P
        superset_eval = 1
        for i in superset:
            superset_eval = superset_eval * (z - points[i]) % P
        q_scalar = (-superset_eval * normalizer) % P
        f_comm = g1_sum_with_scalar(scalars + [q_scalar], list(comms) + [q_comm])

        eval_ = 0
        for s, ns in zip(sets, normalized_scalars):
            pts = [points[i] for i in s["points"]]
            ws = barycentric_weights(P, pts)
            r_evals = [barycentric_interpolate(P, ws, pts, row, z) for row in s["evals"]]
            r_eval = sum(pb * rv for pb, rv in zip(pow_beta, r_evals)) % P
            eval_ = (eval_ + ns * r_eval) % P
        UnivariateKzg.verify(vp, f_comm, z, eval_, transcript)


def _eval_sets(evals: Sequence[Evaluation]):
    """kzg.rs:454-512: group the polys by their point sets."""
    poly_shifts: List = []
    superset: List[int] = []
    for ev in evals:
        entry = next((e for e in poly_shifts if e[0] == ev.poly), None)
        if entry is None:
            poly_shifts.append((ev.poly, [ev.point], [ev.value]))
        elif ev.point not in entry[1]:
            entry[1].append(ev.point)
            entry[2].append(ev.value)
        if ev.point not in superset:
            superset.append(ev.point)
    superset = sorted(superset)

    sets: List[dict] = []
    for poly, pts, vals in poly_shifts:
        match = next((s for s in sets if set(s["points"]) == set(pts)), None)
        if match is not None:
            if poly not in match["polys"]:
                match["polys"].append(poly)
                match["evals"].append([vals[pts.index(lhs)] for lhs in match["points"]])
        else:
            diffs = [i for i in superset if i not in pts]
            sets.append({"polys": [poly], "points": pts, "diffs": diffs, "evals": [vals]})
    return sets, superset


def _set_scalars(sets, pow_gamma, points, z):
    """kzg.rs:514-539."""
    vdiff_evals = []
    for s in sets:
        acc = 1
        for i in s["diffs"]:
            acc = acc * (z - points[i]) % P
        vdiff_evals.append(acc)
    normalizer = pow(vdiff_evals[0], -1, P) if vdiff_evals[0] % P else 1
    normalized = [normalizer * v % P * pg % P for pg, v in zip(pow_gamma, vdiff_evals)]
    return normalized, normalizer
