"""HyperPlonk backend over multilinear KZG: setup / preprocess / prove /
verify (the port of halo2_lasso_tpu/backend/hyperplonk/__init__.py;
plonkish_backend/src/backend/hyperplonk.rs:85-369 semantics).

Witness tables, lookup and permutation polys, the zero check and the MSMs
run on the device that holds the prover parameters (``setup`` defaults to
``device="cuda"``); Fiat-Shamir, the verifier and the pairings run on the
host. The stage scopes of ``utils/timer.py`` carry the JAX package's names.
Circuits with Lasso lookups are not ported yet: every entry point refuses
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.backend import PlonkishCircuit, PlonkishCircuitInfo
from halo2_lasso_tpu_torch.backend.hyperplonk import preprocessor, prover, verifier
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, from_foreign
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg, from_jax_kzg_params
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript
from halo2_lasso_tpu_torch.utils.timer import timed


def new_transcript(proof: Optional[bytes] = None) -> Keccak256Transcript:
    return Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)


def _refuse_lasso(lasso_lookups) -> None:
    if lasso_lookups:
        raise Halo2LassoError(
            "HyperPlonk with Lasso lookups is not ported yet; only logup lookups are"
        )


@dataclasses.dataclass
class HyperPlonkProverParam:
    pcs: Any
    num_instances: List[int]
    num_witness_polys: List[int]
    num_challenges: List[int]
    lookups: list
    num_permutation_z_polys: int
    num_vars: int
    expression: Expression
    preprocess_polys: List[torch.Tensor]
    preprocess_comms: List[Any]
    permutation_polys: List[Tuple[int, torch.Tensor]]
    permutation_comms: List[Any]


@dataclasses.dataclass
class HyperPlonkVerifierParam:
    pcs: Any
    num_instances: List[int]
    num_witness_polys: List[int]
    num_challenges: List[int]
    num_lookups: int
    num_permutation_z_polys: int
    num_vars: int
    expression: Expression
    preprocess_comms: List[Any]
    permutation_comms: List[Tuple[int, Any]]


def from_jax_hyperplonk_params(jpp, jvp, device="cuda") -> Tuple[HyperPlonkProverParam, HyperPlonkVerifierParam]:
    """The JAX package's HyperPlonkProverParam / HyperPlonkVerifierParam
    (limb arrays convertible to numpy, Python ints, its Expression trees)
    -> the port's, with the preprocessed polys on `device`."""
    _refuse_lasso(jpp.lasso_lookups or jvp.lasso_lookups)

    def poly(a):
        return F.from_jax_limbs(np.asarray(a), device)

    pp = HyperPlonkProverParam(
        pcs=from_jax_kzg_params(jpp.pcs, device),
        num_instances=list(jpp.num_instances),
        num_witness_polys=list(jpp.num_witness_polys),
        num_challenges=list(jpp.num_challenges),
        lookups=[[(from_foreign(i), from_foreign(t)) for i, t in lk] for lk in jpp.lookups],
        num_permutation_z_polys=jpp.num_permutation_z_polys,
        num_vars=jpp.num_vars,
        expression=from_foreign(jpp.expression),
        preprocess_polys=[poly(a) for a in jpp.preprocess_polys],
        preprocess_comms=list(jpp.preprocess_comms),
        permutation_polys=[(i, poly(a)) for i, a in jpp.permutation_polys],
        permutation_comms=list(jpp.permutation_comms),
    )
    vp = HyperPlonkVerifierParam(
        pcs=from_jax_kzg_params(jvp.pcs, device),
        num_instances=list(jvp.num_instances),
        num_witness_polys=list(jvp.num_witness_polys),
        num_challenges=list(jvp.num_challenges),
        num_lookups=jvp.num_lookups,
        num_permutation_z_polys=jvp.num_permutation_z_polys,
        num_vars=jvp.num_vars,
        expression=from_foreign(jvp.expression),
        preprocess_comms=list(jvp.preprocess_comms),
        permutation_comms=list(jvp.permutation_comms),
    )
    return pp, vp


class HyperPlonk:
    Pcs = MultilinearKzg
    field = Fr

    @classmethod
    def setup(cls, circuit_info: PlonkishCircuitInfo, rng: np.random.RandomState, device="cuda"):
        assert circuit_info.is_well_formed()
        _refuse_lasso(circuit_info.lasso_lookups)
        return cls.Pcs.setup(1 << circuit_info.k, rng=rng, device=device)

    @classmethod
    @timed("preprocess")
    def preprocess(cls, param, circuit_info: PlonkishCircuitInfo) -> Tuple[HyperPlonkProverParam, HyperPlonkVerifierParam]:
        """Commit the preprocessed and permutation polys on the device of
        `param` and compose the zero-check expression."""
        assert circuit_info.is_well_formed()
        _refuse_lasso(circuit_info.lasso_lookups)
        num_vars = circuit_info.k
        spec = cls.field
        pcs_pp, pcs_vp = cls.Pcs.trim(param, 1 << num_vars)
        device = param.eqs[0]["x"].device

        preprocess_polys = [spec.encode(vals, device) for vals in circuit_info.preprocess_polys]
        preprocess_comms = cls.Pcs.batch_commit(pcs_pp, preprocess_polys)

        perm_poly_indices = circuit_info.permutation_polys()
        perm_values = preprocessor.permutation_polys_values(
            num_vars, perm_poly_indices, circuit_info.permutations
        )
        permutation_polys = [prover.encode_small(spec, v, device) for v in perm_values]
        permutation_comms = cls.Pcs.batch_commit(pcs_pp, permutation_polys)

        num_permutation_z_polys, expression = preprocessor.compose(circuit_info)

        pp = HyperPlonkProverParam(
            pcs=pcs_pp,
            num_instances=list(circuit_info.num_instances),
            num_witness_polys=list(circuit_info.num_witness_polys),
            num_challenges=list(circuit_info.num_challenges),
            lookups=list(circuit_info.lookups),
            num_permutation_z_polys=num_permutation_z_polys,
            num_vars=num_vars,
            expression=expression,
            preprocess_polys=preprocess_polys,
            preprocess_comms=preprocess_comms,
            permutation_polys=list(zip(perm_poly_indices, permutation_polys)),
            permutation_comms=permutation_comms,
        )
        vp = HyperPlonkVerifierParam(
            pcs=pcs_vp,
            num_instances=list(circuit_info.num_instances),
            num_witness_polys=list(circuit_info.num_witness_polys),
            num_challenges=list(circuit_info.num_challenges),
            num_lookups=len(circuit_info.lookups),
            num_permutation_z_polys=num_permutation_z_polys,
            num_vars=num_vars,
            expression=expression,
            preprocess_comms=list(preprocess_comms),
            permutation_comms=list(zip(perm_poly_indices, permutation_comms)),
        )
        return pp, vp

    @classmethod
    @timed("prove")
    def prove(cls, pp: HyperPlonkProverParam, circuit: PlonkishCircuit, transcript: Keccak256Transcript) -> None:
        spec = cls.field
        p = spec.modulus
        num_vars = pp.num_vars
        device = pp.pcs.eqs[0]["x"].device

        instances = circuit.instances()
        for num, inst in zip(pp.num_instances, instances):
            assert len(inst) == num
            for v in inst:
                transcript.common_field_element(v)
        instance_polys = [
            spec.encode(prover.instance_poly_values(num_vars, inst, spec), device)
            for inst in instances
        ]

        # Round 0..n: witness phases
        witness_polys: List[torch.Tensor] = []
        witness_comms: List[Any] = []
        challenges: List[int] = []
        for round_, (num_w, num_c) in enumerate(zip(pp.num_witness_polys, pp.num_challenges)):
            with timed.scope(f"witness_collector-{round_}"):
                cols = circuit.synthesize(round_, challenges)
                assert len(cols) == num_w
                polys_r = [spec.encode(c, device) for c in cols]
            comms = cls.Pcs.batch_commit(pp.pcs, polys_r)
            cls.Pcs.write_commitments(comms, transcript)
            witness_comms.extend(comms)
            witness_polys.extend(polys_r)
            challenges.extend(transcript.squeeze_challenges(num_c))

        polys = instance_polys + pp.preprocess_polys + witness_polys

        # Round n: beta, lookup m polys
        beta = transcript.squeeze_challenge()
        with timed.scope("lookup_compressed_polys"):
            max_width = max((len(lk) for lk in pp.lookups), default=0)
            betas = [pow(beta, i, p) for i in range(max_width)]
            compressed = prover.lookup_compressed_polys(pp.lookups, polys, challenges, betas, spec=spec)
        with timed.scope("lookup_m_polys"):
            m_polys = prover.lookup_m_polys(compressed, spec=spec)
        m_comms = cls.Pcs.batch_commit(pp.pcs, m_polys)
        cls.Pcs.write_commitments(m_comms, transcript)

        # Round n+1: gamma, h polys + permutation z polys
        gamma = transcript.squeeze_challenge()
        with timed.scope("lookup_h_polys"):
            h_polys = prover.lookup_h_polys(compressed, m_polys, gamma, spec=spec)
        with timed.scope("permutation_z_polys"):
            z_polys = prover.permutation_z_polys(
                pp.num_permutation_z_polys, pp.permutation_polys, polys, beta, gamma, spec=spec
            )
        hz_polys = h_polys + z_polys
        hz_comms = cls.Pcs.batch_commit(pp.pcs, hz_polys)
        cls.Pcs.write_commitments(hz_comms, transcript)

        # Round n+2: zero check
        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(num_vars)

        all_polys = polys + [poly for _, poly in pp.permutation_polys] + m_polys + hz_polys
        all_comms = (
            [None] * len(pp.num_instances)  # instance polys are never opened
            + list(pp.preprocess_comms)
            + witness_comms
            + list(pp.permutation_comms)
            + m_comms
            + hz_comms
        )
        challenges = challenges + [beta, gamma, alpha]
        with timed.scope("zero_check"):
            points, evals = prover.prove_zero_check(
                len(pp.num_instances), pp.expression, all_polys, challenges, y, transcript, spec=spec
            )

        with timed.scope("pcs_batch_open"):
            cls.Pcs.batch_open(pp.pcs, all_polys, all_comms, points, evals, transcript)

    @classmethod
    @timed("verify")
    def verify(cls, vp: HyperPlonkVerifierParam, instances: Sequence[Sequence[int]], transcript: Keccak256Transcript) -> None:
        num_vars = vp.num_vars
        for num, inst in zip(vp.num_instances, instances):
            assert len(inst) == num
            for v in inst:
                transcript.common_field_element(v)

        witness_comms: List[Any] = []
        challenges: List[int] = []
        for num_w, num_c in zip(vp.num_witness_polys, vp.num_challenges):
            witness_comms.extend(cls.Pcs.read_commitments(vp.pcs, num_w, transcript))
            challenges.extend(transcript.squeeze_challenges(num_c))

        beta = transcript.squeeze_challenge()
        m_comms = cls.Pcs.read_commitments(vp.pcs, vp.num_lookups, transcript)
        gamma = transcript.squeeze_challenge()
        hz_comms = cls.Pcs.read_commitments(vp.pcs, vp.num_lookups + vp.num_permutation_z_polys, transcript)
        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(num_vars)

        challenges = challenges + [beta, gamma, alpha]
        points, evals = verifier.verify_zero_check(
            num_vars, vp.expression, instances, challenges, y, transcript, spec=cls.field
        )
        comms = (
            [None] * len(vp.num_instances)  # never opened (pcs_query excludes them)
            + list(vp.preprocess_comms)
            + witness_comms
            + [c for _, c in vp.permutation_comms]
            + m_comms
            + hz_comms
        )
        cls.Pcs.batch_verify(vp.pcs, comms, points, evals, transcript)
