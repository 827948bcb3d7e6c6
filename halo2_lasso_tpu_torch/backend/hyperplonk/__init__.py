"""HyperPlonk backend, generic over the polynomial commitment scheme: setup /
preprocess / prove / verify (the port of
halo2_lasso_tpu/backend/hyperplonk/__init__.py;
plonkish_backend/src/backend/hyperplonk.rs:85-369 semantics). ``HyperPlonk``
runs over multilinear KZG; ``hyperplonk(pcs_cls)`` instantiates it over
another PCS (Gemini, Zeromorph, MultilinearIpa, MultilinearHyrax,
MultilinearBrakedown over BN254, MultilinearIpaGrumpkin,
MultilinearHyraxGrumpkin over grumpkin), the
reference's ``HyperPlonk<Pcs>`` (hyperplonk.rs:398-427). The SNARK's field is
the PCS's ``FIELD``: BN254 Fr, or Fq for the grumpkin-backed PCS.

Witness tables, lookup and permutation polys, the zero check and the MSMs
run on the device that holds the prover parameters (``setup`` defaults to
``device="cuda"``); Fiat-Shamir, the verifier and the pairings run on the
host. The stage scopes of ``utils/timer.py`` carry the JAX package's names.
Lasso lookups (``lasso/integration.py``) commit their Surge columns after
the witness phases, join the zero check through ``compose``, and close with
a GKR memory check whose leaves are opened in the main batch open and, for
the table-sized ``final_cts``, in one batch open per subtable size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.backend import PlonkishCircuit, PlonkishCircuitInfo
from halo2_lasso_tpu_torch.backend.hyperplonk import preprocessor, prover, verifier
from halo2_lasso_tpu_torch.expression import Expression, from_foreign
from halo2_lasso_tpu_torch.lasso import integration as lasso_int
from halo2_lasso_tpu_torch.lasso import tables
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.ops import curves
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript
from halo2_lasso_tpu_torch.utils.timer import timed


def new_transcript(proof: Optional[bytes] = None) -> Keccak256Transcript:
    return Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)


def transcript_for(pcs_cls, proof: Optional[bytes] = None) -> Keccak256Transcript:
    """A transcript for a PCS's curve and field: challenges in its FIELD,
    points checked on its CURVE (BN254 G1 and Fr unless it says)."""
    curve = getattr(pcs_cls, "CURVE", curves.BN254_G1)
    field = getattr(pcs_cls, "FIELD", Fr)
    return Keccak256Transcript(field.modulus, base_modulus=curve.base.modulus, proof=proof, curve_b=curve.b)


def _max_num_vars(circuit_info_or_pp) -> int:
    """Largest num_vars the PCS must support: the circuit hypercube or the
    largest Lasso subtable, whichever is bigger."""
    nv = circuit_info_or_pp.k if hasattr(circuit_info_or_pp, "k") else circuit_info_or_pp.num_vars
    for lk in circuit_info_or_pp.lasso_lookups:
        for mem in lk.table.memories:
            nv = max(nv, mem.subtable.index_bits)
    return nv


def _table_from_foreign(t) -> tables.LassoTable:
    """Rebuild another package's Lasso table from the port's constructor of
    the same name and shape, and check that its collation g agrees."""
    kind = t.name.rsplit("_", 1)[0]
    if kind == "range":
        mine = tables.range_table(t.index_bits, t.chunk_bits)
    elif kind in ("and", "xor", "or", "lt"):
        mine = getattr(tables, f"{kind}_table")(t.index_bits // 2, t.chunk_bits)
    else:
        raise lasso_int.LassoIntegrationError(f"no port of Lasso table {t.name}")
    if (mine.name, mine.g.structural_key) != (t.name, from_foreign(t.g).structural_key):
        raise lasso_int.LassoIntegrationError(f"Lasso table {t.name} does not match the port's")
    return mine


def _lasso_from_foreign(lookups) -> List[lasso_int.LassoLookup]:
    return [
        lasso_int.LassoLookup(_table_from_foreign(lk.table), tuple(from_foreign(e) for e in lk.inputs), from_foreign(lk.output))
        for lk in lookups
    ]


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
    lasso_lookups: list = dataclasses.field(default_factory=list)


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
    lasso_lookups: list = dataclasses.field(default_factory=list)


def from_jax_hyperplonk_params(jpp, jvp, device="cuda", pcs=MultilinearKzg) -> Tuple[HyperPlonkProverParam, HyperPlonkVerifierParam]:
    """The JAX package's HyperPlonkProverParam / HyperPlonkVerifierParam
    (limb arrays convertible to numpy, Python ints, its Expression trees)
    -> the port's, with the preprocessed polys on `device` and the PCS
    params converted by the port's `pcs` class (``from_jax_params``), and
    its prover-side commitments by ``from_jax_commitment`` where the PCS
    keeps more than the verifier's form (Brakedown's codeword and tree).
    Each Lasso lookup's table is rebuilt by the port's constructor of the
    same name."""

    def poly(a):
        return F.from_jax_limbs(np.asarray(a), device)

    comm = getattr(pcs, "from_jax_commitment", lambda c: c)

    pp = HyperPlonkProverParam(
        pcs=pcs.from_jax_params(jpp.pcs, device),
        num_instances=list(jpp.num_instances),
        num_witness_polys=list(jpp.num_witness_polys),
        num_challenges=list(jpp.num_challenges),
        lookups=[[(from_foreign(i), from_foreign(t)) for i, t in lk] for lk in jpp.lookups],
        num_permutation_z_polys=jpp.num_permutation_z_polys,
        num_vars=jpp.num_vars,
        expression=from_foreign(jpp.expression),
        preprocess_polys=[poly(a) for a in jpp.preprocess_polys],
        preprocess_comms=[comm(c) for c in jpp.preprocess_comms],
        permutation_polys=[(i, poly(a)) for i, a in jpp.permutation_polys],
        permutation_comms=[comm(c) for c in jpp.permutation_comms],
        lasso_lookups=_lasso_from_foreign(jpp.lasso_lookups),
    )
    vp = HyperPlonkVerifierParam(
        pcs=pcs.from_jax_params(jvp.pcs, device),
        num_instances=list(jvp.num_instances),
        num_witness_polys=list(jvp.num_witness_polys),
        num_challenges=list(jvp.num_challenges),
        num_lookups=jvp.num_lookups,
        num_permutation_z_polys=jvp.num_permutation_z_polys,
        num_vars=jvp.num_vars,
        expression=from_foreign(jvp.expression),
        preprocess_comms=list(jvp.preprocess_comms),
        permutation_comms=list(jvp.permutation_comms),
        lasso_lookups=_lasso_from_foreign(jvp.lasso_lookups),
    )
    return pp, vp


class HyperPlonk:
    Pcs = MultilinearKzg
    field = Fr  # the PCS's polynomial field (``hyperplonk`` sets it)

    @classmethod
    def transcript(cls, proof: Optional[bytes] = None) -> Keccak256Transcript:
        return transcript_for(cls.Pcs, proof)

    @classmethod
    def setup(cls, circuit_info: PlonkishCircuitInfo, rng: np.random.RandomState, device="cuda"):
        assert circuit_info.is_well_formed()
        return cls.Pcs.setup(1 << _max_num_vars(circuit_info), rng=rng, device=device)

    @classmethod
    @timed("preprocess")
    def preprocess(cls, param, circuit_info: PlonkishCircuitInfo) -> Tuple[HyperPlonkProverParam, HyperPlonkVerifierParam]:
        """Commit the preprocessed and permutation polys on the device of
        `param` and compose the zero-check expression."""
        assert circuit_info.is_well_formed()
        num_vars = circuit_info.k
        spec = cls.field
        # the PCS params must also cover the Lasso final_cts polys, whose
        # subtables may be larger than the circuit's hypercube
        pcs_pp, pcs_vp = cls.Pcs.trim(param, 1 << _max_num_vars(circuit_info))
        device = param.device
        num_permutation_z_polys, expression = preprocessor.compose(circuit_info)

        preprocess_polys = [F.encode_dev(spec, vals, device) for vals in circuit_info.preprocess_polys]
        preprocess_comms = cls.Pcs.batch_commit(pcs_pp, preprocess_polys)

        perm_poly_indices = circuit_info.permutation_polys()
        perm_values = preprocessor.permutation_polys_values(
            num_vars, perm_poly_indices, circuit_info.permutations
        )
        permutation_polys = [F.encode_dev(spec, v, device) for v in perm_values]
        permutation_comms = cls.Pcs.batch_commit(pcs_pp, permutation_polys)

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
            lasso_lookups=list(circuit_info.lasso_lookups),
        )
        vc = cls.Pcs.verifier_commitment
        vp = HyperPlonkVerifierParam(
            pcs=pcs_vp,
            num_instances=list(circuit_info.num_instances),
            num_witness_polys=list(circuit_info.num_witness_polys),
            num_challenges=list(circuit_info.num_challenges),
            num_lookups=len(circuit_info.lookups),
            num_permutation_z_polys=num_permutation_z_polys,
            num_vars=num_vars,
            expression=expression,
            preprocess_comms=[vc(c) for c in preprocess_comms],
            permutation_comms=list(zip(perm_poly_indices, [vc(c) for c in permutation_comms])),
            lasso_lookups=list(circuit_info.lasso_lookups),
        )
        return pp, vp

    @classmethod
    @timed("prove")
    def prove(cls, pp: HyperPlonkProverParam, circuit: PlonkishCircuit, transcript: Keccak256Transcript) -> None:
        spec = cls.field
        p = spec.modulus
        num_vars = pp.num_vars
        device = pp.pcs.device

        instances = circuit.instances()
        for num, inst in zip(pp.num_instances, instances):
            assert len(inst) == num
            for v in inst:
                transcript.common_field_element(v)
        instance_polys = [
            F.encode_dev(spec, prover.instance_poly_values(num_vars, inst, spec), device)
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
                polys_r = [F.encode_dev(spec, c, device) for c in cols]
            comms = cls.Pcs.batch_commit(pp.pcs, polys_r)
            cls.Pcs.write_commitments(comms, transcript)
            witness_comms.extend(comms)
            witness_polys.extend(polys_r)
            challenges.extend(transcript.squeeze_challenges(num_c))

        # Lasso lookups: commit the Surge witness columns (dims, subtable
        # reads E, read timestamps), then the table-sized final counters; the
        # pointwise bindings are already inside pp.expression (compose)
        lasso_layouts = [lasso_int.LassoLayout(lk) for lk in pp.lasso_lookups]
        lasso_locals: List[List[torch.Tensor]] = []
        lasso_fcs: List[List[torch.Tensor]] = []
        lasso_comms: List[Any] = []
        if pp.lasso_lookups:
            base_polys = instance_polys + pp.preprocess_polys + witness_polys
            with timed.scope("lasso_witness"):
                for lk, layout in zip(pp.lasso_lookups, lasso_layouts):
                    loc, fcs = lasso_int.build_lookup_witness(spec, lk, layout, base_polys, challenges, num_vars)
                    lasso_locals.append(loc)
                    lasso_fcs.append(fcs)
            with timed.scope("lasso_commit"):
                lasso_comms = cls.Pcs.batch_commit(pp.pcs, [a for loc in lasso_locals for a in loc])
                fc_comms = cls.Pcs.batch_commit(pp.pcs, [a for fcs in lasso_fcs for a in fcs])
            cls.Pcs.write_commitments(lasso_comms, transcript)
            cls.Pcs.write_commitments(fc_comms, transcript)
        lasso_flat = [a for loc in lasso_locals for a in loc]

        polys = instance_polys + pp.preprocess_polys + witness_polys + lasso_flat

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
            + lasso_comms
            + list(pp.permutation_comms)
            + m_comms
            + hz_comms
        )
        challenges = challenges + [beta, gamma, alpha]
        with timed.scope("zero_check"):
            points, evals = prover.prove_zero_check(
                len(pp.num_instances), pp.expression, all_polys, challenges, y, transcript, spec=spec
            )

        # Lasso offline memory check: batched GKR grand products over the
        # read/write/init/final fingerprint multisets; the m-sized leaves
        # are opened at x_m in the main batch open below
        if pp.lasso_lookups:
            gamma_l = transcript.squeeze_challenge()
            tau = transcript.squeeze_challenge()
            with timed.scope("lasso_memory_check"):
                x_m, x_ns = lasso_int.prove_memory_check(
                    spec, lasso_layouts, lasso_locals, lasso_fcs, gamma_l, tau, num_vars, transcript
                )
            lasso_offset = len(polys) - len(lasso_flat)
            xm_vals = mle.evaluate_stacked_ints(spec, lasso_flat, x_m)
            transcript.write_field_elements(xm_vals)
            points = list(points) + [list(x_m)]
            evals = list(evals) + [Evaluation(lasso_offset + i, len(points) - 1, v) for i, v in enumerate(xm_vals)]

        with timed.scope("pcs_batch_open"):
            cls.Pcs.batch_open(pp.pcs, all_polys, all_comms, points, evals, transcript)

        # Lasso final counters: one batch open per subtable size, at that
        # group's x_n
        if pp.lasso_lookups:
            with timed.scope("lasso_open_fc"):
                for nv_n, members in lasso_int._n_groups(lasso_layouts).items():
                    group_polys = [lasso_fcs[li][mi] for li, mi in members]
                    vals = mle.evaluate_stacked_ints(spec, group_polys, x_ns[nv_n])
                    transcript.write_field_elements(vals)
                    n_evals = [Evaluation(j, 0, v) for j, v in enumerate(vals)]
                    cls.Pcs.batch_open(pp.pcs, group_polys, None, [x_ns[nv_n]], n_evals, transcript)

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

        lasso_layouts = [lasso_int.LassoLayout(lk) for lk in vp.lasso_lookups]
        total_locals = sum(layout.num_local for layout in lasso_layouts)
        lasso_comms: List[Any] = []
        if lasso_layouts:
            lasso_comms = cls.Pcs.read_commitments(vp.pcs, total_locals, transcript)
            fc_comms = cls.Pcs.read_commitments(vp.pcs, sum(len(layout.mems) for layout in lasso_layouts), transcript)

        beta = transcript.squeeze_challenge()
        m_comms = cls.Pcs.read_commitments(vp.pcs, vp.num_lookups, transcript)
        gamma = transcript.squeeze_challenge()
        hz_comms = cls.Pcs.read_commitments(vp.pcs, vp.num_lookups + vp.num_permutation_z_polys, transcript)
        alpha = transcript.squeeze_challenge()
        y = transcript.squeeze_challenges(num_vars)

        challenges = challenges + [beta, gamma, alpha]
        spec = cls.field
        points, evals = verifier.verify_zero_check(
            num_vars, vp.expression, instances, challenges, y, transcript, spec=spec
        )

        # Lasso memory check (mirrors prove): the GKR grand products, then
        # the fingerprint recombination against the x_m / x_n openings
        if lasso_layouts:
            gamma_l = transcript.squeeze_challenge()
            tau = transcript.squeeze_challenge()
            x_m, q_m, n_claims = lasso_int.verify_memory_check(spec, lasso_layouts, gamma_l, tau, num_vars, transcript)
            xm_vals = transcript.read_field_elements(total_locals)
            starts = np.cumsum([0] + [layout.num_local for layout in lasso_layouts])
            local_evals = [xm_vals[a:b] for a, b in zip(starts[:-1], starts[1:])]
            lasso_int.check_m_fingerprints(spec, lasso_layouts, local_evals, q_m, gamma_l, tau)
            lasso_offset = len(vp.num_instances) + len(vp.preprocess_comms) + len(witness_comms)
            points = list(points) + [list(x_m)]
            evals = list(evals) + [Evaluation(lasso_offset + i, len(points) - 1, v) for i, v in enumerate(xm_vals)]

        comms = (
            [None] * len(vp.num_instances)  # never opened (pcs_query excludes them)
            + list(vp.preprocess_comms)
            + witness_comms
            + lasso_comms
            + [c for _, c in vp.permutation_comms]
            + m_comms
            + hz_comms
        )
        cls.Pcs.batch_verify(vp.pcs, comms, points, evals, transcript)

        if lasso_layouts:
            fc_pos = {key: pos for pos, key in enumerate(
                (li, mi) for li, layout in enumerate(lasso_layouts) for mi in range(len(layout.mems))
            )}
            for nv_n, members in lasso_int._n_groups(lasso_layouts).items():
                x_n, init_claims, final_claims = n_claims[nv_n]
                fc_evals = transcript.read_field_elements(len(members))
                lasso_int.check_n_fingerprints(
                    spec, lasso_layouts, members, x_n, init_claims, final_claims, fc_evals, gamma_l, tau
                )
                n_evals = [Evaluation(j, 0, v) for j, v in enumerate(fc_evals)]
                cls.Pcs.batch_verify(vp.pcs, [fc_comms[fc_pos[key]] for key in members], [x_n], n_evals, transcript)


def hyperplonk(pcs_cls) -> type:
    """HyperPlonk over `pcs_cls` (the reference's HyperPlonk<Pcs>), over the
    PCS's polynomial field (the JAX package's ``field()``,
    halo2_lasso_tpu/backend/hyperplonk/__init__.py:96-99)."""
    if pcs_cls is MultilinearKzg:
        return HyperPlonk
    return type(f"HyperPlonk_{pcs_cls.__name__}", (HyperPlonk,),
                {"Pcs": pcs_cls, "field": getattr(pcs_cls, "FIELD", Fr)})
