"""Port multi-phase witnesses (rand_two_phase_circuit and the witness-phase
loop of backend.hyperplonk) against the JAX package on the CPU.

rand_two_phase_circuit at nv = 3 (RandomState(103)) and nv = 5
(RandomState(105)), setup seed 0, the shapes tests/test_multiphase.py
compiles: num_challenges [1, 0], the phase-1 witness synthesized against the
challenge squeezed after phase 0. The port's proof, made with its own setup
and preprocess, equals the JAX package's proof (at nv = 3 it hashes to
chip_smoke.TWO_PHASE_SHA256); each package verifies the other's proof; both
circuits synthesize the same witnesses; a witness built against a wrong
challenge (cheat=True) is rejected by both verifiers. All comparisons are
exact; one JAX setup / preprocess / prove per size (module fixture).
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu.errors import Halo2LassoError as JHalo2LassoError
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, fixtures, new_transcript
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops.bn254 import Fr

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores


def circuits(nv, cheat=False):
    """The same circuit from both packages: ((info, circuit), (jinfo, jcircuit))."""
    return tuple(
        pkg.rand_two_phase_circuit(nv, np.random.RandomState(100 + nv), cheat=cheat) for pkg in (fixtures, jfixtures)
    )


@pytest.fixture(scope="module", params=[3, 5], ids=["nv3", "nv5"])
def two_phase(request):
    """Both packages' params and proofs of one size; the port's from its
    own setup and preprocess on the CPU."""
    nv = request.param
    (ci, circ), (jci, jcirc) = circuits(nv)
    jpp, jvp = JHyperPlonk.preprocess(JHyperPlonk.setup(jci, np.random.RandomState(0)), jci)
    t = j_new_transcript()
    JHyperPlonk.prove(jpp, jcirc, t)
    pp, vp = HyperPlonk.preprocess(HyperPlonk.setup(ci, np.random.RandomState(0), device="cpu"), ci)
    tw = new_transcript()
    HyperPlonk.prove(pp, circ, tw)
    return {"nv": nv, "jax": t.into_proof(), "proof": tw.into_proof(), "pp": pp, "vp": vp, "jpp": jpp, "jvp": jvp}


def test_proof_bytes_match_jax(two_phase):
    assert two_phase["proof"] == two_phase["jax"]
    if two_phase["nv"] == 3:
        assert hashlib.sha256(two_phase["proof"]).hexdigest() == chip_smoke.TWO_PHASE_SHA256


def test_port_verifies_jax_proof(two_phase):
    HyperPlonk.verify(two_phase["vp"], [], new_transcript(two_phase["jax"]))


def test_jax_verifies_port_proof(two_phase):
    JHyperPlonk.verify(two_phase["jvp"], [], j_new_transcript(two_phase["proof"]))


def test_witness_phases_match_jax(two_phase):
    (ci, circ), (jci, jcirc) = circuits(two_phase["nv"])
    assert (ci.num_witness_polys, ci.num_challenges) == (jci.num_witness_polys, jci.num_challenges) == ([1, 1], [1, 0])
    assert circ.synthesize(0, []) == jcirc.synthesize(0, [])
    theta = [Fr.modulus - 5]
    assert circ.synthesize(1, theta) == jcirc.synthesize(1, theta)


def test_cheating_witness_rejected(two_phase):
    """A phase-1 witness built against theta + 1: the prover completes, and
    both packages' verifiers reject the proof."""
    (_, liar), _ = circuits(two_phase["nv"], cheat=True)
    tw = new_transcript()
    HyperPlonk.prove(two_phase["pp"], liar, tw)
    proof = tw.into_proof()
    with pytest.raises(Halo2LassoError):
        HyperPlonk.verify(two_phase["vp"], [], new_transcript(proof))
    with pytest.raises(JHalo2LassoError):
        JHyperPlonk.verify(two_phase["jvp"], [], j_new_transcript(proof))
