"""Port HyperPlonk over the secondary BN254 PCS
(halo2_lasso_tpu_torch.backend.hyperplonk.hyperplonk) against the JAX
package on the CPU: rand_vanilla_plonk_circuit at nv = 3 with
tests/test_hyperplonk_pcs.py's seeds (3, 103; setup seed 0) under Gemini and
Zeromorph here, MultilinearIpa and MultilinearHyrax in
tests/test_torch_hyperplonk_ipa.py, and their grumpkin twins (the circuit
over BN254 Fq) in tests/test_torch_grumpkin_hyperplonk_ipa.py and
tests/test_torch_grumpkin_hyperplonk_hyrax.py (which reuse these tests):

* the port's proof made with the JAX package's preprocessed state
  (from_jax_hyperplonk_params dispatching on the PCS class) equals the JAX
  proof and hashes to chip_smoke.PCS_PLONK_SHA256;
* the port's own setup and preprocess give the same bytes;
* each package verifies the other's proof, and a tampered proof is
  rejected.
All comparisons are exact. One JAX setup / preprocess / prove per PCS
serves every test (module fixture)."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import hyperplonk as jhyperplonk
from halo2_lasso_tpu.pcs.gemini import Gemini as JGemini
from halo2_lasso_tpu.pcs.hyrax import MultilinearHyrax as JHyrax
from halo2_lasso_tpu.pcs.hyrax import MultilinearHyraxGrumpkin as JHyraxGrumpkin
from halo2_lasso_tpu.pcs.ipa import MultilinearIpa as JIpa
from halo2_lasso_tpu.pcs.ipa import MultilinearIpaGrumpkin as JIpaGrumpkin
from halo2_lasso_tpu.pcs.zeromorph import Zeromorph as JZeromorph
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, from_jax_hyperplonk_params, hyperplonk
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.pcs.gemini import Gemini
from halo2_lasso_tpu_torch.pcs.hyrax import MultilinearHyrax, MultilinearHyraxGrumpkin
from halo2_lasso_tpu_torch.pcs.ipa import MultilinearIpa, MultilinearIpaGrumpkin
from halo2_lasso_tpu_torch.pcs.zeromorph import Zeromorph

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
CFG = chip_smoke.PCS_PLONK_SMALL
PCS = {
    "Gemini": (JGemini, Gemini),
    "Zeromorph": (JZeromorph, Zeromorph),
    "MultilinearIpa": (JIpa, MultilinearIpa),
    "MultilinearHyrax": (JHyrax, MultilinearHyrax),
    "MultilinearIpaGrumpkin": (JIpaGrumpkin, MultilinearIpaGrumpkin),
    "MultilinearHyraxGrumpkin": (JHyraxGrumpkin, MultilinearHyraxGrumpkin),
}


def circuit(fx, field):
    """The config's circuit over `field`, the backend's (BN254 Fq for the
    grumpkin-backed PCS)."""
    return fx.rand_vanilla_plonk_circuit(CFG["num_vars"], *(np.random.RandomState(s) for s in CFG["seeds"]),
                                         field=field)


def prove(backend, pp, circ):
    t = backend.transcript()
    backend.prove(pp, circ, t)
    return t.into_proof()


def make_case(name):
    """The JAX package's proof under one PCS; the port's proofs with the
    carried JAX state and with its own setup, on the CPU."""
    jpcs, pcs = PCS[name]
    jb, b = jhyperplonk(jpcs), hyperplonk(pcs)
    jci, jcirc = circuit(jfixtures, jb.field())
    jpp, jvp = jb.preprocess(jb.setup(jci, np.random.RandomState(CFG["setup_seed"])), jci)
    ci, circ = circuit(fixtures, b.field)
    pp, vp = from_jax_hyperplonk_params(jpp, jvp, device="cpu", pcs=pcs)
    own_pp, own_vp = b.preprocess(b.setup(ci, np.random.RandomState(CFG["setup_seed"]), device="cpu"), ci)
    return {
        "name": name, "jb": jb, "b": b, "jvp": jvp, "vp": vp, "own_vp": own_vp, "circ": circ,
        "jax": prove(jb, jpp, jcirc), "port": prove(b, pp, circ), "own": prove(b, own_pp, circ),
    }


@pytest.fixture(scope="module", params=["Gemini", "Zeromorph"])
def case(request):
    return make_case(request.param)


def test_proof_bytes_match_jax(case):
    assert case["port"] == case["jax"]
    assert hashlib.sha256(case["port"]).hexdigest() == chip_smoke.PCS_PLONK_SHA256[case["name"]]


def test_port_setup_gives_the_same_bytes(case):
    assert case["own"] == case["jax"]


def test_port_verifies_jax_proof(case):
    b, inst = case["b"], case["circ"].instances()
    b.verify(case["vp"], inst, b.transcript(case["jax"]))
    b.verify(case["own_vp"], inst, b.transcript(case["jax"]))


def test_jax_verifies_port_proof(case):
    case["jb"].verify(case["jvp"], case["circ"].instances(), case["jb"].transcript(case["own"]))


@pytest.mark.parametrize("where", ["commitment", "middle", "opening"])
def test_tampered_proof_rejected(case, where):
    proof = case["own"]
    at = {"commitment": 70, "middle": len(proof) // 2, "opening": len(proof) - 40}[where]
    bad = bytearray(proof)
    bad[at] ^= 1
    with pytest.raises(Halo2LassoError):
        case["b"].verify(case["own_vp"], case["circ"].instances(), case["b"].transcript(bytes(bad)))
