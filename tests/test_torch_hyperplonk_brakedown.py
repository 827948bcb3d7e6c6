"""Port HyperPlonk over Brakedown
(halo2_lasso_tpu_torch.backend.hyperplonk.hyperplonk(MultilinearBrakedown))
against the JAX package on the CPU, at nv = 3: rand_vanilla_plonk_circuit
and rand_vanilla_plonk_with_lookup_circuit (seeds 3 / 103, setup seed 0,
tests/test_hyperplonk_pcs.py's). The port's proof with the carried JAX state
(``from_jax_hyperplonk_params``, its commitments through
``from_jax_commitment``) and with its own setup equals the JAX proof (the
vanilla one hashes to chip_smoke.PCS_PLONK_SHA256["MultilinearBrakedown"]);
the port verifies it, and tampered proofs are rejected. Every open writes
3,755 columns, so the proofs are 8.4 and 12.0 MB. One JAX setup,
preprocess and prove per circuit serves every test (a module fixture); the
JAX verifier is not run on proofs whose bytes equal its own
(tests/test_hyperplonk_pcs.py covers it)."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import hyperplonk as jhyperplonk
from halo2_lasso_tpu.pcs import brakedown as JB
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, from_jax_hyperplonk_params, hyperplonk
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.pcs import brakedown as B

torch.set_num_threads(1)  # the suite's workers share the cores

CIRCUITS = ["rand_vanilla_plonk_circuit", "rand_vanilla_plonk_with_lookup_circuit"]
CFG = chip_smoke.PCS_PLONK_SMALL


@pytest.fixture(scope="module", params=CIRCUITS)
def plonk(request):
    """HyperPlonk over Brakedown at nv = 3: the JAX package's proof, and the
    port's with the carried JAX state and with its own setup."""
    name = request.param
    jb, b = jhyperplonk(JB.MultilinearBrakedown), hyperplonk(B.MultilinearBrakedown)

    def circuit(fx):
        return getattr(fx, name)(CFG["num_vars"], *(np.random.RandomState(s) for s in CFG["seeds"]))

    def prove(backend, pp, circ):
        t = backend.transcript()
        backend.prove(pp, circ, t)
        return t.into_proof()

    jci, jcirc = circuit(jfixtures)
    jpp, jvp = jb.preprocess(jb.setup(jci, np.random.RandomState(CFG["setup_seed"])), jci)
    ci, circ = circuit(fixtures)
    pp, vp = from_jax_hyperplonk_params(jpp, jvp, device="cpu", pcs=B.MultilinearBrakedown)
    own_pp, own_vp = b.preprocess(b.setup(ci, np.random.RandomState(CFG["setup_seed"]), device="cpu"), ci)
    return {"name": name, "b": b, "vp": vp, "own_vp": own_vp, "circ": circ,
            "jax": prove(jb, jpp, jcirc), "port": prove(b, pp, circ), "own": prove(b, own_pp, circ)}


def test_hyperplonk_proof_bytes_match_jax(plonk):
    assert plonk["port"] == plonk["jax"]
    assert plonk["own"] == plonk["jax"]
    if plonk["name"] == "rand_vanilla_plonk_circuit":
        assert hashlib.sha256(plonk["jax"]).hexdigest() == chip_smoke.PCS_PLONK_SHA256["MultilinearBrakedown"]


def test_hyperplonk_port_verifies_jax_proof(plonk):
    b, inst = plonk["b"], plonk["circ"].instances()
    b.verify(plonk["vp"], inst, b.transcript(plonk["jax"]))
    b.verify(plonk["own_vp"], inst, b.transcript(plonk["jax"]))


@pytest.mark.parametrize("where", ["commitment", "middle", "opening"])
def test_hyperplonk_tampered_proof_rejected(plonk, where):
    proof = plonk["own"]
    at = {"commitment": 70, "middle": len(proof) // 2, "opening": len(proof) - 40}[where]
    bad = bytearray(proof)
    bad[at] ^= 1
    with pytest.raises(Halo2LassoError):
        plonk["b"].verify(plonk["own_vp"], plonk["circ"].instances(), plonk["b"].transcript(bytes(bad)))
