"""Port standalone Lasso over Gemini (halo2_lasso_tpu_torch.lasso with
pcs=Gemini) against the JAX package on the CPU, in the shape of
tests/test_lasso.py::test_lasso_over_gemini: range_table(16, 8), 8 lookups
(indices from RandomState(123)), Gemini SRS of 2^8 from RandomState(3).
The port's proof, with its own setup, equals the JAX package's and hashes
to chip_smoke.LASSO_GEMINI_SHA256; the SRS converted from the JAX package
(Gemini.from_jax_params) gives the same bytes; each package verifies the
other's proof; a tampered proof is rejected. One JAX setup and proof
serves every test (module fixture)."""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu import lasso as jlasso
from halo2_lasso_tpu.lasso.tables import range_table as jrange_table
from halo2_lasso_tpu.pcs.gemini import Gemini as JGemini
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch import lasso
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.lasso.tables import range_table
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
from halo2_lasso_tpu_torch.pcs.gemini import Gemini
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
CFG = chip_smoke.LASSO_GEMINI_SMALL
NV_M = CFG["lookups"].bit_length() - 1
NV = max(NV_M, CFG["chunk_bits"])


def new_t(cls, proof=None):
    return cls(Fr.modulus, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)


def indices():
    rng = np.random.RandomState(CFG["index_seed"])
    return [int(rng.randint(1 << CFG["index_bits"])) for _ in range(CFG["lookups"])]


@pytest.fixture(scope="module")
def proofs():
    jparam = JGemini.setup(1 << NV, np.random.RandomState(CFG["srs_seed"]))
    jpp, jvp = JGemini.trim(jparam, 1 << NV)
    t = new_t(JTranscript)
    jlasso.prove(jpp, jrange_table(CFG["index_bits"], CFG["chunk_bits"]), indices(), t, pcs=JGemini)
    table = range_table(CFG["index_bits"], CFG["chunk_bits"])
    pp, vp = Gemini.trim(Gemini.setup(1 << NV, np.random.RandomState(CFG["srs_seed"]), device="cpu"), 1 << NV)
    own = new_t(Keccak256Transcript)
    lasso.prove(pp, table, indices(), own, pcs=Gemini, device="cpu")
    carried = new_t(Keccak256Transcript)
    lasso.prove(Gemini.from_jax_params(jpp, "cpu"), table, indices(), carried, pcs=Gemini, device="cpu")
    return {"jax": t.into_proof(), "own": own.into_proof(), "carried": carried.into_proof(), "vp": vp,
            "jvp": jvp, "table": table}


def test_proof_bytes_match_jax(proofs):
    assert proofs["own"] == proofs["jax"] == proofs["carried"]
    assert hashlib.sha256(proofs["own"]).hexdigest() == chip_smoke.LASSO_GEMINI_SHA256


def test_port_verifies_jax_proof(proofs):
    lasso.verify(proofs["vp"], proofs["table"], NV_M, new_t(Keccak256Transcript, proofs["jax"]), pcs=Gemini)


def test_jax_verifies_port_proof(proofs):
    jtable = jrange_table(CFG["index_bits"], CFG["chunk_bits"])
    jlasso.verify(proofs["jvp"], jtable, NV_M, new_t(JTranscript, proofs["own"]), pcs=JGemini)


@pytest.mark.parametrize("at", [3, 2], ids=["third", "half"])
def test_tampered_proof_rejected(proofs, at):
    bad = bytearray(proofs["own"])
    bad[len(bad) // at] ^= 1
    with pytest.raises(Halo2LassoError):
        lasso.verify(proofs["vp"], proofs["table"], NV_M, new_t(Keccak256Transcript, bytes(bad)), pcs=Gemini)
