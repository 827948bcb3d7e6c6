"""Port HyperPlonk over MultilinearHyraxGrumpkin (the grumpkin half of the
BN254 2-cycle, hyperplonk.rs:422-423) against the JAX package on the CPU: the
tests of tests/test_torch_hyperplonk_pcs.py (rand_vanilla_plonk_circuit at
nv = 3 over BN254 Fq, seeds 3 / 103, setup seed 0: proof bytes equal with the
carried and with the port's own setup, hashing to
chip_smoke.PCS_PLONK_SHA256, verified across packages, tampering rejected).
A file of its own so that each SNARK's JAX side stays within the suite's
time a file."""

import pytest
import torch

from test_torch_hyperplonk_pcs import (  # noqa: F401  (collected here over this file's PCS)
    make_case,
    test_jax_verifies_port_proof,
    test_port_setup_gives_the_same_bytes,
    test_port_verifies_jax_proof,
    test_proof_bytes_match_jax,
    test_tampered_proof_rejected,
)

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores


@pytest.fixture(scope="module", params=["MultilinearHyraxGrumpkin"])
def case(request):
    return make_case(request.param)
