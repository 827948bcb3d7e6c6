"""The full-feature proof under a port mesh on the CPU: gates, a copy
constraint, a logup lookup and two Lasso lookups with their GKR memory
checks (``rand_full_feature_circuit(5)``, fixture seeds 5 and 105, setup
seed 0), proved through ``HyperPlonk.prove`` under ``use_mesh`` over D
virtual CPU shards (D = 2 and 4), must give the single-device proof's
bytes, and verify in the port and in the JAX package.

The single-device proof is held by its SHA-256,
``chip_smoke.FULL_FEATURE_SHA256[5]`` (``ff6b46bc…``): the JAX package's proof of this circuit on the CPU, and the
port's, which tests/test_torch_distributed.py proves on one device and
holds to it (proving it here as well would take this file past ~90 s). The
JAX test proves this circuit at nv = 6 (tests/test_sharding.py); nv = 5
keeps the file near 90 s.
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript
from halo2_lasso_tpu_torch.parallel import sharding as sh
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.scripts import dryrun_multiprocess as dry

NV = 5
torch.set_num_threads(1)  # the suite's workers share the cores


@pytest.fixture(scope="module")
def port():
    pp, vp, circuit = dry.full_feature(NV, "cpu")
    return {"pp": pp, "vp": vp, "circuit": circuit, "proofs": {}}


@pytest.fixture(scope="module")
def jax_vp():
    """The JAX package's verifier params of the same circuit."""
    info, _ = jfixtures.rand_full_feature_circuit(NV, np.random.RandomState(NV), np.random.RandomState(100 + NV))
    return JHyperPlonk.preprocess(JHyperPlonk.setup(info, np.random.RandomState(0)), info)[1]


def prove_under_mesh(port, d):
    """The proof under a mesh of d CPU shards (kept for the verify test)."""
    if d not in port["proofs"]:
        with sh.use_mesh(sh.Mesh(["cpu"] * d)):
            port["proofs"][d] = dry.prove(port["pp"], port["circuit"])
    return port["proofs"][d]


@pytest.mark.parametrize("d", [2, 4])
def test_full_feature_proof_under_mesh_is_the_single_device_proof(port, d, monkeypatch):
    split = []
    round_message = sc.round_message
    monkeypatch.setattr(sc, "round_message",
                        lambda spec, t, *a: split.append(t[0].shape[0]) or round_message(spec, t, *a))
    proof = prove_under_mesh(port, d)
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.FULL_FEATURE_SHA256[NV]
    assert split.count((1 << NV) // d) >= d  # the zero check's first round ran on each shard


def test_sharded_proof_verifies_in_both_packages(port, jax_vp):
    """The bytes every mesh gave (the tests above hold them to the
    single-device proof's)."""
    proof = prove_under_mesh(port, 4)
    HyperPlonk.verify(port["vp"], port["circuit"].instances(), new_transcript(proof))
    _, jcircuit = jfixtures.rand_full_feature_circuit(NV, np.random.RandomState(NV), np.random.RandomState(100 + NV))
    JHyperPlonk.verify(jax_vp, jcircuit.instances(), j_new_transcript(proof))
