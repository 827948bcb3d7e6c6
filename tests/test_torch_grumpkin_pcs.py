"""MultilinearIpaGrumpkin and MultilinearHyraxGrumpkin (halo2_lasso_tpu_torch.pcs.ipa,
.hyrax) against the JAX package on the CPU, as tests/test_grumpkin.py runs
them (IPA at nv = 3, Hyrax at nv = 4, polynomials over BN254 Fq, the
transcript's points on grumpkin):

* commit, open and the whole transcript are byte-equal, with each
  package's own transparent setup and with the JAX parameters carried into
  the port (``from_jax_params``);
* each package verifies the other's proof, and an evaluation off by one is
  rejected.
One JAX setup and proof per PCS serves every test (module fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops.bn254 import Fq as JFq
from halo2_lasso_tpu.pcs.hyrax import MultilinearHyraxGrumpkin as JHyraxGrumpkin
from halo2_lasso_tpu.pcs.ipa import MultilinearIpaGrumpkin as JIpaGrumpkin
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.backend.hyperplonk import transcript_for
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops import curves
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, FR_MODULUS, Fq
from halo2_lasso_tpu_torch.pcs.hyrax import MultilinearHyraxGrumpkin
from halo2_lasso_tpu_torch.pcs.ipa import MultilinearIpaGrumpkin
from halo2_lasso_tpu_torch.poly import multilinear as mle

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
P = FQ_MODULUS
# name: (JAX class, port class, num_vars)
PCS = {
    "MultilinearIpaGrumpkin": (JIpaGrumpkin, MultilinearIpaGrumpkin, 3),
    "MultilinearHyraxGrumpkin": (JHyraxGrumpkin, MultilinearHyraxGrumpkin, 4),
}


def jax_transcript(proof=None):
    return JTranscript(P, base_modulus=FR_MODULUS, proof=proof, curve_b=curves.GRUMPKIN_B)


def write_comm(t, comm):
    if isinstance(comm, list):
        t.write_commitments(comm)
    else:
        t.write_commitment(comm)


def read_comm(t, like):
    return t.read_commitments(len(like)) if isinstance(like, list) else t.read_commitment()


def open_proof(pcs, pp, poly, vals, nv, t):
    """Commit, squeeze the point, write the evaluation, open."""
    comm = pcs.commit(pp, poly)
    write_comm(t, comm)
    point = t.squeeze_challenges(nv)
    v = sum(a * mle.lagrange_eval_host(P, point, b) for b, a in enumerate(vals)) % P
    t.write_field_element(v)
    pcs.open(pp, poly, point, v, t)
    return comm, t.into_proof()


def verify(pcs, vp, like, nv, proof, transcript, bump=0):
    t = transcript(proof)
    comm = read_comm(t, like)
    point = t.squeeze_challenges(nv)
    v = t.read_field_element()
    pcs.verify(vp, comm, point, (v + bump) % P, t)


@pytest.fixture(scope="module", params=list(PCS))
def case(request):
    jpcs, pcs, nv = PCS[request.param]
    rng = np.random.RandomState(11)
    vals = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(1 << nv)]
    jpp, jvp = jpcs.trim(jpcs.setup(1 << nv), 1 << nv)
    jcomm, jproof = open_proof(jpcs, jpp, jnp.asarray(JFq.encode(vals)), vals, nv, jax_transcript())
    pp, vp = pcs.trim(pcs.setup(1 << nv, device="cpu"), 1 << nv)
    comm, proof = open_proof(pcs, pp, Fq.encode(vals), vals, nv, transcript_for(pcs))
    cpp, cvp = pcs.from_jax_params(jpp, "cpu"), pcs.from_jax_params(jvp, "cpu")
    carried = open_proof(pcs, cpp, Fq.encode(vals), vals, nv, transcript_for(pcs))[1]
    return {"jpcs": jpcs, "pcs": pcs, "nv": nv, "jvp": jvp, "vp": vp, "cvp": cvp, "jcomm": jcomm, "comm": comm,
            "jax": jproof, "port": proof, "carried": carried}


def test_open_bytes_match_jax(case):
    assert case["comm"] == case["jcomm"]
    assert all(curves.on_curve(curves.GRUMPKIN, *c) for c in (case["comm"] if isinstance(case["comm"], list)
                                                               else [case["comm"]]))
    assert case["port"] == case["jax"]


def test_carried_params_give_the_same_bytes(case):
    """from_jax_params carries the JAX package's grumpkin generators."""
    assert case["carried"] == case["jax"]


def test_open_verifies_across_packages(case):
    pcs, jpcs, nv = case["pcs"], case["jpcs"], case["nv"]
    transcript = lambda proof: transcript_for(pcs, proof)  # noqa: E731
    verify(pcs, case["vp"], case["comm"], nv, case["jax"], transcript)
    verify(pcs, case["cvp"], case["comm"], nv, case["jax"], transcript)
    verify(jpcs, case["jvp"], case["jcomm"], nv, case["port"], jax_transcript)
    with pytest.raises(Halo2LassoError):
        verify(pcs, case["vp"], case["comm"], nv, case["port"], transcript, bump=1)
