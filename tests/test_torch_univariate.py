"""Port univariate polynomials and univariate KZG
(halo2_lasso_tpu_torch.poly.univariate, .pcs.univariate_kzg) against the
JAX package on the CPU, at the sizes of tests/test_univariate.py:

* evaluate, powers_array, div_by_linear (17 coefficients), mul_small,
  add_padded and div_rem_by_vanishing (16 coefficients, 3 roots) give the
  JAX package's limbs;
* the port's own setup (16 and 8 powers, seeds 9 and 11) gives the JAX
  package's SRS as affine points and G2 points;
* an open and an fflonk batch open (3 polys at 2 points) are byte-equal to
  the JAX package's, each package verifies the other's proof, and a
  tampered evaluation is rejected.
All comparisons are exact. One JAX setup and proof per size serves every
test (module fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import ec as jec
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.pcs import Evaluation as JEvaluation
from halo2_lasso_tpu.pcs.univariate_kzg import UnivariateKzg as JUniKzg
from halo2_lasso_tpu.poly import univariate as juni
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.pcs.univariate_kzg import UnivariateKzg
from halo2_lasso_tpu_torch.poly import univariate as uni
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
PAIRS = [(0, 0), (0, 1), (1, 0), (2, 1)]  # (poly, point) of the batch open


def rand_fes(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def new_t(cls, proof=None):
    return cls(P, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)


def same(t, jarr):
    return np.array_equal(F.to_jax_limbs(t), np.asarray(jarr))


def single_open(pcs, pp, t, coeffs, poly):
    """Commit, squeeze z, write f(z), open (tests/test_univariate.py)."""
    t.write_commitment(pcs.commit(pp, poly))
    z = t.squeeze_challenge()
    ev = uni.evaluate_host(P, coeffs, z)
    t.write_field_element(ev)
    pcs.open(pp, poly, z, ev, t)
    return t.into_proof()


def read_single(t):
    comm = t.read_commitment()
    z = t.squeeze_challenge()
    return comm, z, t.read_field_element()


def batch_open(pcs, ev_cls, pp, t, coeffs, polys):
    t.write_commitments(pcs.batch_commit(pp, polys) if hasattr(pcs, "batch_commit")
                        else [pcs.commit(pp, p) for p in polys])
    points = [t.squeeze_challenge() for _ in range(2)]
    evals = [ev_cls(pi, ti, uni.evaluate_host(P, coeffs[pi], points[ti])) for pi, ti in PAIRS]
    t.write_field_elements([e.value for e in evals])
    pcs.batch_open(pp, polys, points, evals, t)
    return t.into_proof()


def read_batch(t, ev_cls):
    comms = t.read_commitments(3)
    points = [t.squeeze_challenge() for _ in range(2)]
    vals = t.read_field_elements(len(PAIRS))
    return comms, points, [ev_cls(pi, ti, v) for (pi, ti), v in zip(PAIRS, vals)]


@pytest.fixture(scope="module")
def jax_kzg():
    """The JAX package's SRS of 16 (seed 9) and 8 (seed 11) powers, its open
    of 16 coefficients and its batch open of 3 polys of 8."""
    rng = np.random.RandomState(13)
    out = {}
    param = JUniKzg.setup(16, np.random.RandomState(9))
    pp, vp = JUniKzg.trim(param, 16)
    coeffs = rand_fes(rng, 16)
    proof = single_open(JUniKzg, pp, new_t(JTranscript), coeffs, jnp.asarray(JFr.encode(coeffs)))
    out["single"] = {"param": param, "vp": vp, "coeffs": coeffs, "proof": proof}
    param = JUniKzg.setup(8, np.random.RandomState(11))
    pp, vp = JUniKzg.trim(param, 8)
    coeffs = [rand_fes(rng, 8) for _ in range(3)]
    proof = batch_open(JUniKzg, JEvaluation, pp, new_t(JTranscript), coeffs,
                       [jnp.asarray(JFr.encode(c)) for c in coeffs])
    out["batch"] = {"param": param, "vp": vp, "coeffs": coeffs, "proof": proof}
    return out


@pytest.fixture(scope="module")
def port_kzg(jax_kzg):
    """The port's own setups of the same sizes and seeds, and its proofs of
    the same polys on the CPU."""
    out = {}
    for name, size, seed in (("single", 16, 9), ("batch", 8, 11)):
        param = UnivariateKzg.setup(size, np.random.RandomState(seed), device="cpu")
        pp, vp = UnivariateKzg.trim(param, size)
        coeffs = jax_kzg[name]["coeffs"]
        if name == "single":
            proof = single_open(UnivariateKzg, pp, new_t(Keccak256Transcript), coeffs, Fr.encode(coeffs))
        else:
            proof = batch_open(UnivariateKzg, Evaluation, pp, new_t(Keccak256Transcript), coeffs,
                               [Fr.encode(c) for c in coeffs])
        out[name] = {"param": param, "vp": vp, "proof": proof}
    return out


def test_evaluate_and_div_by_linear_match_jax():
    rng = np.random.RandomState(17)
    coeffs, x = rand_fes(rng, 17), rand_fes(rng, 1)[0]
    jc, jx = jnp.asarray(JFr.encode(coeffs)), jnp.asarray(JFr.encode([x]))[0]
    c = F.from_jax_limbs(np.asarray(jc))
    got = uni.evaluate(Fr, c, x)
    assert same(got, juni.evaluate(JFr, jc, jx))
    assert Fr.decode_ints(got[None]) == [uni.evaluate_host(P, coeffs, x)]
    assert same(uni.powers_array(Fr, x, 17, "cpu"), juni.powers_array(JFr, jx, 17))
    q, r = uni.div_by_linear(Fr, c, x)
    jq, jr = juni.div_by_linear(JFr, jc, jx)
    assert same(q, jq) and same(r, jr)
    for n in (1, 2, 3):  # the scan's edges: no level, one level, a ragged one
        jq, jr = juni.div_by_linear(JFr, jc[:n], jx)
        q, r = uni.div_by_linear(Fr, c[:n], x)
        assert same(q, jq) and same(r, jr)


def test_div_rem_by_vanishing_matches_jax():
    rng = np.random.RandomState(19)
    coeffs, roots = rand_fes(rng, 16), rand_fes(rng, 3)
    jc = jnp.asarray(JFr.encode(coeffs))
    c = F.from_jax_limbs(np.asarray(jc))
    q, rem = uni.div_rem_by_vanishing(Fr, c, roots)
    jq, jrem = juni.div_rem_by_vanishing(JFr, jc, roots)
    assert same(q, jq) and same(rem, jrem)
    for rt in roots:
        assert uni.evaluate_host(P, coeffs, rt) == uni.evaluate_host(P, Fr.decode_ints(rem), rt)
    v = uni.vanishing_poly_host(P, roots)
    assert v == juni.vanishing_poly_host(P, roots)
    assert same(uni.mul_small(Fr, c, v), juni.mul_small(JFr, jc, v))
    assert same(uni.add_padded(Fr, c[:5], c), juni.add_padded(JFr, jc[:5], jc))


@pytest.mark.parametrize("name", ["single", "batch"])
def test_setup_matches_jax(jax_kzg, port_kzg, name):
    jp, p = jax_kzg[name]["param"], port_kzg[name]["param"]
    want = [(int(x), int(y)) for x, y in jec.jacobian_to_affine(jp.powers_g1)]
    assert ec.jacobian_to_affine(p.powers_g1) == want
    assert (p.g2, p.s_g2, p.s_g2_offsets) == (jp.g2, jp.s_g2, jp.s_g2_offsets)


@pytest.mark.parametrize("name", ["single", "batch"])
def test_proof_bytes_match_jax(jax_kzg, port_kzg, name):
    assert port_kzg[name]["proof"] == jax_kzg[name]["proof"]


def test_open_verifies_across_packages(jax_kzg, port_kzg):
    proof = port_kzg["single"]["proof"]
    t = new_t(Keccak256Transcript, jax_kzg["single"]["proof"])
    UnivariateKzg.verify(port_kzg["single"]["vp"], *read_single(t), t)
    t = new_t(JTranscript, proof)
    JUniKzg.verify(jax_kzg["single"]["vp"], *read_single(t), t)
    t = new_t(Keccak256Transcript, proof)
    comm, z, ev = read_single(t)
    with pytest.raises(Halo2LassoError):
        UnivariateKzg.verify(port_kzg["single"]["vp"], comm, z, (ev + 1) % P, t)


def test_batch_open_verifies_across_packages(jax_kzg, port_kzg):
    t = new_t(Keccak256Transcript, jax_kzg["batch"]["proof"])
    comms, points, evals = read_batch(t, Evaluation)
    UnivariateKzg.batch_verify(port_kzg["batch"]["vp"], comms, points, evals, t)
    t = new_t(JTranscript, port_kzg["batch"]["proof"])
    comms, points, evals = read_batch(t, JEvaluation)
    JUniKzg.batch_verify(jax_kzg["batch"]["vp"], comms, points, evals, t)
    t = new_t(Keccak256Transcript, port_kzg["batch"]["proof"])
    comms, points, evals = read_batch(t, Evaluation)
    evals[1] = Evaluation(evals[1].poly, evals[1].point, (evals[1].value + 1) % P)
    with pytest.raises(Halo2LassoError):
        UnivariateKzg.batch_verify(port_kzg["batch"]["vp"], comms, points, evals, t)

