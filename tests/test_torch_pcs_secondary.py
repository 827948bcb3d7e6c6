"""Port secondary multilinear PCS (halo2_lasso_tpu_torch.pcs.gemini,
.zeromorph; .ipa and .hyrax in tests/test_torch_pcs_ipa.py, which reuses
this file's tests) and the curve catalogue (.ops.curves) against the JAX
package on the CPU, at the sizes and seeds of tests/test_pcs_secondary.py
and tests/test_hash_to_curve.py:

* a single open at nv = 4 and an additive batch open at nv = 3 (3 polys at
  2 points) under Gemini and Zeromorph, each package with its own setup,
  are byte-equal; each package verifies the other's proof and rejects a
  tampered evaluation;
* hash_to_curve gives the JAX package's points on BN254 G1, Grumpkin and
  Pallas, and sqrt_mod, host_add and host_mul agree;
* the BN254 scalar ladder (ops/ec.py scalar_mul_bits) matches host
  arithmetic, with its bits shared or per lane;
* the small CPU batches' host-int plain paths (ops/field.py, ops/ec.py)
  give the limb programs' bits.
All comparisons are exact. One JAX setup and proof per PCS serves every
test (module fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import curves as jcurves
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.pcs import Evaluation as JEvaluation
from halo2_lasso_tpu.pcs.gemini import Gemini as JGemini
from halo2_lasso_tpu.pcs.hyrax import MultilinearHyrax as JHyrax
from halo2_lasso_tpu.pcs.ipa import MultilinearIpa as JIpa
from halo2_lasso_tpu.pcs.zeromorph import Zeromorph as JZeromorph
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fq, Fr
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.pcs.gemini import Gemini
from halo2_lasso_tpu_torch.pcs.hyrax import MultilinearHyrax
from halo2_lasso_tpu_torch.pcs.ipa import MultilinearIpa
from halo2_lasso_tpu_torch.pcs.zeromorph import Zeromorph
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
PAIRS = [(0, 0), (1, 0), (2, 1), (0, 1)]  # (poly, point) of the batch open
# name: (JAX class, port class, setup seed of the single open, of the batch
# open; None for the transparent IPA and Hyrax setups)
PCS = {
    "Gemini": (JGemini, Gemini, 2, 4),
    "Zeromorph": (JZeromorph, Zeromorph, 2, 4),
    "MultilinearIpa": (JIpa, MultilinearIpa, None, None),
    "MultilinearHyrax": (JHyrax, MultilinearHyrax, None, None),
}


def rand_fes(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def new_t(cls, proof=None):
    return cls(P, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)


def eval_host(vals, point):
    return sum(v * mle.lagrange_eval_host(P, point, b) for b, v in enumerate(vals)) % P


def write_comm(t, comm):
    if isinstance(comm, list):
        t.write_commitments(comm)
    else:
        t.write_commitment(comm)


def read_comm(t, like):
    return t.read_commitments(len(like)) if isinstance(like, list) else t.read_commitment()


def setup(pcs, seed, nv, device):
    kw = {} if device is None else {"device": device}
    if seed is None:
        return pcs.setup(1 << nv, **kw)
    return pcs.setup(1 << nv, np.random.RandomState(seed), **kw)


def single(pcs, seed, vals, encode, tcls, device=None):
    """Commit, squeeze the point, write the evaluation, open
    (tests/test_pcs_secondary.py run_single) at nv = 4."""
    nv = 4
    pp, vp = pcs.trim(setup(pcs, seed, nv, device), 1 << nv)
    poly = encode(vals)
    t = new_t(tcls)
    comm = pcs.commit(pp, poly)
    write_comm(t, comm)
    point = t.squeeze_challenges(nv)
    v = eval_host(vals, point)
    t.write_field_element(v)
    pcs.open(pp, poly, point, v, t)
    return {"vp": vp, "comm": comm, "proof": t.into_proof()}


def batch(pcs, seed, vals, encode, tcls, ev_cls, device=None):
    """tests/test_pcs_secondary.py run_batch at nv = 3: 3 polys, 2 points."""
    nv = 3
    pp, vp = pcs.trim(setup(pcs, seed, nv, device), 1 << nv)
    polys = [encode(v) for v in vals]
    t = new_t(tcls)
    comms = pcs.batch_commit(pp, polys)
    for c in comms:
        write_comm(t, c)
    points = [t.squeeze_challenges(nv) for _ in range(2)]
    evals = [ev_cls(pi, ti, eval_host(vals[pi], points[ti])) for pi, ti in PAIRS]
    t.write_field_elements([e.value for e in evals])
    pcs.batch_open(pp, polys, comms, points, evals, t)
    return {"vp": vp, "comms": comms, "proof": t.into_proof()}


def verify_single(pcs, case, proof, tcls, bump=0):
    t = new_t(tcls, proof)
    comm = read_comm(t, case["comm"])
    point = t.squeeze_challenges(4)
    v = t.read_field_element()
    pcs.verify(case["vp"], comm, point, (v + bump) % P, t)


def verify_batch(pcs, case, proof, tcls, ev_cls, bump=0):
    t = new_t(tcls, proof)
    comms = [read_comm(t, c) for c in case["comms"]]
    points = [t.squeeze_challenges(3) for _ in range(2)]
    vals = t.read_field_elements(len(PAIRS))
    vals[0] = (vals[0] + bump) % P
    evals = [ev_cls(pi, ti, v) for (pi, ti), v in zip(PAIRS, vals)]
    pcs.batch_verify(case["vp"], comms, points, evals, t)


def make_case(name):
    """One PCS's single and batch opens by the JAX package and by the port
    (its own setup, on the CPU), on the same polys."""
    jpcs, pcs, seed_single, seed_batch = PCS[name]
    rng = np.random.RandomState(21)
    vals = rand_fes(rng, 16)
    bvals = [rand_fes(rng, 8) for _ in range(3)]
    jenc = lambda v: jnp.asarray(JFr.encode(v))  # noqa: E731
    penc = lambda v: Fr.encode(v)  # noqa: E731
    return {
        "pcs": pcs, "jpcs": jpcs,
        "jax": single(jpcs, seed_single, vals, jenc, JTranscript),
        "port": single(pcs, seed_single, vals, penc, Keccak256Transcript, "cpu"),
        "jax_batch": batch(jpcs, seed_batch, bvals, jenc, JTranscript, JEvaluation),
        "port_batch": batch(pcs, seed_batch, bvals, penc, Keccak256Transcript, Evaluation, "cpu"),
    }


@pytest.fixture(scope="module", params=["Gemini", "Zeromorph"])
def case(request):
    return make_case(request.param)


def test_single_open_bytes_match_jax(case):
    assert case["port"]["comm"] == case["jax"]["comm"]
    assert case["port"]["proof"] == case["jax"]["proof"]


def test_batch_open_bytes_match_jax(case):
    assert case["port_batch"]["comms"] == case["jax_batch"]["comms"]
    assert case["port_batch"]["proof"] == case["jax_batch"]["proof"]


def test_single_open_verifies_across_packages(case):
    pcs, jpcs = case["pcs"], case["jpcs"]
    verify_single(pcs, case["port"], case["jax"]["proof"], Keccak256Transcript)
    verify_single(jpcs, case["jax"], case["port"]["proof"], JTranscript)
    with pytest.raises(Halo2LassoError):
        verify_single(pcs, case["port"], case["jax"]["proof"], Keccak256Transcript, bump=1)


def test_batch_open_verifies_across_packages(case):
    pcs, jpcs = case["pcs"], case["jpcs"]
    verify_batch(pcs, case["port_batch"], case["jax_batch"]["proof"], Keccak256Transcript, Evaluation)
    verify_batch(jpcs, case["jax_batch"], case["port_batch"]["proof"], JTranscript, JEvaluation)
    with pytest.raises(Halo2LassoError):
        verify_batch(pcs, case["port_batch"], case["jax_batch"]["proof"], Keccak256Transcript, Evaluation, bump=1)


@pytest.mark.parametrize("name", ["BN254_G1", "GRUMPKIN", "PALLAS"])
def test_hash_to_curve_matches_jax(name):
    curve, jcurve = getattr(curves, name), getattr(jcurves, name)
    got = curves.hash_to_curve(curve, b"test-seed", 32)
    want = jcurves.hash_to_curve(jcurve, b"test-seed", 32)
    assert [(int(x), int(y)) for x, y in got] == [(int(x), int(y)) for x, y in want]
    assert all(curves.on_curve(curve, int(x), int(y)) for x, y in got)
    assert (curve.base.modulus, curve.scalar.modulus, curve.b, curve.generator) == (
        jcurve.base.modulus, jcurve.scalar.modulus, jcurve.b, jcurve.generator)


@pytest.mark.parametrize("name", ["BN254_G1", "GRUMPKIN", "PALLAS"])
def test_host_curve_arithmetic_matches_jax(name):
    curve, jcurve = getattr(curves, name), getattr(jcurves, name)
    a, b = (tuple(int(c) for c in pt) for pt in curves.hash_to_curve(curve, b"host-ops", 2))
    rng = np.random.RandomState(7)
    for k in [0, 1, 2, curve.scalar.modulus - 1] + [int(rng.randint(1, 1 << 62)) for _ in range(3)]:
        assert curves.host_mul(curve, a, k) == jcurves.host_mul(jcurve, a, k)
    for p, q in ((a, b), (a, a), (a, (a[0], (-a[1]) % curve.base.modulus)), ((0, 0), b), (None, a)):
        assert curves.host_add(curve, p, q) == jcurves.host_add(jcurve, p, q)
    for p in (curve.base.modulus, curve.scalar.modulus):
        for v in [0, 1, 2, 3, 5] + [int(rng.randint(1, 1 << 62)) for _ in range(4)]:
            assert curves.sqrt_mod(v, p) == jcurves.sqrt_mod(v, p)


def test_scalar_mul_bits_matches_host():
    """The ladder over four BN254 points (one the identity) with the bits
    shared by every lane (scalar_mul_bits), and with per-lane scalars as
    limbs (ec_ladder), against host arithmetic: its steps meet doubling
    (P + P) and identity lanes."""
    pts = [tuple(int(c) for c in pt) for pt in curves.hash_to_curve(curves.BN254_G1, b"ladder", 3)] + [(0, 0)]
    batch_pts = ec.affine_to_jacobian(pts)
    rng = np.random.RandomState(5)
    ks = [int(rng.randint(1, 1 << 62)) * (1 << 190) + 3 for _ in range(4)]
    shared = ec.scalar_mul_bits(batch_pts, [(ks[0] >> i) & 1 for i in range(254)])
    assert ec.jacobian_to_affine(shared) == [curves.host_mul(curves.BN254_G1, pt, ks[0]) for pt in pts]
    lanes = ec.ec_ladder(batch_pts, F.from_numpy_u32(F.ints_to_u32(ks)), 254)
    assert ec.jacobian_to_affine(lanes) == [curves.host_mul(curves.BN254_G1, pt, k) for pt, k in zip(pts, ks)]
    assert ec.jacobian_to_affine(ec.ec_neg(batch_pts)) == [
        (0, 0) if pt == (0, 0) else (pt[0], (-pt[1]) % FQ_MODULUS) for pt in pts]
    gen = ec.curve_generator(curves.BN254_G1, "cpu")
    assert ec.jacobian_to_affine(gen) == [(1, 2)]
    # grumpkin and the Pasta curves have device group ops too; a curve over
    # a field without kernels has none
    assert ec.jacobian_to_affine(ec.curve_generator(curves.GRUMPKIN, "cpu"), Fr) == [curves.GRUMPKIN.generator]
    assert ec.jacobian_to_affine(ec.curve_generator(curves.PALLAS, "cpu"), curves.Fp_pallas) == [
        curves.PALLAS.generator]
    no_kernels = F.FieldSpec(name="no_kernels", modulus=curves.PALLAS_MODULUS, kernel_id=None)
    with pytest.raises(ValueError):
        ec.curve_generator(curves.CurveSpec("no_kernels", no_kernels, curves.Fq_vesta, 5, curves.PALLAS.generator),
                           "cpu")
    assert MJ.host_batch_affine([MJ.host_jac_double((1, 2, 1), Fq.modulus)], Fq.modulus) == [
        curves.host_mul(curves.BN254_G1, (1, 2), 2)]


def test_small_cpu_plain_paths_match_limb_programs(monkeypatch):
    """The host-int plain paths of small CPU batches against the limb
    programs (HOST_PLAIN_ROWS 0), on rows with 0, 1, p - 1 and R mod p, and
    the complete add over its five cases (generic, P = Q, P = -Q, P = O,
    Q = O)."""
    rng = np.random.RandomState(9)
    pts = [tuple(int(c) for c in pt) for pt in curves.hash_to_curve(curves.BN254_G1, b"plain", 4)]
    jac = ec.affine_to_jacobian(pts)
    dbl = ec.ec_add_plain(jac, jac)  # Z != 1, so the P = Q lanes below are rescaled
    p_pts = {k: torch.cat([jac[k], dbl[k], jac[k], ec.identity_point(1)[k], jac[k][:1]]) for k in ec.COORDS}
    neg = ec.affine_to_jacobian([(x, (-y) % FQ_MODULUS) for x, y in pts])
    q_pts = {k: torch.cat([dbl[k][[1, 2, 3, 0]], dbl[k], neg[k], jac[k][:1], ec.identity_point(1)[k]])
             for k in ec.COORDS}
    rows = {}
    for spec in (Fr, Fq):
        vals = [0, 1, spec.modulus - 1, spec.R] + rand_fes(rng, 8)
        a, b = spec.encode(vals), spec.encode(vals[::-1])
        rows[spec.name] = (a, b, b[3])
    host = {name: [F.mont_mul_plain(spec, a, b), F.mont_mul_plain(spec, a, c), F.add_plain(spec, a, b),
                   F.sub_plain(spec, a, c), F.neg_plain(spec, a)]
            for spec, (name, (a, b, c)) in zip((Fr, Fq), rows.items())}
    host_ec = ec.ec_add_plain(p_pts, q_pts)
    monkeypatch.setattr(F, "HOST_PLAIN_ROWS", 0)
    for spec, (name, (a, b, c)) in zip((Fr, Fq), rows.items()):
        limb = [F.mont_mul_plain(spec, a, b), F.mont_mul_plain(spec, a, c), F.add_plain(spec, a, b),
                F.sub_plain(spec, a, c), F.neg_plain(spec, a)]
        assert all(torch.equal(x, y) for x, y in zip(host[name], limb))
    limb_ec = ec.ec_add_plain(p_pts, q_pts)
    assert all(torch.equal(host_ec[k], limb_ec[k]) for k in ec.COORDS)
