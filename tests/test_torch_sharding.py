"""The port's sharding (halo2_lasso_tpu_torch.parallel.sharding and the mesh
branches of piop/sum_check.py, piop/gkr.py and ops/msm_jacobian.py) against
the JAX package's (halo2_lasso_tpu/parallel/sharding.py, as
tests/test_sharding.py drives it) on the CPU.

The port runs on a mesh of D virtual CPU shards (``["cpu"] * D``, D = 2 and
4), the JAX package on the 4-device mesh tests/conftest.py provides; the
same numpy-seeded inputs go to both and every comparison is exact, as
canonical ints or proof bytes:

* sharded_sum_reduce, sharded_fix_var and the sharded round message of a
  degree-3 expression with a challenge and a hypercube-constant term (each
  shard adds c h_local, the total is c h);
* the sumcheck with a rotated query at k = 6 (test_sharding.py:122), the
  coefficient sumcheck and GKR's fractional sumcheck, under either mesh;
* the MSM's policy: under the mesh a BN254 G1 MSM splits from
  SHARD_MIN_POINTS points a shard on, grumpkin's never;
* a sumcheck whose table starts at the boundary (2^k == 2D): its first
  round takes one round message a shard, the rest one on the gathered
  tables;
* the nv = 4 vanilla proof under the mesh against the JAX package's proof,
  verified by both packages.

The full-feature proof under the mesh is
tests/test_torch_sharding_full_feature.py's, the MSM of 2^12 points split
over the mesh tests/test_torch_sharding_msm.py's. One module fixture makes
every JAX-side value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu.expression import Expression as JExpression
from halo2_lasso_tpu.ops import field as JF
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.parallel import sharding as jsh
from halo2_lasso_tpu.piop import gkr as jgkr
from halo2_lasso_tpu.piop import sum_check as jsc
from halo2_lasso_tpu.poly import multilinear as jmle
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, from_jax_hyperplonk_params, new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures
from halo2_lasso_tpu_torch.expression import Expression
from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fq, Fr
from halo2_lasso_tpu_torch.parallel import sharding as sh
from halo2_lasso_tpu_torch.piop import gkr
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

P = Fr.modulus
Q = FQ_MODULUS
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
SHARDS = [2, 4]
NV = 4  # the vanilla proof's (tests/test_sharding.py)
COEFF_K = 4  # the coefficient sumcheck's variables
GKR_K = 4  # variables of GKR's bottom layer


def rand_fes(rng, n, p=P):
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]


def port(jarr):
    return F.from_jax_limbs(np.asarray(jarr), "cpu")


def jints(jarr, spec=JFr):
    return [int(v) for v in spec.decode(np.asarray(jarr)).reshape(-1)]


def mesh_of(d):
    return sh.Mesh(["cpu"] * d)


def inputs():
    """Every case's inputs, from one seed (the JAX side and the port's)."""
    rng = np.random.RandomState(55)
    k = 6
    return {
        "sum": rand_fes(rng, 1 << 8),
        "fix": rand_fes(rng, 1 << 6),
        "x": rand_fes(rng, 1)[0],
        "round_polys": [rand_fes(rng, 1 << k) for _ in range(2)],
        "round_y": rand_fes(rng, k),
        "chal": rand_fes(rng, 1),
        "rot_polys": [rand_fes(rng, 1 << k) for _ in range(2)],
        "rot_y": rand_fes(rng, k),
        "coeff_eqs": [rand_fes(rng, COEFF_K) for _ in range(3)],
        "coeff_polys": [rand_fes(rng, 1 << COEFF_K) for _ in range(3)],
        "coeff_scalars": rand_fes(rng, 3),
        "gkr_ps": [rand_fes(rng, 1 << GKR_K) for _ in range(2)],
        "gkr_qs": [rand_fes(rng, 1 << GKR_K) for _ in range(2)],
    }


def round_expressions(E):
    """A degree-3 term with a challenge, and a hypercube constant."""
    c0 = E.challenge(0)
    return (E.poly(0) + c0) * E.poly(1) * E.eq_xy(0), c0 * 3 + E.constant(5)


def rotation_expression(E):
    return (E.poly(0, rotation=1) * E.poly(1) + E.poly(0)) * E.eq_xy(0)


def rotation_sum(polys, y, k):
    """The claim: sum over the hypercube of (p0(rot 1) p1 + p0) eq(y)."""
    rot = Fr.decode_ints(mle.rotate_evals(Fr, Fr.encode(polys[0]), 1))
    eq = [mle.eq_xy_eval_host(P, [(b >> i) & 1 for i in range(k)], y) for b in range(1 << k)]
    return sum((rot[b] * polys[1][b] + polys[0][b]) * eq[b] for b in range(1 << k)) % P


def coeff_claim(scalars, eqs, polys):
    return sum(s * sum(e * p for e, p in zip(eq, po)) for s, eq, po in zip(scalars, eqs, polys)) % P


@pytest.fixture(scope="module")
def data():
    return inputs()


@pytest.fixture(scope="module")
def jax_side(data):
    """Every JAX-side value: the sharded helpers on the 4-device mesh, the
    sumchecks under it, and the nv = 4 vanilla proof."""
    mesh = jsh.make_mesh(4)
    out = {}
    arr = jnp.asarray(JFr.encode(data["sum"]))
    out["sum"] = JF.decode_scalar(JFr, np.asarray(jsh.sharded_sum_reduce(JFr, mesh)(jsh.shard_evals(mesh, arr))))
    fix = jnp.asarray(JFr.encode(data["fix"]))
    xd = jnp.asarray(JFr.encode([data["x"]]))[0]
    out["fix"] = jints(jsh.sharded_fix_var(JFr, mesh)(jsh.shard_evals(mesh, fix), xd))

    main, const = round_expressions(JExpression)
    arrays = {("poly", i, 0): jnp.asarray(JFr.encode(p)) for i, p in enumerate(data["round_polys"])}
    arrays[("eq", 0)] = jmle.eq_xy(JFr, jnp.asarray(JFr.encode(data["round_y"])))
    fn = jsh.make_sharded_chunk_fn(JFr, mesh, [main, const], 3, 1)
    sums = fn({k: jsh.shard_evals(mesh, v) for k, v in arrays.items()},
              jsh.replicate(mesh, jnp.asarray(JFr.encode(data["chal"]))))
    out["round"] = [(jints(sums[t, 0])[0] + jints(sums[t, 1])[0]) % P for t in range(3)]

    k = 6
    expr = rotation_expression(JExpression)
    polys = [jnp.asarray(JFr.encode(p)) for p in data["rot_polys"]]
    tw = JTranscript(P, base_modulus=Q, curve_b=3)
    with jsh.use_mesh(mesh):
        jsc.prove(JFr, k, jsc.VirtualPolynomial(expr, polys, [], [data["rot_y"]]),
                  rotation_sum(data["rot_polys"], data["rot_y"], k), tw)
    out["rotation"] = tw.into_proof()

    eqs = [jmle.eq_xy(JFr, jnp.asarray(JFr.encode(y))) for y in data["coeff_eqs"]]
    eq_ints = [jints(e) for e in eqs]
    polys = [jnp.asarray(JFr.encode(p)) for p in data["coeff_polys"]]
    claim = coeff_claim(data["coeff_scalars"], eq_ints, data["coeff_polys"])
    tw = JTranscript(P)
    with jsh.use_mesh(mesh):
        jsc.prove_coeff_products(JFr, COEFF_K, list(zip(data["coeff_scalars"], eqs, polys)), claim, tw)
    out["coeff"] = (claim, eq_ints, tw.into_proof())

    for pure in (False, True):
        tw = JTranscript(P)
        ps = [None, None] if pure else [jnp.asarray(JFr.encode(p)) for p in data["gkr_ps"]]
        with jsh.use_mesh(mesh):
            jgkr.prove_fractional_sum_check([None, None], [None, None], ps,
                                            [jnp.asarray(JFr.encode(q)) for q in data["gkr_qs"]], tw)
        out[f"gkr_{pure}"] = tw.into_proof()

    ci, circ = jfixtures.rand_vanilla_plonk_circuit(NV, np.random.RandomState(NV), np.random.RandomState(100 + NV))
    jpp, jvp = JHyperPlonk.preprocess(JHyperPlonk.setup(ci, np.random.RandomState(0)), ci)
    tw = j_new_transcript()
    JHyperPlonk.prove(jpp, circ, tw)
    out["plonk"] = {"proof": tw.into_proof(), "pp": jpp, "vp": jvp, "circuit": circ}
    return out


@pytest.fixture(scope="module")
def port_plonk(jax_side):
    """The port's params of the nv = 4 vanilla circuit (carried from the JAX
    package's) and its circuit."""
    pp, vp = from_jax_hyperplonk_params(jax_side["plonk"]["pp"], jax_side["plonk"]["vp"], device="cpu")
    _, circ = fixtures.rand_vanilla_plonk_circuit(NV, np.random.RandomState(NV), np.random.RandomState(100 + NV))
    return pp, vp, circ


@pytest.fixture
def launches(monkeypatch):
    """Calls of the round message (K1) and the fold (K2) by table length."""
    seen = {"round": [], "fold": []}
    round_message, fold_all = sc.round_message, mle.fold_all

    def counted_round(spec, tables, *args):
        seen["round"].append(tables[0].shape[0])
        return round_message(spec, tables, *args)

    def counted_fold(spec, tables, *args, **kw):
        seen["fold"].append(tables[0].shape[0])
        return fold_all(spec, tables, *args, **kw)

    monkeypatch.setattr(sc, "round_message", counted_round)
    monkeypatch.setattr(mle, "fold_all", counted_fold)
    return seen


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_sum_reduce_matches_jax(jax_side, data, d):
    mesh = mesh_of(d)
    parts = sh.shard_evals(mesh, Fr.encode(data["sum"]))
    assert len(parts) == d and all(p.shape[0] == 256 // d for p in parts)
    assert sh.sharded_sum_reduce(Fr, mesh, parts) == jax_side["sum"] == sum(data["sum"]) % P


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_fix_var_matches_jax(jax_side, data, d):
    mesh = mesh_of(d)
    t = Fr.encode(data["fix"])
    got = sh.replicate(mesh, sh.sharded_fix_var(Fr, mesh, sh.shard_evals(mesh, t), data["x"]))
    assert Fr.decode_ints(got) == jax_side["fix"] == Fr.decode_ints(mle.fold_all(Fr, [t], data["x"])[0])


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_round_with_constant_term_matches_jax(jax_side, data, d):
    """Each shard's round message adds the constant c over its own h_local
    pairs; the combined message is the single-device one (c h)."""
    mesh = mesh_of(d)
    main, const = round_expressions(Expression)
    expr = main + const
    keys = sc._leaf_keys(expr, 2)
    tables = [Fr.encode(p) for p in data["round_polys"]] + [mle.eq_xy(Fr, data["round_y"], "cpu")]
    program = sc.lower_expression(expr, keys)
    chal = Fr.encode(data["chal"])
    shards = zip(*(mesh.split(t) for t in tables))
    got = mesh.combine(Fr, [sc.round_message(Fr, list(s), program, chal, 3) for s in shards])
    assert got == jax_side["round"] == Fr.decode_ints(sc.round_message(Fr, tables, program, chal, 3))


def port_rotation_proof(data, mesh):
    k = 6
    vp = sc.VirtualPolynomial(rotation_expression(Expression), [Fr.encode(p) for p in data["rot_polys"]], [],
                              [data["rot_y"]])
    tw = Keccak256Transcript(P, base_modulus=Q, curve_b=3)
    with sh.use_mesh(mesh):
        sc.prove(Fr, k, vp, rotation_sum(data["rot_polys"], data["rot_y"], k), tw)
    return tw.into_proof()


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_rotation_sumcheck_matches_jax(jax_side, data, d, launches):
    got = port_rotation_proof(data, mesh_of(d))
    assert got == jax_side["rotation"]
    # rounds split while the tables hold 2D rows: D round messages each, then one
    split = [n for n in (64, 32, 16, 8, 4) if n >= 2 * d]
    assert launches["round"] == [n // d for n in split for _ in range(d)] + [n for n in (64, 32, 16, 8, 4, 2)
                                                                            if n < 2 * d]
    assert got == port_rotation_proof(data, mesh_of(1))


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_coeff_sumcheck_matches_jax(jax_side, data, d, launches):
    claim, eq_ints, want = jax_side["coeff"]
    terms = [(s, Fr.encode(e), Fr.encode(p)) for s, e, p in zip(data["coeff_scalars"], eq_ints, data["coeff_polys"])]
    tw = Keccak256Transcript(P)
    with sh.use_mesh(mesh_of(d)):
        x, final = sc.prove_coeff_products(Fr, COEFF_K, terms, claim, tw)
    assert tw.into_proof() == want
    assert launches["fold"][:d] == [(1 << COEFF_K) // d] * d  # the first fold on each shard
    tt = Keccak256Transcript(P)
    x1, final1 = sc.prove_coeff_products(Fr, COEFF_K, terms, claim, tt)
    assert x == x1 and [Fr.decode_ints(f) for f in final] == [Fr.decode_ints(f) for f in final1]


@pytest.mark.parametrize("pure", [False, True], ids=["fractional", "grand_product"])
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_gkr_matches_jax(jax_side, data, d, pure, launches):
    """GKR's layers built and proved on each shard, their halves split over
    the mesh again, give the JAX package's bytes."""
    tw = Keccak256Transcript(P)
    ps = [None, None] if pure else [Fr.encode(p) for p in data["gkr_ps"]]
    with sh.use_mesh(mesh_of(d)):
        gkr.prove_fractional_sum_check([None, None], [None, None], ps, [Fr.encode(q) for q in data["gkr_qs"]], tw)
    assert tw.into_proof() == jax_side[f"gkr_{pure}"]
    bottom = 1 << (GKR_K - 1)  # the bottom layer's quadrants: its sumcheck's first round on each shard
    assert launches["round"].count(bottom // d) >= d


def test_msm_splits_under_the_active_mesh_above_its_policy(monkeypatch):
    """Under use_mesh a BN254 G1 MSM splits at SHARD_MIN_POINTS points a
    shard and not below; grumpkin's (base Fr) never does."""
    calls = []
    planes = MJ.msm_planes
    monkeypatch.setattr(MJ, "msm_planes", lambda pts, s, *a: calls.append(s.shape[0]) or planes(pts, s, *a))
    monkeypatch.setattr(MJ, "SHARD_MIN_POINTS", 4)
    rng = np.random.RandomState(9)
    pts = ec.affine_to_jacobian([(1, 2)] * 8, "cpu", Fq)
    scal = Fr.encode(rand_fes(rng, 8))
    with sh.use_mesh(mesh_of(2)):
        split = MJ.msm(pts, scal)
        whole = MJ.msm({c: v[:4] for c, v in pts.items()}, scal[:4])
    assert calls == [4, 4, 4]
    assert MJ.host_batch_affine([split], Q) == MJ.host_batch_affine([MJ.msm(pts, scal)], Q)
    assert MJ.host_batch_affine([whole], Q) == MJ.host_batch_affine([MJ.msm({c: v[:4] for c, v in pts.items()},
                                                                            scal[:4])], Q)
    grumpkin = ec.affine_to_jacobian([curves.GRUMPKIN_GEN] * 8, "cpu", Fr)
    with sh.use_mesh(mesh_of(2)):
        MJ.msm(grumpkin, Fq.encode(rand_fes(rng, 8, Fq.modulus)), Fr, Fq)
    assert calls[-1] == 8


@pytest.mark.parametrize("d", SHARDS)
def test_rounds_at_the_split_boundary(jax_side, data, d, launches):
    """A table of exactly 2D rows: the first round one message a shard (one
    pair each), then the tables gathered and one message a round."""
    k = d.bit_length()  # 2^k == 2D
    polys = [Fr.encode(p[: 1 << k]) for p in data["round_polys"]]
    main, _ = round_expressions(Expression)
    vp = sc.VirtualPolynomial(main, polys, data["chal"], [data["round_y"][:k]])
    eq = [mle.eq_xy_eval_host(P, [(b >> i) & 1 for i in range(k)], data["round_y"][:k]) for b in range(1 << k)]
    a, b = data["round_polys"]
    claim = sum((a[i] + data["chal"][0]) * b[i] * eq[i] for i in range(1 << k)) % P
    proofs = []
    for mesh in (mesh_of(d), None):
        tw = Keccak256Transcript(P)
        if mesh is None:
            sc.prove(Fr, k, vp, claim, tw)
        else:
            with sh.use_mesh(mesh):
                sc.prove(Fr, k, vp, claim, tw)
        proofs.append(tw.into_proof())
    assert launches["round"][: d + k - 1] == [2] * d + [2 * d >> r for r in range(1, k)]
    jexpr = round_expressions(JExpression)[0]
    jvp = jsc.VirtualPolynomial(jexpr, [jnp.asarray(JFr.encode(p[: 1 << k])) for p in data["round_polys"]],
                                data["chal"], [data["round_y"][:k]])
    tw = JTranscript(P)
    jsc.prove(JFr, k, jvp, claim, tw)
    assert proofs[0] == proofs[1] == tw.into_proof()


@pytest.mark.parametrize("d", SHARDS)
def test_vanilla_proof_under_mesh_matches_jax(jax_side, port_plonk, d, launches):
    pp, vp, circ = port_plonk
    tw = new_transcript()
    with sh.use_mesh(mesh_of(d)):
        HyperPlonk.prove(pp, circ, tw)
    proof = tw.into_proof()
    assert proof == jax_side["plonk"]["proof"]
    assert launches["round"].count(16 // d) >= d  # the zero check's first round, on each shard
    HyperPlonk.verify(vp, circ.instances(), new_transcript(proof))
    JHyperPlonk.verify(jax_side["plonk"]["vp"], jax_side["plonk"]["circuit"].instances(), j_new_transcript(proof))


def test_mesh_refuses_what_it_cannot_split():
    with pytest.raises(ValueError):
        sh.Mesh(["cpu"] * 3)
    with pytest.raises(ValueError):
        sh.Mesh([])
    with pytest.raises(ValueError):
        mesh_of(4).split(Fr.encode([1] * 6))
    with pytest.raises(RuntimeError):  # no CUDA device here: never a CPU shard instead
        sh.make_mesh(1)


def test_active_mesh_is_the_innermost_of_more_than_one_shard():
    assert sh.active_mesh() is None
    two, one = mesh_of(2), mesh_of(1)
    with sh.use_mesh(two):
        assert sh.active_mesh() is two
        with sh.use_mesh(one):
            assert sh.active_mesh() is None
        assert sh.active_mesh() is two
    assert sh.active_mesh() is None


@pytest.mark.parametrize("d", SHARDS)
def test_halves_split_again_over_every_shard(d):
    """A split (b, m, 8) stack's halves on its highest variable, each split
    over all D shards, are the whole table's halves."""
    mesh = mesh_of(d)
    st = Fr.encode(np.arange(3 * 4 * d).reshape(3, 4 * d) % 97)
    low, high = mesh.halves(mesh.split(st, 1), 1)
    assert torch.equal(mesh.gather(low, 1), st[:, : 2 * d]) and torch.equal(mesh.gather(high, 1), st[:, 2 * d :])
    assert all(p.shape == (3, 2, 8) for p in low + high)
