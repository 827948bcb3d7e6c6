"""Round programs past the round kernel's limits (piop/sum_check.py
``plan_round``) against the JAX package on the CPU: with MAX_LEAVES,
MAX_OPS or MAX_CONSTS set low the nv = 4 vanilla zero check and a GKR batch
are cut into chunks of whole terms and prove byte-equal; a GKR batch past
the real limits (100 grand products, 201 leaves) is byte-equal at nv = 4,
and at nv = 6 hashes to chip_smoke.SPLIT_SHA256, the JAX package's proof;
a right-deep expression lowers within the stack. Rounds past the kernel's
MAX_DEGREE (8) are split into chunks of points: the nv = 3 HyperPlonk proof
of a degree-9 zero check (chip_smoke.DEGREE9_SMALL) and a degree-17
sumcheck are byte-equal to the JAX package's (the lt_table(16, 2) Lasso
proof, degree 9 too, is in tests/test_torch_lasso_lt.py). A term that alone
passes a limit is evaluated with the field ops as the JAX package's chunked
round evaluation does (``evaluated_message``): the product of MAX_LEAVES + 1
tables (chip_smoke.WIDE at nv = 3, WIDE_SHA256) and terms past MAX_STACK,
MAX_OPS or MAX_CONSTS (set low), alone or beside K1's chunks and under a
mesh of 4 CPU shards, prove byte-equal, both packages' verifiers accepting
the port's proof."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import preprocessor as jpreprocessor
from halo2_lasso_tpu.expression import Expression as JExpression
from halo2_lasso_tpu.expression import Query as JQuery
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.piop import gkr as jgkr
from halo2_lasso_tpu.piop import sum_check as jsc
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor
from halo2_lasso_tpu_torch.expression import Expression, Query, evaluate_host, from_foreign
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.parallel import sharding
from halo2_lasso_tpu_torch.piop import gkr
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

P = Fr.modulus
NV = 4
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(1607)

# limits below the nv = 4 vanilla zero check's (17 leaves, 93 ops, 4
# constants; its largest term 10 leaves, 60 ops, 2 constants) and a GKR
# batch of 6's (13 leaves, 53 ops)
ZERO_CHECK_LIMITS = [("MAX_LEAVES", 12), ("MAX_OPS", 64), ("MAX_CONSTS", 2)]
GKR_LIMITS = [("MAX_LEAVES", 8), ("MAX_OPS", 20)]


def rand_fes(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


@pytest.fixture
def low_limit(request, monkeypatch):
    """One of the kernel's limits set low, and the plan cache emptied."""
    name, value = request.param
    monkeypatch.setattr(sc, name, value)
    monkeypatch.setattr(sc, "_PLANS", {})
    return request.param


def zero_check_case():
    """The nv = 4 vanilla plonk circuit's composed zero-check expression in
    both packages, with random polys, challenges and point."""
    jci, _ = jfixtures.rand_vanilla_plonk_circuit(NV, np.random.RandomState(42), np.random.RandomState(43))
    _, jexpr = jpreprocessor.compose(jci)
    ci, _ = fixtures.rand_vanilla_plonk_circuit(NV, np.random.RandomState(42), np.random.RandomState(43))
    _, expr = preprocessor.compose(ci)
    assert expr.structural_key == jexpr.structural_key
    n_polys = 1 + max(q.poly for q in expr.used_query)
    n_chal = 1 + max(expr.used_challenge)
    return expr, jexpr, n_polys, n_chal


def sumcheck_both(expr, jexpr, n_polys, n_chal, k=NV):
    """(port proof, JAX proof) of one sumcheck on the same random inputs;
    the port's also verified by both packages' verifiers."""
    polys = [rand_fes(1 << k) for _ in range(n_polys)]
    chals, y, claim = rand_fes(n_chal), rand_fes(k), rand_fes(1)[0]
    jt = JTranscript(P)
    jpolys = [jnp.asarray(JFr.encode(v)) for v in polys]
    jout = jsc.prove(JFr, k, jsc.VirtualPolynomial(jexpr, jpolys, chals, [y]), claim, jt)
    tt = Keccak256Transcript(P)
    tpolys = [F.from_jax_limbs(np.asarray(v)) for v in jpolys]
    out = sc.prove(Fr, k, sc.VirtualPolynomial(expr, tpolys, chals, [y]), claim, tt)
    assert out == jout
    return tt.into_proof(), jt.into_proof()


def hypercube_sum(expr, k, polys, chals, y):
    """The expression's sum over the hypercube, on host ints."""
    seq = BooleanHypercube(k).iter_indices()
    total = 0
    for b in range(1 << k):
        def leaf(kind, arg):
            if kind == "poly":
                return polys[arg.poly][b]
            if kind == "eq_xy":
                return mle.eq_xy_eval_host(P, [(b >> i) & 1 for i in range(k)], y)
            if kind == "identity":
                return b
            return int(b == int(seq[arg % (1 << k)]))

        total += evaluate_host(expr, P, leaf, chals)
    return total % P


def both_verifiers_accept(expr, jexpr, k, claim, proof, tpolys, out, chals=(), y=()):
    """Both packages' verifiers read the port's proof to the prover's
    challenges, and its final evaluation is the expression at the tables'
    own evaluations there (which the prover's equal)."""
    final, xs = sc.verify(P, k, expr.degree, claim, Keccak256Transcript(P, proof=proof))
    assert jsc.verify(P, k, jexpr.degree, claim, JTranscript(P, proof=proof)) == (final, xs)
    own = mle.evaluate_stacked_ints(Fr, tpolys, xs)
    assert (xs, own) == tuple(out)
    ys = [list(y)] if y else []
    assert final == sc.evaluate_at_point(expr, P, k, {Query(i): v for i, v in enumerate(own)}, chals, ys, xs)
    assert final == jsc.evaluate_at_point(jexpr, P, k, {JQuery(i): v for i, v in enumerate(own)}, chals, ys, xs)


def sumcheck_verified(expr, jexpr, n_polys, n_chal, k=NV, mesh=None):
    """``sumcheck_both`` on the true claim: the port's proof (under `mesh`
    when given) byte-equal to the JAX package's, and accepted by both
    packages' verifiers."""
    polys = [rand_fes(1 << k) for _ in range(n_polys)]
    chals, y = rand_fes(n_chal), rand_fes(k)
    claim = hypercube_sum(expr, k, polys, chals, y)
    jt = JTranscript(P)
    jpolys = [jnp.asarray(JFr.encode(v)) for v in polys]
    jout = jsc.prove(JFr, k, jsc.VirtualPolynomial(jexpr, jpolys, chals, [y]), claim, jt)
    tt = Keccak256Transcript(P)
    tpolys = [F.from_jax_limbs(np.asarray(v)) for v in jpolys]
    if mesh is None:
        out = sc.prove(Fr, k, sc.VirtualPolynomial(expr, tpolys, chals, [y]), claim, tt)
    else:
        with sharding.use_mesh(mesh):
            out = sc.prove(Fr, k, sc.VirtualPolynomial(expr, tpolys, chals, [y]), claim, tt)
    assert out == jout
    proof = tt.into_proof()
    assert proof == jt.into_proof()
    both_verifiers_accept(expr, jexpr, k, claim, proof, tpolys, out, chals, y)


def gkr_both(b, k=NV, seed=5):
    """(port proof, JAX proof) of a pure grand-product GKR batch of b."""
    rng = np.random.RandomState(seed)
    vals = rng.randint(1, 1 << 62, size=(b, 1 << k), dtype=np.int64)
    jt = JTranscript(P)
    jqs = [jnp.asarray(JFr.encode([int(v) for v in row])) for row in vals]
    jout = jgkr.prove_fractional_sum_check([0] * b, [None] * b, [None] * b, jqs, jt)
    tt = Keccak256Transcript(P)
    out = gkr.prove_fractional_sum_check([0] * b, [None] * b, [None] * b, list(F.encode_dev(Fr, vals)), tt)
    assert out == jout
    proof = tt.into_proof()
    assert gkr.verify_fractional_sum_check(k, [0] * b, [None] * b, Keccak256Transcript(P, proof=proof))[:3] == out[:3]
    return proof, jt.into_proof()


@pytest.mark.parametrize("low_limit", ZERO_CHECK_LIMITS, indirect=True, ids=lambda v: v[0])
def test_split_zero_check_matches_jax(low_limit):
    expr, jexpr, n_polys, n_chal = zero_check_case()
    plan = sc.plan_round(expr, sc._leaf_keys(expr, n_polys), P, n_chal)
    assert plan.program is None and len(plan.chunks) > 1
    for c in plan.chunks:
        assert len(c.leaves) <= sc.MAX_LEAVES and len(c.program.ops) <= sc.MAX_OPS
        assert len(c.program.consts) <= sc.MAX_CONSTS and c.program.max_stack <= sc.MAX_STACK
    proof, jproof = sumcheck_both(expr, jexpr, n_polys, n_chal)
    assert proof == jproof


@pytest.mark.parametrize("low_limit", GKR_LIMITS, indirect=True, ids=lambda v: v[0])
def test_split_gkr_batch_matches_jax(low_limit):
    expr = gkr.sum_check_expression_pure(6)
    assert len(sc.plan_round(expr, sc._leaf_keys(expr, 12), P, 1).chunks) > 1
    proof, jproof = gkr_both(6)
    assert proof == jproof


def test_gkr_batch_past_the_real_limits_matches_jax():
    """100 grand products: 201 leaves and 1,000 ops a round, two chunks."""
    expr = gkr.sum_check_expression_pure(100)
    keys = sc._leaf_keys(expr, 200)
    assert len(keys) > sc.MAX_LEAVES and len(sc._lower(expr, keys).ops) > sc.MAX_OPS
    plan = sc.plan_round(expr, keys, P, 1)
    assert plan.program is None and len(plan.chunks) == 2
    proof, jproof = gkr_both(100)
    assert proof == jproof


def test_split_golden_is_the_jax_packages():
    """The smoke's split GKR batch at nv = 6: the JAX package's proof hash
    is chip_smoke.SPLIT_SHA256, and the port's CPU proof is the same."""
    cfg = chip_smoke.SPLIT_GKR
    vals = chip_smoke.split_gkr_inputs(np, cfg, 6)
    b = cfg["products"]
    jt = JTranscript(P)
    jgkr.prove_fractional_sum_check([0] * b, [None] * b, [None] * b,
                                    [jnp.asarray(JFr.encode([int(v) for v in row])) for row in vals], jt)
    assert hashlib.sha256(jt.into_proof()).hexdigest() == chip_smoke.SPLIT_SHA256
    proof, _ = chip_smoke.split_gkr_proof(np, cfg, "cpu", 6)
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.SPLIT_SHA256


def _left_first_stack(e) -> int:
    """The stack the program of `e` needs with every child emitted left
    first (the order before the deeper-first rule)."""
    if e.kind in ("neg", "scaled"):
        return _left_first_stack(e.args[0])
    if e.kind in ("sum", "product"):
        return max(_left_first_stack(e.args[0]), 1 + _left_first_stack(e.args[1]))
    return 1


def right_deep(E):
    """eq * (p0 q0 + (p1 q1 + (... + p7 q7))): right-deep, degree 3."""
    acc = E.poly(14) * E.poly(15)
    for i in range(6, -1, -1):
        acc = E.poly(2 * i) * E.poly(2 * i + 1) + acc
    return E.eq_xy(0) * acc


def test_right_deep_expression_fits_the_stack():
    expr, jexpr = right_deep(Expression), right_deep(JExpression)
    assert _left_first_stack(expr) == 10
    prog = sc.lower_expression(expr, sc._leaf_keys(expr, 16))
    assert prog.max_stack <= sc.MAX_STACK
    assert sc.plan_round(expr, sc._leaf_keys(expr, 16), P, 0).program is prog
    proof, jproof = sumcheck_both(expr, jexpr, 16, 0)
    assert proof == jproof


def test_too_deep_term_is_reported(monkeypatch):
    """A program that still needs more than MAX_STACK (set to 2 here) is
    refused by ``lower_expression`` with its depth named (no prove calls
    it: plan_round lowers with ``_lower``), and a term that alone does not
    fit is planned as an evaluated term, not refused."""
    monkeypatch.setattr(sc, "MAX_STACK", 2)
    monkeypatch.setattr(sc, "_PLANS", {})
    expr = right_deep(Expression)
    E = Expression
    with pytest.raises(sc.SumcheckError, match="depth 3 needs a stack of 3"):
        sc.lower_expression(E.poly(0) * E.poly(1) + E.poly(2) * E.poly(3), [("poly", i, 0) for i in range(4)])
    plan = sc.plan_round(expr, sc._leaf_keys(expr, 16), P, 0)
    assert plan.chunks == () and [e.term.structural_key for e in plan.evaluated] == [expr.structural_key]
    assert plan.evaluated[0].leaves == tuple(range(17)) and plan.evaluated[0].row == 0


def test_degree9_gate_proof_matches_jax():
    """The nv = 3 vanilla circuit with its first gate raised to degree 8
    (chip_smoke.DEGREE9_SMALL): a zero check of degree 9, two chunks of
    points a round (1..8 and 9). The port's proof on the CPU is the JAX
    package's, whose hash is chip_smoke.DEGREE9_SHA256."""
    from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
    from halo2_lasso_tpu.backend.hyperplonk import new_transcript as jnew_transcript

    cfg = chip_smoke.DEGREE9_SMALL
    rngs = [np.random.RandomState(s) for s in cfg["seeds"]]
    jci, jcirc = jfixtures.rand_vanilla_plonk_circuit(cfg["num_vars"], *rngs)
    jci = chip_smoke.raise_gate(jci, JExpression, cfg["gate_degree"])
    assert jpreprocessor.compose(jci)[1].degree == 9
    jparam = JHyperPlonk.setup(jci, np.random.RandomState(cfg["setup_seed"]))
    jpp, _ = JHyperPlonk.preprocess(jparam, jci)
    jt = jnew_transcript()
    JHyperPlonk.prove(jpp, jcirc, jt)
    jproof = jt.into_proof()
    ci, _ = chip_smoke.make_circuit(np, cfg)
    expr = preprocessor.compose(ci)[1]
    assert expr.degree == 9 and sc.point_chunks(expr.degree) == ((0, 8), (8, 1))
    proof, _ = chip_smoke.hyperplonk_proof(np, cfg, "cpu")
    assert proof == jproof
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.DEGREE9_SHA256


def degree17(E):
    """eq * p0 p1 ... p15 over four polys: degree 17, three chunks of
    points a round (1..8, 9..16, 17)."""
    acc = E.eq_xy(0)
    for i in range(16):
        acc = acc * E.poly(i % 4)
    return acc


def test_degree17_sumcheck_matches_jax():
    expr, jexpr = degree17(Expression), degree17(JExpression)
    assert expr.degree == 17
    plan = sc.plan_round(expr, sc._leaf_keys(expr, 4), P, 0)
    assert plan.program is not None and plan.points == ((0, 8), (8, 8), (16, 1))
    proof, jproof = sumcheck_both(expr, jexpr, 4, 0)
    assert proof == jproof


def test_single_product_past_max_leaves_matches_jax():
    """One product of MAX_LEAVES + 1 (129) tables, a term that no split of
    terms or points can cut, at nv = 3 (chip_smoke.WIDE's twin): one
    evaluated term of 128 products a point, the proof the JAX package's
    (WIDE_SHA256), both verifiers accepting it."""
    cfg = {**chip_smoke.WIDE, "num_vars": 3}
    expr = chip_smoke.wide_product(Expression, cfg["tables"])
    jexpr = chip_smoke.wide_product(JExpression, cfg["tables"])
    keys = sc._leaf_keys(expr, sc.MAX_LEAVES + 1)
    assert cfg["tables"] == len(keys) == sc.MAX_LEAVES + 1
    plan = sc.plan_round(expr, keys, P, 0)
    assert plan.program is None and plan.chunks == () and len(plan.points) == 17
    assert [(e.leaves, e.field_ops) for e in plan.evaluated] == [(tuple(range(129)), 128)]
    extra = {}
    proof, _ = chip_smoke.wide_product_proof(np, cfg, "cpu", tamper=True, extra=extra)
    vals = chip_smoke.wide_product_inputs(np, cfg, 3)
    jt = JTranscript(P)
    jpolys = [jnp.asarray(JFr.encode([int(v) for v in row])) for row in vals]
    jout = jsc.prove(JFr, 3, jsc.VirtualPolynomial(jexpr, jpolys, [], []), extra["claim"], jt)
    assert proof == jt.into_proof()
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.WIDE_SHA256
    assert extra["claim"] == hypercube_sum(expr, 3, [[int(v) for v in row] for row in vals], [], [])
    both_verifiers_accept(expr, jexpr, 3, extra["claim"], proof, list(F.encode_dev(Fr, vals)), jout)


def past_a_limit(E, name):
    """(expression, polys, challenges) of each case: a term past MAX_STACK
    (a balanced product under eq, a stack of 3), MAX_OPS (the identity
    times a product of ten tables, one with a challenge added: 25 ops),
    MAX_CONSTS (three constants beside a Lagrange column), and beside K1's
    chunks ("mixed": a product of ten tables of degree 10, two chunks of
    points, weighted by a challenge, and two small terms in one chunk)."""
    p = [E.poly(i) for i in range(10)]
    if name == "MAX_STACK":
        return E.eq_xy(0) * ((p[0] * p[1]) * (p[2] * p[3])), 4, 0
    if name == "MAX_OPS":
        acc = E.identity() * (p[0] + E.challenge(0))
        for q in p[1:]:
            acc = acc * q
        return acc, 10, 1
    if name == "MAX_CONSTS":
        return E.lagrange(1) * (p[0] + 3) * (p[1] - 5) * (p[2] * 7), 3, 0
    acc = p[0]
    for q in p[1:]:
        acc = acc * q
    return E.challenge(0) * acc + E.eq_xy(0) * p[0] * p[1] + E.challenge(1) * p[2] * p[3], 10, 2


PAST_A_LIMIT = [("MAX_STACK", 2), ("MAX_OPS", 20), ("MAX_CONSTS", 2), ("MAX_LEAVES", 8)]


@pytest.mark.parametrize("low_limit", PAST_A_LIMIT, indirect=True,
                         ids=["MAX_STACK", "MAX_OPS", "MAX_CONSTS", "mixed"])
def test_term_past_a_limit_matches_jax(low_limit):
    name = "mixed" if low_limit[0] == "MAX_LEAVES" else low_limit[0]
    expr, n_polys, n_chal = past_a_limit(Expression, name)
    plan = sc.plan_round(expr, sc._leaf_keys(expr, n_polys), P, n_chal)
    assert plan.program is None and len(plan.evaluated) == 1
    if name == "mixed":
        assert len(plan.chunks) == 1 and plan.points == ((0, 8), (8, 2)) and plan.evaluated[0].row == n_chal
    else:
        assert plan.chunks == ()
    for c in plan.chunks:
        assert len(c.leaves) <= sc.MAX_LEAVES and len(c.program.ops) <= sc.MAX_OPS
    sumcheck_verified(expr, past_a_limit(JExpression, name)[0], n_polys, n_chal)


def test_evaluated_term_under_cpu_mesh_matches_jax(monkeypatch):
    """The mixed case under a mesh of 4 CPU shards: its evaluated term's
    message computed a shard at a time (2 pairs each) in the split rounds,
    the proof the JAX package's."""
    monkeypatch.setattr(sc, "MAX_LEAVES", 8)
    monkeypatch.setattr(sc, "_PLANS", {})
    rows = []
    real = sc.evaluated_message
    monkeypatch.setattr(sc, "evaluated_message", lambda spec, t, *a: rows.append(t[0].shape[0]) or real(spec, t, *a))
    expr, n_polys, n_chal = past_a_limit(Expression, "mixed")
    sumcheck_verified(expr, past_a_limit(JExpression, "mixed")[0], n_polys, n_chal,
                      mesh=sharding.Mesh(["cpu"] * 4))
    assert rows[:8] == [4] * 8 and 16 not in rows


def test_foreign_split_terms_match_jax():
    """split_challenge_terms of the composed zero check: the same terms and
    coefficients as the JAX package's."""
    from halo2_lasso_tpu.expression import split_challenge_terms as jsplit
    from halo2_lasso_tpu_torch.expression import split_challenge_terms

    expr, jexpr, _, _ = zero_check_case()
    got = [(c.structural_key, t.structural_key) for c, t in split_challenge_terms(expr, P)]
    want = [(from_foreign(c).structural_key, from_foreign(t).structural_key) for c, t in jsplit(jexpr, P)]
    assert got == want and len(got) > 1
