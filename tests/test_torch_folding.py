"""The port's folding helpers (halo2_lasso_tpu_torch.folding) and MLE
wrapper (poly/multilinear.py ``MLE``) against the JAX package on the CPU.

tests/test_folding.py's four tests, through the port, with its
parametrised r: the products split, the homogeneous relaxed expression,
the cross-term fold identity

    R(w1 + r*w2, c1 + r*c2, u1 + r*u2)
      = R(lhs) + sum_{j=1}^{d-1} r^j * T_j(lhs, rhs) + r^d * R(rhs),

and no cross terms for a linear constraint; each output also equals the
JAX package's as an ``expression_to_obj`` tree. The MLE wrapper's ints,
evaluations and sizes equal the JAX package's ``MLE``."""

import numpy as np
import pytest
import torch

from halo2_lasso_tpu import folding as jfolding
from halo2_lasso_tpu.expression import Expression as JExpression
from halo2_lasso_tpu.expression import expression_to_obj as j_to_obj
from halo2_lasso_tpu.poly.multilinear import MLE as JMLE
from halo2_lasso_tpu_torch.expression import Expression, evaluate_host, expression_to_obj
from halo2_lasso_tpu_torch.folding import (
    PolynomialSet,
    cross_term_expressions,
    folding_degree,
    products,
    relaxed_expression,
)
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu_torch.poly.multilinear import MLE

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores


def _constraint(E=Expression):
    # q * a * b + ch * a + b + 3   (q preprocess; a=1, b=2 folding; one challenge)
    q, a, b = E.poly(0), E.poly(1), E.poly(2)
    return q * a * b + E.challenge(0) * a + b + E.constant(3)


def _trees(prods, to_obj):
    return [(to_obj(p.preprocess), [to_obj(f) for f in p.foldees]) for p in prods]


def test_products_split():
    prods = products({0}, _constraint())
    assert sorted(p.folding_degree for p in prods) == [0, 1, 2, 2]
    assert folding_degree(prods) == 2
    (p2,) = [p for p in prods if p.preprocess.used_poly]
    assert p2.preprocess.used_poly == frozenset({0}) and p2.folding_degree == 2
    assert _trees(prods, expression_to_obj) == _trees(jfolding.products({0}, _constraint(JExpression)), j_to_obj)


def test_relaxed_expression_homogeneous():
    prods = products({0}, _constraint())
    relaxed = relaxed_expression(prods, u=1)
    assert {p.folding_degree for p in products({0}, relaxed)} == {2}
    jrelaxed = jfolding.relaxed_expression(jfolding.products({0}, _constraint(JExpression)), u=1)
    assert expression_to_obj(relaxed) == j_to_obj(jrelaxed)


@pytest.mark.parametrize("r", [0, 1, 2, 12345, P - 1])
def test_cross_term_fold_identity(r):
    prods = products({0}, _constraint())
    fd = folding_degree(prods)
    num_challenges = 1
    relaxed = relaxed_expression(prods, u=num_challenges)
    ts = cross_term_expressions(PolynomialSet(preprocess={0}, folding={1, 2}), prods, num_challenges)
    assert len(ts) == fd - 1
    jts = jfolding.cross_term_expressions(jfolding.PolynomialSet(preprocess={0}, folding={1, 2}),
                                          jfolding.products({0}, _constraint(JExpression)), num_challenges)
    assert [expression_to_obj(t) for t in ts] == [j_to_obj(t) for t in jts]

    q_val = 11
    lhs_w = {1: 1234567, 2: 7654321}
    rhs_w = {1: 1111, 2: 999999999}
    lhs_ch = [5, 17]  # [challenge, u]
    rhs_ch = [23, 29]

    def point_eval(expr, w, ch):
        def leaf(kind, arg):
            assert kind == "poly" and arg.rotation == 0
            return q_val if arg.poly == 0 else w[arg.poly]

        return evaluate_host(expr, P, leaf, ch)

    fold_w = {i: (lhs_w[i] + r * rhs_w[i]) % P for i in (1, 2)}
    fold_ch = [(a + r * b) % P for a, b in zip(lhs_ch, rhs_ch)]
    lhs_val = point_eval(relaxed, lhs_w, lhs_ch)
    rhs_val = point_eval(relaxed, rhs_w, rhs_ch)
    fold_val = point_eval(relaxed, fold_w, fold_ch)

    # cross terms live in the combined space [pre | lhs fold | rhs fold],
    # challenges [lhs ch, lhs u, rhs ch, rhs u]
    comb_w = {0: q_val, 1: lhs_w[1], 2: lhs_w[2], 3: rhs_w[1], 4: rhs_w[2]}
    comb_ch = lhs_ch + rhs_ch

    def comb_eval(expr):
        def leaf(kind, arg):
            assert kind == "poly" and arg.rotation == 0
            return comb_w[arg.poly]

        return evaluate_host(expr, P, leaf, comb_ch)

    expect = lhs_val
    for j, t in enumerate(ts, start=1):
        expect = (expect + pow(r, j, P) * comb_eval(t)) % P
    expect = (expect + pow(r, fd, P) * rhs_val) % P
    assert fold_val == expect


def test_cross_terms_no_constraint():
    assert cross_term_expressions(PolynomialSet(preprocess=set(), folding={0}), products(set(), Expression.poly(0)),
                                  0) == []
    assert jfolding.cross_term_expressions(jfolding.PolynomialSet(preprocess=set(), folding={0}),
                                           jfolding.products(set(), JExpression.poly(0)), 0) == []


@pytest.mark.parametrize("k", [0, 1, 5])
def test_mle_wrapper_matches_jax(k):
    rng = np.random.RandomState(40 + k)
    vals = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(1 << k)]
    x = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(k)]
    mine, theirs = MLE.from_ints(Fr, vals, device="cpu"), JMLE.from_ints(JFr, vals)
    assert (mine.num_vars, mine.to_ints(), mine.device.type) == (theirs.num_vars, theirs.to_ints(), "cpu")
    assert mine.evaluate_ints(x) == theirs.evaluate_ints(x)
    with pytest.raises(ValueError, match="2\\^k"):
        MLE(Fr, torch.zeros((3, 8), dtype=torch.int32))
