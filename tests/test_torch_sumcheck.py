"""Port sumcheck (halo2_lasso_tpu_torch.piop.sum_check) against the JAX
package on the CPU: round messages, full proof bytes at nv <= 6 for the
expressions of the Lasso path and the reference's own test expressions,
the degree-2 coefficient prover, and verification across packages. The
round kernel is held to its plain version on the card by
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.expression import Expression as JExpression
from halo2_lasso_tpu.lasso.tables import range_table as jrange_table
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.piop import gkr as jgkr
from halo2_lasso_tpu.piop import sum_check as jsc
from halo2_lasso_tpu.poly import multilinear as jmle
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.expression import Expression, evaluate_host
from halo2_lasso_tpu_torch.lasso.tables import range_table
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.piop import gkr
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(99)


def rand_fes(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


def build(E):
    """The test expressions, built with either package's Expression class."""
    return {
        "degree2": (4, 3, 1, E.eq_xy(0) * (E.poly(0) * E.poly(1) + E.challenge(0) * E.poly(2))),
        "lagrange_identity": (
            3, 2, 0,
            E.eq_xy(0) * (E.lagrange(1) * E.poly(0) + E.identity()) + E.poly(1) * E.poly(1),
        ),
        "powers_neg_scaled": (
            5, 3, 1,
            E.distribute_powers(
                [E.poly(0) * E.poly(1) - E.poly(2), (E.poly(0) * 7) - E.constant(5), -E.poly(1)],
                E.challenge(0),
            ) * E.eq_xy(0),
        ),
    }


CASES = ["degree2", "lagrange_identity", "powers_neg_scaled", "lasso_primary", "gkr_pure"]


def case(name):
    if name == "lasso_primary":
        return 6, 2, 0, Expression.eq_xy(0) * range_table(8, 4).g, JExpression.eq_xy(0) * jrange_table(8, 4).g
    if name == "gkr_pure":
        return 5, 4, 1, gkr.sum_check_expression_pure(2), jgkr.sum_check_expression_pure(2)
    k, n_polys, n_chal, e = build(Expression)[name]
    return k, n_polys, n_chal, e, build(JExpression)[name][3]


def hypercube_sum(expr, k, polys, chals, y):
    eq = [mle.eq_xy_eval_host(P, [(b >> i) & 1 for i in range(k)], y) for b in range(1 << k)]
    from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube

    seq = BooleanHypercube(k).iter_indices()

    def total():
        acc = 0
        for b in range(1 << k):
            def leaf(kind, arg):
                if kind == "poly":
                    return polys[arg.poly][b]
                if kind == "eq_xy":
                    return eq[b]
                if kind == "identity":
                    return b
                return 1 if b == int(seq[arg % (1 << k)]) else 0

            acc += evaluate_host(expr, P, leaf, chals)
        return acc % P

    return total()


@pytest.mark.parametrize("name", CASES)
def test_sumcheck_proof_bytes_match_jax(name):
    k, n_polys, n_chal, expr, jexpr = case(name)
    polys = [rand_fes(1 << k) for _ in range(n_polys)]
    chals, y = rand_fes(n_chal), rand_fes(k)
    claim = hypercube_sum(expr, k, polys, chals, y)

    jt = JTranscript(P)
    jpolys = [jnp.asarray(JFr.encode(v)) for v in polys]
    jx, jevals = jsc.prove(JFr, k, jsc.VirtualPolynomial(jexpr, jpolys, chals, [y]), claim, jt)
    jproof = jt.into_proof()

    tt = Keccak256Transcript(P)
    tpolys = [F.from_jax_limbs(np.asarray(p)) for p in jpolys]
    x, evals = sc.prove(Fr, k, sc.VirtualPolynomial(expr, tpolys, chals, [y]), claim, tt)
    proof = tt.into_proof()
    assert proof == jproof
    assert (x, evals) == (jx, jevals)

    # the port's verifier reads the JAX proof, the JAX verifier the port's
    x_eval, vx = sc.verify(P, k, expr.degree, claim, Keccak256Transcript(P, proof=jproof))
    jx_eval, jvx = jsc.verify(P, k, jexpr.degree, claim, JTranscript(P, proof=proof))
    assert (x_eval, vx) == (jx_eval, jvx)

    # first round message straight from the round kernel's wrapper
    keys = sc._leaf_keys(expr, n_polys)
    tables = [sc._leaf_table(Fr, key, sc.VirtualPolynomial(expr, tpolys, chals, [y]), k, "cpu") for key in keys]
    msg = sc.round_message(Fr, tables, sc.lower_expression(expr, keys), Fr.encode(chals) if chals else None, expr.degree)
    first = [int.from_bytes(jproof[32 * i : 32 * i + 32], "big") for i in range(1, expr.degree + 1)]
    assert Fr.decode_ints(msg) == first


@pytest.mark.parametrize("name", CASES)
def test_lowered_program_matches_evaluate_host(name):
    k, n_polys, n_chal, expr, _ = case(name)
    keys = sc._leaf_keys(expr, n_polys)
    prog = sc.lower_expression(expr, keys)
    assert prog is sc.lower_expression(expr, keys)  # cached on the structural key
    vals = {key: rand_fes(1)[0] for key in keys}
    chals = rand_fes(n_chal)
    # two-entry tables: the round message at t = 1 is the program at the hi row
    tables = [Fr.encode([0, vals[key]]) for key in keys]
    got = Fr.decode_ints(sc.round_message_plain(Fr, tables, prog, Fr.encode(chals) if chals else None, 1))[0]

    def leaf(kind, arg):
        key = {"poly": lambda: ("poly", arg.poly, arg.rotation), "eq_xy": lambda: ("eq", arg),
               "identity": lambda: ("identity",), "lagrange": lambda: ("lagrange", arg)}[kind]()
        return vals[key]

    assert got == evaluate_host(expr, P, leaf, chals)


def test_coeff_sumcheck_matches_jax():
    k, T = 4, 3
    eqs = [jmle.eq_xy(JFr, jnp.asarray(JFr.encode(rand_fes(k)))) for _ in range(T)]
    polys = [jnp.asarray(JFr.encode(rand_fes(1 << k))) for _ in range(T)]
    scalars = rand_fes(T)
    claim = sum(
        s * sum(int(e) * int(p) for e, p in zip(JFr.decode(np.asarray(eq)), JFr.decode(np.asarray(po))))
        for s, eq, po in zip(scalars, eqs, polys)
    ) % P
    jt = JTranscript(P)
    jx, jfinal = jsc.prove_coeff_products(JFr, k, list(zip(scalars, eqs, polys)), claim, jt)
    tt = Keccak256Transcript(P)
    terms = [(s, F.from_jax_limbs(np.asarray(e)), F.from_jax_limbs(np.asarray(p))) for s, e, p in zip(scalars, eqs, polys)]
    x, final = sc.prove_coeff_products(Fr, k, terms, claim, tt)
    assert tt.into_proof() == jt.into_proof()
    assert x == jx
    assert [Fr.decode_ints(f) for f in final] == [[int(v) for v in JFr.decode(np.asarray(f))] for f in jfinal]
    assert sc.verify_coeff(P, k, 2, claim, Keccak256Transcript(P, proof=jt.into_proof())) == \
        jsc.verify_coeff(P, k, 2, claim, JTranscript(P, proof=jt.into_proof()))
