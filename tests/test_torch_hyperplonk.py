"""Port HyperPlonk (halo2_lasso_tpu_torch.backend.hyperplonk) against the JAX
package on the CPU.

* The port's vanilla plonk proof at nv = 3 (seeds 42 / 43, setup seed 0) is
  the golden proof that tests/test_golden_proof.py pins for the JAX package.
* At nv = 4 the vanilla-with-lookup proof is byte-equal to the JAX
  package's live proof for the same seeds and the same preprocessed state
  (carried across by from_jax_hyperplonk_params); each package verifies the
  other's proof; a tampered proof is rejected.
* The fixtures, compose(), the rotation helpers, rotate_evals,
  evaluate_for_rotation, permutation_z_polys, lookup m / h polys and the
  composed expression's round message agree with the JAX package as
  canonical integers, exactly.
One JAX setup / preprocess / prove serves every test (module fixture)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import preprocessor as jpreprocessor
from halo2_lasso_tpu.backend.hyperplonk import prover as jprover
from halo2_lasso_tpu.expression import evaluate_host as j_evaluate_host
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.poly import bh as jbh
from halo2_lasso_tpu.poly import multilinear as jmle
from halo2_lasso_tpu_torch.backend import PlonkishCircuitInfo
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, from_jax_hyperplonk_params, new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor, prover
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.poly import bh
from halo2_lasso_tpu_torch.poly import multilinear as mle

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(41)

# tests/test_golden_proof.py: the JAX package's vanilla plonk proof at nv = 3
GOLDEN_LEN = 1760
GOLDEN_SHA256 = "c7716e87345611deed36d015513aecec8da288a8433e74610cf420cf687be3c0"
GOLDEN_HEAD = "234ce5fa052b5a0abb7f77f498818925810fb53717e987f9f57ea57a932fed10"
NV = 4  # the with-lookup case, a shape tests/test_hyperplonk.py compiles
SEEDS = (NV, 100 + NV)  # its preprocess / witness seeds at that nv
CIRCUITS = ["rand_vanilla_plonk_circuit", "rand_vanilla_plonk_with_lookup_circuit"]


def rand_fes(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


def to_port(jarr):
    return F.from_jax_limbs(np.asarray(jarr), "cpu")


def same(t, jarr):
    return np.array_equal(F.to_jax_limbs(t), np.asarray(jarr))


@pytest.fixture(scope="module")
def jax_lookup():
    """The JAX package's nv = 4 with-lookup circuit: params and proof."""
    ci, circ = jfixtures.rand_vanilla_plonk_with_lookup_circuit(
        NV, np.random.RandomState(SEEDS[0]), np.random.RandomState(SEEDS[1])
    )
    param = JHyperPlonk.setup(ci, np.random.RandomState(0))
    jpp, jvp = JHyperPlonk.preprocess(param, ci)
    t = j_new_transcript()
    JHyperPlonk.prove(jpp, circ, t)
    return {"proof": t.into_proof(), "pp": jpp, "vp": jvp, "circuit": circ}


@pytest.fixture(scope="module")
def port_lookup(jax_lookup):
    """The port's proof of the same circuit on the CPU, with the JAX
    package's preprocessed state."""
    pp, vp = from_jax_hyperplonk_params(jax_lookup["pp"], jax_lookup["vp"], device="cpu")
    _, circ = fixtures.rand_vanilla_plonk_with_lookup_circuit(
        NV, np.random.RandomState(SEEDS[0]), np.random.RandomState(SEEDS[1])
    )
    t = new_transcript()
    HyperPlonk.prove(pp, circ, t)
    return {"proof": t.into_proof(), "pp": pp, "vp": vp, "circuit": circ}


@pytest.fixture(scope="module")
def port_golden():
    """The port's own setup, preprocess and proof of the golden circuit."""
    ci, circ = fixtures.rand_vanilla_plonk_circuit(3, np.random.RandomState(42), np.random.RandomState(43))
    param = HyperPlonk.setup(ci, np.random.RandomState(0), device="cpu")
    pp, vp = HyperPlonk.preprocess(param, ci)
    t = new_transcript()
    HyperPlonk.prove(pp, circ, t)
    return t.into_proof(), vp, circ


def test_golden_proof_bytes(port_golden):
    proof = port_golden[0]
    assert len(proof) == GOLDEN_LEN
    assert proof[:32].hex() == GOLDEN_HEAD
    assert hashlib.sha256(proof).hexdigest() == GOLDEN_SHA256


def test_port_verifies_golden_proof(port_golden):
    proof, vp, circ = port_golden
    HyperPlonk.verify(vp, circ.instances(), new_transcript(proof))


def test_lookup_proof_bytes_match_jax(jax_lookup, port_lookup):
    assert port_lookup["proof"] == jax_lookup["proof"]


def test_port_verifies_jax_proof(jax_lookup, port_lookup):
    HyperPlonk.verify(port_lookup["vp"], port_lookup["circuit"].instances(), new_transcript(jax_lookup["proof"]))


def test_jax_verifies_port_proof(jax_lookup, port_lookup):
    JHyperPlonk.verify(jax_lookup["vp"], jax_lookup["circuit"].instances(), j_new_transcript(port_lookup["proof"]))


@pytest.mark.parametrize("where", ["witness_commitment", "zero_check", "opening"])
def test_tampered_proof_rejected(port_lookup, where):
    proof = port_lookup["proof"]
    at = {"witness_commitment": 70, "zero_check": len(proof) // 2, "opening": len(proof) - 40}[where]
    bad = bytearray(proof)
    bad[at] ^= 1
    with pytest.raises(Halo2LassoError):
        HyperPlonk.verify(port_lookup["vp"], port_lookup["circuit"].instances(), new_transcript(bytes(bad)))


def test_two_operand_lasso_lookup_with_one_input_refused():
    """A Lasso lookup whose two-operand table gets a single input is refused
    when the circuit is composed."""
    ci, _ = fixtures.rand_lasso_circuit(3, np.random.RandomState(1), np.random.RandomState(2))
    lk = ci.lasso_lookups[0]
    ci.lasso_lookups = [type(lk)(lk.table, lk.inputs[:1], lk.output)]
    with pytest.raises(Halo2LassoError, match="two operand"):
        preprocessor.compose(ci)


@pytest.mark.parametrize("name", CIRCUITS)
def test_fixtures_and_compose_match_jax(name):
    ci, circ = getattr(fixtures, name)(NV, np.random.RandomState(5), np.random.RandomState(6))
    jci, jcirc = getattr(jfixtures, name)(NV, np.random.RandomState(5), np.random.RandomState(6))
    assert ci.preprocess_polys == jci.preprocess_polys
    assert ci.permutations == jci.permutations
    assert circ.instances() == jcirc.instances()
    assert circ.synthesize(0, []) == jcirc.synthesize(0, [])
    assert [c.structural_key for c in ci.constraints] == [c.structural_key for c in jci.constraints]
    nz, expr = preprocessor.compose(ci)
    jnz, jexpr = jpreprocessor.compose(jci)
    assert (nz, expr.structural_key) == (jnz, jexpr.structural_key)
    assert preprocessor.batch_size(ci) == jpreprocessor.batch_size(jci)
    perm = ci.permutation_polys()
    got = preprocessor.permutation_polys_values(NV, perm, ci.permutations)
    want = jpreprocessor.permutation_polys_values(NV, perm, jci.permutations)
    assert [list(map(int, g)) for g in got] == [list(map(int, w)) for w in want]


@pytest.mark.parametrize("rotation", [-2, -1, 1, 3])
def test_rotation_helpers_match_jax(rotation):
    assert np.array_equal(bh.BooleanHypercube(NV).rotation_map(rotation), jbh.BooleanHypercube(NV).rotation_map(rotation))
    assert np.array_equal(bh.BooleanHypercube(NV).nth_map(), jbh.BooleanHypercube(NV).nth_map())
    x = rand_fes(NV)
    assert mle.rotation_eval_points(P, x, rotation) == jmle.rotation_eval_points(P, x, rotation)
    evals = rand_fes(1 << abs(rotation))
    assert mle.rotation_eval(P, x, rotation, evals) == jmle.rotation_eval(P, x, rotation, evals)
    jpoly = jnp.asarray(JFr.encode(rand_fes(1 << NV)))
    assert same(mle.rotate_evals(Fr, to_port(jpoly), rotation), jmle.rotate_evals(JFr, jpoly, rotation))


@pytest.mark.parametrize("rotation", [-1, 1])
def test_evaluate_for_rotation_matches_jax(rotation):
    jpoly = jnp.asarray(JFr.encode(rand_fes(1 << NV)))
    x = rand_fes(NV)
    got = mle.evaluate_for_rotation(Fr, to_port(jpoly), x, rotation)
    assert got == jmle.evaluate_for_rotation(JFr, jpoly, x, rotation)


def _jax_polys(jax_lookup):
    """instance + preprocess + witness polys of the nv = 4 circuit (JAX)."""
    jpp, circ = jax_lookup["pp"], jax_lookup["circuit"]
    inst = [jnp.asarray(JFr.encode(jprover.instance_poly_values(NV, i))) for i in circ.instances()]
    wit = [jnp.asarray(JFr.encode(c)) for c in circ.synthesize(0, [])]
    return inst + list(jpp.preprocess_polys) + wit


def test_permutation_z_polys_match_jax(jax_lookup, port_lookup):
    jpolys = _jax_polys(jax_lookup)
    beta, gamma = rand_fes(2)
    jpp, pp = jax_lookup["pp"], port_lookup["pp"]
    want = jprover.permutation_z_polys(jpp.num_permutation_z_polys, jpp.permutation_polys, jpolys, beta, gamma, spec=JFr)
    got = prover.permutation_z_polys(
        pp.num_permutation_z_polys, pp.permutation_polys, [to_port(p) for p in jpolys], beta, gamma, spec=Fr
    )
    assert len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))


def test_lookup_m_and_h_polys_match_jax(jax_lookup, port_lookup):
    jpolys = _jax_polys(jax_lookup)
    beta, gamma = rand_fes(2)
    betas = [pow(beta, i, P) for i in range(3)]
    jcomp = jprover.lookup_compressed_polys(jax_lookup["pp"].lookups, jpolys, [], betas, spec=JFr)
    comp = prover.lookup_compressed_polys(port_lookup["pp"].lookups, [to_port(p) for p in jpolys], [], betas, spec=Fr)
    assert all(same(a, ja) and same(b, jb) for (a, b), (ja, jb) in zip(comp, jcomp))
    jm, m = jprover.lookup_m_polys(jcomp, spec=JFr), prover.lookup_m_polys(comp, spec=Fr)
    assert all(same(a, b) for a, b in zip(m, jm))
    jh, h = jprover.lookup_h_polys(jcomp, jm, gamma, spec=JFr), prover.lookup_h_polys(comp, m, gamma, spec=Fr)
    assert all(same(a, b) for a, b in zip(h, jh))


def test_invalid_lookup_input_rejected():
    tbl = Fr.encode([5, 7, 7, 9])
    inp = Fr.encode([7, 9, 5, 11])
    with pytest.raises(prover.ProofError):
        prover.lookup_m_polys([(inp, tbl)])
    m = prover.lookup_m_polys([(Fr.encode([7, 9, 7, 7]), tbl)])[0]
    assert Fr.decode_ints(m) == [0, 0, 3, 1]  # the last index of a repeated value


def test_compose_round_message_matches_jax(jax_lookup, port_lookup):
    """The K1 program of the composed zero-check expression (plain path) at
    nv = 4 against the JAX package's host evaluator of the same expression
    over every pair, at t = 1..degree."""
    jexpr, expr = jax_lookup["pp"].expression, port_lookup["pp"].expression
    n_polys = 23 - 4  # 13 circuit + 3 sigma + m + h + z polys
    keys = sc._leaf_keys(expr, n_polys)
    assert len(keys) == 23 and keys[n_polys:] == [("poly", 18, 1), ("eq", 0), ("identity",), ("lagrange", 1)]
    prog = sc.lower_expression(expr, keys)
    assert prog.max_stack <= sc.MAX_STACK and expr.degree <= sc.MAX_DEGREE
    vals = [rand_fes(1 << NV) for _ in keys]
    chals = rand_fes(3)
    got = Fr.decode_ints(sc.round_message_plain(Fr, [Fr.encode(v) for v in vals], prog, Fr.encode(chals), expr.degree))

    def at(i, t):
        return {k: (v[2 * i + 1] + (t - 1) * (v[2 * i + 1] - v[2 * i])) % P for k, v in zip(keys, vals)}

    def leaf(row):
        def fn(kind, arg):
            if kind == "poly":
                return row[("poly", arg.poly, arg.rotation)]
            return row[{"eq_xy": ("eq", arg), "identity": ("identity",), "lagrange": ("lagrange", arg)}[kind]]
        return fn

    want = [
        sum(j_evaluate_host(jexpr, P, leaf(at(i, t)), chals) for i in range(1 << (NV - 1))) % P
        for t in range(1, expr.degree + 1)
    ]
    assert got == want
