"""Port circuit-builder frontend (halo2_lasso_tpu_torch.frontend) and
encode_dev against the JAX package on the CPU.

* Builder parity, no proofs: the copy circuit of
  tests/test_frontend.py::test_builder_e2e, the AND-lookup and two-phase
  builder circuits of the same file, arx_chain_circuit(4, 8, 4, 3) and
  arx_chain_circuit(5) (32-bit words) built by both packages' builders give
  the same circuit info (sizes, preprocessed values, constraints, lookups and
  Lasso tables by structural key, permutation cycles in order) and the same
  witness of every phase; _cycles_from_copies agrees on a seeded copy set
  given in shuffled order.
* Proof parity: arx_chain_circuit(4, 8, 4, 3) and the copy circuit at setup
  seed 0. The port's proof, made with the JAX package's preprocessed state
  (from_jax_hyperplonk_params), equals the JAX proof and hashes to
  chip_smoke.ARX_SMALL_SHA256 / BUILDER_SHA256; the port's own setup and
  preprocess give the same parameters (the ARX chain) or the same proof (the
  copy circuit); each package verifies the other's proof; a tampered proof is
  rejected.
* encode_dev and canonical_limbs give the limbs of spec.encode and of the
  JAX package's canonical_limbs / encode_dev on an int64 column, Python ints
  up to p - 1 and an empty column; a negative int64 column wraps to
  2^64 + x as in the JAX package, and a builder circuit with negative int64
  advice cells proves the same bytes in both packages.
* The ARX chain's zero check lowers to a round program with 11 constant
  slots, within K1's compiled limits.
All comparisons are exact. One JAX setup / preprocess / prove per circuit
serves every test (module fixtures).
"""

import ast
import hashlib
import pathlib
import random

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu.expression import Expression as JExpression
from halo2_lasso_tpu.frontend import arx as jarx
from halo2_lasso_tpu.frontend import builder as jbuilder
from halo2_lasso_tpu.lasso import tables as jtables
from halo2_lasso_tpu.ops import field as JF
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, from_jax_hyperplonk_params, new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk import preprocessor
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, from_foreign
from halo2_lasso_tpu_torch.frontend import arx, builder
from halo2_lasso_tpu_torch.lasso import tables
from halo2_lasso_tpu_torch.lasso.integration import LassoLookup
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.piop import sum_check as SC

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
PORT = (builder, Expression, tables)
JAX = (jbuilder, JExpression, jtables)


def copy_circuit(pkg):
    return chip_smoke.builder_copy_circuit(pkg[0].CircuitBuilder, P)


def and_lookup_circuit(pkg):
    """tests/test_frontend.py::test_builder_lasso_lookup's circuit."""
    bld, _, tbl = pkg
    b = bld.CircuitBuilder(3)
    x, y, z = (b.advice_column() for _ in range(3))
    b.max_degree = 4
    b.lasso_lookup("and", tbl.and_table(4, 2), lambda ctx: ((ctx.expr(x), ctx.expr(y)), ctx.expr(z)))
    xv = [5, 9, 15, 0, 3, 7, 1, 2]
    yv = [3, 12, 15, 0, 1, 7, 0, 2]
    return b.build({}, lambda phase, ch: [xv, yv, [a & c for a, c in zip(xv, yv)]], [])


def two_phase_circuit(pkg):
    """tests/test_frontend.py::test_builder_two_phase_challenge's circuit."""
    bld, expr, _ = pkg
    k = 3
    b = bld.CircuitBuilder(k, num_phases=2)
    w0 = b.advice_column(0)
    w1 = b.advice_column(1)
    th = b.challenge(0)
    b.max_degree = 4
    b.gate("phase1", lambda ctx: expr.challenge(th) * ctx.expr(w0) + ctx.expr(w0) * ctx.expr(w0) - ctx.expr(w1))
    w0_vals = [int(v) for v in np.random.RandomState(42).randint(0, 1 << 16, 1 << k)]

    def advice_fn(phase, challenges):
        if phase == 0:
            return [w0_vals]
        return [[(challenges[0] * v + v * v) % P for v in w0_vals]]

    return b.build({}, advice_fn, [])


CIRCUITS = {
    "copy": copy_circuit,
    "and_lookup": and_lookup_circuit,
    "two_phase": two_phase_circuit,
    "arx_8bit": lambda pkg: (arx if pkg is PORT else jarx).arx_chain_circuit(4, 8, 4, 3),
    "arx_32bit": lambda pkg: (arx if pkg is PORT else jarx).arx_chain_circuit(5),
}


def _keys(exprs):
    return [from_foreign(e).structural_key for e in exprs]


def info_key(ci):
    """Every part of a circuit info, as plain values (expressions by
    structural key, Lasso tables by name and the key of their collation)."""
    return {
        "sizes": (ci.k, list(ci.num_instances), list(ci.num_witness_polys), list(ci.num_challenges), ci.max_degree),
        "preprocess": [[int(v) for v in col] for col in ci.preprocess_polys],
        "constraints": _keys(ci.constraints),
        "lookups": [[(from_foreign(i).structural_key, from_foreign(t).structural_key) for i, t in lk] for lk in ci.lookups],
        "permutations": [list(cycle) for cycle in ci.permutations],
        "lasso": [info_key_lasso(lk) for lk in ci.lasso_lookups],
    }


def info_key_lasso(lk):
    return lk.table.name, from_foreign(lk.table.g).structural_key, _keys(lk.inputs), from_foreign(lk.output).structural_key


def canonical(cols):
    return [[int(v) % P for v in col] for col in cols]


@pytest.mark.parametrize("name", CIRCUITS)
def test_builder_matches_jax(name):
    (ci, circ), (jci, jcirc) = CIRCUITS[name](PORT), CIRCUITS[name](JAX)
    assert info_key(ci) == info_key(jci)
    assert ci.is_well_formed() and jci.is_well_formed()
    assert circ.instances() == jcirc.instances()
    challenges = []
    for phase, num_c in enumerate(ci.num_challenges):
        assert canonical(circ.synthesize(phase, challenges)) == canonical(jcirc.synthesize(phase, challenges))
        challenges += [(P - 7 - 3 * len(challenges)) % P for _ in range(num_c)]


def test_cycles_from_copies_matches_jax():
    rng = random.Random(1234)
    copies = [(rng.randrange(5), rng.randrange(16), rng.randrange(5), rng.randrange(16)) for _ in range(60)]
    for _ in range(3):
        rng.shuffle(copies)
        cycles = builder._cycles_from_copies(copies)
        assert cycles == jbuilder._cycles_from_copies(list(copies))
        assert sum(len(c) for c in cycles) == len({cell for a, i, b, j in copies for cell in ((a, i), (b, j))})


def test_arx_zero_check_program_fits_k1():
    """The 32-bit ARX chain's composed zero check: 11 distinct constants, one
    slot each, and within every compiled limit of K1."""
    ci, _ = arx.arx_chain_circuit(5)
    nz, expr = preprocessor.compose(ci)
    n_polys = ci.num_poly() + preprocessor.num_lasso_polys(ci) + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz
    keys = SC._leaf_keys(expr, n_polys)
    prog = SC.lower_expression(expr, keys)
    assert len(prog.consts) == len(set(prog.consts)) == 11
    assert {arg for op, arg in prog.ops if op in (SC.OP_CONST, SC.OP_SCALED)} == set(range(11))
    assert len(keys) <= SC.MAX_LEAVES and len(prog.ops) <= SC.MAX_OPS and prog.max_stack <= SC.MAX_STACK
    assert expr.degree == 3


def prove_jax(ci, circ):
    param = JHyperPlonk.setup(ci, np.random.RandomState(0))
    jpp, jvp = JHyperPlonk.preprocess(param, ci)
    t = j_new_transcript()
    JHyperPlonk.prove(jpp, circ, t)
    return {"proof": t.into_proof(), "pp": jpp, "vp": jvp, "instances": circ.instances()}


def prove_port(pp, circ):
    t = new_transcript()
    HyperPlonk.prove(pp, circ, t)
    return t.into_proof()


@pytest.fixture(scope="module", params=["arx_8bit", "copy"])
def proofs(request):
    """One circuit's JAX proof and the port's proof made on the CPU with
    the JAX package's preprocessed state."""
    name = request.param
    jax = prove_jax(*CIRCUITS[name](JAX))
    ci, circ = CIRCUITS[name](PORT)
    pp, vp = from_jax_hyperplonk_params(jax["pp"], jax["vp"], device="cpu")
    sha = {"arx_8bit": chip_smoke.ARX_SMALL_SHA256, "copy": chip_smoke.BUILDER_SHA256}[name]
    return {"name": name, "jax": jax, "proof": prove_port(pp, circ), "pp": pp, "vp": vp, "ci": ci, "circ": circ,
            "sha": sha}


def test_proof_bytes_match_jax(proofs):
    assert proofs["proof"] == proofs["jax"]["proof"]
    assert hashlib.sha256(proofs["proof"]).hexdigest() == proofs["sha"]


def _same_params(a, b):
    """Equal parameter trees: tensors bit for bit, expressions by structural
    key, Lasso lookups by their table's name and keys, everything else by
    value."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, Expression):
        return a.structural_key == b.structural_key
    if isinstance(a, LassoLookup):
        return info_key_lasso(a) == info_key_lasso(b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_params(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_params(a[k], b[k]) for k in a)
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and _same_params(vars(a), vars(b))
    return a == b


def test_port_setup_matches_jax(proofs):
    """The port's own setup and preprocess: the same parameters as the
    carried ones for the ARX chain, and for the copy circuit the same proof."""
    param = HyperPlonk.setup(proofs["ci"], np.random.RandomState(0), device="cpu")
    pp, vp = HyperPlonk.preprocess(param, proofs["ci"])
    assert _same_params(pp, proofs["pp"]) and _same_params(vp, proofs["vp"])
    if proofs["name"] == "copy":
        assert prove_port(pp, proofs["circ"]) == proofs["jax"]["proof"]


def test_port_verifies_jax_proof(proofs):
    HyperPlonk.verify(proofs["vp"], proofs["jax"]["instances"], new_transcript(proofs["jax"]["proof"]))


def test_jax_verifies_port_proof(proofs):
    JHyperPlonk.verify(proofs["jax"]["vp"], proofs["jax"]["instances"], j_new_transcript(proofs["proof"]))


def test_tampered_proof_rejected(proofs):
    bad = bytearray(proofs["proof"])
    bad[len(bad) // 10] ^= 1
    with pytest.raises(Halo2LassoError):
        HyperPlonk.verify(proofs["vp"], proofs["jax"]["instances"], new_transcript(bytes(bad)))


ENCODE_COLUMNS = {
    "int64": lambda: np.concatenate([
        np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1], np.int64),
        np.random.RandomState(5).randint(0, 2**62, size=59, dtype=np.int64),
    ]),
    "python_ints": lambda: [0, 1, P - 1, P - 2, 2**255 % P] + [
        int.from_bytes(np.random.RandomState(6).bytes(32), "little") % P for _ in range(27)
    ],
    "empty": lambda: [],
}


@pytest.mark.parametrize("kind", ENCODE_COLUMNS)
def test_encode_dev_matches_encode_and_jax(kind):
    col = ENCODE_COLUMNS[kind]()
    got = F.encode_dev(Fr, col, "cpu")
    assert got.shape == (len(col), F.LIMBS)
    assert torch.equal(got, Fr.encode(col, "cpu").reshape(got.shape))
    assert torch.equal(got, F.from_jax_limbs(np.asarray(JF.encode_dev(JFr, col)).reshape(-1, 16)))
    limbs = Fr.canonical_limbs(col)
    jlimbs = np.asarray(JFr.canonical_limbs(col), np.uint32).reshape(-1, 16)
    assert np.array_equal(limbs, jlimbs[:, 0::2] | (jlimbs[:, 1::2] << np.uint32(16)))
    assert F.u32_to_ints(limbs) == [int(v) % P for v in col]


def test_encode_dev_negative_int64_wraps_as_jax():
    """A negative int64 column wraps to 2^64 + x (uint64), as the JAX
    package's canonical_limbs / encode_dev do; an object array of Python
    ints is still reduced mod p."""
    col = np.array([-1, -2, -(2**32), -(2**63), 5], np.int64)
    got = F.encode_dev(Fr, col, "cpu")
    assert torch.equal(got, F.from_jax_limbs(np.asarray(JF.encode_dev(JFr, col)).reshape(-1, 16)))
    assert torch.equal(got, Fr.encode([int(v) % 2**64 for v in col], "cpu"))
    jlimbs = np.asarray(JFr.canonical_limbs(col), np.uint32).reshape(-1, 16)
    assert np.array_equal(Fr.canonical_limbs(col), jlimbs[:, 0::2] | (jlimbs[:, 1::2] << np.uint32(16)))
    assert F.u32_to_ints(Fr.canonical_limbs(col.astype(object))) == [int(v) % P for v in col]


def negative_copy_circuit(pkg):
    """The copy circuit's gate and copies with int64 advice columns whose a
    and c cells are negative: a + b = c holds both mod p and for the wrapped
    2^64 + x, so the witness is valid either way and only the encoding
    decides the proof bytes."""
    b = pkg[0].CircuitBuilder(3)
    b.instance_column()
    q = b.selector()
    a, bcol, c = (b.advice_column() for _ in range(3))
    b.max_degree = 4
    b.gate("add", lambda ctx: ctx.expr(q) * (ctx.expr(a) + ctx.expr(bcol) - ctx.expr(c)))
    a_vals, b_vals, c_vals = [-100], [4, 5, 6, 7, 8], []
    for i in range(5):
        c_vals.append(a_vals[i] + b_vals[i])
        if i < 4:
            a_vals.append(c_vals[i])
            b.copy(c, i, a, i + 1)
    cols = [np.array(v, np.int64) for v in (a_vals, b_vals, c_vals)]
    return b.build({(q.index, r): 1 for r in range(5)}, lambda phase, challenges: cols, [[]])


def test_negative_int64_column_proof_matches_jax():
    """A builder circuit with negative int64 advice cells proves the same
    bytes in both packages (the port's own setup and preprocess), and the
    JAX package verifies the port's proof."""
    jax = prove_jax(*negative_copy_circuit(JAX))
    ci, circ = negative_copy_circuit(PORT)
    pp, vp = HyperPlonk.preprocess(HyperPlonk.setup(ci, np.random.RandomState(0), device="cpu"), ci)
    proof = prove_port(pp, circ)
    assert proof == jax["proof"]
    HyperPlonk.verify(vp, circ.instances(), new_transcript(proof))
    JHyperPlonk.verify(jax["vp"], jax["instances"], j_new_transcript(proof))


def test_frontend_imports_neither_jax_nor_the_jax_package():
    root = pathlib.Path(__file__).resolve().parent.parent / "halo2_lasso_tpu_torch" / "frontend"
    files = sorted(root.glob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "arx.py", "builder.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            for mod in names:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "halo2_lasso_tpu"), f"{f} imports {mod}"
