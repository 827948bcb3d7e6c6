"""Port Brakedown (halo2_lasso_tpu_torch.pcs.brakedown) against the JAX
package's halo2_lasso_tpu/pcs/brakedown.py on the CPU, every comparison
exact (canonical ints, roots, transcript bytes):

* the specs' dimensions, codeword length, column openings and proximity
  tests for SPEC1-6 at the nv = 6, 12 and 16 shapes;
* the sparse matrices drawn from the same RandomState, and the params
  carried over from the JAX package (``from_jax_params``) against the
  port's own setup;
* ``encode`` at nv = 6 (one row) and nv = 12 (two rows: the proximity-test
  path), and its linearity;
* roots and open bytes at nv = 6 and nv = 12, the port verifying the JAX
  proof, and PcsError for a wrong evaluation, a flipped column item and a
  flipped path hash;
HyperPlonk over Brakedown is in tests/test_torch_hyperplonk_brakedown.py
(a file of its own, so that each stays within the suite's time a file).
One JAX setup, commit and open per shape serves every test (a module
fixture). The JAX verifier is not run on proofs whose bytes equal its own
(tests/test_brakedown.py covers it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import field as JF
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.pcs import brakedown as JB
from halo2_lasso_tpu.poly import multilinear as jmle
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.pcs import brakedown as B
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import PcsError
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

torch.set_num_threads(1)  # the suite's workers share the cores
P = Fr.modulus
SPECS = ["SPEC1", "SPEC2", "SPEC3", "SPEC4", "SPEC5", "SPEC6"]
SETUP_SEED = 2


def rand_fes(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


@pytest.mark.parametrize("num_vars", [6, 12, 16])
@pytest.mark.parametrize("spec", SPECS)
def test_spec_dimensions_match_jax(spec, num_vars):
    mine, theirs = getattr(B, spec), getattr(JB, spec)
    n_0 = min(20, (1 << num_vars) - 1)
    row_len = B.BrakedownCode.choose_row_len(num_vars, n_0, mine)
    assert row_len & (row_len - 1) == 0 and row_len > n_0
    assert mine.dimensions(B.LOG2_Q, row_len, n_0) == theirs.dimensions(JB.LOG2_Q, row_len, n_0)
    assert mine.codeword_len(B.LOG2_Q, row_len, n_0) == theirs.codeword_len(JB.LOG2_Q, row_len, n_0)
    assert mine.num_column_opening() == theirs.num_column_opening()
    assert mine.num_proximity_testing(B.LOG2_Q, row_len, n_0) == theirs.num_proximity_testing(JB.LOG2_Q, row_len, n_0)


def test_nv16_shape():
    """The shape the card runs: 8 rows of 8192, the (n, m, d) triples, a
    codeword of 14,091 columns, 3,755 column openings, 1 proximity test."""
    row_len = B.BrakedownCode.choose_row_len(16, 20, B.SPEC6)
    a, b = B.SPEC6.dimensions(B.LOG2_Q, row_len, 20)
    assert row_len == 8192
    assert a == [(8192, 1950, 11), (1950, 465, 11), (465, 111, 14), (111, 27, 18), (27, 7, 7)]
    assert b == [(3354, 2545, 21), (800, 604, 23), (191, 144, 31), (47, 33, 28), (13, 7, 7)]
    assert B.SPEC6.codeword_len(B.LOG2_Q, row_len, 20) == 14091
    assert B.SPEC6.num_column_opening() == 3755
    assert B.SPEC6.num_proximity_testing(B.LOG2_Q, row_len, 20) == 1


@pytest.fixture(scope="module", params=[6, 12])
def shape(request):
    """The JAX package's params, commit and open of a random poly at nv,
    and the port's, on the CPU."""
    nv = request.param
    jpp = JB.MultilinearBrakedown.setup(1 << nv, np.random.RandomState(SETUP_SEED))
    pp = B.MultilinearBrakedown.setup(1 << nv, rng=np.random.RandomState(SETUP_SEED), device="cpu")
    vals = rand_fes(np.random.RandomState(100 + nv), 1 << nv)
    jpoly = jnp.asarray(JFr.encode(vals))
    jcomm = JB.MultilinearBrakedown.commit(jpp, jpoly)
    poly = Fr.encode(vals)
    comm = B.MultilinearBrakedown.commit(pp, poly)

    def open_(pcs, params, c, p, transcript):
        transcript.write_hash(c.root)
        point = transcript.squeeze_challenges(nv)
        value = JF.decode_scalar(JFr, np.asarray(jmle.evaluate(JFr, jpoly, jnp.asarray(JFr.encode(point)))))
        transcript.write_field_element(value)
        pcs.open(params, p, c, point, value, transcript)
        return transcript.into_proof()

    return {
        "nv": nv, "jpp": jpp, "pp": pp, "vals": vals, "jcomm": jcomm, "comm": comm,
        "jproof": open_(JB.MultilinearBrakedown, jpp, jcomm, jpoly, JTranscript(P)),
        "proof": open_(B.MultilinearBrakedown, pp, comm, poly, Keccak256Transcript(P)),
    }


def _matrices(code):
    return code.a + code.b


def test_matrices_match_jax(shape):
    jcode, code = shape["jpp"].code, shape["pp"].code
    assert (code.row_len, code.codeword_len) == (jcode.row_len, jcode.codeword_len)
    assert shape["pp"].num_rows == shape["jpp"].num_rows
    for ja, a in zip(_matrices(jcode), _matrices(code), strict=True):
        assert (a.n, a.m, a.d) == (ja.n, ja.m, ja.d)
        assert np.array_equal(a.rows_idx, np.asarray(ja.rows_idx))
        assert np.array_equal(a.cols_idx, np.asarray(ja.cols_idx))
        assert np.array_equal(F.to_jax_limbs(a.coeffs), np.asarray(ja.coeffs))


def test_from_jax_params_equals_own_setup(shape):
    carried, own = B.MultilinearBrakedown.from_jax_params(shape["jpp"], device="cpu"), shape["pp"]
    assert (carried.num_vars, carried.num_rows) == (own.num_vars, own.num_rows)
    assert (carried.code.row_len, carried.code.codeword_len) == (own.code.row_len, own.code.codeword_len)
    assert torch.equal(carried.code.vandermonde, own.code.vandermonde)
    for x, y in zip(_matrices(carried.code), _matrices(own.code), strict=True):
        assert torch.equal(x.idx, y.idx) and torch.equal(x.coeff, y.coeff)


def test_grouped_layout_holds_every_entry(shape):
    """Each matrix's grouped (D, m) layout holds its entries once, padded
    with coefficient 0."""
    for a in _matrices(shape["pp"].code):
        nnz = len(a.rows_idx)
        assert a.idx.shape == (a.width, a.m) and int((a.coeff != 0).any(-1).sum()) == nnz
        assert a.width == np.bincount(a.cols_idx, minlength=a.m).max()


def test_encode_matches_jax(shape):
    """Every row of the poly at once (one row at nv = 6, two at nv = 12),
    canonical in, canonical out, against the rows the JAX commit encoded a
    row at a time (its commitment keeps them as host ints)."""
    pp = shape["pp"]
    row_len, rows = pp.code.row_len, pp.num_rows
    vals = np.array(shape["vals"], dtype=object).reshape(rows, row_len)
    got = pp.code.encode(F.from_numpy_u32(F.ints_to_u32(vals.T.reshape(-1))).reshape(row_len, rows, F.LIMBS))
    got = np.array(F.u32_to_ints(F.to_numpy_u32(got).reshape(-1, F.LIMBS)), dtype=object).reshape(-1, rows)
    want = np.asarray(shape["jcomm"].rows, dtype=object)
    assert want.shape == (rows, pp.code.codeword_len)
    assert all(list(got[:, r]) == [int(v) for v in want[r]] for r in range(rows))


def test_passes_split_at_the_row_sum_limit(shape, monkeypatch):
    """Where a pass would give one sum_reduce more columns than it takes
    (the open's rows from nv = 20, the encode's from nv = 18 on the card),
    encode and the row combinations split it: the same values."""
    code, rows = shape["pp"].code, shape["pp"].num_rows
    x = Fr.encode(shape["vals"]).reshape(rows, code.row_len, F.LIMBS)
    coeffs = Fr.encode(rand_fes(np.random.RandomState(3), 2 * rows)).reshape(2, rows, F.LIMBS)
    whole = (code.encode(x.transpose(0, 1)), B._combine(x, coeffs))
    monkeypatch.setattr(B, "SUM_COLUMNS", 2 * code.max_outputs - 1)  # one row a pass; 2 * max_outputs - 1 columns
    split = (code.encode(x.transpose(0, 1)), B._combine(x, coeffs))
    assert all(torch.equal(a, b) for a, b in zip(whole, split))


def test_encode_linear():
    """The mirror of tests/test_brakedown.py::test_encode_linear, on the
    port's code (Montgomery rows in, Montgomery codewords out)."""
    rng = np.random.RandomState(66)
    code = B.BrakedownCode.random(6, 10, B.SPEC6, np.random.RandomState(1), "cpu")
    u, v = rand_fes(rng, code.row_len), rand_fes(rng, code.row_len)
    c = rand_fes(rng, 1)[0]
    w = [(a + c * b) % P for a, b in zip(u, v)]
    eu, ev, ew = (Fr.decode(code.encode(Fr.encode(x)[:, None]))[:, 0] for x in (u, v, w))
    assert len(ew) == code.codeword_len
    assert all(int(z) == (int(x) + c * int(y)) % P for x, y, z in zip(eu, ev, ew))


def test_commit_and_open_bytes_match_jax(shape):
    assert shape["comm"].root == shape["jcomm"].root
    assert shape["proof"] == shape["jproof"]


def test_from_jax_commitment(shape):
    carried = B.MultilinearBrakedown.from_jax_commitment(shape["jcomm"])
    assert np.array_equal(carried.columns, shape["comm"].columns)
    assert all(np.array_equal(x, y) for x, y in zip(carried.tree, shape["comm"].tree, strict=True))


def verify(shape, proof, bump=0):
    tr = Keccak256Transcript(P, proof=proof)
    root = tr.read_hash()
    point = tr.squeeze_challenges(shape["nv"])
    value = tr.read_field_element()
    B.MultilinearBrakedown.verify(shape["pp"], root, point, (value + bump) % P, tr)


def test_port_verifies_jax_proof(shape):
    verify(shape, shape["jproof"])


def _column_offset(shape):
    """Where the first opened column starts in the standalone proof: after
    the root, the evaluation and the combined rows."""
    code, rows = shape["pp"].code, shape["pp"].num_rows
    combined = (code.num_proximity_testing if rows > 1 else 0) + 1
    return 64 + combined * code.row_len * 32


@pytest.mark.parametrize("what", ["eval", "column item", "path hash"])
def test_rejects(shape, what):
    proof, bump = bytearray(shape["jproof"]), 0
    at = _column_offset(shape)
    if what == "eval":
        bump = 1
    elif what == "column item":
        proof[at + 31] ^= 1  # the low byte of the first item (big-endian)
    else:
        proof[at + shape["pp"].num_rows * 32] ^= 1  # the first sibling of the first column
    match = {"eval": "consistency", "column item": "proximity", "path hash": "merkle"}[what]
    with pytest.raises(PcsError, match=match):
        verify(shape, bytes(proof), bump)
