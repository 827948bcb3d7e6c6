"""Port GKR, KZG and Lasso (halo2_lasso_tpu_torch.piop.gkr, .pcs, .lasso)
against the JAX package on the CPU: GKR proof bytes at nv = 4, the SRS from
one seed, KZG commit / open / verify at nv = 4, the tables and witness
counters, and whole Lasso proofs byte-equal to halo2_lasso_tpu.lasso.prove
for the same SRS and indices (range_table(8, 4), and the two-operand
and_table(4, 2) and lt_table(4, 2)), with proofs verified across packages
both ways (one JAX SRS serves them all).
The JAX proof's SHA-256 is the constant chip_smoke.py holds the card to."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu import lasso as jlasso
from halo2_lasso_tpu.lasso.integration import _read_ts_and_final_dev as j_read_ts_and_final_dev
from halo2_lasso_tpu.lasso import tables as jtables
from halo2_lasso_tpu.lasso.tables import range_table as jrange_table
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.ops.bn254 import Fq as JFq
from halo2_lasso_tpu.pcs.multilinear_kzg import MultilinearKzg as JKzg
from halo2_lasso_tpu.piop import gkr as jgkr
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch import lasso
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.lasso import tables
from halo2_lasso_tpu_torch.lasso.tables import range_table
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg, PcsError, from_jax_kzg_params
from halo2_lasso_tpu_torch.piop import gkr
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(31)
SMALL = chip_smoke.SMALL


def rand_fes(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


def new_t(cls, proof=None):
    return cls(P, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)


def small_case():
    table = (SMALL["index_bits"], SMALL["chunk_bits"])
    rng = np.random.RandomState(SMALL["index_seed"])
    indices = [int(rng.randint(1 << SMALL["index_bits"])) for _ in range(SMALL["lookups"])]
    nv = max(SMALL["lookups"].bit_length() - 1, SMALL["chunk_bits"])
    return table, indices, nv


@pytest.fixture(scope="module")
def jax_srs():
    """The JAX package's SRS of the small case (nv = 4, seed 3), shared by
    the SRS, KZG and Lasso tests."""
    _, _, nv = small_case()
    param = JKzg.setup(1 << nv, np.random.RandomState(SMALL["srs_seed"]))
    return param, JKzg.trim(param, 1 << nv)


@pytest.fixture(scope="module")
def jax_small_proof(jax_srs):
    table, indices, _ = small_case()
    _, (jpp, jvp) = jax_srs
    t = new_t(JTranscript)
    jlasso.prove(jpp, jrange_table(*table), indices, t)
    return t.into_proof(), jpp, jvp


@pytest.mark.parametrize("pure", [True, False], ids=["pure", "fractional"])
def test_gkr_proof_bytes_match_jax(pure):
    nv, b = 4, 2
    qs = [rand_fes(1 << nv) for _ in range(b)]
    ps = [None] * b if pure else [rand_fes(1 << nv) for _ in range(b)]
    claimed_p = [0] * b if pure else [None] * b
    claimed_q = [None] * b
    jt = JTranscript(P)
    jqs = [jnp.asarray(JFr.encode(v)) for v in qs]
    jps = [None if v is None else jnp.asarray(JFr.encode(v)) for v in ps]
    jout = jgkr.prove_fractional_sum_check(claimed_p, claimed_q, jps, jqs, jt)
    tt = Keccak256Transcript(P)
    tqs = [F.from_jax_limbs(np.asarray(v)) for v in jqs]
    tps = [None if v is None else F.from_jax_limbs(np.asarray(v)) for v in jps]
    out = gkr.prove_fractional_sum_check(claimed_p, claimed_q, tps, tqs, tt)
    proof = tt.into_proof()
    assert proof == jt.into_proof()
    assert out == jout
    mine = gkr.verify_fractional_sum_check(nv, claimed_p, claimed_q, Keccak256Transcript(P, proof=proof))
    theirs = jgkr.verify_fractional_sum_check(nv, claimed_p, claimed_q, JTranscript(P, proof=proof))
    assert mine == theirs
    assert mine[:3] == out[:3]


@pytest.mark.parametrize(
    "factory,args",
    [("range_table", (8, 4)), ("range_table", (16, 16)), ("and_table", (4, 2)),
     ("xor_table", (8, 4)), ("or_table", (8, 4)), ("lt_table", (4, 2))],
)
def test_tables_match_jax(factory, args):
    mine, theirs = getattr(tables, factory)(*args), getattr(jtables, factory)(*args)
    assert mine.g.structural_key == theirs.g.structural_key
    assert (mine.index_bits, mine.chunk_bits, mine.num_chunks) == (theirs.index_bits, theirs.chunk_bits, theirs.num_chunks)
    idx = RNG.randint(0, 1 << mine.index_bits, 32)
    assert all(np.array_equal(a, b) for a, b in zip(mine.chunk_indices_np(idx), theirs.chunk_indices_np(idx)))
    assert [mine.lookup(int(i)) for i in idx[:8]] == [theirs.lookup(int(i)) for i in idx[:8]]
    for m, t in zip(mine.memories, theirs.memories):
        assert m.chunk == t.chunk and m.subtable.name == t.subtable.name
        if m.subtable.index_bits <= 8:
            assert list(m.subtable.values()) == list(t.subtable.values())
        z = rand_fes(m.subtable.index_bits)
        assert m.subtable.mle_eval(z) == t.subtable.mle_eval(z)


def test_witness_and_memory_counters_match_jax():
    table, indices, _ = small_case()
    mine = lasso.build_witness(range_table(*table), indices)
    theirs = jlasso.build_witness(jrange_table(*table), indices)
    for field in ("dims", "e_vals", "read_ts", "final_cts"):
        assert all(np.array_equal(a, b) for a, b in zip(getattr(mine, field), getattr(theirs, field))), field
    assert list(mine.outputs) == list(theirs.outputs) == indices
    addr = np.asarray(mine.dims[0])
    ts, fc = lasso._read_ts_and_final_dev(torch.from_numpy(addr), 16)
    jts, jfc = j_read_ts_and_final_dev(jnp.asarray(addr.astype(np.uint32)), 16)
    assert ts.tolist() == np.asarray(jts).tolist() and fc.tolist() == np.asarray(jfc).tolist()


@pytest.fixture(scope="module")
def port_small_proof(jax_small_proof):
    """The port's proof of the small case on the CPU, with the JAX SRS."""
    _, jpp, jvp = jax_small_proof
    table, indices, _ = small_case()
    pp, vp = from_jax_kzg_params(jpp, device="cpu"), from_jax_kzg_params(jvp, device="cpu")
    t = new_t(Keccak256Transcript)
    lasso.prove(pp, range_table(*table), indices, t, device="cpu")
    return t.into_proof(), vp


NV_M = SMALL["lookups"].bit_length() - 1
TABLE = (SMALL["index_bits"], SMALL["chunk_bits"])


def test_jax_small_proof_hash_is_the_smoke_constant(jax_small_proof):
    assert hashlib.sha256(jax_small_proof[0]).hexdigest() == chip_smoke.SMALL_PROOF_SHA256


def test_lasso_proof_bytes_match_jax(jax_small_proof, port_small_proof):
    assert port_small_proof[0] == jax_small_proof[0]


def test_port_verifies_jax_lasso_proof(jax_small_proof, port_small_proof):
    lasso.verify(port_small_proof[1], range_table(*TABLE), NV_M, new_t(Keccak256Transcript, jax_small_proof[0]))


def test_jax_verifies_port_lasso_proof(jax_small_proof, port_small_proof):
    jlasso.verify(jax_small_proof[2], jrange_table(*TABLE), NV_M, new_t(JTranscript, port_small_proof[0]))


def test_tampered_lasso_proof_rejected(port_small_proof):
    proof, vp = port_small_proof
    bad = bytearray(proof)
    bad[-40] ^= 1  # inside the last quotient commitment
    with pytest.raises(Halo2LassoError):
        lasso.verify(vp, range_table(*TABLE), NV_M, new_t(Keccak256Transcript, bytes(bad)))


TWO_OPERAND = {"and_table": (4, 2), "lt_table": (4, 2)}  # tests/test_lasso.py:72-82 sizes


@pytest.fixture(scope="module", params=list(TWO_OPERAND), ids=list(TWO_OPERAND))
def two_operand_proofs(request, jax_srs):
    """A two-operand (interleaved) table: 8 lookups of two 4-bit operands
    proved by both packages with the JAX SRS (nv = 4, the 2^4 subtables)."""
    name, args = request.param, TWO_OPERAND[request.param]
    rng = np.random.RandomState(78)
    indices = [int(v) for v in rng.randint(0, 1 << 8, 8)]
    _, (jpp, jvp) = jax_srs
    jt = new_t(JTranscript)
    jlasso.prove(jpp, getattr(jtables, name)(*args), indices, jt)
    pp, vp = from_jax_kzg_params(jpp, device="cpu"), from_jax_kzg_params(jvp, device="cpu")
    t = new_t(Keccak256Transcript)
    lasso.prove(pp, getattr(tables, name)(*args), indices, t, device="cpu")
    return {"name": name, "args": args, "proof": t.into_proof(), "jproof": jt.into_proof(), "vp": vp, "jvp": jvp}


def test_two_operand_proof_bytes_match_jax(two_operand_proofs):
    assert two_operand_proofs["proof"] == two_operand_proofs["jproof"]


def test_two_operand_proofs_verify_across_packages(two_operand_proofs):
    d = two_operand_proofs
    lasso.verify(d["vp"], getattr(tables, d["name"])(*d["args"]), 3, new_t(Keccak256Transcript, d["jproof"]))
    jlasso.verify(d["jvp"], getattr(jtables, d["name"])(*d["args"]), 3, new_t(JTranscript, d["proof"]))


def test_setup_matches_jax_srs(jax_srs):
    param, _ = jax_srs
    mine = MultilinearKzg.setup(1 << 4, np.random.RandomState(3), device="cpu")
    assert (mine.g1, mine.g2, mine.ss) == (param.g1, param.g2, param.ss)
    for eq, jeq in zip(mine.eqs, param.eqs):
        jac = list(zip(*([int(v) for v in JFq.decode(np.asarray(jeq[k]))] for k in ec.COORDS)))
        assert ec.jacobian_to_affine(eq) == MJ.host_batch_affine(jac, FQ_MODULUS)


@pytest.fixture(scope="module")
def kzg_open(jax_srs):
    """One commit and open at nv = 4 in both packages."""
    _, (jpp, jvp) = jax_srs
    pp, vp = from_jax_kzg_params(jpp, device="cpu"), from_jax_kzg_params(jvp, device="cpu")
    poly, point = rand_fes(1 << 4), rand_fes(4)
    value = sum(c * mle_eval_basis(point, b) for b, c in enumerate(poly)) % P
    jpoly = jnp.asarray(JFr.encode(poly))
    tpoly = F.from_jax_limbs(np.asarray(jpoly))
    tt, jt = new_t(Keccak256Transcript), new_t(JTranscript)
    MultilinearKzg.open(pp, tpoly, point, value, tt)
    JKzg.open(jpp, jpoly, point, value, jt)
    return {
        "comm": MultilinearKzg.commit(pp, tpoly), "jcomm": JKzg.commit(jpp, jpoly),
        "proof": tt.into_proof(), "jproof": jt.into_proof(),
        "vp": vp, "jvp": jvp, "point": point, "value": value,
    }


def mle_eval_basis(point, b):
    acc = 1
    for i, x in enumerate(point):
        acc = acc * (x if (b >> i) & 1 else 1 - x) % P
    return acc


def test_kzg_commit_matches_jax(kzg_open):
    assert kzg_open["comm"] == kzg_open["jcomm"]


def test_kzg_open_bytes_match_jax(kzg_open):
    assert kzg_open["proof"] == kzg_open["jproof"]


def test_kzg_proofs_verify_across_packages(kzg_open):
    k = kzg_open
    MultilinearKzg.verify(k["vp"], k["comm"], k["point"], k["value"], new_t(Keccak256Transcript, k["jproof"]))
    JKzg.verify(k["jvp"], k["comm"], k["point"], k["value"], new_t(JTranscript, k["proof"]))


def test_kzg_wrong_value_rejected(kzg_open):
    k = kzg_open
    with pytest.raises(PcsError):
        MultilinearKzg.verify(k["vp"], k["comm"], k["point"], (k["value"] + 1) % P, new_t(Keccak256Transcript, k["proof"]))
