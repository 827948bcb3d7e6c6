"""Port Lasso-in-HyperPlonk (halo2_lasso_tpu_torch.lasso.integration and the
Lasso branches of backend.hyperplonk) against the JAX package on the CPU.

* rand_lasso_circuit at nv = 3 (seeds 3 / 503, setup seed 0, the shapes
  tests/test_lasso_hyperplonk.py compiles): the port's proof, made with the
  JAX package's preprocessed state carried by from_jax_hyperplonk_params,
  equals the JAX proof and hashes to chip_smoke.LASSO_PLONK_SHA256; each
  package verifies the other's proof; a tampered proof is rejected.
* LassoLayout slots and MemSpecs, lasso_constraints, compose and max_degree
  agree for and_table(8, 4), range_table(8, 8), range_table(10, 10) and
  and_table(32, 8); both fixtures agree; the digit extractor agrees on its
  edges; build_lookup_witness gives the same locals and final_cts.
* A wrong output is rejected by the verifier and an out-of-range input by
  the prover, as tests/test_lasso_hyperplonk.py checks for the JAX package.
All comparisons are exact. One JAX setup / preprocess / prove serves every
test (module fixture)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu.backend.hyperplonk import preprocessor as jpreprocessor
from halo2_lasso_tpu.lasso import integration as jint
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu_torch.backend import MockCircuit
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, from_jax_hyperplonk_params, new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.lasso import integration
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr

P = Fr.modulus
torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
NV = 3
SEEDS = (3, 503)
# fixture keyword arguments -> the tables of their two lookups:
# and_table(8, 4) + range_table(8, 8); range_table(10, 10); and_table(32, 8)
TABLE_CASES = {
    "and8_range8": {},
    "range10": {"range_bits": 10},
    "and32": {"operand_bits": 32, "chunk_bits": 8, "range_bits": 16},
}
FIXTURES = ["rand_lasso_circuit", "rand_full_feature_circuit"]


def circuits(name="rand_lasso_circuit", nv=NV, seeds=SEEDS, **kw):
    """The same fixture from both packages: ((info, circuit), (jinfo, jcircuit))."""
    rngs = lambda: [np.random.RandomState(s) for s in seeds]  # noqa: E731
    return getattr(fixtures, name)(nv, *rngs(), **kw), getattr(jfixtures, name)(nv, *rngs(), **kw)


@pytest.fixture(scope="module")
def jax_lasso():
    """The JAX package's nv = 3 Lasso circuit: params and proof."""
    _, (ci, circ) = circuits()
    param = JHyperPlonk.setup(ci, np.random.RandomState(0))
    jpp, jvp = JHyperPlonk.preprocess(param, ci)
    t = j_new_transcript()
    JHyperPlonk.prove(jpp, circ, t)
    return {"proof": t.into_proof(), "pp": jpp, "vp": jvp, "circuit": circ}


@pytest.fixture(scope="module")
def port_lasso(jax_lasso):
    """The port's proof of the same circuit on the CPU, with the JAX
    package's preprocessed state."""
    pp, vp = from_jax_hyperplonk_params(jax_lasso["pp"], jax_lasso["vp"], device="cpu")
    (_, circ), _ = circuits()
    t = new_transcript()
    HyperPlonk.prove(pp, circ, t)
    return {"proof": t.into_proof(), "pp": pp, "vp": vp, "circuit": circ}


def test_proof_bytes_match_jax(jax_lasso, port_lasso):
    assert port_lasso["proof"] == jax_lasso["proof"]
    assert hashlib.sha256(jax_lasso["proof"]).hexdigest() == chip_smoke.LASSO_PLONK_SHA256


def test_port_verifies_jax_proof(jax_lasso, port_lasso):
    HyperPlonk.verify(port_lasso["vp"], [], new_transcript(jax_lasso["proof"]))


def test_jax_verifies_port_proof(jax_lasso, port_lasso):
    JHyperPlonk.verify(jax_lasso["vp"], [], j_new_transcript(port_lasso["proof"]))


@pytest.mark.parametrize("frac", [0.1, 0.4, 0.6, 0.85], ids=["commitments", "zero_check", "gkr", "openings"])
def test_tampered_proof_rejected(port_lasso, frac):
    """Byte flips across the proof stream (commitments, sumcheck messages,
    the GKR region, openings) must all be rejected."""
    bad = bytearray(port_lasso["proof"])
    bad[int(len(bad) * frac)] ^= 1
    with pytest.raises(Halo2LassoError):
        HyperPlonk.verify(port_lasso["vp"], [], new_transcript(bytes(bad)))


def test_params_carry_lasso_lookups(jax_lasso, port_lasso):
    for lk, jlk in zip(port_lasso["pp"].lasso_lookups, jax_lasso["pp"].lasso_lookups):
        assert lk.table.name == jlk.table.name
        assert lk.table.g.structural_key == jlk.table.g.structural_key
        assert [e.structural_key for e in lk.inputs] == [e.structural_key for e in jlk.inputs]
        assert lk.output.structural_key == jlk.output.structural_key


def _mem_key(ms):
    return (ms.addr_terms, ms.subtable.name, ms.subtable.index_bits, ms.e_local, ms.ts_local, ms.is_real)


@pytest.mark.parametrize("kw", TABLE_CASES.values(), ids=TABLE_CASES.keys())
def test_layout_constraints_and_compose_match_jax(kw):
    (ci, _), (jci, _) = circuits(**kw)
    for lk, jlk in zip(ci.lasso_lookups, jci.lasso_lookups):
        lay, jlay = integration.LassoLayout(lk), jint.LassoLayout(jlk)
        assert (lk.table.name, lay.num_dims, lay.num_local) == (jlk.table.name, jlay.num_dims, jlay.num_local)
        assert [_mem_key(m) for m in lay.mems] == [_mem_key(m) for m in jlay.mems]
        assert lay.g_expression(7, lk).structural_key == jlay.g_expression(7, jlk).structural_key
    assert integration.num_lasso_polys(ci) == jint.num_lasso_polys(jci)
    off = ci.num_poly()
    assert [c.structural_key for c in integration.lasso_constraints(ci, off)] == [
        c.structural_key for c in jint.lasso_constraints(jci, off)
    ]
    assert preprocessor.max_degree(ci) == jpreprocessor.max_degree(jci)
    nz, expr = preprocessor.compose(ci)
    jnz, jexpr = jpreprocessor.compose(jci)
    assert (nz, expr.structural_key) == (jnz, jexpr.structural_key)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_match_jax(name):
    (ci, circ), (jci, jcirc) = circuits(name, nv=4, seeds=(5, 6))
    assert ci.preprocess_polys == jci.preprocess_polys
    assert ci.permutations == jci.permutations
    assert circ.synthesize(0, []) == jcirc.synthesize(0, []) and circ.instances() == jcirc.instances()
    assert [c.structural_key for c in ci.constraints] == [c.structural_key for c in jci.constraints]
    assert [(i.structural_key, t.structural_key) for lk in ci.lookups for i, t in lk] == [
        (i.structural_key, t.structural_key) for lk in jci.lookups for i, t in lk
    ]
    def lasso_keys(info):
        return [(lk.table.name, [e.structural_key for e in lk.inputs], lk.output.structural_key) for lk in info.lasso_lookups]

    assert lasso_keys(ci) == lasso_keys(jci)
    assert ci.is_well_formed() and jci.is_well_formed()


def _digit_cases(bits):
    """The extractor's edges: 0, 2^bits - 1, 2^bits (out of range), p - 1,
    and values with bit 31 of a limb set."""
    return [0, (1 << bits) - 1, 1 << bits, P - 1, (1 << 31) | 5, (1 << 63) | (1 << 31) | 7]


@pytest.mark.parametrize("b", [2, 4, 8, 12, 16])
def test_digits_match_jax(b):
    c = 3  # bits = 3b: the b = 12 digit at offset 24 straddles two 32-bit limbs; 36 and 48 bits reach limb 1
    bits = b * c
    for vals in [[v] for v in _digit_cases(bits)] + [[v for v in _digit_cases(bits)[:2]]]:
        jd, jok = jint._digits_from_mont_dev(JFr, jnp.asarray(JFr.encode(vals)), bits, b, c)
        d, ok = integration._digits_from_mont_dev(Fr, Fr.encode(vals), bits, b, c)
        assert bool(ok) == bool(np.asarray(jok)) == all(v < 1 << bits for v in vals)
        assert [x.tolist() for x in d] == [np.asarray(x).astype(np.int64).tolist() for x in jd]


def test_chunk_bits_above_16_refused():
    with pytest.raises(integration.LassoIntegrationError):
        integration._digits_from_mont_dev(Fr, Fr.encode([1]), 34, 17, 2)


def test_build_lookup_witness_matches_jax(jax_lasso, port_lasso):
    (_, circ), _ = circuits()
    cols = circ.synthesize(0, [])
    jpolys = [jnp.asarray(JFr.encode(c)) for c in cols]
    polys = [F.from_jax_limbs(np.asarray(p)) for p in jpolys]
    for lk, jlk in zip(port_lasso["pp"].lasso_lookups, jax_lasso["pp"].lasso_lookups):
        loc, fcs = integration.build_lookup_witness(Fr, lk, integration.LassoLayout(lk), polys, [], NV)
        jloc, jfcs = jint.build_lookup_witness(JFr, jlk, jint.LassoLayout(jlk), jpolys, [], NV)
        assert len(loc) == len(jloc) and len(fcs) == len(jfcs)
        for got, want in zip(loc + fcs, list(jloc) + list(jfcs)):
            assert np.array_equal(F.to_jax_limbs(got), np.asarray(want))


def test_wrong_output_rejected(port_lasso):
    """w_and is not x & y on one row: the prover completes (its Surge
    columns are consistent among themselves) but the zero-check binding
    output == g(E...) fails at the verifier."""
    (_, circ), _ = circuits()
    cols = circ.synthesize(0, [])
    cols[2][3] ^= 1  # flip one bit of w_and[3]
    t = new_transcript()
    HyperPlonk.prove(port_lasso["pp"], MockCircuit([], cols), t)
    with pytest.raises(Halo2LassoError):
        HyperPlonk.verify(port_lasso["vp"], [], new_transcript(t.into_proof()))


def test_out_of_range_input_raises(port_lasso):
    """An out-of-range lookup operand is refused when the witness is built."""
    (_, circ), _ = circuits()
    cols = circ.synthesize(0, [])
    cols[4][1] = 1 << 12  # w_r outside the 8-bit range table
    with pytest.raises(integration.LassoIntegrationError, match="out of range"):
        HyperPlonk.prove(port_lasso["pp"], MockCircuit([], cols), new_transcript())
