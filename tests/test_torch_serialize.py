"""Parameter files (halo2_lasso_tpu_torch.utils.serialize) against the JAX
package on the CPU: tests/test_serialize.py's three round trips through the
port (KZG params; HyperPlonk params with a prove and a verify; a Lasso
set-up with a prove and a verify), then files crossing the packages both
ways: the JAX package's files load in the port and prove the JAX proofs'
bytes, the port's files load in the JAX package and prove the same bytes,
and the two packages write equal arrays and equal JSON. The tables'
factory specs match. One JAX set-up and prove serve every test (module
fixture)."""

import hashlib
import json

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu import lasso as jlasso
from halo2_lasso_tpu.backend.hyperplonk import HyperPlonk as JHyperPlonk
from halo2_lasso_tpu.backend.hyperplonk import new_transcript as j_new_transcript
from halo2_lasso_tpu.backend.hyperplonk.fixtures import rand_vanilla_plonk_circuit as j_rand_vanilla_plonk_circuit
from halo2_lasso_tpu.lasso import tables as jtables
from halo2_lasso_tpu.pcs.multilinear_kzg import MultilinearKzg as JKzg
from halo2_lasso_tpu.utils import serialize as jser
from halo2_lasso_tpu_torch import lasso
from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk.fixtures import rand_vanilla_plonk_circuit
from halo2_lasso_tpu_torch.lasso import tables
from halo2_lasso_tpu_torch.lasso.tables import range_table
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
from halo2_lasso_tpu_torch.utils import serialize as ser

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
NV = 2  # tests/test_serialize.py's circuit
LASSO_TABLE, LASSO_M, LASSO_SEED = (4, 4), 8, 11
GOLDEN = chip_smoke.PLONK_SMALL  # nv = 3, the JAX package's golden proof
SMALL = chip_smoke.SMALL  # range_table(8, 4), 16 lookups, SRS seed 3


def plonk_circuit(mod):
    return mod(NV, np.random.RandomState(NV), np.random.RandomState(100 + NV))


def golden_circuit(mod):
    return mod(GOLDEN["num_vars"], *(np.random.RandomState(s) for s in GOLDEN["seeds"]))


def lasso_case():
    rng = np.random.RandomState(LASSO_SEED)
    nv = max(LASSO_M.bit_length() - 1, LASSO_TABLE[0])
    return rng, nv


def small_lasso_nv():
    return max(SMALL["lookups"].bit_length() - 1, SMALL["chunk_bits"])


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """Files across the packages: the JAX package writes the golden
    circuit's HyperPlonk params and the small Lasso set-up; the port loads
    them, proves, and writes them again; the JAX package loads the port's
    files and proves. Returns both packages' proofs and the two folders."""
    jdir, pdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jci, jcircuit = golden_circuit(j_rand_vanilla_plonk_circuit)
    jser.save_hyperplonk_params(str(jdir / "hp"), *JHyperPlonk.preprocess(
        JHyperPlonk.setup(jci, np.random.RandomState(GOLDEN["setup_seed"])), jci))
    nv = small_lasso_nv()
    jser.save_lasso_setup(str(jdir / "lasso"), jtables.range_table(SMALL["index_bits"], SMALL["chunk_bits"]),
                          JKzg.setup(1 << nv, np.random.RandomState(SMALL["srs_seed"])))
    out = {"jdir": jdir, "pdir": pdir, "jcircuit": jcircuit, "indices": chip_smoke.lasso_indices(np, SMALL)}

    pp, vp = ser.load_hyperplonk_params(str(jdir / "hp"), device="cpu")
    _, circuit = golden_circuit(rand_vanilla_plonk_circuit)
    tw = new_transcript()
    HyperPlonk.prove(pp, circuit, tw)
    out.update(plonk=tw.into_proof(), vp=vp, circuit=circuit)
    ser.save_hyperplonk_params(str(pdir / "hp"), pp, vp)
    table, params = ser.load_lasso_setup(str(jdir / "lasso"), device="cpu")
    lpp, lvp = MultilinearKzg.trim(params, 1 << nv)
    out.update(lasso=port_lasso_proof(lpp, table, out["indices"]), table=table, lvp=lvp)
    ser.save_lasso_setup(str(pdir / "lasso"), table, params)

    jpp, jvp = jser.load_hyperplonk_params(str(pdir / "hp"))
    tw = j_new_transcript()
    JHyperPlonk.prove(jpp, jcircuit, tw)
    out.update(jplonk=tw.into_proof(), jvp=jvp)
    jtable, jparams = jser.load_lasso_setup(str(pdir / "lasso"))
    jlpp, jlvp = JKzg.trim(jparams, 1 << nv)
    tw = j_new_transcript()
    jlasso.prove(jlpp, jtable, out["indices"], tw)
    out.update(jlasso=tw.into_proof(), jtable=jtable, jlvp=jlvp)
    return out


def port_plonk_proof(pp):
    _, circuit = plonk_circuit(rand_vanilla_plonk_circuit)
    tw = new_transcript()
    HyperPlonk.prove(pp, circuit, tw)
    return tw.into_proof(), circuit


def port_lasso_proof(pp, table, indices):
    tw = new_transcript()
    lasso.prove(pp, table, indices, tw, device="cpu")
    return tw.into_proof()


# --- tests/test_serialize.py's round trips, through the port ---------------


def test_kzg_params_roundtrip(tmp_path):
    params = MultilinearKzg.setup(1 << 3, np.random.RandomState(7), device="cpu")
    base = str(tmp_path / "kzg")
    ser.save_kzg_params(base, params)
    loaded = ser.load_kzg_params(base, device="cpu")
    assert (loaded.g1, loaded.g2, loaded.ss) == (params.g1, params.g2, params.ss)
    for a, b in zip(loaded.eqs, params.eqs):
        for c in ("x", "y", "z"):
            assert torch.equal(a[c], b[c])


def test_hyperplonk_params_roundtrip_prove_verify(tmp_path):
    ci, circuit = plonk_circuit(rand_vanilla_plonk_circuit)
    pp, vp = HyperPlonk.preprocess(HyperPlonk.setup(ci, np.random.RandomState(0), device="cpu"), ci)
    base = str(tmp_path / "hp")
    ser.save_hyperplonk_params(base, pp, vp)
    pp2, vp2 = ser.load_hyperplonk_params(base, device="cpu")
    proof, _ = port_plonk_proof(pp)
    assert port_plonk_proof(pp2)[0] == proof
    HyperPlonk.verify(vp2, circuit.instances(), new_transcript(proof))


def test_lasso_setup_roundtrip_prove_verify(tmp_path):
    table = range_table(*LASSO_TABLE)
    rng, nv = lasso_case()
    params = MultilinearKzg.setup(1 << nv, rng, device="cpu")
    pp, _ = MultilinearKzg.trim(params, 1 << nv)
    base = str(tmp_path / "lasso")
    ser.save_lasso_setup(base, table, params)
    table2, params2 = ser.load_lasso_setup(base, device="cpu")
    pp2, vp2 = MultilinearKzg.trim(params2, 1 << nv)
    assert table2.name == table.name and table2.num_chunks == table.num_chunks
    indices = [int(v) for v in rng.randint(0, 1 << LASSO_TABLE[0], size=LASSO_M)]
    proof = port_lasso_proof(pp, table, indices)
    assert port_lasso_proof(pp2, table2, indices) == proof
    lasso.verify(vp2, table2, LASSO_M.bit_length() - 1, new_transcript(proof))


# --- files crossing the packages ------------------------------------------


def test_jax_hyperplonk_files_prove_in_the_port(crossed):
    """The JAX package's params, loaded in the port, prove its golden proof."""
    assert hashlib.sha256(crossed["plonk"]).hexdigest() == chip_smoke.GOLDEN_SHA256
    HyperPlonk.verify(crossed["vp"], crossed["circuit"].instances(), new_transcript(crossed["plonk"]))


def test_port_hyperplonk_files_prove_in_jax(crossed):
    assert crossed["jplonk"] == crossed["plonk"]
    JHyperPlonk.verify(crossed["jvp"], crossed["jcircuit"].instances(), j_new_transcript(crossed["jplonk"]))


def test_jax_lasso_files_prove_in_the_port(crossed):
    assert hashlib.sha256(crossed["lasso"]).hexdigest() == chip_smoke.SMALL_PROOF_SHA256
    lasso.verify(crossed["lvp"], crossed["table"], SMALL["lookups"].bit_length() - 1, new_transcript(crossed["lasso"]))


def test_port_lasso_files_prove_in_jax(crossed):
    assert crossed["jlasso"] == crossed["lasso"]
    jlasso.verify(crossed["jlvp"], crossed["jtable"], SMALL["lookups"].bit_length() - 1,
                  j_new_transcript(crossed["jlasso"]))


@pytest.mark.parametrize("name", ["hp", "lasso"])
def test_files_are_equal(crossed, name):
    """The port wrote the JAX package's arrays and JSON for the same params."""
    mine, theirs = str(crossed["pdir"] / name), str(crossed["jdir"] / name)
    a, b = np.load(mine + ".npz"), np.load(theirs + ".npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for ext in [".json"] + ([".lasso.json"] if name == "lasso" else []):
        with open(mine + ext) as f, open(theirs + ext) as g:
            assert json.load(f) == json.load(g)


@pytest.mark.parametrize("factory,args", [("range_table", (16, 16)), ("range_table", (8,)), ("and_table", ()),
                                          ("xor_table", (16, 4)), ("or_table", (8, 4)), ("lt_table", (8, 4))])
def test_table_specs_match(factory, args):
    assert getattr(tables, factory)(*args).spec == getattr(jtables, factory)(*args).spec


def test_load_refuses_another_kind(crossed):
    with pytest.raises(ValueError, match="not multilinear_kzg"):
        ser.load_kzg_params(str(crossed["pdir"] / "hp"), device="cpu")
