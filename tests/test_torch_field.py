"""Port field layer, MLE folds, Keccak and transcript (halo2_lasso_tpu_torch
.ops.field, poly.multilinear, ops.keccak, transcript) against the JAX
package on the CPU: exact agreement as limbs, canonical ints and bytes. The mont_mul and fold_all kernels are held to
their plain versions on the card by tests/test_torch_kernels.py."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import field as JF
from halo2_lasso_tpu.ops.bn254 import Fq as JFq
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.poly import multilinear as jmle
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS
from halo2_lasso_tpu_torch.ops.keccak import keccak256
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript, TranscriptError
from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.scripts import layout_bench

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
RNG = np.random.RandomState(11)
SPECS = [pytest.param(Fr, JFr, id="fr"), pytest.param(Fq, JFq, id="fq")]
N = 64


def rand_ints(p, n):
    return [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(n)]


def operands(spec):
    """N values with the edge cases 0, 1, p-1 and R mod p up front."""
    p = spec.modulus
    a = [0, 1, p - 1, spec.R] + rand_ints(p, N - 4)
    b = [p - 1, p - 1, p - 1, 1] + rand_ints(p, N - 4)
    return a, b


@pytest.mark.parametrize("spec,jspec", SPECS)
def test_repack_round_trip(spec, jspec):
    a, _ = operands(spec)
    jl = jspec.encode(a)
    t = F.from_jax_limbs(jl)
    assert torch.equal(t, spec.encode(a))
    assert spec.decode_ints(t) == a
    assert np.array_equal(F.to_jax_limbs(t), jl)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mont_mul"])
@pytest.mark.parametrize("spec,jspec", SPECS)
def test_field_op_matches_jax(spec, jspec, op):
    a, b = operands(spec)
    ja, jb = jnp.asarray(jspec.encode(a)), jnp.asarray(jspec.encode(b))
    ta, tb = F.from_jax_limbs(np.asarray(ja)), F.from_jax_limbs(np.asarray(jb))
    if op == "neg":
        want, got = JF.neg(jspec, ja), F.neg(spec, ta)
    else:
        want, got = getattr(JF, op)(jspec, ja, jb), getattr(F, op)(spec, ta, tb)
    assert np.array_equal(F.to_jax_limbs(got), np.asarray(want))


def test_u32_to_mont_matches_jax():
    x = np.array([0, 1, 2, 65535, 65536, 2**32 - 1] + list(RNG.randint(0, 2**31, N - 6)), np.uint32)
    want = JF.u32_to_mont(JFr, jnp.asarray(x))
    got = F.u32_to_mont(Fr, torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(F.to_jax_limbs(got), np.asarray(want))


@pytest.mark.parametrize("op", ["batch_inv", "sum_reduce"])
def test_reductions_match_jax(op):
    a, _ = operands(Fr)
    ja = jnp.asarray(JFr.encode(a))
    got = getattr(F, op)(Fr, F.from_jax_limbs(np.asarray(ja)))
    assert np.array_equal(F.to_jax_limbs(got), np.asarray(getattr(JF, op)(JFr, ja)))


@pytest.mark.parametrize("sub", [False, True], ids=["mul_add", "mul_sub"])
@pytest.mark.parametrize("spec,jspec", SPECS)
def test_mul_add_matches_jax(spec, jspec, sub):
    """a * b +- c against the JAX package's mont_mul and add / sub, with b
    and c as tensors, as one broadcast row and as host ints (by value on
    the card)."""
    a, b = operands(spec)
    c = rand_ints(spec.modulus, N)
    ja, jb, jc = (jnp.asarray(jspec.encode(v)) for v in (a, b, c))
    want = np.asarray((JF.sub if sub else JF.add)(jspec, JF.mont_mul(jspec, ja, jb), jc))
    ta, tb, tc = (F.from_jax_limbs(np.asarray(v)) for v in (ja, jb, jc))
    assert np.array_equal(F.to_jax_limbs(F.mul_add(spec, ta, tb, tc, sub=sub)), want)
    want_int = np.asarray((JF.sub if sub else JF.add)(jspec, JF.mont_mul(jspec, ja, jb[3:4]), jc[:1]))
    for b_, c_ in ((tb[3], tc[0]), (b[3], c[0]), (tb[3], c[0])):
        assert np.array_equal(F.to_jax_limbs(F.mul_add(spec, ta, b_, c_, sub=sub)), want_int)


def test_fix_var_chain_matches_jax():
    """The chain's plain path against the JAX package: KZG's quotient
    polys (highest variable first, every quotient) and the evaluation
    (lowest first), with 0, 1 and p - 1 among the coordinates."""
    from halo2_lasso_tpu.pcs.multilinear_kzg import MultilinearKzg as JKzg
    from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg

    p = Fr.modulus
    point = [0, 1, p - 1] + rand_ints(p, 3)
    jp = jnp.asarray(JFr.encode(rand_ints(p, N)))
    tp = F.from_jax_limbs(np.asarray(jp))
    jq, jrem = JKzg.quotient_polys(jp, point)
    tq, trem = MultilinearKzg.quotient_polys(tp, point)
    assert [i for i, _ in tq] == [i for i, _ in jq] == list(range(6))
    for (_, q), (_, want) in zip(tq, jq):
        assert np.array_equal(F.to_jax_limbs(q), np.asarray(want))
    assert np.array_equal(F.to_jax_limbs(trem), np.asarray(jrem))
    got = mle.evaluate(Fr, tp, point)
    assert np.array_equal(F.to_jax_limbs(got), np.asarray(jmle.evaluate(JFr, jp, jnp.asarray(JFr.encode(point)))))


@pytest.mark.parametrize(
    "case",
    ["dtype", "limbs", "out_shape", "first_int", "sum_dim", "sum_empty", "chain_vars", "chain_odd",
     "chain_quotients", "chain_point"],
)
def test_wrapper_argument_checks(case):
    """The field and chain wrappers check their arguments on either device,
    before the plain path or a launch: int32 (..., 8) rows, an out tensor of
    the result's shape, a tensor first operand, (n, ..., 8) sums with
    n >= 1, at most 32 chain variables, a table that splits into 2^j, and
    quotients only for a whole chain."""
    t = Fr.encode(rand_ints(Fr.modulus, 8))
    with pytest.raises(ValueError):
        {
            "dtype": lambda: F.mont_mul(Fr, t.long(), t),
            "limbs": lambda: F.add(Fr, t, t[:, :7]),
            "out_shape": lambda: F.mont_mul(Fr, t, 5, out=torch.empty_like(t[:4])),
            "first_int": lambda: F.sub(Fr, 5, t),
            "sum_dim": lambda: F.sum_reduce(Fr, t[0]),
            "sum_empty": lambda: F.sum_reduce(Fr, t[:0]),
            "chain_vars": lambda: mle.fix_var_chain(Fr, t, [1] * (mle.MAX_CHAIN_VARS + 1), last=True),
            "chain_odd": lambda: mle.fix_var_chain(Fr, t[:5], [3], last=False),
            "chain_quotients": lambda: mle.fix_var_chain(Fr, t, [1, 2], last=True, quotients=True),
            "chain_point": lambda: mle.fix_var_chain(Fr, t, t[:2, :4], last=False),
        }[case]()


@pytest.mark.parametrize("op", ["pow_fixed", "prefix_products", "prefix_products_reverse"])
def test_chains_match_jax(op):
    """The chains that csrc/mont_chain.cu runs in one launch each, through
    their plain versions: pow_fixed (Fermat's exponent p - 2) against the
    JAX package's, and the prefix products both ways against
    jax.lax.associative_scan over its mont_mul (as its batch_inv scans)."""
    import functools

    import jax

    a, _ = operands(Fr)
    ja = jnp.asarray(JFr.encode(a))
    ta = F.from_jax_limbs(np.asarray(ja))
    if op == "pow_fixed":
        got, want = F.pow_fixed(Fr, ta, Fr.modulus - 2), JF.pow_fixed(JFr, ja, Fr.modulus - 2)
    else:
        reverse = op.endswith("reverse")
        got = F.prefix_products(Fr, ta, reverse=reverse)
        want = jax.lax.associative_scan(functools.partial(JF.mont_mul, JFr), ja, reverse=reverse)
    assert np.array_equal(F.to_jax_limbs(got), np.asarray(want))


@pytest.mark.parametrize("last", [False, True], ids=["fix_var", "fix_last_var"])
def test_fold_all_matches_jax(last):
    tables = [rand_ints(Fr.modulus, N) for _ in range(3)]
    jx = jnp.asarray(JFr.encode(rand_ints(Fr.modulus, 1)))[0]
    jt = [jnp.asarray(JFr.encode(t)) for t in tables]
    tt = [F.from_jax_limbs(np.asarray(t)) for t in jt]
    tx = F.from_jax_limbs(np.asarray(jx))
    jfold = jmle.fix_last_var if last else jmle.fix_var
    for got, j in zip(mle.fold_all(Fr, tt, tx, last=last), jt):
        assert np.array_equal(F.to_jax_limbs(got), np.asarray(jfold(JFr, j, jx)))
    assert torch.equal(mle.fix_var_chain(Fr, tt[0], tx[None], last)[0], mle.fold_all(Fr, tt, tx, last=last)[0])
    x = Fr.decode_ints(tx[None])[0]  # the challenge as the sumchecks pass it, a host int
    assert all(torch.equal(a, b) for a, b in zip(mle.fold_all(Fr, tt, x, last=last), mle.fold_all(Fr, tt, tx, last=last)))


@pytest.mark.parametrize("last", [False, True], ids=["fix_var", "fix_last_var"])
def test_fix_var_matches_jax(last):
    """The single-table fold (K5's plain path) against the JAX package, with
    0, 1, p-1 and R mod p among the table and the challenge values, at a
    ragged half-length (37 pairs)."""
    p = Fr.modulus
    vals = [0, 1, p - 1, Fr.R, p - 1, 0, 1, p - 1] + rand_ints(p, 66)
    jt = jnp.asarray(JFr.encode(vals))
    tt = F.from_jax_limbs(np.asarray(jt))
    jfold = jmle.fix_last_var if last else jmle.fix_var
    for x in [0, 1, p - 1, Fr.R] + rand_ints(p, 1):
        jx = jnp.asarray(JFr.encode([x]))[0]
        got = mle.fix_var_chain(Fr, tt, F.from_jax_limbs(np.asarray(jx))[None], last)[0]
        assert np.array_equal(F.to_jax_limbs(got), np.asarray(jfold(JFr, jt, jx)))


def test_layout_products_match_jax():
    """The plain versions of K6 (limbs-first (8, n)) and K7 ((8, n/128,
    128)) at n = 2^10 against the JAX package's mont_mul over Fr
    (ops/field.py:329) on the transposed (n, 16) inputs, with 0, 1, p-1 and
    R mod p among the entries. The TPU layout bench's own kernels
    (scripts/tpu_layout_bench.py) are not imported: they have no interpret
    mode, use pltpu.VMEM, and importing that script repoints JAX's
    compilation cache to .jax_cache_tpu."""
    n, p = 1 << 10, Fr.modulus
    a = [0, 1, p - 1, Fr.R] + rand_ints(p, n - 4)
    b = [p - 1, Fr.R, p - 1, 1] + rand_ints(p, n - 4)
    ja, jb = jnp.asarray(JFr.encode(a)), jnp.asarray(JFr.encode(b))
    want = np.asarray(JF.mont_mul(JFr, ja, jb))
    a_lf = F.from_jax_limbs(np.asarray(ja)).T.contiguous()
    b_lf = F.from_jax_limbs(np.asarray(jb)).T.contiguous()
    k6 = layout_bench.mont_mul_limbs_first(a_lf, b_lf)
    k7 = layout_bench.mont_mul_tiled(a_lf.view(8, -1, 128), b_lf.view(8, -1, 128))
    assert np.array_equal(F.to_jax_limbs(k6.T), want)
    assert np.array_equal(F.to_jax_limbs(k7.reshape(8, n).T), want)
    with pytest.raises(ValueError):
        layout_bench.mont_mul_tiled(a_lf.view(8, -1, 64), b_lf.view(8, -1, 64))


def test_eq_xy_matches_jax():
    y = rand_ints(Fr.modulus, 6)
    jy = jnp.asarray(JFr.encode(y))
    eq = mle.eq_xy(Fr, F.from_jax_limbs(np.asarray(jy)))
    assert np.array_equal(F.to_jax_limbs(eq), np.asarray(jmle.eq_xy(JFr, jy)))
    assert torch.equal(mle.eq_xy(Fr, y, "cpu"), eq)  # the point as host ints


def test_evaluate_matches_jax():
    jy = jnp.asarray(JFr.encode(rand_ints(Fr.modulus, 6)))
    jp = jnp.asarray(JFr.encode(rand_ints(Fr.modulus, 1 << 6)))
    got = mle.evaluate(Fr, F.from_jax_limbs(np.asarray(jp)), F.from_jax_limbs(np.asarray(jy)))
    assert np.array_equal(F.to_jax_limbs(got), np.asarray(jmle.evaluate(JFr, jp, jy)))


def test_evaluate_stacked_ints_matches_jax():
    y = rand_ints(Fr.modulus, 6)
    jp = [jnp.asarray(JFr.encode(rand_ints(Fr.modulus, 1 << 6))) for _ in range(3)]
    tp = [F.from_jax_limbs(np.asarray(p)) for p in jp]
    assert mle.evaluate_stacked_ints(Fr, tp, y) == jmle.evaluate_stacked_ints(JFr, jp, y)


@pytest.mark.parametrize(
    "msg,digest",
    [
        (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
        (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
        (b"The quick brown fox jumps over the lazy dog",
         "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15"),
        (bytes(range(256)) * 3, None),  # multi-block: against the JAX package
    ],
)
def test_keccak_vectors(msg, digest):
    from halo2_lasso_tpu.ops.keccak import keccak256 as jkeccak256

    assert keccak256(msg).hex() == (digest or jkeccak256(msg).hex())


def test_transcript_bytes_match_jax():
    p = Fr.modulus
    script = [("fe", v) for v in rand_ints(p, 3)] + [("comm", (1, 2)), ("comm", (0, 0)), ("sq", 2), ("fe", p - 1), ("sq", 1)]
    streams = []
    for cls in (Keccak256Transcript, JTranscript):
        t = cls(p, base_modulus=FQ_MODULUS, curve_b=3)
        out = []
        for kind, v in script:
            if kind == "fe":
                t.write_field_element(v)
            elif kind == "comm":
                t.write_commitment(v)
            else:
                out.append(t.squeeze_challenges(v))
        streams.append((t.into_proof(), out))
    assert streams[0] == streams[1]
    r = Keccak256Transcript(p, base_modulus=FQ_MODULUS, proof=streams[0][0], curve_b=3)
    assert r.read_field_elements(3) == [v for k, v in script[:3]]
    assert r.read_commitments(2) == [(1, 2), (0, 0)]
    bad = Keccak256Transcript(p, base_modulus=FQ_MODULUS, proof=(1).to_bytes(32, "big") * 2, curve_b=3)
    with pytest.raises(TranscriptError):
        bad.read_commitment()  # (1, 1) is not on y^2 = x^3 + 3


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "halo2_lasso_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "halo2_lasso_tpu"), f"{f} imports {mod}"
