"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the JAX package, so they run on a machine
with a GPU and no JAX. Without a visible GPU they skip. On the card:

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

(`--noconftest`: tests/conftest.py configures JAX, which that machine lacks.)
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu_torch import lasso
from halo2_lasso_tpu_torch.expression import Expression
from halo2_lasso_tpu_torch.lasso.tables import range_table
from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, FR_MODULUS, Fq, Fr
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
from halo2_lasso_tpu_torch.piop import gkr
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.scripts import layout_bench
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

RNG = np.random.RandomState(21)
pytestmark = pytest.mark.cuda
# the field instances of K4 (csrc/mont_mul.cu, csrc/mont_chain.cu and their
# Pasta source csrc/mont_pasta.cu) and the curves of K3's
FIELDS = [Fr, Fq, curves.Fp_pallas, curves.Fq_vesta]
FIELD_IDS = ["fr", "fq", "pallas", "vesta"]
CURVES = [curves.BN254_G1, curves.GRUMPKIN, curves.PALLAS, curves.VESTA]
CURVE_IDS = ["bn254", "grumpkin", "pallas", "vesta"]
# a field no kernel has an instance for
NO_KERNELS = F.FieldSpec(name="no_kernels", modulus=curves.PALLAS_MODULUS, kernel_id=None)


def counted(kernel, spec):
    """native.counts' name of `kernel`'s instance for the field (K3: the
    curve's coordinate field) `spec`; the kernel's own for its first."""
    if kernel in ("ec_add", "msm_level", "ec_ladder", "plane_tree"):
        inst = native.CURVES[spec.kernel_id]
    elif kernel in ("sumcheck_round", "fold_all"):
        inst = "fq" if spec.kernel_id == 1 else ""
    else:
        inst = native.PASTA.get(spec.kernel_id, "")
    return f"{kernel}.{inst}" if inst else kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


def rand_ints(p, n):
    return [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(n)]


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
def test_mont_mul_kernel_matches_plain(cuda, spec):
    p = spec.modulus
    a = spec.encode([0, 1, p - 1, spec.R] + rand_ints(p, 1000), cuda)
    b = spec.encode([p - 1, p - 1, p - 1, 1] + rand_ints(p, 1000), cuda)
    assert torch.equal(F.mont_mul(spec, a, b), F.mont_mul_plain(spec, a, b))
    assert torch.equal(F.mont_mul(spec, a, b[5]), F.mont_mul_plain(spec, a, b[5]))


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
@pytest.mark.parametrize("n", [1, 257, 1037, 1 << 16])
def test_ew_kernel_matches_plain(cuda, spec, n):
    """Every op code of csrc/mont_mul.cu against the plain versions on the
    same card operands (strided, broadcast, by value): one launch each, no
    host sync, no carry pass on the card."""
    p = spec.modulus
    rows = spec.encode([0, 1, p - 1, spec.R] + rand_ints(p, 4 * n), cuda)[: 4 * n].contiguous()
    for a, b, c in chip_smoke.ew_cases(rows, rand_ints(p, 1)[0], p - 1):
        for op in range(6):
            args = [a, b, c][: F._EW_ARGS[op]]
            norm = F.norm_on_card
            got, k = launches(lambda: no_sync(lambda: F._ew(spec, op, *args)), "mont_mul", counted("mont_mul", spec))
            assert k == (1, 1) and F.norm_on_card == norm
            vals = [x if isinstance(x, torch.Tensor) else spec.encode([x], cuda)[0] for x in args]
            want = F._ew_plain(spec, op, *vals)
            assert torch.equal(got, want.expand(got.shape)), (op, n)
    a, b, _ = chip_smoke.ew_cases(rows, 0, 0)[0]
    out = torch.empty_like(a)
    assert F.mont_mul(spec, a, b, out=out) is out
    assert torch.equal(out, F.mont_mul_plain(spec, a, b))


@pytest.mark.parametrize("spec", [Fr, Fq], ids=["fr", "fq"])
@pytest.mark.parametrize("n", [1, 257, (1 << 15) + 3])
def test_sum_reduce_kernel_matches_plain(cuda, spec, n):
    """One launch, no host sync: (n, 8) rows, a batch of 2 x 6 columns, and
    the coefficient prover's transposed (h, 2T) view read in place."""
    p = spec.modulus
    a = spec.encode([p - 1] * 3 + rand_ints(p, 12 * n), cuda)[: 12 * n].contiguous()
    for x in (a[:n], a.view(n, 2, 6, 8), a.view(12, n, 8).transpose(0, 1)):
        got, k = launches(lambda: no_sync(lambda: F.sum_reduce(spec, x)), "sum_reduce")
        assert k == (1,) and torch.equal(got, F.sum_reduce_plain(spec, x)), x.shape


@pytest.mark.parametrize("spec", [Fr, Fq], ids=["fr", "fq"])
@pytest.mark.parametrize("k", [0, 1, 5, 12, 13, 16])
def test_fix_var_chain_kernel_matches_plain(cuda, spec, k):
    """Both directions, with and without the packed quotients, the point
    as host ints (no sync, no copy) and on the card: one launch (none at
    k = 0); and binding 3 of the variables of a 3 * 2^k table."""
    p = spec.modulus
    t = spec.encode([0, 1, p - 1, spec.R] + rand_ints(p, 3 << k), cuda)[: 3 << k].contiguous()
    y = ([0, 1, p - 1] + rand_ints(p, k))[:k]
    ty = spec.encode(y, cuda) if k else spec.zeros(0, cuda)
    for last in (False, True):
        for quot in (False, True):
            want = mle.fix_var_chain_plain(spec, t[: 1 << k], ty, last, quot)
            for point in (y, ty):
                got, n = launches(lambda: mle.fix_var_chain(spec, t[: 1 << k], point, last, quot), "fix_var")
                assert n == (int(k > 0),) and torch.equal(got[0], want[0])
                assert not quot or torch.equal(got[1], want[1])
            no_sync(lambda: mle.fix_var_chain(spec, t[: 1 << k], y, last, quot))
        if k >= 3:
            pt = rand_ints(p, 3)
            got = mle.fix_var_chain(spec, t, pt, last)[0]
            assert torch.equal(got, mle.fix_var_chain_plain(spec, t, spec.encode(pt, cuda), last)[0])


@pytest.mark.parametrize("size", [1 << 12, 9 * 128, 1037], ids=["pow2", "partial_tile", "ragged"])
def test_layout_kernels_match_plain_and_mont_mul(cuda, size):
    """K6 and K7 against their plain versions and K4 (transposed); each
    launch moves its counter by one. K7 takes only multiples of 128."""
    p = Fr.modulus
    a = Fr.encode([0, 1, p - 1, Fr.R] + rand_ints(p, size - 4), cuda)
    b = Fr.encode([p - 1, Fr.R, p - 1, 1] + rand_ints(p, size - 4), cuda)
    want = F.mont_mul(Fr, a, b).T
    a_lf, b_lf = a.T.contiguous(), b.T.contiguous()
    before = native.counts["mont_mul_limbs_first"]
    got = layout_bench.mont_mul_limbs_first(a_lf, b_lf)
    assert native.counts["mont_mul_limbs_first"] == before + 1
    assert torch.equal(got, want) and torch.equal(got, layout_bench.mont_mul_limbs_first_plain(a_lf, b_lf))
    if size % 128:
        with pytest.raises(ValueError):
            layout_bench.mont_mul_tiled(a_lf[:, None], b_lf[:, None])
        return
    a_t, b_t = a_lf.view(8, -1, 128), b_lf.view(8, -1, 128)
    before = native.counts["mont_mul_tiled"]
    got = layout_bench.mont_mul_tiled(a_t, b_t)
    assert native.counts["mont_mul_tiled"] == before + 1
    assert torch.equal(got.reshape(8, size), want) and torch.equal(got, layout_bench.mont_mul_tiled_plain(a_t, b_t))


def no_sync(fn):
    return chip_smoke.no_sync(torch, fn)


def launches(fn, *names):
    """(fn(), the launches it made of each kernel named)."""
    before = {k: native.counts[k] for k in names}
    out = fn()
    return out, tuple(native.counts[k] - before[k] for k in names)


@pytest.mark.parametrize("ntables", [1, 37, 64, 65])
def test_fold_all_kernel_matches_plain(cuda, ntables):
    """Both pair strides, the challenge as a host int (no sync, no copy) and
    as a card tensor; one launch up to 64 tables, two beyond."""
    tables = [Fr.encode(rand_ints(Fr.modulus, 1 << 6), cuda) for _ in range(ntables)]
    xv = rand_ints(Fr.modulus, 1)[0]
    x = Fr.encode([xv], cuda)[0]
    groups = -(-ntables // mle.FOLD_MAX_TABLES)
    for last in (False, True):
        want = mle.fold_all_plain(Fr, tables, x, last=last)
        got, n = launches(lambda: no_sync(lambda: mle.fold_all(Fr, tables, xv, last=last)), "fold_all")
        assert n == (groups,) and all(torch.equal(g, w) for g, w in zip(got, want))
        got, n = launches(lambda: mle.fold_all(Fr, tables, x, last=last), "fold_all")
        assert n == (groups,) and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
def test_mont_pow_kernel_matches_plain(cuda, spec):
    """Exponents 0, 1, 2, p - 2 and a random 254-bit one on one row and on
    304 rows with 0, 1, p - 1 and R mod p: one launch each."""
    p = spec.modulus
    rows = spec.encode([0, 1, p - 1, spec.R] + rand_ints(p, 300), cuda)
    for a in (rows[3:4], rows):
        for e in (0, 1, 2, p - 2, int.from_bytes(RNG.bytes(32), "little") % (1 << 254) | 1 << 253):
            got, n = launches(lambda: F.pow_fixed(spec, a, e), "mont_pow", counted("mont_pow", spec))
            assert n == (1, 1) and torch.equal(got, F.pow_fixed_plain(spec, a, e)), e


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1024, 1025, (1 << 17) + 3])
def test_prefix_products_kernel_matches_plain(cuda, n):
    """Both directions; 1 launch up to one tile (1024 rows), else 3."""
    x = Fr.encode([0, 1, Fr.modulus - 1, Fr.R] + rand_ints(Fr.modulus, n), cuda)[:n].contiguous()
    for reverse in (False, True):
        got, k = launches(lambda: no_sync(lambda: F.prefix_products(Fr, x, reverse)), "prefix_products")
        assert k == ((1 if n <= F.SCAN_TILE else 3),)
        assert torch.equal(got, F.prefix_products_plain(Fr, x, reverse))


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
@pytest.mark.parametrize("n", [1, 257, 1025, (1 << 17) + 3])
def test_batch_inv_kernel_matches_plain(cuda, spec, n):
    """Zero rows stay zero; the scan's phases and one mont_pow, a fixed
    number of launches whatever n is, and no host sync or copy."""
    p = spec.modulus
    a = spec.encode([0, 1, p - 1, spec.R] + rand_ints(p, n), cuda)[:n].contiguous()
    a[7::11] = 0
    got, k = launches(lambda: no_sync(lambda: F.batch_inv(spec, a)), "prefix_products", "mont_pow")
    assert k == ((2 if n <= F.SCAN_TILE else 3), 1)
    assert torch.equal(got, F.batch_inv_plain(spec, a))


@pytest.mark.parametrize("spec", [curves.Fp_pallas, curves.Fq_vesta], ids=["pallas", "vesta"])
@pytest.mark.parametrize("n", [1, 1024, 1025, (1 << 17) + 3])
def test_prefix_products_kernel_pasta_instances_match_plain(cuda, spec, n):
    """The scan over the Pasta fields (csrc/mont_pasta.cu), both
    directions, with 0, 1, p - 1 and R mod p among the rows: 1 launch up to
    one tile, else 3, each counted to the instance."""
    p = spec.modulus
    x = spec.encode([0, 1, p - 1, spec.R] + rand_ints(p, n), cuda)[:n].contiguous()
    for reverse in (False, True):
        got, k = launches(lambda: no_sync(lambda: F.prefix_products(spec, x, reverse)), "prefix_products",
                          counted("prefix_products", spec))
        assert k == ((1, 1) if n <= F.SCAN_TILE else (3, 3))
        assert torch.equal(got, F.prefix_products_plain(spec, x, reverse))


@pytest.mark.parametrize("k", [0, 1, 5, 9, 16])
def test_eq_xy_kernel_matches_plain(cuda, k):
    """One launch, the point as host ints (no sync, no copy) or on the card,
    with 0, 1 and p - 1 among the coordinates."""
    y = ([0, 1, Fr.modulus - 1] + rand_ints(Fr.modulus, k))[:k]
    ty = Fr.encode(y, cuda) if k else Fr.zeros(0, cuda)
    want = mle.eq_xy_plain(Fr, ty)
    got, n = launches(lambda: no_sync(lambda: mle.eq_xy(Fr, y, cuda)), "eq_xy")
    assert n == (1,) and torch.equal(got, want)
    got, n = launches(lambda: mle.eq_xy(Fr, ty), "eq_xy")
    assert n == (1,) and torch.equal(got, want)


@pytest.mark.parametrize("size", [1 << 12, 2 * 1037], ids=["pow2", "ragged"])
@pytest.mark.parametrize("last", [False, True], ids=["fix_var", "fix_last_var"])
def test_fix_var_kernel_matches_plain(cuda, last, size):
    p = Fr.modulus
    t = Fr.encode([0, 1, p - 1, Fr.R, p - 1, 0, 1, p - 1] + rand_ints(p, size - 8), cuda)
    for xv in (0, 1, p - 1, Fr.R, rand_ints(p, 1)[0]):
        x = Fr.encode([xv], cuda)[0]
        before = native.counts["fix_var"]
        assert torch.equal(mle.fix_var_chain(Fr, t, x[None], last)[0], mle.fix_var_plain(Fr, t, x, last))
        assert native.counts["fix_var"] == before + 1


def _degree_expr(d):
    """A degree-d expression over three polys: poly_0 * challenge - 3, times
    d - 1 more polys, every other one negated."""
    e = Expression.poly(0) * Expression.challenge(0) - Expression.constant(3)
    for i in range(1, d):
        e = e * (Expression.poly(i % 3) if i % 2 else -Expression.poly(i % 3))
    return e, 3


@pytest.mark.parametrize(
    "expr,n_polys",
    [
        (Expression.eq_xy(0) * range_table(16, 16).g, 1),
        (gkr.sum_check_expression_pure(2), 4),
        (Expression.eq_xy(0) * (Expression.lagrange(1) * Expression.poly(0) + Expression.identity())
         - Expression.poly(1) * 5 + Expression.constant(7), 2),
        _degree_expr(1), _degree_expr(3), _degree_expr(5), _degree_expr(8),
    ],
    ids=["lasso_primary", "gkr_pure", "lagrange_identity_neg_const", "degree1", "degree3", "degree5", "degree8"],
)
@pytest.mark.parametrize("pairs", [1 << 10, 1, 1037], ids=["pow2", "h1", "ragged"])
def test_round_kernel_matches_plain(cuda, expr, n_polys, pairs):
    """One launch per call (the counter moves by one) and no host sync or
    host-to-device copy in it, bit-exact against the plain version."""
    keys = sc._leaf_keys(expr, n_polys)
    prog = sc.lower_expression(expr, keys)
    tables = [Fr.encode(rand_ints(Fr.modulus, 2 * pairs), cuda) for _ in keys]
    chals = Fr.encode(rand_ints(Fr.modulus, 1), cuda) if expr.used_challenge else None
    before = native.counts["sumcheck_round"]
    got = no_sync(lambda: sc.round_message(Fr, tables, prog, chals, expr.degree))
    assert native.counts["sumcheck_round"] == before + 1
    assert torch.equal(got, sc.round_message_plain(Fr, tables, prog, chals, expr.degree))


def test_round_kernel_on_the_lasso_zero_check(cuda):
    """The nv = 16 Lasso-in-HyperPlonk zero check's expression (37 leaves,
    degree 3, stack 3 with the deeper operand first) at 2^12."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor

    ci, _ = fixtures.rand_lasso_circuit(16, np.random.RandomState(16), np.random.RandomState(516),
                                        **chip_smoke.LASSO_PLONK["kwargs"])
    nz, expr = preprocessor.compose(ci)
    n_polys = ci.num_poly() + preprocessor.num_lasso_polys(ci) + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz
    keys = sc._leaf_keys(expr, n_polys)
    prog = sc.lower_expression(expr, keys)
    assert (len(keys), expr.degree, prog.max_stack) == (37, 3, 3)
    tables = [Fr.encode(rand_ints(Fr.modulus, 1 << 12), cuda) for _ in keys]
    chals = Fr.encode(rand_ints(Fr.modulus, 3), cuda)
    got = sc.round_message(Fr, tables, prog, chals, expr.degree)
    assert torch.equal(got, sc.round_message_plain(Fr, tables, prog, chals, expr.degree))


def test_ec_add_kernel_matches_plain_and_host(cuda):
    ps, qs = chip_smoke.ec_cases(np, RNG, MJ, FQ_MODULUS, 640)
    p = {k: Fq.encode([pt[i] for pt in ps], cuda) for i, k in enumerate(ec.COORDS)}
    q = {k: Fq.encode([pt[i] for pt in qs], cuda) for i, k in enumerate(ec.COORDS)}
    got, want = ec.ec_add(p, q), ec.ec_add_plain(p, q)
    assert all(torch.equal(got[k], want[k]) for k in ec.COORDS)
    host = [MJ.host_jac_add(a, b, FQ_MODULUS) for a, b in zip(ps, qs)]
    assert ec.jacobian_to_affine(got) == MJ.host_batch_affine(host, FQ_MODULUS)


@pytest.mark.parametrize("n", [1 << 9, 1 << 12])
def test_msm_on_card_matches_cpu(cuda, n):
    """The MSM on the card against the CPU's; its device part launches
    msm_level log2(n) times and once more for the final flush, and never
    syncs with the host."""
    ps, _ = chip_smoke.ec_cases(np, RNG, MJ, FQ_MODULUS, n)
    pts = {k: Fq.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    scal = Fr.encode(rand_ints(Fr.modulus, n))
    on_card = ec.msm_to_affine_int({k: v.to(cuda) for k, v in pts.items()}, scal.to(cuda))
    assert on_card == ec.msm_to_affine_int(pts, scal)
    card_pts, card_scal = {k: v.to(cuda) for k, v in pts.items()}, scal.to(cuda)
    before = native.counts["msm_level"]
    no_sync(lambda: MJ.msm_planes(card_pts, card_scal))
    assert native.counts["msm_level"] == before + n.bit_length()


def test_msm_level_kernel_matches_plain(cuda):
    """Every level of a 64-point MSM (c = 3) on the card against the plain
    level on the same inputs: survivors, digits and buckets, bit for bit,
    one launch a level. Two base points, rescaled and some negated, give
    P = Q and P = -Q lanes; a third of the scalars are 0 (digit-0 slots) and
    one point is the identity."""
    points = chip_smoke.msm_edge_points(np, RNG, MJ, FQ_MODULUS, cuda)
    before = native.counts["msm_level"]
    assert chip_smoke.check_msm_levels(torch, np, RNG, cuda, points, 64, Fr) == 0
    assert native.counts["msm_level"] == before + 7  # six levels and the final flush


def test_small_lasso_proof_on_card_matches_jax(cuda):
    """Byte-equal to the JAX package's proof, with no plain carry pass
    (ops/field.py's _norm) run on the card."""
    norm = F.norm_on_card
    cfg = chip_smoke.SMALL
    rng = np.random.RandomState(cfg["index_seed"])
    indices = [int(rng.randint(1 << cfg["index_bits"])) for _ in range(cfg["lookups"])]
    nv = max(cfg["lookups"].bit_length() - 1, cfg["chunk_bits"])
    param = MultilinearKzg.setup(1 << nv, np.random.RandomState(cfg["srs_seed"]), device=cuda)
    pp, _ = MultilinearKzg.trim(param, 1 << nv)
    t = Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, curve_b=3)
    lasso.prove(pp, range_table(cfg["index_bits"], cfg["chunk_bits"]), indices, t, device=cuda)
    assert hashlib.sha256(t.into_proof()).hexdigest() == chip_smoke.SMALL_PROOF_SHA256
    assert F.norm_on_card == norm


def test_small_hyperplonk_proof_on_card_is_golden(cuda):
    norm = F.norm_on_card
    proof, _ = chip_smoke.hyperplonk_proof(np, chip_smoke.PLONK_SMALL, cuda)
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.GOLDEN_SHA256
    assert F.norm_on_card == norm


def test_small_lasso_hyperplonk_proof_on_card_matches_jax(cuda):
    norm = F.norm_on_card
    proof, _ = chip_smoke.hyperplonk_proof(np, chip_smoke.LASSO_PLONK_SMALL, cuda)
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.LASSO_PLONK_SHA256
    assert F.norm_on_card == norm


# the grumpkin SNARK's field instances: K1 and K2 over BN254 Fq, K3's add and
# level over grumpkin (coordinates in BN254 Fr, scalars in Fq)


@pytest.mark.parametrize("pairs", [1 << 10, 1, 1037], ids=["pow2", "h1", "ragged"])
def test_round_kernel_fq_instance_matches_plain(cuda, pairs):
    """The Fq instance on the grumpkin SNARK's zero check (the vanilla
    circuit with lookup: 23 leaves, degree 5) and on a degree-8 program: one
    launch of the instance each, no host sync, bit-exact."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor

    ci = fixtures.vanilla_plonk_with_lookup_circuit_info(4, 4, [[0]] * 9, [[(10, 1), (11, 1), (12, 1)]])
    nz, zexpr = preprocessor.compose(ci)
    cases = [(zexpr, ci.num_poly() + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz), _degree_expr(8)]
    for expr, n_polys in cases:
        keys = sc._leaf_keys(expr, n_polys)
        prog = sc.lower_expression(expr, keys)
        tables = [Fq.encode([0, 1, FQ_MODULUS - 1, Fq.R] + rand_ints(FQ_MODULUS, 2 * pairs), cuda)[: 2 * pairs]
                  .contiguous() for _ in keys]
        chals = Fq.encode(rand_ints(FQ_MODULUS, 3), cuda)
        got, n = launches(lambda: no_sync(lambda: sc.round_message(Fq, tables, prog, chals, expr.degree)),
                          "sumcheck_round", "sumcheck_round.fq")
        assert n == (1, 1)
        assert torch.equal(got, sc.round_message_plain(Fq, tables, prog, chals, expr.degree))


@pytest.mark.parametrize("ntables", [1, 23, 65])
def test_fold_all_kernel_fq_instance_matches_plain(cuda, ntables):
    tables = [Fq.encode([0, 1, FQ_MODULUS - 1, Fq.R] + rand_ints(FQ_MODULUS, (1 << 6) - 4), cuda)
              for _ in range(ntables)]
    xv = rand_ints(FQ_MODULUS, 1)[0]
    x = Fq.encode([xv], cuda)[0]
    groups = -(-ntables // mle.FOLD_MAX_TABLES)
    for last in (False, True):
        want = mle.fold_all_plain(Fq, tables, x, last=last)
        for xc in (xv, x):
            got, n = launches(lambda: mle.fold_all(Fq, tables, xc, last=last), "fold_all", "fold_all.fq")
            assert n == (groups, groups) and all(torch.equal(g, w) for g, w in zip(got, want))


def test_ec_add_kernel_grumpkin_instance_matches_plain_and_host(cuda):
    ps, qs = chip_smoke.ec_cases(np, RNG, MJ, FR_MODULUS, 640, curves.GRUMPKIN.generator)
    p = {k: Fr.encode([pt[i] for pt in ps], cuda) for i, k in enumerate(ec.COORDS)}
    q = {k: Fr.encode([pt[i] for pt in qs], cuda) for i, k in enumerate(ec.COORDS)}
    got, n = launches(lambda: ec.ec_add(p, q, Fr), "ec_add", "ec_add.grumpkin")
    want = ec.ec_add_plain(p, q, Fr)
    assert n == (1, 1) and all(torch.equal(got[k], want[k]) for k in ec.COORDS)
    host = [MJ.host_jac_add(a, b, FR_MODULUS) for a, b in zip(ps, qs)]
    assert ec.jacobian_to_affine(got, Fr) == MJ.host_batch_affine(host, FR_MODULUS)


def test_msm_level_kernel_grumpkin_instance_matches_plain(cuda):
    """Every level of a 64-point grumpkin MSM on the card against the plain
    level (P = Q, P = -Q, digit-0 and identity lanes); then a 2^9 grumpkin
    MSM on the card against the CPU's, its device part 10 launches of the
    grumpkin instance with no host sync."""
    points = chip_smoke.msm_edge_points(np, RNG, MJ, FR_MODULUS, cuda, curve=curves.GRUMPKIN)
    before = native.counts["msm_level.grumpkin"]
    assert chip_smoke.check_msm_levels(torch, np, RNG, cuda, points, 64, Fq, Fr) == 0
    assert native.counts["msm_level.grumpkin"] == before + 7
    ps, _ = chip_smoke.ec_cases(np, RNG, MJ, FR_MODULUS, 1 << 9, curves.GRUMPKIN.generator)
    pts = {k: Fr.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    scal = Fq.encode(rand_ints(FQ_MODULUS, 1 << 9))
    card_pts, card_scal = {k: v.to(cuda) for k, v in pts.items()}, scal.to(cuda)
    assert ec.msm_to_affine_int(card_pts, card_scal, Fr, Fq) == ec.msm_to_affine_int(pts, scal, Fr, Fq)
    _, n = launches(lambda: no_sync(lambda: MJ.msm_planes(card_pts, card_scal, Fr, Fq)), "msm_level.grumpkin")
    assert n == (10,)


def test_kernels_raise_for_a_field_without_instance(cuda):
    """A CUDA tensor over a field with no compiled instance (kernel_id
    None) raises in each wrapper; nothing falls back to the plain
    version."""
    spec = NO_KERNELS
    t = [spec.encode([1, 2, 3, 4], cuda) for _ in range(2)]
    prog = sc.lower_expression(Expression.poly(0) * Expression.poly(1), [("poly", 0, 0), ("poly", 1, 0)])
    pts = ec.identity_point(4, cuda, spec)
    with pytest.raises(ValueError):
        sc.round_message(spec, t, prog, None, 2)
    with pytest.raises(ValueError):
        mle.fold_all(spec, t, 5)
    with pytest.raises(ValueError):
        ec.ec_add(pts, pts, spec)
    dig = torch.zeros(4, dtype=torch.int32, device=cuda)
    bucket = ec.identity_point(5, cuda, spec)
    with pytest.raises(ValueError):
        MJ.msm_level(pts, dig, bucket, 2, 2, base=spec)


# K3's ladder and plane tree (csrc/ec_add.cu), in both curve instances


@pytest.mark.parametrize("curve", CURVES, ids=CURVE_IDS)
def test_ec_ladder_kernel_matches_plain(cuda, curve):
    """The ladder over 64 points (every fifth the identity) with a shared
    scalar (0, 1, q - 1, random, and 1 + 2^200, whose steps skip the add)
    and with per-lane scalars, against the plain loop on CPU copies;
    one launch of the kernel and of its instance each, none of ec_add;
    scalar_mul_bits (shared bits) is that one launch too."""
    base, q, nbits = curve.base, curve.scalar.modulus, curve.scalar.num_bits
    ps, _ = chip_smoke.ec_cases(np, RNG, MJ, base.modulus, 64, curve.generator)
    pts = {k: base.encode([pt[i] for pt in ps], cuda) for i, k in enumerate(ec.COORDS)}
    host = {k: v.cpu() for k, v in pts.items()}
    names = ("ec_ladder", counted("ec_ladder", base), "ec_add")
    for k in (0, 1, q - 1, rand_ints(q, 1)[0], 1 + (1 << 200)):
        got, n = launches(lambda: no_sync(lambda: ec.ec_ladder(pts, k, nbits, base)), *names)
        want = ec.ec_ladder(host, k, nbits, base)
        assert n == (1, 1, 0) and all(torch.equal(got[c].cpu(), want[c]) for c in ec.COORDS), k
        again, n = launches(lambda: ec.scalar_mul_bits(pts, [(k >> i) & 1 for i in range(nbits)], base), *names)
        assert n == (1, 1, 0) and all(torch.equal(again[c], got[c]) for c in ec.COORDS)
    ks = [0, 1, q - 1] + rand_ints(q, 61)
    limbs = F.from_numpy_u32(F.ints_to_u32(ks))
    got, n = launches(lambda: ec.ec_ladder(pts, limbs.to(cuda), nbits, base), *names)
    want = ec.ec_ladder(host, limbs, nbits, base)
    assert n == (1, 1, 0) and all(torch.equal(got[c].cpu(), want[c]) for c in ec.COORDS)


@pytest.mark.parametrize("curve", CURVES, ids=CURVE_IDS)
@pytest.mark.parametrize("c, W", [(2, 3), (3, 85), (4, 64), (10, 2)])
def test_plane_tree_kernel_matches_plain(cuda, curve, c, W):
    """The plane tree over buckets with empty ones, equal points and
    negations among them, at each shape of its 128-thread block (several
    planes a block at c = 2, 3 and 4, one at c = 10 with two positions a
    thread), against bucket_planes_plain; one launch of the kernel and of
    its instance."""
    base = curve.base
    bucket = chip_smoke.msm_edge_points(np, RNG, MJ, base.modulus, cuda, n=(W << c) + 1, curve=curve)
    empty = ec.identity_point(1, cuda, base)
    for r in (1, 2, 7, 1 << c):
        for k in ec.COORDS:
            bucket[k][r] = empty[k][0]
    want = MJ.bucket_planes_plain(bucket, c, W, base)
    inst = counted("plane_tree", base)
    got, n = launches(lambda: no_sync(lambda: MJ.bucket_planes(bucket, c, W, base)), "plane_tree", inst)
    assert n == (1, 1) and all(torch.equal(got[k], want[k]) for k in ec.COORDS)


def test_msm_launches_one_plane_tree_and_no_ec_add(cuda):
    """Each MSM's bit-plane tree is one plane_tree launch, and an MSM
    launches no ec_add; the result equals the CPU's."""
    ps, _ = chip_smoke.ec_cases(np, RNG, MJ, FQ_MODULUS, 1 << 8)
    pts = {k: Fq.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    scal = Fr.encode(rand_ints(Fr.modulus, 1 << 8))
    card = ({k: v.to(cuda) for k, v in pts.items()}, scal.to(cuda))
    got, n = launches(lambda: ec.msm_list_to_affine_int([card, card]), "plane_tree", "msm_level", "ec_add")
    assert n == (2, 18, 0) and got == [ec.msm_to_affine_int(pts, scal)] * 2


def test_ladder_and_tree_raise_for_a_field_without_instance(cuda):
    """A field without kernels (kernel_id None) raises in both entries."""
    spec = NO_KERNELS
    pts = ec.identity_point(4, cuda, spec)
    with pytest.raises(ValueError):
        ec.ec_ladder(pts, 5, 8, spec)
    with pytest.raises(ValueError):
        ec.scalar_mul_bits(pts, [1, 0, 1], spec)
    bucket = ec.identity_point(3 << 3, cuda, spec)
    with pytest.raises(ValueError):
        MJ.bucket_planes(bucket, 3, 3, spec)


# the Pasta instances of K3 (csrc/ec_pasta.cu, csrc/msm_level_pasta.cu), K1's
# point chunks, and the kernels that have no Pasta instance


@pytest.mark.parametrize("curve", [curves.PALLAS, curves.VESTA], ids=["pallas", "vesta"])
def test_ec_add_and_msm_level_kernels_pasta_instances_match_plain(cuda, curve):
    """The complete add over 640 lanes of the five cases against the plain
    version and host arithmetic; every level of a 64-point MSM against the
    plain level (one launch of the instance a level); a 2^9 MSM on the card
    against the CPU's."""
    base, scalar = curve.base, curve.scalar
    ps, qs = chip_smoke.ec_cases(np, RNG, MJ, base.modulus, 640, curve.generator)
    p = {k: base.encode([pt[i] for pt in ps], cuda) for i, k in enumerate(ec.COORDS)}
    q = {k: base.encode([pt[i] for pt in qs], cuda) for i, k in enumerate(ec.COORDS)}
    got, n = launches(lambda: ec.ec_add(p, q, base), "ec_add", counted("ec_add", base))
    want = ec.ec_add_plain(p, q, base)
    assert n == (1, 1) and all(torch.equal(got[k], want[k]) for k in ec.COORDS)
    host = [MJ.host_jac_add(a, b, base.modulus) for a, b in zip(ps, qs)]
    assert ec.jacobian_to_affine(got, base) == MJ.host_batch_affine(host, base.modulus)
    points = chip_smoke.msm_edge_points(np, RNG, MJ, base.modulus, cuda, curve=curve)
    inst = counted("msm_level", base)
    before = native.counts[inst]
    assert chip_smoke.check_msm_levels(torch, np, RNG, cuda, points, 64, scalar, base) == 0
    assert native.counts[inst] == before + 7
    ps, _ = chip_smoke.ec_cases(np, RNG, MJ, base.modulus, 1 << 9, curve.generator)
    pts = {k: base.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    scal = scalar.encode(rand_ints(scalar.modulus, 1 << 9))
    card = ({k: v.to(cuda) for k, v in pts.items()}, scal.to(cuda))
    assert ec.msm_to_affine_int(*card, base, scalar) == ec.msm_to_affine_int(pts, scal, base, scalar)


def _product_expr(degree):
    """eq * p0 p1 ... : a product of `degree` tables."""
    acc = Expression.eq_xy(0)
    for i in range(degree - 1):
        acc = acc * Expression.poly(i % 3)
    return acc


@pytest.mark.parametrize("degree", [9, 17])
@pytest.mark.parametrize("pairs", [1 << 10, 1037], ids=["pow2", "ragged"])
def test_round_kernel_point_chunks_match_plain(cuda, degree, pairs):
    """A round of degree 9 or 17 as plan_round splits it: ceil(degree / 8)
    launches from t0 = 0, 8, 16, the messages concatenated on the card with
    no host sync, against the plain version's degree points in one pass;
    and one launch from t0 > 0 against the plain version at that offset."""
    expr = _product_expr(degree)
    keys = sc._leaf_keys(expr, 3)
    plan = sc.plan_round(expr, keys, Fr.modulus, 0)
    assert plan.points == sc.point_chunks(degree) and len(plan.points) == -(-degree // 8)
    tables = [Fr.encode(rand_ints(Fr.modulus, 2 * pairs), cuda) for _ in keys]
    tables[0][:4] = Fr.encode([0, 1, Fr.modulus - 1, Fr.R], cuda)
    got, n = launches(lambda: no_sync(lambda: sc.round_message_planned(Fr, tables, plan, None)), "sumcheck_round")
    assert n == (len(plan.points),) and got.shape == (degree, F.LIMBS)
    assert torch.equal(got, sc.round_message_plain(Fr, tables, plan.program, None, degree))
    t0, d = plan.points[-1]
    part = no_sync(lambda: sc.round_message(Fr, tables, plan.program, None, d, t0))
    assert t0 > 0 and torch.equal(part, sc.round_message_plain(Fr, tables, plan.program, None, d, t0))


@pytest.mark.parametrize("pairs", [37, 64], ids=["ragged", "pow2"])
def test_evaluated_term_matches_plain(cuda, pairs):
    """A round past the round kernel's limits on the card: the product of
    MAX_LEAVES + 1 tables (an evaluated term, degree 129, 17 chunks of
    points, each one pass) beside a challenge-weighted product that one K1
    chunk takes. The message, with no host sync, equals the plain path's
    on copies of the tables on the CPU, bit for bit; it launches K1 once a
    chunk of points, and K2, K4 and the row sum as the plan says
    (chip_smoke.evaluated_launches over one round, less its fold)."""
    E = Expression
    expr = chip_smoke.wide_product(E, sc.MAX_LEAVES + 1) + E.challenge(0) * E.poly(0) * E.poly(1)
    keys = sc._leaf_keys(expr, sc.MAX_LEAVES + 1)
    plan = sc.plan_round(expr, keys, Fr.modulus, 1)
    assert len(plan.chunks) == 1 and len(plan.evaluated) == 1 and len(plan.points) == 17
    chal = Fr.encode(plan.challenge_rows(Fr.modulus, rand_ints(Fr.modulus, 1)), cuda)
    tables = list(F.encode_dev(Fr, RNG.randint(0, 1 << 62, size=(len(keys), 2 * pairs), dtype=np.int64), cuda))
    tables[0][:4] = Fr.encode([0, 1, Fr.modulus - 1, Fr.R], cuda)
    names = ("sumcheck_round", "fold_all", "mont_mul", "sum_reduce")
    got, n = launches(lambda: no_sync(lambda: sc.round_message_planned(Fr, tables, plan, chal)), *names)
    assert n == tuple(chip_smoke.evaluated_launches(sc, plan, [pairs], 0)[k] for k in names)
    assert n[0] == len(plan.points) and got.shape == (expr.degree, F.LIMBS)
    want = sc.round_message_planned(Fr, [t.cpu() for t in tables], plan, chal.cpu())
    assert torch.equal(got.cpu(), want)


def test_bn254_only_kernels_raise_for_a_pasta_field(cuda):
    """K1, K2, K5, the row sum and the eq table have no Pasta instance: a
    CUDA tensor over either Pasta field raises in each wrapper before any
    launch (no BN254 instance runs in its place)."""
    for spec in (curves.Fp_pallas, curves.Fq_vesta):
        t = [spec.encode([1, 2, 3, 4], cuda) for _ in range(2)]
        prog = sc.lower_expression(Expression.poly(0) * Expression.poly(1), [("poly", 0, 0), ("poly", 1, 0)])
        before = dict(native.counts)
        for fn in (lambda: sc.round_message(spec, t, prog, None, 2), lambda: mle.fold_all(spec, t, 5),
                   lambda: mle.fix_var_chain(spec, t[0], [5, 6], False), lambda: F.sum_reduce(spec, t[0]),
                   lambda: mle.eq_xy(spec, [1, 2], cuda)):
            with pytest.raises(ValueError, match="no instance"):
                fn()
        assert native.counts == before


def test_entry_points_refuse_an_unknown_field_id(cuda):
    """Every C entry point that takes a field id returns
    cudaErrorInvalidValue for one it was not built for (4, and the Pasta
    ids where the kernel has no Pasta instance) before it reads anything,
    so no instance runs in its place."""
    lib = native.lib()
    for name, argtypes in native._SIGNATURES.items():
        entry = name[len("h2l_"):]
        if entry not in native.FIELD_IDS:
            continue
        for field in [4, -1] + [i for i in (2, 3) if i not in native.FIELD_IDS[entry]]:
            args = [field] + [None if t is native._P else 0 for t in argtypes[1:]]
            assert getattr(lib, name)(*args) == 1, (entry, field)  # cudaErrorInvalidValue


# sharding: a kernel launches on the card of the tensors it is given, and a
# sharded proof on the card is the unsharded one


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: launches on a card that is not current")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_the_card_of_their_tensors(two_cards):
    """K1, K2 and msm_planes given cuda:1 tensors while cuda:0 is current
    launch on cuda:1 (its stream, its block counter) and match the plain
    version; cuda:0 stays current."""
    first, second = two_cards
    expr, n_polys = _degree_expr(3)
    keys = sc._leaf_keys(expr, n_polys)
    prog = sc.lower_expression(expr, keys)
    cpu_tables = [Fr.encode(rand_ints(Fr.modulus, 1 << 12)) for _ in keys]
    chals = Fr.encode(rand_ints(Fr.modulus, 3))
    ps, _ = chip_smoke.ec_cases(np, RNG, MJ, FQ_MODULUS, 1 << 10)
    pts = {k: Fq.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    scal = Fr.encode(rand_ints(Fr.modulus, 1 << 10))
    with torch.cuda.device(first):
        tables = [t.to(second) for t in cpu_tables]
        msg, n1 = launches(lambda: sc.round_message(Fr, tables, prog, chals.to(second), expr.degree), "sumcheck_round")
        folded, n2 = launches(lambda: mle.fold_all(Fr, tables, 12345), "fold_all")
        (planes, c, W), n3 = launches(lambda: MJ.msm_planes({k: v.to(second) for k, v in pts.items()},
                                                            scal.to(second)), "plane_tree")
        torch.cuda.synchronize(second)
        assert torch.cuda.current_device() == first.index
    assert (n1, n2, n3) == ((1,), (1,), (1,))
    assert msg.device == second and all(t.device == second for t in folded) and planes["x"].device == second
    assert torch.equal(msg.cpu(), sc.round_message_plain(Fr, cpu_tables, prog, chals, expr.degree))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(folded, mle.fold_all(Fr, cpu_tables, 12345)))
    want, wc, wW = MJ.msm_planes(pts, scal)
    assert (c, W) == (wc, wW) and all(torch.equal(planes[k].cpu(), want[k]) for k in ec.COORDS)


def test_small_proofs_under_a_mesh_of_virtual_shards_on_card(cuda):
    """The nv = 3 Lasso-in-HyperPlonk and the small Lasso proofs under a
    mesh of 4 virtual shards on the card hash as the unsharded ones."""
    from halo2_lasso_tpu_torch.parallel import sharding as sh

    with sh.use_mesh(sh.Mesh([cuda] * 4)):
        plonk, _ = chip_smoke.hyperplonk_proof(np, chip_smoke.LASSO_PLONK_SMALL, cuda)
        small, _ = chip_smoke.lasso_proof(np, chip_smoke.SMALL, cuda)
    assert hashlib.sha256(plonk).hexdigest() == chip_smoke.LASSO_PLONK_SHA256
    assert hashlib.sha256(small).hexdigest() == chip_smoke.SMALL_PROOF_SHA256
