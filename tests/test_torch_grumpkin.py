"""The grumpkin half of the BN254 2-cycle in the port against the JAX package
on the CPU, below the PCS: the plain versions of the kernels' new field
instances and the curve layer over grumpkin (y^2 = x^3 - 17 over BN254 Fr,
scalars in BN254 Fq).

* K1 and K2 over BN254 Fq: a sumcheck over Fq at k = 4 gives the JAX
  package's proof bytes, its first round message straight from
  ``round_message`` (the plain version on the CPU), and ``fold_all`` over Fq
  both ways equals the JAX package's ``fix_var`` / ``fix_last_var``;
* K3 over grumpkin: ``ec_add_plain`` on the five lane cases equals JAX
  ``ec.ec_add(spec=Fr)`` and ``msm_jacobian.jac_add_lf`` in affine, the
  scalar ladder equals host arithmetic, and a 256-point MSM equals JAX
  ``ec.variable_base_msm(base=Fr, scalar=Fq)`` (its double-and-add path:
  JAX ``msm_jacobian.msm`` gives the same group element, tests/test_msm_jacobian.py,
  but compiles for over a minute on the CPU even at 16 points);
* ``curves.sqrt_mod`` gives the JAX package's roots (the port's old
  version) over a few hundred residues and non-residues of Fr, Fq and the
  Pasta moduli.
The kernels themselves are held to these plain versions on the card by
tests/test_torch_kernels.py. All comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.expression import Expression as JExpression
from halo2_lasso_tpu.ops import curves as jcurves
from halo2_lasso_tpu.ops import ec as jec
from halo2_lasso_tpu.ops import msm_jacobian as jmj
from halo2_lasso_tpu.ops.bn254 import Fq as JFq
from halo2_lasso_tpu.ops.bn254 import Fr as JFr
from halo2_lasso_tpu.piop import sum_check as jsc
from halo2_lasso_tpu.poly import multilinear as jmle
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.expression import Expression
from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, FR_MODULUS, Fq, Fr
from halo2_lasso_tpu_torch.piop import sum_check as sc
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
G = curves.GRUMPKIN
RNG = np.random.RandomState(12)


def rand_fes(p, n):
    return [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(n)]


def degree3(E):
    """A degree-3 zero-check-like expression over three polys and a challenge."""
    return E.eq_xy(0) * (E.poly(0) * E.poly(1) - E.challenge(0) * E.poly(2) + E.constant(5))


def test_sumcheck_over_fq_matches_jax():
    """sum_check.prove over BN254 Fq (its rounds through round_message and
    fold_all, the plain versions of K1's and K2's Fq instances): the JAX
    package's proof bytes, point and evaluations, each package verifying
    the other's proof; the first round message straight from round_message."""
    k, p = 4, FQ_MODULUS
    polys = [rand_fes(p, 1 << k) for _ in range(3)]
    chals, y = rand_fes(p, 1), rand_fes(p, k)
    eq = [mle.eq_xy_eval_host(p, [(b >> i) & 1 for i in range(k)], y) for b in range(1 << k)]
    claim = sum(e * (a * b - chals[0] * c + 5) for e, a, b, c in zip(eq, *polys)) % p
    expr, jexpr = degree3(Expression), degree3(JExpression)

    jt = JTranscript(p)
    jpolys = [jnp.asarray(JFq.encode(v)) for v in polys]
    jx, jevals = jsc.prove(JFq, k, jsc.VirtualPolynomial(jexpr, jpolys, chals, [y]), claim, jt)
    jproof = jt.into_proof()
    t = Keccak256Transcript(p)
    tpolys = [F.from_jax_limbs(np.asarray(a)) for a in jpolys]
    x, evals = sc.prove(Fq, k, sc.VirtualPolynomial(expr, tpolys, chals, [y]), claim, t)
    proof = t.into_proof()
    assert proof == jproof and (x, evals) == (jx, jevals)
    assert sc.verify(p, k, 3, claim, Keccak256Transcript(p, proof=jproof)) == \
        jsc.verify(p, k, 3, claim, JTranscript(p, proof=proof))

    keys = sc._leaf_keys(expr, 3)
    vp = sc.VirtualPolynomial(expr, tpolys, chals, [y])
    tables = [sc._leaf_table(Fq, key, vp, k, "cpu") for key in keys]
    msg = sc.round_message(Fq, tables, sc.lower_expression(expr, keys), Fq.encode(chals), 3)
    assert Fq.decode_ints(msg) == [int.from_bytes(jproof[32 * i : 32 * i + 32], "big") for i in range(1, 4)]


def test_fold_all_over_fq_matches_jax():
    """fold_all over Fq, the lowest and the highest variable, the challenge
    as a host int and as a tensor, against the JAX package's fix_var and
    fix_last_var over Fq, with 0, 1, p - 1 and R mod p among the rows."""
    p = FQ_MODULUS
    vals = [[0, 1, p - 1, Fq.R] + rand_fes(p, 28) for _ in range(3)]
    xv = rand_fes(p, 1)[0]
    jx = jnp.asarray(JFq.encode([xv]))[0]
    for last, jfn in ((False, jmle.fix_var), (True, jmle.fix_last_var)):
        want = [F.from_jax_limbs(np.asarray(jfn(JFq, jnp.asarray(JFq.encode(v)), jx))) for v in vals]
        tables = [Fq.encode(v) for v in vals]
        for x in (xv, Fq.encode([xv])[0]):
            got = mle.fold_all(Fq, tables, x, last=last)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def ladder_mul(pt, k):
    """k * pt on grumpkin by host Jacobian arithmetic."""
    acc, add = (0, 0, 0), pt
    while k:
        if k & 1:
            acc = MJ.host_jac_add(acc, add, FR_MODULUS)
        add = MJ.host_jac_double(add, FR_MODULUS)
        k >>= 1
    return acc


def five_cases(n):
    """Grumpkin Jacobian pairs: generic, P = Q (rescaled), P = -Q, P = O, Q = O."""
    import chip_smoke

    return chip_smoke.ec_cases(np, RNG, MJ, FR_MODULUS, n, G.generator)


def jax_points(pts):
    return {k: jnp.asarray(JFr.encode([pt[i] for pt in pts])) for i, k in enumerate(ec.COORDS)}


def jax_affine(coords):
    jac = list(zip(*([int(v) for v in JFr.decode(np.asarray(coords[k]))] for k in ec.COORDS)))
    return MJ.host_batch_affine(jac, FR_MODULUS)


def test_grumpkin_ec_add_matches_jax():
    """ec_add_plain over grumpkin (the plain version of K3's grumpkin
    instance, the limb programs and the small-batch host ints) against JAX
    ec.ec_add(spec=Fr) and msm_jacobian.jac_add_lf, the add the TPU runs
    for grumpkin, in affine."""
    ps, qs = five_cases(80)
    jp, jq = jax_points(ps), jax_points(qs)
    want = jax_affine(jec.ec_add(jp, jq, JFr))
    lf = jmj.jac_add_lf(JFr, *(jp[k].T for k in ec.COORDS), *(jq[k].T for k in ec.COORDS))
    assert jax_affine({k: v.T for k, v in zip(ec.COORDS, lf)}) == want
    p = {k: F.from_jax_limbs(np.asarray(v)) for k, v in jp.items()}
    q = {k: F.from_jax_limbs(np.asarray(v)) for k, v in jq.items()}
    assert ec.jacobian_to_affine(ec.ec_add(p, q, Fr), Fr) == want  # 80 rows: the limb programs
    small = ec.ec_add({k: v[:20] for k, v in p.items()}, {k: v[:20] for k, v in q.items()}, Fr)
    assert ec.jacobian_to_affine(small, Fr) == want[:20]  # 20 rows: host ints
    assert want[2::5] == [(0, 0)] * 16
    assert all(curves.on_curve(G, *pt) for pt in want if pt != (0, 0))


def test_grumpkin_scalar_mul_bits_matches_host():
    """The scalar ladder over grumpkin points (one the identity), with the
    bits shared (scalar_mul_bits) and per-lane scalars as limbs
    (ec_ladder), against host arithmetic; the generator and ec_neg on
    grumpkin."""
    gen = ec.curve_generator(G, "cpu")
    assert ec.jacobian_to_affine(gen, Fr) == [G.generator]
    pts = [ladder_mul((*G.generator, 1), int(RNG.randint(1, 1 << 40))) for _ in range(3)] + [(1, 1, 0)]
    batch = {k: Fr.encode([pt[i] for pt in pts]) for i, k in enumerate(ec.COORDS)}
    aff = MJ.host_batch_affine(pts, FR_MODULUS)
    ks = [int(RNG.randint(1, 1 << 62)) * (1 << 190) + 3 for _ in range(4)]
    shared = ec.scalar_mul_bits(batch, [(ks[0] >> i) & 1 for i in range(254)], Fr)
    assert ec.jacobian_to_affine(shared, Fr) == [curves.host_mul(G, a, ks[0]) for a in aff]
    lanes = ec.ec_ladder(batch, F.from_numpy_u32(F.ints_to_u32(ks)), 254, Fr)
    assert ec.jacobian_to_affine(lanes, Fr) == [curves.host_mul(G, a, k) for a, k in zip(aff, ks)]
    assert ec.jacobian_to_affine(ec.ec_neg(batch, Fr), Fr) == [
        (0, 0) if a == (0, 0) else (a[0], (-a[1]) % FR_MODULUS) for a in aff]
    no_kernels = F.FieldSpec(name="no_kernels", modulus=curves.PALLAS_MODULUS, kernel_id=None)
    with pytest.raises(ValueError):  # a curve over a field without kernels
        ec.curve_generator(curves.CurveSpec("no_kernels", no_kernels, Fq, 5, curves.PALLAS.generator), "cpu")


def test_grumpkin_msm_matches_jax(monkeypatch):
    """A 256-point grumpkin MSM (an identity point, a zero scalar) in the
    port's halving-tree Pippenger (msm_level_plain over grumpkin) against
    the JAX package's variable_base_msm(base=Fr, scalar=Fq), in affine."""
    monkeypatch.setattr(jec, "SMALL_MSM_MAX", 1 << 10)  # its double-and-add path: seconds on the CPU
    n = 256
    base = [ladder_mul((*G.generator, 1), int(RNG.randint(1, 1 << 30))) for _ in range(8)]
    pts = [MJ.host_jac_add(base[i % 8], base[(i * 3 + 1) % 8], FR_MODULUS) for i in range(n)]
    pts[1] = (1, 1, 0)
    scal = rand_fes(FQ_MODULUS, n)
    scal[2] = 0
    jpts, jscal = jax_points(pts), jnp.asarray(JFq.encode(scal))
    want = jax_affine({k: v[None] for k, v in jec.variable_base_msm(jpts, jscal, JFr, JFq).items()})
    got = ec.msm_to_affine_int({k: F.from_jax_limbs(np.asarray(v)) for k, v in jpts.items()},
                               F.from_jax_limbs(np.asarray(jscal)), Fr, Fq)
    assert [got] == want


@pytest.mark.parametrize("name", ["FR", "FQ", "PALLAS", "VESTA"])
def test_sqrt_mod_matches_the_old_roots(name):
    """The port's sqrt_mod (Tonelli-Shanks with its per-modulus constants
    computed once, one power a root) gives the roots of the old version,
    which the JAX package keeps, on 300 residues and 300 non-residues."""
    p = {"FR": FR_MODULUS, "FQ": FQ_MODULUS, "PALLAS": curves.PALLAS_MODULUS, "VESTA": curves.VESTA_MODULUS}[name]
    rng = np.random.RandomState(len(name))
    res = [0, 1, 4] + [pow(int.from_bytes(rng.bytes(40), "little"), 2, p) for _ in range(297)]
    non, a = [], 2
    while len(non) < 300:
        a = (a * 7 + int(rng.randint(1, 1 << 30))) % p
        if pow(a, (p - 1) // 2, p) == p - 1:
            non.append(a)
    for v in res:
        r = curves.sqrt_mod(v, p)
        assert r == jcurves.sqrt_mod(v, p) and r * r % p == v % p
    assert all(curves.sqrt_mod(v, p) is None and jcurves.sqrt_mod(v, p) is None for v in non)


@pytest.mark.parametrize("name", ["rand_vanilla_plonk_circuit", "rand_vanilla_plonk_with_lookup_circuit"])
def test_vanilla_fixtures_over_fq_match_jax(name):
    """The two vanilla fixtures over BN254 Fq (the grumpkin SNARK's
    circuits) give the JAX fixtures' preprocessed polys, copies, instances
    and witness at nv = 4."""
    from halo2_lasso_tpu.backend.hyperplonk import fixtures as jfixtures
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures

    jci, jcirc = getattr(jfixtures, name)(4, np.random.RandomState(42), np.random.RandomState(43), field=JFq)
    ci, circ = getattr(fixtures, name)(4, np.random.RandomState(42), np.random.RandomState(43), field=Fq)
    as_ints = lambda cols: [[int(v) for v in c] for c in cols]  # noqa: E731
    assert as_ints(ci.preprocess_polys) == as_ints(jci.preprocess_polys)
    assert ci.permutations == jci.permutations
    assert as_ints(circ.instances()) == as_ints(jcirc.instances())
    assert as_ints(circ.synthesize(0, [])) == as_ints(jcirc.synthesize(0, []))
    assert any(int(v) >= FR_MODULUS for c in ci.preprocess_polys for v in c)  # values beyond Fr: over Fq
