"""The Pasta 2-cycle (Pallas and Vesta, ops/curves.py) in the port against
the JAX package on the CPU, mirroring tests/test_pasta.py's four tests:

* the Pallas generator on the curve, as ``ec.curve_generator`` gives it;
* scalar multiplication's linearity over Pallas (``scalars_to_bits`` and
  ``scalar_mul_bits``, K3's ladder's plain version), the point equal to
  the JAX package's;
* a 256-point Pallas MSM through ``msm_affine`` against the per-lane
  ladder ``_msm_small``, over points of ``fixed_base_msm``;
* the Vesta half of the cycle: the fields swapped (``TWO_CHAIN``), the
  generator on the curve, and ``ec_double`` (K3's add of a point to itself)
  equal to the JAX package's dbl-2009-l.

Besides, a 256-point ``variable_base_msm`` over each curve (an identity
point and a zero scalar among them), through the production Pippenger
(msm_level and the plane tree in their plain versions over the 255-bit
fields, the path the card runs at 2^16), gives the JAX package's
``variable_base_msm``. The JAX side of both MSMs is one call a curve, shared
by the file. All comparisons are exact, in affine integers; the kernels'
Pasta instances are held to these plain versions on the card by
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_lasso_tpu.ops import curves as jcurves
from halo2_lasso_tpu.ops import ec as jec
from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_affine
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ

torch.set_num_threads(1)  # small tensors; the suite's workers share the cores
C, V = curves.PALLAS, curves.VESTA
JAX_CURVES = {"pallas": jcurves.PALLAS, "vesta": jcurves.VESTA}
N = 256


def as_affine(aff):
    """The JAX package's (n, 2) object array -> [(x, y)] ints."""
    return [(int(x), int(y)) for x, y in np.asarray(aff).reshape(-1, 2)]


def jax_points(pts):
    """A port point batch -> the JAX package's (16-bit limbs)."""
    return {k: jnp.asarray(F.to_jax_limbs(v)) for k, v in pts.items()}


def smul(pt, k, curve):
    """k * pt over a one-point batch: the scalar's 256 bits, one row."""
    bits = ec.scalars_to_bits(F.from_numpy_u32(F.ints_to_u32([k])), 256)
    return ec.scalar_mul_bits(pt, bits, curve.base)


@pytest.fixture(scope="module")
def msm_inputs():
    """Each curve's 256 points (fixed_base_msm over the generator, point 1
    the identity) and Montgomery scalars (scalar 2 zero), and the JAX
    package's variable_base_msm of them in affine: one JAX call a curve."""
    out = {}
    for curve in (C, V):
        rng = np.random.RandomState(13 if curve is C else 31)
        ms = [int(v) for v in rng.randint(1, 1 << 30, size=N)]
        pts = ec.fixed_base_msm(curve.generator, curve.scalar.encode(ms), 8, curve.base, curve.scalar)
        pts = {k: v.clone() for k, v in pts.items()}
        assert ec.jacobian_to_affine({k: v[:4] for k, v in pts.items()}, curve.base) == [
            curves.host_mul(curve, curve.generator, m) for m in ms[:4]]
        for k, v in ec.identity_point(1, "cpu", curve.base).items():
            pts[k][1] = v[0]
        sc = [int.from_bytes(rng.bytes(40), "little") % curve.scalar.modulus for _ in range(N)]
        sc[2] = 0
        scal = curve.scalar.encode(sc)
        jc = JAX_CURVES[curve.name]
        got = jec.variable_base_msm(jax_points(pts), jnp.asarray(F.to_jax_limbs(scal)), jc.base, jc.scalar)
        want = as_affine(jec.jacobian_to_affine({k: v[None] for k, v in got.items()}, jc.base))
        out[curve.name] = (pts, scal, want)
    return out


def test_pallas_generator_on_curve():
    assert curves.on_curve(C, *C.generator)
    g = ec.curve_generator(C, "cpu")
    assert ec.jacobian_to_affine(g, C.base) == [C.generator]
    assert as_affine(jec.jacobian_to_affine(jec.curve_generator(jcurves.PALLAS), jcurves.PALLAS.base)) == [C.generator]


def test_pallas_scalar_mul_linearity():
    """a G + b G == (a + b) G over Pallas, and the sum is the JAX
    package's point."""
    order = C.scalar.modulus
    g = ec.curve_generator(C, "cpu")
    a, b = 55555333, 777799911
    s = ec.ec_add(smul(g, a, C), smul(g, b, C), C.base)
    aff = ec.jacobian_to_affine(s, C.base)
    assert aff == ec.jacobian_to_affine(smul(g, (a + b) % order, C), C.base)
    assert curves.on_curve(C, *aff[0])
    jc = jcurves.PALLAS
    jg = jec.curve_generator(jc)

    def jsmul(k):
        can = jnp.asarray(np.asarray([[(k >> (16 * i)) & 0xFFFF for i in range(16)]], dtype=np.uint32))
        return jec.scalar_mul_bits({kk: v[None] for kk, v in jg.items()}, jec.scalars_to_bits(can, 256), jc.base)

    assert as_affine(jec.jacobian_to_affine(jec.ec_add(jsmul(a), jsmul(b), jc.base), jc.base)) == aff


def test_pallas_msm_matches_small_path(msm_inputs):
    """The batched-affine MSM (ops/msm_affine.py) over Pallas against the
    per-lane ladder and row sum (ec._msm_small), and both against the JAX
    package's point."""
    pts, scal, want = msm_inputs["pallas"]
    got = msm_affine.msm_affine(pts, scal, C.base, C.scalar)
    ref = ec._msm_small(pts, F.from_mont(C.scalar, scal)[None], C.base, C.scalar.num_bits)
    ga, ra = ec.jacobian_to_affine(got, C.base), ec.jacobian_to_affine(ref, C.base)
    assert ga == ra == want
    assert curves.on_curve(C, *ga[0])


def test_vesta_cycle_pairing():
    """TwoChainCurve: Vesta's base field is Pallas' scalar field and vice
    versa (util/arithmetic.rs:37-59); 2G over Vesta by ec_double, on the
    curve and equal to the JAX package's."""
    assert V.base is C.scalar and V.scalar is C.base
    assert curves.TWO_CHAIN["pallas"] is V and curves.TWO_CHAIN["vesta"] is C
    assert {k: v.name for k, v in curves.TWO_CHAIN.items()} == {k: v.name for k, v in jcurves.TWO_CHAIN.items()}
    assert curves.on_curve(V, *V.generator)
    d = ec.ec_double(ec.curve_generator(V, "cpu"), V.base)
    aff = ec.jacobian_to_affine(d, V.base)
    assert curves.on_curve(V, *aff[0]) and aff == [curves.host_add(V, V.generator, V.generator)]
    jv = jcurves.VESTA
    jd = jec.ec_double(jec.curve_generator(jv), jv.base)
    assert as_affine(jec.jacobian_to_affine({k: v[None] for k, v in jd.items()}, jv.base)) == aff
    ident = ec.ec_double(ec.identity_point(1, "cpu", V.base), V.base)
    assert ec.jacobian_to_affine(ident, V.base) == [(0, 0)]


@pytest.mark.parametrize("name", ["pallas", "vesta"])
def test_variable_base_msm_matches_jax(msm_inputs, monkeypatch, name):
    """256 points over each curve, an identity point and a zero scalar
    among them: the port's variable_base_msm through its production
    Pippenger (msm_level and the plane tree over the curve's base field,
    W = ceil(255 / c) windows; SMALL_MSM_MAX lowered so that 256 points take
    it, as 2^16 do) gives the JAX package's variable_base_msm."""
    monkeypatch.setattr(ec, "SMALL_MSM_MAX", N // 2)
    curve = C if name == "pallas" else V
    pts, scal, want = msm_inputs[name]
    got = ec.jacobian_to_affine(ec.variable_base_msm(pts, scal, curve.base, curve.scalar), curve.base)
    assert got == want
    assert curves.on_curve(curve, *want[0])
    c = MJ.best_c(N)
    assert -(-curve.scalar.num_bits // c) == 64 and curve.scalar.num_bits == 255


def test_no_instance_raises_for_a_field_without_kernels():
    """A field whose kernel_id is None has no curve kernel: its curve's
    generator and point batches are refused, even on the CPU."""
    made_up = F.FieldSpec(name="no_kernels", modulus=C.base.modulus, kernel_id=None)
    curve = curves.CurveSpec("no_kernels", base=made_up, scalar=C.scalar, b=5, generator=C.generator)
    with pytest.raises(ValueError, match="no curve kernel"):
        ec.curve_generator(curve, "cpu")
    with pytest.raises(ValueError, match="no curve kernel"):
        ec.curve_instance(made_up)
    assert [ec.curve_instance(s) for s in (C.base, V.base)] == ["pallas", "vesta"]


def test_montgomery_product_multiply_adds_follow_the_modulus():
    """The kernels' bound counts a Montgomery product's multiply-adds from
    the modulus's limbs: Pasta's p has limbs 0, 1 and 2^30 (folded by the
    compiler), so 176 against BN254's 256, whose limbs are all generic."""
    from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
    from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, imad_per_mont_mul

    for spec in (C.base, V.base):
        limbs = [(spec.modulus >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
        assert limbs[0] == 1 and limbs[4:7] == [0, 0, 0] and limbs[7] == 1 << 30
        assert imad_per_mont_mul(spec) == 2 * (64 + 8 * 3) == 176
    assert imad_per_mont_mul(Fr) == imad_per_mont_mul(Fq) == IMAD_PER_MONT_MUL == 256


@pytest.mark.parametrize("name", ["bn254_g1", "grumpkin", "pallas", "vesta"])
def test_plain_add_of_a_batch_to_itself_is_the_complete_add(name):
    """ec_add_plain(P, P) (the same dict) computes only the doubling; its
    coordinates equal the complete add's of P and an equal copy (the sum,
    then the doubling and identity lanes selected), identity lanes among
    them, over the limb path (more rows than the host-int path takes)."""
    curve = curves.TWO_CHAIN[curves.TWO_CHAIN[name].name]
    rng = np.random.RandomState(11)
    n = F.HOST_PLAIN_ROWS + 32
    pts = ec.fixed_base_msm(curve.generator, curve.scalar.encode([int(v) for v in rng.randint(1, 1 << 30, n)]),
                            base=curve.base, scalar=curve.scalar)
    pts["z"][::7] = 0
    got = ec.ec_add_plain(pts, pts, curve.base)
    want = ec.ec_add_plain(pts, {k: v.clone() for k, v in pts.items()}, curve.base)
    assert all(torch.equal(got[k], want[k]) for k in ec.COORDS)
    assert ec.jacobian_to_affine(got, curve.base)[::7] == [(0, 0)] * len(range(0, n, 7))
