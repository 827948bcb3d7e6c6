// Complete Jacobian addition for one lane over the coordinate field P, and
// the scalar ladder's dedicated doubling, shared by csrc/ec_add.cu,
// csrc/msm_level.cu (and their Pasta sources) and the host-compiled CPU test
// (see field.cuh). Four instances: P = Fq, BN254 G1 (y^2 = x^3 + 3); P =
// Fr, grumpkin (y^2 = x^3 - 17), the other half of the BN254 2-cycle; P =
// Pallas and P = Vesta, the Pasta 2-cycle (y^2 = x^3 + 5 over each). Every
// curve has a = 0, and b appears in neither formula, so the instances
// differ only in the modulus.
//
// add-2007-bl takes 16 Montgomery products. The doubling (dbl-2009-l, 7
// more) is needed only where P = Q, which an MSM almost never meets, so it
// runs only when some lane of the warp needs it (a warp vote): the branch
// is uniform across the warp, every lane's output is selected as before,
// and the result is bit for bit what computing both would give.
#pragma once

#include "field.cuh"

#ifdef FIELD_HOST_TEST
#define H2L_WARP_ANY(pred) (pred)
#else
#define H2L_WARP_ANY(pred) __any_sync(__activemask(), (pred))
#endif

// The product out of line keeps the kernels' bodies small, so their build
// takes seconds, and measured faster than inlined (csrc/msm_level.cu).
template <class P>
static FD_NOINLINE Fe qmul(Fe a, Fe b) { return fe_mul<P>(a, b); }
template <class P>
FD Fe qadd(const Fe& a, const Fe& b) { return fe_add<P>(a, b); }
template <class P>
FD Fe qsub(const Fe& a, const Fe& b) { return fe_sub<P>(a, b); }

// dbl-2009-l (a = 0): 2P for P = (x1, y1, z1) not the identity, 7
// Montgomery products.
template <class P>
FD void ec_dbl_formulas(const Fe& x1, const Fe& y1, const Fe& z1, Fe& xd, Fe& yd, Fe& zd) {
  Fe a = qmul<P>(x1, x1), b = qmul<P>(y1, y1);
  Fe c = qmul<P>(b, b);
  Fe xb = qadd<P>(x1, b);
  Fe t = qsub<P>(qsub<P>(qmul<P>(xb, xb), a), c);
  Fe d = qadd<P>(t, t);
  Fe e = qadd<P>(qadd<P>(a, a), a);
  xd = qsub<P>(qmul<P>(e, e), qadd<P>(d, d));
  Fe c8 = qadd<P>(qadd<P>(c, c), qadd<P>(c, c));
  c8 = qadd<P>(c8, c8);
  yd = qsub<P>(qmul<P>(e, qsub<P>(d, xd)), c8);
  zd = qmul<P>(qadd<P>(y1, y1), z1);
}

template <class P>
FD void ec_add_lane(const Fe& x1, const Fe& y1, const Fe& z1, const Fe& x2, const Fe& y2,
                    const Fe& z2, Fe& ox, Fe& oy, Fe& oz) {
  Fe z1z1 = qmul<P>(z1, z1), z2z2 = qmul<P>(z2, z2);
  Fe u1 = qmul<P>(x1, z2z2), u2 = qmul<P>(x2, z1z1);
  Fe s1 = qmul<P>(qmul<P>(y1, z2), z2z2), s2 = qmul<P>(qmul<P>(y2, z1), z1z1);
  Fe h = qsub<P>(u2, u1), r = qsub<P>(s2, s1);
  Fe hh = qmul<P>(h, h);
  Fe hhh = qmul<P>(hh, h);
  Fe v = qmul<P>(u1, hh);
  Fe x3 = qsub<P>(qsub<P>(qmul<P>(r, r), hhh), qadd<P>(v, v));
  Fe y3 = qsub<P>(qmul<P>(r, qsub<P>(v, x3)), qmul<P>(s1, hhh));
  Fe z3 = qmul<P>(qmul<P>(z1, z2), h);

  bool p_id = fe_is_zero(z1), q_id = fe_is_zero(z2);
  bool both = !p_id && !q_id;
  bool use_dbl = both && fe_is_zero(h) && fe_is_zero(r);
  bool use_id = both && fe_is_zero(h) && !fe_is_zero(r);
  bool take_q = p_id && !q_id, take_id = p_id && q_id, take_p = q_id && !p_id;
  if (H2L_WARP_ANY(use_dbl)) {
    Fe xd, yd, zd;
    ec_dbl_formulas<P>(x1, y1, z1, xd, yd, zd);
    x3 = fe_sel(use_dbl, xd, x3);
    y3 = fe_sel(use_dbl, yd, y3);
    z3 = fe_sel(use_dbl, zd, z3);
  }
  Fe one = fe_one<P>(), zero = fe_zero();
  ox = fe_sel(use_id || take_id, one, fe_sel(take_q, x2, fe_sel(take_p, x1, x3)));
  oy = fe_sel(use_id || take_id, one, fe_sel(take_q, y2, fe_sel(take_p, y1, y3)));
  oz = fe_sel(use_id || take_id, zero, fe_sel(take_q, z2, fe_sel(take_p, z1, z3)));
}

// The dedicated doubling of the scalar ladder, in place: dbl-2009-l, or
// (R, R, 0) for the identity (z = 0). Bit for bit what ec_add_lane(P, P)
// gives: for P not the identity h = r = 0 selects the same formulas, and
// for the identity take_id gives (R, R, 0); 7 products where the complete
// add computes 16 before its vote.
template <class P>
FD void ec_dbl_lane(Fe& x, Fe& y, Fe& z) {
  if (fe_is_zero(z)) {
    x = y = fe_one<P>();
    return;
  }
  Fe xd, yd, zd;
  ec_dbl_formulas<P>(x, y, z, xd, yd, zd);
  x = xd;
  y = yd;
  z = zd;
}
