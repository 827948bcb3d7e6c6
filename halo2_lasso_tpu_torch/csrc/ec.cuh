// Complete Jacobian addition on BN254 G1 over Fq for one lane, shared by
// csrc/ec_add.cu, csrc/msm_level.cu and the host-compiled CPU test (see
// field.cuh).
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
static FD_NOINLINE Fe qmul(Fe a, Fe b) { return fe_mul<Fq>(a, b); }
FD Fe qadd(const Fe& a, const Fe& b) { return fe_add<Fq>(a, b); }
FD Fe qsub(const Fe& a, const Fe& b) { return fe_sub<Fq>(a, b); }

FD void ec_add_lane(const Fe& x1, const Fe& y1, const Fe& z1, const Fe& x2, const Fe& y2,
                    const Fe& z2, Fe& ox, Fe& oy, Fe& oz) {
  Fe z1z1 = qmul(z1, z1), z2z2 = qmul(z2, z2);
  Fe u1 = qmul(x1, z2z2), u2 = qmul(x2, z1z1);
  Fe s1 = qmul(qmul(y1, z2), z2z2), s2 = qmul(qmul(y2, z1), z1z1);
  Fe h = qsub(u2, u1), r = qsub(s2, s1);
  Fe hh = qmul(h, h);
  Fe hhh = qmul(hh, h);
  Fe v = qmul(u1, hh);
  Fe x3 = qsub(qsub(qmul(r, r), hhh), qadd(v, v));
  Fe y3 = qsub(qmul(r, qsub(v, x3)), qmul(s1, hhh));
  Fe z3 = qmul(qmul(z1, z2), h);

  bool p_id = fe_is_zero(z1), q_id = fe_is_zero(z2);
  bool both = !p_id && !q_id;
  bool use_dbl = both && fe_is_zero(h) && fe_is_zero(r);
  bool use_id = both && fe_is_zero(h) && !fe_is_zero(r);
  bool take_q = p_id && !q_id, take_id = p_id && q_id, take_p = q_id && !p_id;
  if (H2L_WARP_ANY(use_dbl)) {
    // doubling of P (dbl-2009-l, a = 0)
    Fe a = qmul(x1, x1), b = qmul(y1, y1);
    Fe c = qmul(b, b);
    Fe xb = qadd(x1, b);
    Fe t = qsub(qsub(qmul(xb, xb), a), c);
    Fe d = qadd(t, t);
    Fe e = qadd(qadd(a, a), a);
    Fe xd = qsub(qmul(e, e), qadd(d, d));
    Fe c8 = qadd(qadd(c, c), qadd(c, c));
    c8 = qadd(c8, c8);
    Fe yd = qsub(qmul(e, qsub(d, xd)), c8);
    Fe zd = qmul(qadd(y1, y1), z1);
    x3 = fe_sel(use_dbl, xd, x3);
    y3 = fe_sel(use_dbl, yd, y3);
    z3 = fe_sel(use_dbl, zd, z3);
  }
  Fe one = fe_one<Fq>(), zero = fe_zero();
  ox = fe_sel(use_id || take_id, one, fe_sel(take_q, x2, fe_sel(take_p, x1, x3)));
  oy = fe_sel(use_id || take_id, one, fe_sel(take_q, y2, fe_sel(take_p, y1, y3)));
  oz = fe_sel(use_id || take_id, zero, fe_sel(take_q, z2, fe_sel(take_p, z1, z3)));
}
