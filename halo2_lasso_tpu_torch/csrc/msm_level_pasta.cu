// The Pallas and Vesta instances of csrc/msm_level.cu's halving level, the
// port of the TPU's complete Jacobian add with the level step around it
// (halo2_lasso_tpu/ops/pallas_ec.py:144, halo2_lasso_tpu/ops/msm_jacobian.py:168;
// for the Pasta curves the TPU adds through msm_jacobian.jac_add_lf, :90,
// over make_mont_mul's instance for each field, ops/pallas_field.py:225).
// The kernel body is csrc/msm_level.cu's, unchanged: both curves have a = 0
// (y^2 = x^3 + 5), and the formulas never read b (csrc/ec.cuh), so only the
// modulus differs. The instances build in a source of their own so that the
// parallel build's slowest job stays what it was; h2l_msm_level calls the
// launcher below for field ids 2 and 3. Bound and design: as the BN254
// instance's.
#define H2L_PASTA_SOURCE
#include "msm_level.cu"

int level_launch_pasta(int field, const void* sx, const void* sy, const void* sz, const void* dig,
                       const void* order, long long pairs, int B, long long lanes, void* bx, void* by,
                       void* bz, void* ox, void* oy, void* oz, void* odig, cudaStream_t s) {
  switch (field) {
    case 2: return level_launch<Pallas>(sx, sy, sz, dig, order, pairs, B, lanes, bx, by, bz, ox, oy, oz, odig, s);
    case 3: return level_launch<Vesta>(sx, sy, sz, dig, order, pairs, B, lanes, bx, by, bz, ox, oy, oz, odig, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
