// Complete Jacobian addition, lane by lane, the port of _ec_add_kernel
// (halo2_lasso_tpu/ops/pallas_ec.py:144; math _ec_add_body :85, launcher
// _ec_add_call :154, pallas_call :167), in two instances selected by
// `field`: 1 = BN254 G1 over Fq (the TPU kernel's curve) and 0 = grumpkin
// over Fr. The grumpkin instance is the port of what the TPU computes for
// that curve through msm_jacobian.jac_add_lf (a complete add built from
// make_mont_mul launches, halo2_lasso_tpu/ops/msm_jacobian.py:90).
//
// add-2007-bl for the generic lanes; dbl-2009-l for P = Q, computed only
// when some lane of the warp needs it (csrc/ec.cuh); identity (x = y = R
// mod p, z = 0) for P = -Q; pass-through when either input is the identity.
// The choice per lane is a select, as in the TPU kernel. The MSM's halving
// levels run in csrc/msm_level.cu; this kernel serves the bit-plane
// reduction tree and the fixed-base MSM. Bound: operations (16 Montgomery
// products a generic lane against 288 bytes moved). The product is kept out
// of line so the kernel body stays small enough for a build of seconds.
#include "ec.cuh"

template <class P>
__global__ void ec_add_kernel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                              const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                              uint32_t* x3, uint32_t* y3, uint32_t* z3, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe ox, oy, oz;
  ec_add_lane<P>(fe_load(x1, i), fe_load(y1, i), fe_load(z1, i), fe_load(x2, i), fe_load(y2, i),
              fe_load(z2, i), ox, oy, oz);
  fe_store(x3, i, ox);
  fe_store(y3, i, oy);
  fe_store(z3, i, oz);
}

// field: the kernel_id of the coordinate field (0 = Fr, grumpkin; 1 = Fq,
// BN254 G1).
extern "C" int h2l_ec_add(int field, const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* x3, void* y3, void* z3,
                          long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  const uint32_t *a = (const uint32_t*)x1, *b = (const uint32_t*)y1, *c = (const uint32_t*)z1,
                 *d = (const uint32_t*)x2, *e = (const uint32_t*)y2, *f = (const uint32_t*)z2;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    ec_add_kernel<Fr><<<blocks, threads, 0, s>>>(a, b, c, d, e, f, (uint32_t*)x3, (uint32_t*)y3,
                                                 (uint32_t*)z3, n);
  else if (field == 1)
    ec_add_kernel<Fq><<<blocks, threads, 0, s>>>(a, b, c, d, e, f, (uint32_t*)x3, (uint32_t*)y3,
                                                 (uint32_t*)z3, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
