// The Pallas and Vesta instances of csrc/ec_add.cu's kernels: the complete
// Jacobian add (the port of _ec_add_kernel, halo2_lasso_tpu/ops/pallas_ec.py:144,
// which the TPU runs for the Pasta curves as msm_jacobian.jac_add_lf,
// halo2_lasso_tpu/ops/msm_jacobian.py:90, over make_mont_mul's instance for
// each field), the scalar ladder (ops/ec.py:216) and the MSM's plane tree
// (ops/msm_jacobian.py:299, :318). The kernel bodies are csrc/ec_add.cu's,
// unchanged: Pallas and Vesta have a = 0 (y^2 = x^3 + 5), and the formulas
// never read b (csrc/ec.cuh), so only the modulus differs (field.cuh,
// 255-bit primes). The instances build in a source of their own so that the
// parallel build's slowest job stays what it was; csrc/ec_add.cu's entry
// points call the launchers below for field ids 2 and 3. Bound and design:
// as the BN254 instances'.
#define H2L_PASTA_SOURCE
#include "ec_add.cu"

int add_launch_pasta(int field, const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                     const void* z2, void* x3, void* y3, void* z3, long long n, cudaStream_t s) {
  switch (field) {
    case 2: return add_launch<Pallas>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, s);
    case 3: return add_launch<Vesta>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ladder_launch_pasta(int field, const void* px, const void* py, const void* pz, const void* lane_k,
                        const LadderScalar& sk, int nbits, void* ox, void* oy, void* oz, long long n,
                        cudaStream_t s) {
  switch (field) {
    case 2: return ladder_launch<Pallas>(px, py, pz, lane_k, sk, nbits, ox, oy, oz, n, s);
    case 3: return ladder_launch<Vesta>(px, py, pz, lane_k, sk, nbits, ox, oy, oz, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int tree_launch_pasta(int field, const void* bx, const void* by, const void* bz, int c, int W, void* ox,
                      void* oy, void* oz, cudaStream_t s) {
  switch (field) {
    case 2: return tree_launch<Pallas>(bx, by, bz, c, W, ox, oy, oz, s);
    case 3: return tree_launch<Vesta>(bx, by, bz, c, W, ox, oy, oz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
