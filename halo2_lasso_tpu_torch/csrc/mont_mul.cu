// Elementwise Montgomery product, the port of make_mont_mul
// (halo2_lasso_tpu/ops/pallas_field.py:225, pallas_call :239).
//
// Bound: bytes. Each lane reads 64 bytes and writes 32 for ~150 integer
// multiply-adds, far under the card's integer rate, so the kernel streams.
// One thread per element with coalesced 32-byte rows; any length, the
// ragged edge masked (the TPU grid dropped remainder rows instead).
#include "field.cuh"

template <class P>
__global__ void mont_mul_kernel(const uint32_t* a, const uint32_t* b, int b_bcast,
                                uint32_t* out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a, i);
  Fe y = fe_load(b, b_bcast ? 0 : i);
  fe_store(out, i, fe_mul<P>(x, y));
}

extern "C" int h2l_mont_mul(int field, const void* a, const void* b, int b_bcast,
                            void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    mont_mul_kernel<Fr><<<blocks, threads, 0, s>>>((const uint32_t*)a, (const uint32_t*)b,
                                                   b_bcast, (uint32_t*)out, n);
  else
    mont_mul_kernel<Fq><<<blocks, threads, 0, s>>>((const uint32_t*)a, (const uint32_t*)b,
                                                   b_bcast, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
