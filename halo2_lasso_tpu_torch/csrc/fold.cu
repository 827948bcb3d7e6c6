// Fold of every table of a sumcheck state with one challenge in one launch,
// the port of make_fold_all (halo2_lasso_tpu/ops/pallas_field.py:293,
// _group_kernel :320, pallas_call :355).
//
//   out[k][i] = (hi - lo) * x + lo,  lo = in[k][j], hi = in[k][j + stride],
//   j = (i / stride) * 2 * stride + i % stride.
//
// stride = 1 pairs adjacent entries (fix_var: bind the lowest variable);
// stride = h pairs the two halves (fix_last_var: bind the highest).
// Bound: bytes (reads 64 B, writes 32 B per output for one Montgomery
// product). blockIdx.y walks the tables, so one launch covers the state;
// the TPU grouped tables only to fit its scoped VMEM.
#include "field.cuh"

__global__ void fold_all_kernel(const uint32_t* const* ins, uint32_t* const* outs,
                                long long h, long long stride, const uint32_t* x) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  const uint32_t* in = ins[blockIdx.y];
  long long j = (i / stride) * 2 * stride + i % stride;
  Fe lo = fe_load(in, j);
  Fe hi = fe_load(in, j + stride);
  Fe xv = fe_load(x, 0);
  Fe r = fe_add<Fr>(fe_mul<Fr>(fe_sub<Fr>(hi, lo), xv), lo);
  fe_store(outs[blockIdx.y], i, r);
}

extern "C" int h2l_fold_all(const void* ins, const void* outs, int ntables, long long h,
                            long long stride, const void* x, void* stream) {
  if (h <= 0 || ntables <= 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((h + threads - 1) / threads), (unsigned)ntables);
  fold_all_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t* const*)ins, (uint32_t* const*)outs, h, stride, (const uint32_t*)x);
  return (int)cudaGetLastError();
}
