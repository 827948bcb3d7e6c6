// Single-table fold, the port of make_fix_var
// (halo2_lasso_tpu/ops/pallas_field.py:250, pallas_call :278).
//
//   out[i] = (hi[i * step] - lo[i * step]) * x + lo[i * step],  i < h.
//
// The caller passes the two halves of each pair as two direct pointers and
// one pair step: lo = t, hi = t + 1 element, step 2 for fix_var (bind the
// lowest variable, pairs (2i, 2i+1)); lo = t, hi = t + h elements, step 1
// for fix_last_var (bind the highest, pairs (i, i+h)). No pointer table and
// no multi-table indirection, unlike fold_all (fold.cu).
// Bound: bytes (reads 64 B, writes 32 B per output for one Montgomery
// product). One thread per output element with the ragged edge masked; the
// TPU kernel's (L, S, 128) tiling is not carried over.
#include "field.cuh"

// One output element; also compiled for the host (FIELD_HOST_TEST) so the
// CPU tests hold it against the plain version.
FD Fe fix_var_elem(const uint32_t* lo, const uint32_t* hi, long long step, long long i,
                   const Fe& x) {
  Fe l = fe_load(lo, i * step);
  Fe u = fe_load(hi, i * step);
  return fe_add<Fr>(fe_mul<Fr>(fe_sub<Fr>(u, l), x), l);
}

#ifndef FIELD_HOST_TEST
__global__ void fix_var_kernel(const uint32_t* lo, const uint32_t* hi, long long step,
                               uint32_t* out, long long h, const uint32_t* x) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  fe_store(out, i, fix_var_elem(lo, hi, step, i, fe_load(x, 0)));
}

extern "C" int h2l_fix_var(const void* lo, const void* hi, long long step, void* out,
                           long long h, const void* x, void* stream) {
  if (h <= 0) return 0;
  const int threads = 256;
  long long blocks = (h + threads - 1) / threads;
  fix_var_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lo, (const uint32_t*)hi, step, (uint32_t*)out, h, (const uint32_t*)x);
  return (int)cudaGetLastError();
}
#endif
