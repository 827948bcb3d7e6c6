// Fold of every table of a sumcheck state with one challenge in one launch,
// the port of make_fold_all (halo2_lasso_tpu/ops/pallas_field.py:293,
// _group_kernel :320, pallas_call :355), in an Fr and an Fq instance
// selected by `field` (the kernel_id: 0 = Fr, 1 = Fq), as make_fold_all
// takes any FieldSpec (the grumpkin-backed SNARK folds over BN254 Fq).
//
//   out[k][i] = (hi - lo) * x + lo,  lo = in[k][j], hi = in[k][j + stride],
//   j = (i / stride) * 2 * stride + i % stride.
//
// stride = 1 pairs adjacent entries (fix_var: bind the lowest variable);
// stride = h pairs the two halves (fix_last_var: bind the highest).
//
// Bound: bytes (reads 64 B, writes 32 B an output for one Montgomery
// product) at the large tables; at the GKR's small layers (h = 1 ... 2^7)
// a launch is latency, and what the host does around it. What the design
// does about it:
//   - the input table pointers and the challenge travel by value in a
//     __grid_constant__ struct (the kernel's parameters), so no pointer
//     table and no challenge is copied to the card before the launch; a
//     challenge the caller holds on the card (x_dev) is read from there;
//   - the outputs are one (ntables, h) block, so output g of the flat grid
//     is row g of it: one thread an output over all the tables in one
//     launch, and the small layers' tables share blocks;
//   - 16-byte loads and stores, the challenge held in registers.
// Up to FOLD_MAX_TABLES tables a launch (K1's MAX_LEAVES); the wrapper
// launches once a group beyond that, as the TPU grouped its tables.
#include <cstring>

#include "field.cuh"

#define FOLD_MAX_TABLES 64

struct FoldParams {
  const uint32_t* ins[FOLD_MAX_TABLES];
  uint32_t* out;         // (ntables, h) rows
  Fe x;                  // the challenge, when x_dev is null
  const uint32_t* x_dev; // the challenge on the card, or null
  long long h, stride;
  int ntables;
};

// Output i of one table.
template <class P>
FD Fe fold_elem(const uint32_t* in, long long stride, long long i, const Fe& x) {
  const long long j = (i / stride) * 2 * stride + i % stride;
  const Fe lo = fe_load16(in, j);
  const Fe hi = fe_load16(in, j + stride);
  return fe_add<P>(fe_mul<P>(fe_sub<P>(hi, lo), x), lo);
}

#ifndef FIELD_HOST_TEST
template <class P>
__global__ void __launch_bounds__(256) fold_all_kernel(const __grid_constant__ FoldParams p) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.h * p.ntables) return;
  const int t = (int)(g / p.h);
  const long long i = g - t * p.h;
  const Fe x = p.x_dev ? fe_load(p.x_dev, 0) : p.x;
  fe_store16(p.out, g, fold_elem<P>(p.ins[t], p.stride, i, x));
}

// ins: host array of ntables device pointers; out: device (ntables, h)
// rows; x_host: a host Montgomery element, or null and x_dev the element
// on the card; field: 0 = Fr, 1 = Fq.
extern "C" int h2l_fold_all(int field, const void* ins, void* out, int ntables, long long h,
                            long long stride, const void* x_host, const void* x_dev,
                            void* stream) {
  if (!field_built(field, false)) return (int)cudaErrorInvalidValue;
  if (h <= 0 || ntables <= 0) return 0;
  if (ntables > FOLD_MAX_TABLES || (!x_host && !x_dev)) return (int)cudaErrorInvalidValue;
  FoldParams p;
  memcpy(p.ins, ins, sizeof(void*) * ntables);
  p.out = (uint32_t*)out;
  if (x_host) memcpy(p.x.v, x_host, sizeof(Fe));
  p.x_dev = x_host ? nullptr : (const uint32_t*)x_dev;
  p.h = h;
  p.stride = stride;
  p.ntables = ntables;
  const int threads = 256;
  const long long blocks = (h * ntables + threads - 1) / threads;
  if (field == 0)
    fold_all_kernel<Fr><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p);
  else
    fold_all_kernel<Fq><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
#endif
