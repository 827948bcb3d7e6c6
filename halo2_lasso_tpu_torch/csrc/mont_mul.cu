// The field's elementwise kernel and its row sum, the port of make_mont_mul
// (halo2_lasso_tpu/ops/pallas_field.py:225, pallas_call :239), redesigned
// for Hopper so that the adds around a product run in the same launch:
//
//   EW_MUL      out = a * b
//   EW_MUL_ADD  out = a * b + c
//   EW_MUL_SUB  out = a * b - c
//   EW_ADD      out = a + b
//   EW_SUB      out = a - b
//   EW_NEG      out = -a
//
// add, sub and neg are field.cuh's fixed carry chains with one conditional
// subtract or add of p (the port of _add_rows, _sub_rows and _neg_rows,
// ops/pallas_field.py:161-199, and of halo2_lasso_tpu/ops/field.py:245-262):
// no loop and no flag read back by the host, unlike the plain versions'
// carry pass (ops/field.py, _norm).
//
// Bound: bytes. A product reads 64-96 bytes and writes 32 for ~256 32-bit
// multiply-adds, under the card's integer rate; an add is 96 bytes for a
// few dozen adds. At the main path's sizes (2^8 ... 2^16 rows) a launch is
// latency and the host's enqueue, so the design cuts launches and copies:
//   - the op is a template parameter (no divergence, no op registers);
//   - each operand is rows on the card read with two row strides over an
//     (outer, inner) grid, so a broadcast row (stride 0), a half or a pair
//     stride of a table (the sumchecks' lo/hi rows) is read in place and
//     never materialised; or one element passed by value in the kernel's
//     parameters (a host scalar: nothing is copied to the card);
//   - one thread an element, 16-byte loads and stores, any length.
//
// sum_reduce_kernel sums the rows of m columns, element (r, j) at row
// r * s0 + j * s1: a grid of (nb, m) blocks, each thread adding rows in
// registers, each block reducing by warp shuffles and shared memory; with
// nb > 1 the last block to finish (an atomic ticket, as K1 does) adds the
// block partials of every column. One launch, no host sync. Field addition
// is exact and reduced, so any order gives the plain tree's bytes.
//
// The elementwise kernel has four field instances: BN254's Fr and Fq here,
// Pallas and Vesta built in csrc/mont_pasta.cu (the same kernel over
// another modulus; its own source keeps the parallel build's slowest job
// as it was). The row sum has the BN254 instances only: no Pasta path
// sums rows.
#include <cstring>

#include "field.cuh"

#define EW_MUL 0
#define EW_MUL_ADD 1
#define EW_MUL_SUB 2
#define EW_ADD 3
#define EW_SUB 4
#define EW_NEG 5

#define EW_THREADS 256
#define SUM_THREADS 256
#define SUM_MAX_BLOCKS 256  // block partials the last block adds per column, one a thread

struct EwOperand {
  const uint32_t* p;  // rows on the card, or null: `v` by value
  long long s0, s1;   // row strides over the (outer, inner) grid; 0 broadcasts
  Fe v;
};

struct EwParams {
  EwOperand a, b, c;
  uint32_t* out;  // outer * inner contiguous rows
  long long outer, inner;
};

FD Fe ew_load(const EwOperand& x, long long o, long long i) {
  return x.p ? fe_load16(x.p, o * x.s0 + i * x.s1) : x.v;
}

// Output g of the grid; also compiled for the host (FIELD_HOST_TEST) so the
// CPU tests hold it against the plain versions.
template <class P, int OP>
FD Fe ew_elem(const EwParams& p, long long g) {
  const long long o = p.outer == 1 ? 0 : g / p.inner, i = g - o * p.inner;
  const Fe a = ew_load(p.a, o, i);
  if (OP == EW_NEG) return fe_neg<P>(a);
  const Fe b = ew_load(p.b, o, i);
  if (OP == EW_ADD) return fe_add<P>(a, b);
  if (OP == EW_SUB) return fe_sub<P>(a, b);
  const Fe ab = fe_mul<P>(a, b);
  if (OP == EW_MUL) return ab;
  const Fe c = ew_load(p.c, o, i);
  return OP == EW_MUL_ADD ? fe_add<P>(ab, c) : fe_sub<P>(ab, c);
}

template <class P>
FD Fe ew_elem_op(int op, const EwParams& p, long long g) {
  switch (op) {
    case EW_MUL: return ew_elem<P, EW_MUL>(p, g);
    case EW_MUL_ADD: return ew_elem<P, EW_MUL_ADD>(p, g);
    case EW_MUL_SUB: return ew_elem<P, EW_MUL_SUB>(p, g);
    case EW_ADD: return ew_elem<P, EW_ADD>(p, g);
    case EW_SUB: return ew_elem<P, EW_SUB>(p, g);
    default: return ew_elem<P, EW_NEG>(p, g);
  }
}

#ifndef FIELD_HOST_TEST
template <class P, int OP>
__global__ void __launch_bounds__(EW_THREADS) mont_mul_kernel(const __grid_constant__ EwParams p) {
  const long long g = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (g >= p.outer * p.inner) return;
  fe_store16(p.out, g, ew_elem<P, OP>(p, g));
}

template <class P>
int ew_launch(int op, const EwParams& p, cudaStream_t s) {
  const unsigned blocks = (unsigned)((p.outer * p.inner + EW_THREADS - 1) / EW_THREADS);
  switch (op) {
    case EW_MUL: mont_mul_kernel<P, EW_MUL><<<blocks, EW_THREADS, 0, s>>>(p); break;
    case EW_MUL_ADD: mont_mul_kernel<P, EW_MUL_ADD><<<blocks, EW_THREADS, 0, s>>>(p); break;
    case EW_MUL_SUB: mont_mul_kernel<P, EW_MUL_SUB><<<blocks, EW_THREADS, 0, s>>>(p); break;
    case EW_ADD: mont_mul_kernel<P, EW_ADD><<<blocks, EW_THREADS, 0, s>>>(p); break;
    case EW_SUB: mont_mul_kernel<P, EW_SUB><<<blocks, EW_THREADS, 0, s>>>(p); break;
    case EW_NEG: mont_mul_kernel<P, EW_NEG><<<blocks, EW_THREADS, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The Pallas and Vesta launchers, built in csrc/mont_pasta.cu.
int ew_launch_pasta(int field, int op, const EwParams& p, cudaStream_t s);

#ifndef H2L_PASTA_SOURCE
// field: 0 = Fr, 1 = Fq, 2 = Pallas, 3 = Vesta; ptrs: host array of 3
// device pointers (a, b, c; null reads the element by value); strides:
// host array of the 6 row strides (s0, s1 of a, b, c); vals: host array of
// 3 Montgomery elements; out: outer * inner rows.
extern "C" int h2l_mont_mul(int field, int op, const void* ptrs, const void* strides, const void* vals,
                            void* out, long long outer, long long inner, void* stream) {
  if (!field_built(field, true)) return (int)cudaErrorInvalidValue;
  if (outer <= 0 || inner <= 0) return 0;
  const void* const* ps = (const void* const*)ptrs;
  const long long* ss = (const long long*)strides;
  EwParams p;
  EwOperand* xs[3] = {&p.a, &p.b, &p.c};
  for (int k = 0; k < 3; ++k) {
    xs[k]->p = (const uint32_t*)ps[k];
    xs[k]->s0 = ss[2 * k];
    xs[k]->s1 = ss[2 * k + 1];
    memcpy(xs[k]->v.v, (const char*)vals + 32 * k, 32);
  }
  if (!p.a.p) return (int)cudaErrorInvalidValue;
  p.out = (uint32_t*)out;
  p.outer = outer;
  p.inner = inner;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return ew_launch<Fr>(op, p, s);
    case 1: return ew_launch<Fq>(op, p, s);
    default: return ew_launch_pasta(field, op, p, s);
  }
}
#endif

struct SumParams {
  const uint32_t* a;  // element (r, j) at row r * s0 + j * s1
  long long n, s0, s1;
  uint32_t* partials;  // m * nb rows, column by column
  uint32_t* out;       // m rows
  unsigned int* ticket;
};

// The block's sum, in thread 0.
template <class P>
__device__ Fe block_sum(Fe v, Fe* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    Fe o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.v[j] = __shfl_down_sync(0xffffffffu, v.v[j], off);
    v = fe_add<P>(v, o);
  }
  __syncthreads();  // earlier readers of warp_sums are done
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < SUM_THREADS / 32 ? warp_sums[lane] : fe_zero();
#pragma unroll
    for (int off = SUM_THREADS / 64; off; off >>= 1) {
      Fe o;
#pragma unroll
      for (int j = 0; j < 8; ++j) o.v[j] = __shfl_down_sync(0xffffffffu, v.v[j], off);
      v = fe_add<P>(v, o);
    }
  }
  return v;
}

template <class P>
__global__ void __launch_bounds__(SUM_THREADS) sum_reduce_kernel(const __grid_constant__ SumParams p) {
  __shared__ Fe warp_sums[SUM_THREADS / 32];
  __shared__ bool last;
  const int tid = threadIdx.x, nb = gridDim.x;
  const long long col = blockIdx.y;
  Fe acc = fe_zero();
  for (long long r = (long long)blockIdx.x * SUM_THREADS + tid; r < p.n; r += (long long)nb * SUM_THREADS)
    acc = fe_add<P>(acc, fe_load16(p.a, r * p.s0 + col * p.s1));
  acc = block_sum<P>(acc, warp_sums);
  if (nb == 1) {
    if (tid == 0) fe_store16(p.out, col, acc);
    return;
  }
  if (tid == 0) {
    fe_store16(p.partials, col * nb + blockIdx.x, acc);
    __threadfence();
    last = atomicAdd(p.ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written and fenced
  for (long long c = 0; c < gridDim.y; ++c) {
    acc = block_sum<P>(tid < nb ? fe_load_cg(p.partials, c * nb + tid) : fe_zero(), warp_sums);
    if (tid == 0) fe_store16(p.out, c, acc);
  }
  if (tid == 0) *p.ticket = 0;  // ready for the next launch on this stream
}

#ifndef H2L_PASTA_SOURCE
// field: 0 = Fr, 1 = Fq; a: device rows, element (r, j) at row r * s0 +
// j * s1 for r < n, j < m; partials: m * nb rows of device scratch;
// ticket: a device counter at 0; out: m rows. nb <= SUM_MAX_BLOCKS blocks
// a column.
extern "C" int h2l_sum_reduce(int field, const void* a, long long n, int m, long long s0, long long s1,
                              int nb, void* partials, void* ticket, void* out, void* stream) {
  if (!field_built(field, false)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || m <= 0) return 0;
  if (nb < 1 || nb > SUM_MAX_BLOCKS || m > 65535) return (int)cudaErrorInvalidValue;
  SumParams p{(const uint32_t*)a, n, s0, s1, (uint32_t*)partials, (uint32_t*)out, (unsigned int*)ticket};
  const dim3 grid((unsigned)nb, (unsigned)m);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) sum_reduce_kernel<Fr><<<grid, SUM_THREADS, 0, s>>>(p);
  else sum_reduce_kernel<Fq><<<grid, SUM_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
#endif
#endif
