// The fix-var chain: bind j variables of one table in one launch, the port
// of make_fix_var (halo2_lasso_tpu/ops/pallas_field.py:250, pallas_call
// :278), which binds one variable a call. Each step is
//
//   q = hi - lo,  out = q * x + lo,
//
// with (lo, hi) = (t[e], t[e + h]) when binding the highest variable first
// (`last`, the KZG quotient order) or (t[2e], t[2e + 1]) when binding the
// lowest first (MLE evaluation). The KZG open keeps every step's quotient q:
// for a table of 2^k rows, step s writes its 2^(k-1-s) quotients at rows
// [2^(k-1-s) - 1, 2^(k-s) - 1) of one packed (2^k - 1, 8) buffer.
//
// Bound: bytes for a wide step (64 B read, 32 B written an output for one
// product), but a chain is k dependent steps, and on the TPU and in the
// port's first version each was a launch (and a plain sub with its host
// reads for the quotient). What the design does about it: one launch, no
// host sync, in two phases.
//   - Columns. The first m steps of the chain never mix columns: with
//     cols = n / 2^m, output i of step m depends only on the 2^m rows
//     i + c * cols (highest first) or i * 2^m + c (lowest first), c < 2^m,
//     taken as a stream in which each step's pairs are adjacent (highest
//     first reads its rows in bit-reversed order). A column is 2^g lanes
//     of one warp (g = min(m, 5)): each lane folds its 2^(m-g) stream
//     positions with a stack of partial results, then the lanes combine
//     by warp shuffles, one step a level; the quotients are written on the
//     way. m is the least that leaves cols <= 2^TAIL_BITS (or j, when the
//     table is wider than that after all j steps: then the columns are the
//     whole chain, as fix_var was).
//   - Tail. The last block to finish its columns (an atomic ticket, as K1
//     does) loads the cols results into shared memory ([limb][element],
//     32 KB at 2^10) and binds the remaining j - m variables there, one
//     step a level with __syncthreads between levels. The tail's products
//     run on one SM, so it is kept at 2^10 rows and the columns take the
//     rest. A cooperative grid with a grid-wide sync would also be one
//     launch, but it pays a grid sync a level (k of them, each a few
//     microseconds at 132 SMs) and needs the whole grid resident.
// The point travels by value in the kernel's parameters (j <= 32 host
// ints, as eq_xy takes its point) or is read from the card.
// Field arithmetic is exact and reduced, so the result equals the plain
// step-by-step loop's bytes.
#include <cstring>

#include "field.cuh"

#define MAX_CHAIN_VARS 32
#define TAIL_BITS 10
#define CHAIN_THREADS 256
#define MAX_LANE_BITS 5  // lanes a column, at most a warp
#define TAIL (1 << TAIL_BITS)
#define TAIL_ITEMS (TAIL / 2 / CHAIN_THREADS)

struct ChainParams {
  Fe x[MAX_CHAIN_VARS];   // the point by value, or
  const uint32_t* x_dev;  // its j rows on the card
  const uint32_t* evals;  // n rows
  uint32_t* mid;          // n >> m rows: the columns' results, when a tail follows
  uint32_t* quot;         // n - 1 rows of quotients (n = 2^j), or null
  uint32_t* out;          // n >> j rows
  unsigned int* ticket;
  long long n;
  int j, m, last;
};

// The coordinate bound at step s: point[i] is variable i (lowest first) or
// variable k - j + i (highest first).
template <class P>
FD Fe chain_x(const ChainParams& p, int s) {
  const int i = p.last ? p.j - 1 - s : s;
  return p.x_dev ? fe_load(p.x_dev, i) : p.x[i];
}

FD long long rev_bits(long long c, int b) {
  long long r = 0;
  for (int q = 0; q < b; ++q) r |= ((c >> q) & 1) << (b - 1 - q);
  return r;
}

// One step on a pair; the quotient goes to entry qi of step s's level.
template <class P>
FD Fe chain_step(const ChainParams& p, int s, long long qi, const Fe& lo, const Fe& hi) {
  const Fe q = fe_sub<P>(hi, lo);
  if (p.quot) fe_store(p.quot, (p.n >> (s + 1)) - 1 + qi, q);
  return fe_add<P>(fe_mul<P>(q, chain_x<P>(p, s)), lo);
}

// The quotient entry of column i's block blk at step s < m: the block's
// lo row in the table after s steps.
FD long long chain_qi(const ChainParams& p, long long i, int s, long long blk) {
  const int b = p.m - s - 1;
  return p.last ? i + rev_bits(blk, b) * (p.n >> p.m) : (i << b) + blk;
}

// log2 of the lanes a column.
FD int chain_lane_bits(int m) { return m < MAX_LANE_BITS ? m : MAX_LANE_BITS; }

// Steps 0 .. d-1 of column i over stream positions [r0, r0 + 2^d), r0 a
// multiple of 2^d: stk[s] holds the pending left operand of step s. Also
// compiled for the host (FIELD_HOST_TEST).
template <class P>
FD Fe chain_rows(const ChainParams& p, long long i, long long r0, int d) {
  const long long cols = p.n >> p.m;
  Fe stk[MAX_CHAIN_VARS + 1];
  Fe v;
  for (long long r = r0; r < r0 + (1ll << d); ++r) {
    v = fe_load16(p.evals, p.last ? i + rev_bits(r, p.m) * cols : (i << p.m) + r);
    int s = 0;
    for (long long c = r - r0; c & 1; c >>= 1, ++s) v = chain_step<P>(p, s, chain_qi(p, i, s, r >> (s + 1)), stk[s], v);
    stk[s] = v;
  }
  return v;
}

// The tail's table in shared memory, [limb][element] with `pitch` (its
// first width) elements a limb.
FD Fe tget(const uint32_t* sm, long long pitch, long long e) {
  Fe r;
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = sm[l * pitch + e];
  return r;
}
FD void tput(uint32_t* sm, long long pitch, long long e, const Fe& a) {
#pragma unroll
  for (int l = 0; l < 8; ++l) sm[l * pitch + e] = a.v[l];
}

// Step s of the tail on element e < h of its table of 2h. Also compiled for
// the host.
template <class P>
FD Fe tail_elem(const ChainParams& p, const uint32_t* sm, long long pitch, int s, long long h, long long e) {
  const Fe lo = tget(sm, pitch, p.last ? e : 2 * e), hi = tget(sm, pitch, p.last ? e + h : 2 * e + 1);
  return chain_step<P>(p, s, e, lo, hi);
}

// The column steps m: the least that leaves at most TAIL rows, or j.
inline int chain_split(long long n, int j) {
  if ((n >> j) >= TAIL) return j;
  int m = 0;
  while ((n >> m) > TAIL) ++m;
  return m;
}

#ifndef FIELD_HOST_TEST
template <class P>
__global__ void __launch_bounds__(CHAIN_THREADS) fix_var_kernel(const __grid_constant__ ChainParams p) {
  __shared__ uint32_t sm[8 * TAIL];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long cols = p.n >> p.m;
  if (p.m > 0) {
    // a column's 2^g lanes are consecutive lanes of one warp
    const int g = chain_lane_bits(p.m), d = p.m - g;
    const long long gid = (long long)blockIdx.x * CHAIN_THREADS + tid, i = gid >> g;
    const int lane = (int)(gid & ((1 << g) - 1));
    Fe v = i < cols ? chain_rows<P>(p, i, (long long)lane << d, d) : fe_zero();
    for (int q = 0; q < g; ++q) {  // step d + q: lane pairs (lane, lane + 2^q)
      Fe hi;
#pragma unroll
      for (int l = 0; l < 8; ++l) hi.v[l] = __shfl_down_sync(0xffffffffu, v.v[l], 1 << q);
      const int s = d + q;
      if (i < cols && (lane & ((2 << q) - 1)) == 0) v = chain_step<P>(p, s, chain_qi(p, i, s, lane >> (q + 1)), v, hi);
    }
    if (i < cols && lane == 0) fe_store16(p.m == p.j ? p.out : p.mid, i, v);
    if (p.m == p.j) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
  }
  // the tail (the one block when m = 0): every column's result is written
  // and fenced
  const uint32_t* src = p.m > 0 ? p.mid : p.evals;
  for (long long e = tid; e < cols; e += CHAIN_THREADS) tput(sm, cols, e, fe_load_cg(src, e));
  __syncthreads();
  long long h = cols;
  for (int s = p.m; s < p.j; ++s) {
    h >>= 1;
    Fe r[TAIL_ITEMS];
#pragma unroll
    for (int u = 0; u < TAIL_ITEMS; ++u) {
      const long long e = tid + u * CHAIN_THREADS;
      if (e < h) r[u] = tail_elem<P>(p, sm, cols, s, h, e);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < TAIL_ITEMS; ++u) {
      const long long e = tid + u * CHAIN_THREADS;
      if (e < h) tput(sm, cols, e, r[u]);
    }
    __syncthreads();
  }
  for (long long e = tid; e < h; e += CHAIN_THREADS) fe_store16(p.out, e, tget(sm, cols, e));
  if (tid == 0 && p.m > 0) *p.ticket = 0;  // ready for the next launch on this stream
}

template <class P>
int chain_launch(const ChainParams& p, cudaStream_t s) {
  const int g = p.m < MAX_LANE_BITS ? p.m : MAX_LANE_BITS;  // chain_lane_bits, on the host
  const long long lanes = p.m > 0 ? (p.n >> p.m) << g : 1;
  const unsigned blocks = (unsigned)((lanes + CHAIN_THREADS - 1) / CHAIN_THREADS);
  fix_var_kernel<P><<<blocks, CHAIN_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Bind j variables of evals (n rows, n a multiple of 2^j): x_host, j
// Montgomery elements on the host, or x_dev, j rows on the card (x_host
// null); mid: min(n, TAIL) rows of device scratch; quot: n - 1 rows
// (n = 2^j) or null; out: n >> j rows; ticket: a device counter at 0.
extern "C" int h2l_fix_var(int field, const void* evals, long long n, int j, int last, const void* x_host,
                           const void* x_dev, void* mid, void* quot, void* out, void* ticket, void* stream) {
  if (!field_built(field, false) || j < 1 || j > MAX_CHAIN_VARS || n < 2 || n % (1ll << j) ||
      (quot && n != (1ll << j)) || (!x_host && !x_dev))
    return (int)cudaErrorInvalidValue;
  ChainParams p;
  if (x_host) memcpy(p.x, x_host, sizeof(Fe) * j);
  p.x_dev = x_host ? nullptr : (const uint32_t*)x_dev;
  p.evals = (const uint32_t*)evals;
  p.mid = (uint32_t*)mid;
  p.quot = (uint32_t*)quot;
  p.out = (uint32_t*)out;
  p.ticket = (unsigned int*)ticket;
  p.n = n;
  p.j = j;
  p.m = chain_split(n, j);
  p.last = last;
  cudaStream_t s = (cudaStream_t)stream;
  return field == 0 ? chain_launch<Fr>(p, s) : chain_launch<Fq>(p, s);
}
#endif
