// The Montgomery product's chains: a power, the prefix-product scan, the
// batch inversion built on both, and the eq table. The JAX package runs
// each inside one jitted graph: pow_fixed's fori_loop
// (halo2_lasso_tpu/ops/field.py:387), batch_inv's two associative_scans
// and Fermat inversion (:416), and the eq_xy doubling
// (halo2_lasso_tpu/poly/multilinear.py:55), all over make_mont_mul
// (halo2_lasso_tpu/ops/pallas_field.py:225). Launched one product at a
// time from the host, each step of those loops was a K4 launch (a Fermat
// inversion about 380), so the host's enqueue, not the card, bounded them.
// Here each chain is a fixed number of launches, whatever its length, and
// nothing is copied between the host and the card:
//
//   - mont_pow: one thread a row raises the row to a power whose bits
//     travel by value in the kernel's parameters (left-to-right square and
//     multiply). For batch_inv's one total this is a single thread on a
//     latency-bound chain of ~253 squarings and ~half as many products:
//     bound by the product's latency, not by bytes or the card's rate.
//   - the scan (scan_kernel, three phases): each block of 256 threads
//     takes a tile of 1024 rows, 4 consecutive rows a thread. TILES writes
//     each tile's product; CARRIES (one block) scans the tile products both
//     ways; APPLY rescans each tile from its carry. The block scan is
//     Hillis-Steele over the threads' products in shared memory, laid out
//     [limb][thread] (no bank conflicts). A single tile needs APPLY alone.
//     Bound: operations at the sizes the proofs use (about 3 products a
//     row against 64 bytes moved); the tiles give 128 blocks at 2^17.
//   - batch_inv: TILES (zero rows read as one), CARRIES, mont_pow on the
//     total (exponent p - 2) and APPLY, which writes prefix * suffix *
//     total^-1 a row (0 for a zero row): four launches, no host sync.
//   - eq_xy: one launch writes the 2^k table. A block covers 256
//     consecutive indices; 16 threads build the table over variables 0-3,
//     16 more the table over variables 4-7, one thread the block's product
//     over the variables above 7, and each index then takes one product of
//     two table entries. Bound: the 32 bytes a row written.
//
// Field products are exact and fully reduced, and multiplication is
// commutative, so every association order gives the plain loops' bytes.
//
// mont_pow, the scan and batch_inv have four field instances: BN254's Fr
// and Fq here, Pallas and Vesta built in csrc/mont_pasta.cu (the inversions
// of the Pasta curves' affine conversions and batched-affine MSM); eq_xy
// has the BN254 instances only.
#include <cstring>

#include "field.cuh"

#define MAX_POW_WORDS 8
#define MAX_EQ_VARS 32
#define SCAN_THREADS 256
#define SCAN_ITEMS 4
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)

// An exponent below 2^256: little-endian words and its bit length.
struct PowExp {
  uint32_t w[MAX_POW_WORDS];
  int nbits;
};

template <class P>
FD Fe fe_pow(const Fe& a, const PowExp& e) {
  if (e.nbits == 0) return fe_one<P>();
  Fe r = a;  // the top bit
#pragma unroll 1
  for (int i = e.nbits - 2; i >= 0; --i) {
    r = fe_mul<P>(r, r);
    if ((e.w[i >> 5] >> (i & 31)) & 1) r = fe_mul<P>(r, a);
  }
  return r;
}

// The eq table's point: k <= 32 coordinates by value (y), or on the card
// (y_dev, k rows) when the caller holds them there.
struct EqParams {
  Fe y[MAX_EQ_VARS];
  const uint32_t* y_dev;
  int k;
};

template <class P>
FD Fe eq_factor(const EqParams& p, int i, long long bit) {
  const Fe y = p.y_dev ? fe_load(p.y_dev, i) : p.y[i];
  return bit ? y : fe_sub<P>(fe_one<P>(), y);
}

// prod over the variables i in [from, min(to, k)) of y_i where bit i - from
// of `bits` is set, else 1 - y_i; one for an empty range.
template <class P>
FD Fe eq_part(const EqParams& p, int from, int to, long long bits) {
  Fe acc = fe_one<P>();
  bool first = true;
#pragma unroll 1
  for (int i = from; i < to && i < p.k; ++i) {
    const Fe f = eq_factor<P>(p, i, (bits >> (i - from)) & 1);
    acc = first ? f : fe_mul<P>(acc, f);
    first = false;
  }
  return acc;
}

// Entry b of the table as the kernel composes it: the two 4-variable
// tables' entries times the product over the higher variables. Also
// compiled for the host (FIELD_HOST_TEST) for the CPU tests.
template <class P>
FD Fe eq_xy_elem(const EqParams& p, long long b) {
  const Fe hi = fe_mul<P>(eq_part<P>(p, 4, 8, (b >> 4) & 15), eq_part<P>(p, 8, MAX_EQ_VARS, b >> 8));
  return fe_mul<P>(eq_part<P>(p, 0, 4, b & 15), hi);
}

#ifndef FIELD_HOST_TEST
template <class P>
__global__ void mont_pow_kernel(const uint32_t* a, uint32_t* out, long long n, const PowExp e) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_store16(out, i, fe_pow<P>(fe_load16(a, i), e));
}

template <class P>
__global__ void __launch_bounds__(256) eq_xy_kernel(const __grid_constant__ EqParams p,
                                                    uint32_t* out) {
  __shared__ Fe lo[16], mid[16], top;
  const int t = threadIdx.x;
  const long long n = 1ll << p.k, b = (long long)blockIdx.x * 256 + t;
  if (t < 16) lo[t] = eq_part<P>(p, 0, 4, t);
  else if (t < 32) mid[t - 16] = eq_part<P>(p, 4, 8, t - 16);
  else if (t == 32) top = eq_part<P>(p, 8, MAX_EQ_VARS, (long long)blockIdx.x);
  __syncthreads();
  if (t < 16 && p.k > 8) mid[t] = fe_mul<P>(mid[t], top);
  __syncthreads();
  if (b < n) fe_store16(out, b, fe_mul<P>(lo[t & 15], mid[t >> 4]));
}

enum { PH_TILES = 0, PH_CARRIES = 1, PH_APPLY = 2 };

struct ScanArgs {
  const uint32_t* x;
  uint32_t* out;
  long long n, nb;        // rows, tiles
  int reverse;            // scan from the last row (row n-1-j is logical row j)
  int inv;                // batch_inv: zero rows read as one, APPLY writes inverses
  uint32_t* tile_tot;     // nb rows: each tile's product (TILES)
  uint32_t* carry_fwd;    // nb rows: the product of the tiles before (CARRIES), or null
  uint32_t* carry_rev;    // nb rows: the product of the tiles after (CARRIES), or null
  uint32_t* total;        // 1 row: the product of every tile (CARRIES)
  const uint32_t* inv_total;  // 1 row: total^-1 (APPLY with inv)
};

// Shared scratch [limb][thread].
FD Fe sget(const uint32_t* s, int i) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = s[j * SCAN_THREADS + i];
  return r;
}
FD void sput(uint32_t* s, int i, const Fe& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j * SCAN_THREADS + i] = a.v[j];
}

// Exclusive product of v over the block's threads, in thread order or in
// reverse; *incl gets the inclusive one.
template <class P>
__device__ Fe block_scan(Fe v, uint32_t* s, bool rev, Fe* incl) {
  const int me = rev ? SCAN_THREADS - 1 - threadIdx.x : threadIdx.x;
  __syncthreads();  // earlier readers of s are done
  sput(s, me, v);
  __syncthreads();
#pragma unroll 1
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const bool has = me >= off;
    Fe o;
    if (has) o = sget(s, me - off);
    __syncthreads();
    if (has) {
      v = fe_mul<P>(o, v);
      sput(s, me, v);
    }
    __syncthreads();
  }
  if (incl) *incl = v;
  return me > 0 ? sget(s, me - 1) : fe_one<P>();
}

template <class P>
FD Fe scan_row(const ScanArgs& a, long long j, bool* zero) {
  const Fe v = fe_load16(a.x, a.reverse ? a.n - 1 - j : j);
  *zero = a.inv && fe_is_zero(v);
  return *zero ? fe_one<P>() : v;
}

template <class P, int PHASE>
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(const ScanArgs a) {
  __shared__ uint32_t s[8 * SCAN_THREADS];
  const int tid = threadIdx.x;
  if (PHASE == PH_CARRIES) {  // one block over the nb tile products
    const long long chunk = (a.nb + SCAN_THREADS - 1) / SCAN_THREADS;
    const long long lo = tid * chunk, hi = lo + chunk < a.nb ? lo + chunk : a.nb;
    Fe prod = fe_one<P>(), incl;
    for (long long b = lo; b < hi; ++b) prod = fe_mul<P>(prod, fe_load16(a.tile_tot, b));
    Fe c = block_scan<P>(prod, s, false, &incl);
    if (tid == SCAN_THREADS - 1) fe_store16(a.total, 0, incl);
    for (long long b = lo; b < hi; ++b) {
      fe_store16(a.carry_fwd, b, c);
      c = fe_mul<P>(c, fe_load16(a.tile_tot, b));
    }
    if (a.carry_rev) {
      c = block_scan<P>(prod, s, true, nullptr);
      for (long long b = hi - 1; b >= lo; --b) {
        fe_store16(a.carry_rev, b, c);
        c = fe_mul<P>(c, fe_load16(a.tile_tot, b));
      }
    }
    return;
  }
  const long long base = (long long)blockIdx.x * SCAN_TILE + (long long)tid * SCAN_ITEMS;
  const int m = a.n - base <= 0 ? 0 : (a.n - base < SCAN_ITEMS ? (int)(a.n - base) : SCAN_ITEMS);
  Fe v[SCAN_ITEMS];
  bool zero[SCAN_ITEMS];
  Fe prod = fe_one<P>();
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    zero[j] = false;
    if (j < m) {
      v[j] = scan_row<P>(a, base + j, &zero[j]);
      prod = j == 0 ? v[j] : fe_mul<P>(prod, v[j]);
    }
  }
  if (PHASE == PH_TILES) {
    Fe incl;
    block_scan<P>(prod, s, false, &incl);
    if (tid == SCAN_THREADS - 1) fe_store16(a.tile_tot, blockIdx.x, incl);
    return;
  }
  // PH_APPLY
  Fe left = block_scan<P>(prod, s, false, nullptr);
  if (a.carry_fwd) left = fe_mul<P>(fe_load16(a.carry_fwd, blockIdx.x), left);
  if (!a.inv) {
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (j < m) {
        left = fe_mul<P>(left, v[j]);
        const long long r = base + j;
        fe_store16(a.out, a.reverse ? a.n - 1 - r : r, left);
      }
    }
    return;
  }
  Fe right = block_scan<P>(prod, s, true, nullptr);
  if (a.carry_rev) right = fe_mul<P>(right, fe_load16(a.carry_rev, blockIdx.x));
  left = fe_mul<P>(left, fe_load16(a.inv_total, 0));
  Fe lefts[SCAN_ITEMS];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (j < m) {
      lefts[j] = left;
      left = fe_mul<P>(left, v[j]);
    }
  }
#pragma unroll
  for (int j = SCAN_ITEMS - 1; j >= 0; --j) {
    if (j < m) {
      const Fe r = fe_mul<P>(lefts[j], right);
      right = fe_mul<P>(right, v[j]);
      fe_store16(a.out, base + j, zero[j] ? fe_zero() : r);
    }
  }
}

template <class P>
int scan_launch(int phase, const ScanArgs& a, cudaStream_t s) {
  const unsigned blocks = phase == PH_CARRIES ? 1u : (unsigned)a.nb;
  if (phase == PH_TILES) scan_kernel<P, PH_TILES><<<blocks, SCAN_THREADS, 0, s>>>(a);
  else if (phase == PH_CARRIES) scan_kernel<P, PH_CARRIES><<<blocks, SCAN_THREADS, 0, s>>>(a);
  else scan_kernel<P, PH_APPLY><<<blocks, SCAN_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <class P>
int pow_launch(const void* a, void* out, long long n, const void* exp, int nbits, cudaStream_t s) {
  PowExp e;
  for (int i = 0; i < MAX_POW_WORDS; ++i) e.w[i] = ((const uint32_t*)exp)[i];
  e.nbits = nbits;
  const int threads = n < 128 ? 32 : 128;
  mont_pow_kernel<P><<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      (const uint32_t*)a, (uint32_t*)out, n, e);
  return (int)cudaGetLastError();
}

// The scan's scratch: 3 nb + 2 rows (tile products, both carries, the
// total and its inverse).
template <class P>
int chain(const void* x, void* out, long long n, int reverse, int inv, void* scratch,
          const void* exp, int nbits, cudaStream_t s) {
  ScanArgs a;
  a.x = (const uint32_t*)x;
  a.out = (uint32_t*)out;
  a.n = n;
  a.nb = (n + SCAN_TILE - 1) / SCAN_TILE;
  a.reverse = reverse;
  a.inv = inv;
  uint32_t* sc = (uint32_t*)scratch;
  a.tile_tot = sc;
  a.carry_fwd = a.nb > 1 ? sc + 8 * a.nb : nullptr;
  a.carry_rev = a.nb > 1 && inv ? sc + 16 * a.nb : nullptr;
  a.total = sc + 24 * a.nb;
  a.inv_total = sc + 24 * a.nb + 8;
  int rc;
  if (inv || a.nb > 1) {
    if ((rc = scan_launch<P>(PH_TILES, a, s))) return rc;
  }
  if (a.nb > 1) {
    if ((rc = scan_launch<P>(PH_CARRIES, a, s))) return rc;
  }
  if (inv) {
    if ((rc = pow_launch<P>(a.nb > 1 ? a.total : a.tile_tot, (void*)a.inv_total, 1, exp, nbits, s)))
      return rc;
  }
  return scan_launch<P>(PH_APPLY, a, s);
}

// The Pallas and Vesta launchers, built in csrc/mont_pasta.cu.
int pow_launch_pasta(int field, const void* a, void* out, long long n, const void* exp, int nbits,
                     cudaStream_t s);
int chain_pasta(int field, const void* x, void* out, long long n, int reverse, int inv, void* scratch,
                const void* exp, int nbits, cudaStream_t s);

#ifndef H2L_PASTA_SOURCE
// field: 0 = Fr, 1 = Fq, 2 = Pallas, 3 = Vesta (every entry below but
// eq_xy, which takes 0 and 1); a, out: device (n, 8); exp: host array of 8
// words, nbits its bit length.
extern "C" int h2l_mont_pow(int field, const void* a, void* out, long long n, const void* exp,
                            int nbits, void* stream) {
  if (!field_built(field, true) || nbits < 0 || nbits > 32 * MAX_POW_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return pow_launch<Fr>(a, out, n, exp, nbits, s);
    case 1: return pow_launch<Fq>(a, out, n, exp, nbits, s);
    default: return pow_launch_pasta(field, a, out, n, exp, nbits, s);
  }
}

static int chain_any(int field, const void* x, void* out, long long n, int reverse, int inv, void* scratch,
                     const void* exp, int nbits, cudaStream_t s) {
  switch (field) {
    case 0: return chain<Fr>(x, out, n, reverse, inv, scratch, exp, nbits, s);
    case 1: return chain<Fq>(x, out, n, reverse, inv, scratch, exp, nbits, s);
    default: return chain_pasta(field, x, out, n, reverse, inv, scratch, exp, nbits, s);
  }
}

// Inclusive prefix products of the rows of x (from the last row when
// `reverse`): 1 launch for n <= 1024, else 3. scratch: 3 nb + 2 rows.
extern "C" int h2l_prefix_products(int field, const void* x, void* out, long long n, int reverse,
                                   void* scratch, void* stream) {
  if (!field_built(field, true)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  return chain_any(field, x, out, n, reverse, 0, scratch, nullptr, 0, (cudaStream_t)stream);
}

// Every row of x inverted, zero rows kept zero: 3 launches for n <= 1024,
// else 4. exp: host array of the 8 words of p - 2, nbits its bit length.
extern "C" int h2l_batch_inv(int field, const void* x, void* out, long long n, void* scratch,
                             const void* exp, int nbits, void* stream) {
  if (!field_built(field, true) || nbits < 1 || nbits > 32 * MAX_POW_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  return chain_any(field, x, out, n, 0, 1, scratch, exp, nbits, (cudaStream_t)stream);
}

// The 2^k table of eq(X, y): y_host, k Montgomery rows on the host, or
// y_dev, k rows on the card (y_host null). One launch.
extern "C" int h2l_eq_xy(int field, const void* y_host, const void* y_dev, int k, void* out,
                         void* stream) {
  if (!field_built(field, false) || k < 0 || k > MAX_EQ_VARS || (k > 0 && !y_host && !y_dev))
    return (int)cudaErrorInvalidValue;
  EqParams p;
  if (y_host) memcpy(p.y, y_host, sizeof(Fe) * k);
  p.y_dev = y_host ? nullptr : (const uint32_t*)y_dev;
  p.k = k;
  const long long blocks = ((1ll << k) + 255) / 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0) eq_xy_kernel<Fr><<<(unsigned)blocks, 256, 0, s>>>(p, (uint32_t*)out);
  else eq_xy_kernel<Fq><<<(unsigned)blocks, 256, 0, s>>>(p, (uint32_t*)out);
  return (int)cudaGetLastError();
}
#endif
#endif
