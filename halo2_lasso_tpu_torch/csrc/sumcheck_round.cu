// Round message of the EvaluationsProver, the port of make_sumcheck_round
// (halo2_lasso_tpu/ops/pallas_field.py:376; kernel :412, eval_expr :463,
// round_fn :523, pallas_call :560). make_sumcheck_round takes any
// FieldSpec; this kernel has an Fr and an Fq instance (a template over the
// field, selected by `field`, the kernel_id): the grumpkin-backed SNARK's
// sumchecks run over BN254 Fq.
//
//   msg[t-1] = sum_i expr(leaf values at X_0 = t), t = t0+1..t0+D,
//   leaf value at t = hi + (t-1)(hi - lo), (lo, hi) = (L[2i], L[2i+1]).
//
// A launch evaluates D <= MAX_DEGREE points from t0 + 1 (t0 = 0 for a
// round of degree at most 8). A round of degree d > 8 is ceil(d / 8) launches,
// t0 = 0, 8, 16, ... (piop/sum_check.py plan_round), as the JAX package's
// message is the evaluations at 1..d whatever d is
// (halo2_lasso_tpu/piop/sum_check.py:427-458): a leaf's first value is
// hi + t0 (hi - lo), one more product a leaf, and constants and
// challenges do not depend on t. MAX_DEGREE is not raised: the stack grows
// with D, and at D = 16 it no longer fits in shared memory at useful
// thread counts.
//
// The TPU kernel is generated per expression. This is ONE compiled kernel
// that interprets the expression: the host lowers it to a short postfix
// program (piop/sum_check.py, lower_expression), and each thread runs the
// program on a small stack for its pairs. Nothing is compiled per
// expression or shape.
//
// Bound: operations at the heavy shapes (the zero check's program does 27
// Montgomery products a point, 3 points a pair, against 32 bytes read a
// leaf table element); bytes for the two-leaf Lasso primary sumcheck. What
// the design does about it:
//   - one pass of the program per pair for all `degree` points: a leaf pair
//     is loaded once (16-byte loads) and extended to t = 1..degree by adds,
//     and every stack slot holds `degree` values;
//   - the stack lives in shared memory, laid out [slot][t][limb][thread]
//     (conflict-free), sized at launch from the program's depth and the
//     degree; the accumulators sit in registers (a template over the
//     degree). No dynamically indexed array is left in local memory;
//   - the leaf pointers, the program and its constants travel by value in
//     the kernel's parameters (the constant bank, where the uniform program
//     is a broadcast read), so no host-to-device copy precedes the launch;
//   - the sum across blocks is done in the same launch: the last block to
//     finish (an atomic ticket) adds the block partials. Field addition mod
//     p is exact, so the order does not change the result;
//   - threads a block from the caller: 128 (piop/sum_check.py). One thread
//     a pair gives the zero check's first round (2^15 pairs) 1024 warps,
//     about 8 an SM, whatever the block size; at that shape 32 / 64 / 128 /
//     256 threads took 0.184 / 0.161 / 0.155 / 0.157 ms (degree 5, 23
//     leaves: 0.510 / 0.468 / 0.458 / 0.458 ms), CUDA events on an
//     NVIDIA H100 80GB HBM3 at 700 W. ptxas:
//     64-80 registers at degrees 1-3, 128 at 4-8, no spills, no stack.
#include <cstring>

#include "field.cuh"

#define OP_LEAF 0
#define OP_CONST 1
#define OP_CHAL 2
#define OP_NEG 3
#define OP_ADD 4
#define OP_MUL 5
#define OP_SCALED 6

#define MAX_STACK 8
#define MAX_DEGREE 8
// 128 leaves and 640 ops take a GKR layer batching 63 pure grand products
// (2 leaves and 10 ops each, and the eq table): the 32-bit ARX chain's
// memory check batches 36.
#define MAX_LEAVES 128
#define MAX_OPS 640
#define MAX_CONSTS 32

// 3.4 KB, under the 4 KB of kernel parameters every CUDA version takes.
struct RoundParams {
  const uint32_t* leaves[MAX_LEAVES];
  Fe consts[MAX_CONSTS];
  unsigned short ops[MAX_OPS];  // op | arg << 3
  const uint32_t* chals;
  long long h;
  int nops;
  int t0;    // the launch's points are t0 + 1 .. t0 + D
  Fe t0_m;   // t0 in Montgomery form
};
static_assert(sizeof(RoundParams) <= 4096, "kernel parameters above 4 KB");

// One thread's stack: value t of slot s, limb j at base[((s * D + t) * 8 + j) * T].
template <int D>
struct Stack {
  uint32_t* base;
  int T;
  FD Fe get(int s, int t) const {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.v[j] = base[((s * D + t) * 8 + j) * T];
    return r;
  }
  FD void put(int s, int t, const Fe& a) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) base[((s * D + t) * 8 + j) * T] = a.v[j];
  }
};

// The program on pair i at t = t0+1..t0+D; the values end in slot 0. Also
// compiled for the host (FIELD_HOST_TEST), where the CPU tests hold it
// against the plain version.
template <class P, int D>
FD void eval_pair(const RoundParams& p, long long i, const Stack<D>& st) {
  int sp = 0;
  for (int pc = 0; pc < p.nops; ++pc) {
    const int code = p.ops[pc];
    const int op = code & 7, arg = code >> 3;
    if (op == OP_LEAF) {
      const uint32_t* tab = p.leaves[arg];
      const Fe lo = fe_load16(tab, 2 * i);
      Fe v = fe_load16(tab, 2 * i + 1);
      if (D > 1 || p.t0) {
        const Fe step = fe_sub<P>(v, lo);
        if (p.t0) v = fe_add<P>(v, fe_mul<P>(step, p.t0_m));
        st.put(sp, 0, v);
#pragma unroll 1
        for (int t = 1; t < D; ++t) {
          v = fe_add<P>(v, step);
          st.put(sp, t, v);
        }
      } else {
        st.put(sp, 0, v);
      }
      ++sp;
    } else if (op == OP_CONST || op == OP_CHAL) {
      const Fe c = op == OP_CONST ? p.consts[arg] : fe_load(p.chals, arg);
#pragma unroll 1
      for (int t = 0; t < D; ++t) st.put(sp, t, c);
      ++sp;
    } else if (op == OP_NEG) {
#pragma unroll 1
      for (int t = 0; t < D; ++t) st.put(sp - 1, t, fe_neg<P>(st.get(sp - 1, t)));
    } else if (op == OP_ADD) {
      --sp;
#pragma unroll 1
      for (int t = 0; t < D; ++t) st.put(sp - 1, t, fe_add<P>(st.get(sp - 1, t), st.get(sp, t)));
    } else {  // OP_MUL, OP_SCALED
      if (op == OP_MUL) --sp;
#pragma unroll 1
      for (int t = 0; t < D; ++t) {
        const Fe rhs = op == OP_MUL ? st.get(sp, t) : p.consts[arg];
        st.put(sp - 1, t, fe_mul<P>(st.get(sp - 1, t), rhs));
      }
    }
  }
}

#ifndef FIELD_HOST_TEST
// Sums slot 0 of every thread's stack into thread 0's (T a power of two).
template <class P, int D>
__device__ void block_sum(uint32_t* smem, const Stack<D>& st) {
  const int T = blockDim.x, tid = threadIdx.x;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const Stack<D> other{smem + tid + s, T};
#pragma unroll 1
      for (int t = 0; t < D; ++t) st.put(0, t, fe_add<P>(st.get(0, t), other.get(0, t)));
    }
    __syncthreads();
  }
}

template <class P, int D>
__global__ void __launch_bounds__(256)
round_kernel(const __grid_constant__ RoundParams p, uint32_t* partials, unsigned int* ticket,
             uint32_t* out) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const Stack<D> st{smem + tid, T};
  Fe acc[D];
#pragma unroll
  for (int t = 0; t < D; ++t) acc[t] = fe_zero();
  const long long stride = (long long)gridDim.x * T;
  for (long long i = (long long)blockIdx.x * T + tid; i < p.h; i += stride) {
    eval_pair<P, D>(p, i, st);
#pragma unroll
    for (int t = 0; t < D; ++t) acc[t] = fe_add<P>(acc[t], st.get(0, t));
  }
#pragma unroll
  for (int t = 0; t < D; ++t) st.put(0, t, acc[t]);
  block_sum<P, D>(smem, st);

  __shared__ bool last;
  if (tid == 0) {
    for (int t = 0; t < D; ++t) fe_store(partials, (long long)blockIdx.x * D + t, st.get(0, t));
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written and fenced
#pragma unroll
  for (int t = 0; t < D; ++t) acc[t] = fe_zero();
  for (int b = tid; b < gridDim.x; b += T) {
#pragma unroll
    for (int t = 0; t < D; ++t) acc[t] = fe_add<P>(acc[t], fe_load_cg(partials, (long long)b * D + t));
  }
#pragma unroll
  for (int t = 0; t < D; ++t) st.put(0, t, acc[t]);
  block_sum<P, D>(smem, st);
  if (tid == 0) {
    for (int t = 0; t < D; ++t) fe_store(out, t, st.get(0, t));
    *ticket = 0;  // ready for the next launch on this stream
  }
}

template <class P, int D>
int launch(const RoundParams& p, int stack, int threads, int blocks, void* partials, void* ticket,
           void* out, cudaStream_t s) {
  // the shared-memory opt-in, once per process, instance and card (an attribute of the current device)
  static unsigned long long optin = 0;
  int dev = 0;
  cudaError_t d = cudaGetDevice(&dev);
  if (d != cudaSuccess) return (int)d;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(optin >> dev & 1)) {
    int most = 0;
    cudaFuncAttributes attr;
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaError_t e = cudaFuncGetAttributes(&attr, round_kernel<P, D>);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(round_kernel<P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    optin |= 1ull << dev;
  }
  const size_t smem = (size_t)stack * D * 32 * threads;
  round_kernel<P, D><<<blocks, threads, smem, s>>>(p, (uint32_t*)partials, (unsigned int*)ticket,
                                                   (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <class P>
int launch_degree(const RoundParams& p, int degree, int stack, int threads, int blocks, void* partials,
                  void* ticket, void* out, cudaStream_t s) {
  switch (degree) {
    case 1: return launch<P, 1>(p, stack, threads, blocks, partials, ticket, out, s);
    case 2: return launch<P, 2>(p, stack, threads, blocks, partials, ticket, out, s);
    case 3: return launch<P, 3>(p, stack, threads, blocks, partials, ticket, out, s);
    case 4: return launch<P, 4>(p, stack, threads, blocks, partials, ticket, out, s);
    case 5: return launch<P, 5>(p, stack, threads, blocks, partials, ticket, out, s);
    case 6: return launch<P, 6>(p, stack, threads, blocks, partials, ticket, out, s);
    case 7: return launch<P, 7>(p, stack, threads, blocks, partials, ticket, out, s);
    default: return launch<P, 8>(p, stack, threads, blocks, partials, ticket, out, s);
  }
}

// field: 0 = Fr, 1 = Fq; leaves: host array of nleaves device pointers;
// ops: host array of nops (op | arg << 3); consts: host array of nconsts
// Montgomery elements (8 words each); chals: device (c, 8) or null; degree:
// the launch's points D, t0 + 1 .. t0 + D, t0_m: t0 in Montgomery form (a
// host element; null for t0 = 0); stack: the program's depth; threads: a
// power of two in 32..256; partials: blocks * degree elements of device
// scratch; ticket: a device counter at 0; out: degree elements.
extern "C" int h2l_sumcheck_round(int field, const void* leaves, int nleaves, const void* ops, int nops,
                                  const void* consts, int nconsts, const void* chals,
                                  long long h, int degree, int t0, const void* t0_m, int stack,
                                  int threads, int blocks, void* partials, void* ticket, void* out,
                                  void* stream) {
  if (!field_built(field, false) || degree < 1 || degree > MAX_DEGREE || t0 < 0 || (t0 > 0 && !t0_m) ||
      nleaves < 1 || nleaves > MAX_LEAVES || nops < 1 || nops > MAX_OPS || nconsts < 0 ||
      nconsts > MAX_CONSTS || stack < 1 || stack > MAX_STACK || threads < 32 || threads > 256 ||
      (threads & (threads - 1)) || blocks < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  RoundParams p;
  memcpy(p.leaves, leaves, sizeof(void*) * nleaves);
  memcpy(p.ops, ops, sizeof(unsigned short) * nops);
  memcpy(p.consts, consts, sizeof(Fe) * nconsts);
  p.chals = (const uint32_t*)chals;
  p.h = h;
  p.nops = nops;
  p.t0 = t0;
  if (t0 > 0) memcpy(p.t0_m.v, t0_m, sizeof(Fe));
  else memset(p.t0_m.v, 0, sizeof(Fe));
  cudaStream_t s = (cudaStream_t)stream;
  return field == 0 ? launch_degree<Fr>(p, degree, stack, threads, blocks, partials, ticket, out, s)
                    : launch_degree<Fq>(p, degree, stack, threads, blocks, partials, ticket, out, s);
}
#endif
