// Round message of the EvaluationsProver, the port of make_sumcheck_round
// (halo2_lasso_tpu/ops/pallas_field.py:376; kernel :412, eval_expr :463,
// round_fn :523, pallas_call :560).
//
//   msg[t-1] = sum_i expr(leaf values at X_0 = t), t = 1..degree,
//   leaf value at t = hi + (t-1)(hi - lo), (lo, hi) = (L[2i], L[2i+1]).
//
// The TPU kernel is generated per expression. This is ONE compiled kernel
// that interprets the expression: the host lowers it to a short postfix
// program (piop/sum_check.py, lower_expression) and each thread runs the
// program on a small stack for its pairs. Sums are exact: field adds per
// thread, then per block through shared memory, then a second one-block
// pass over the block partials. Nothing is compiled per expression or shape.
// Bound: bytes for shallow expressions (every leaf table is read once);
// the interpreter's dispatch and local-memory stack cost more than that.
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
#define THREADS 256

__device__ Fe leaf_at(const uint32_t* tab, long long i, int t) {
  Fe lo = fe_load(tab, 2 * i);
  Fe hi = fe_load(tab, 2 * i + 1);
  Fe step = fe_sub<Fr>(hi, lo);
  Fe v = hi;
  for (int s = 1; s < t; ++s) v = fe_add<Fr>(v, step);
  return v;
}

__device__ void block_sum_store(Fe* buf, Fe v, uint32_t* dst) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] = fe_add<Fr>(buf[threadIdx.x], buf[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) fe_store(dst, 0, buf[0]);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
round_kernel(const uint32_t* const* leaves, long long h, const int* prog, int nprog,
             const uint32_t* consts, const uint32_t* chals, int degree, uint32_t* partials) {
  __shared__ Fe buf[THREADS];
  Fe acc[MAX_DEGREE];
  for (int t = 0; t < degree; ++t) acc[t] = fe_zero();
  long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < h; i += stride) {
    for (int t = 1; t <= degree; ++t) {
      Fe st[MAX_STACK];
      int sp = 0;
      for (int pc = 0; pc < nprog; ++pc) {
        int op = prog[2 * pc], arg = prog[2 * pc + 1];
        switch (op) {
          case OP_LEAF: st[sp++] = leaf_at(leaves[arg], i, t); break;
          case OP_CONST: st[sp++] = fe_load(consts, arg); break;
          case OP_CHAL: st[sp++] = fe_load(chals, arg); break;
          case OP_NEG: st[sp - 1] = fe_neg<Fr>(st[sp - 1]); break;
          case OP_ADD: --sp; st[sp - 1] = fe_add<Fr>(st[sp - 1], st[sp]); break;
          default: {  // OP_MUL, OP_SCALED
            Fe rhs = op == OP_MUL ? st[--sp] : fe_load(consts, arg);
            st[sp - 1] = fe_mul<Fr>(st[sp - 1], rhs);
          }
        }
      }
      acc[t - 1] = fe_add<Fr>(acc[t - 1], st[0]);
    }
  }
  for (int t = 0; t < degree; ++t)
    block_sum_store(buf, acc[t], partials + ((long long)blockIdx.x * degree + t) * 8);
}

__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const uint32_t* partials, int nblocks, int degree, uint32_t* out) {
  __shared__ Fe buf[THREADS];
  for (int t = 0; t < degree; ++t) {
    Fe acc = fe_zero();
    for (int b = threadIdx.x; b < nblocks; b += THREADS)
      acc = fe_add<Fr>(acc, fe_load(partials, (long long)b * degree + t));
    block_sum_store(buf, acc, out + (long long)t * 8);
  }
}

extern "C" int h2l_round_max_stack() { return MAX_STACK; }

// partials: nblocks * degree field elements of scratch; out: degree elements.
extern "C" int h2l_sumcheck_round(const void* leaves, long long h, const void* prog, int nprog,
                                  const void* consts, const void* chals, int degree,
                                  void* partials, int nblocks, void* out, void* stream) {
  if (degree < 1 || degree > MAX_DEGREE || nblocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  round_kernel<<<nblocks, THREADS, 0, s>>>((const uint32_t* const*)leaves, h, (const int*)prog,
                                           nprog, (const uint32_t*)consts,
                                           (const uint32_t*)chals, degree, (uint32_t*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials_kernel<<<1, THREADS, 0, s>>>((const uint32_t*)partials, nblocks, degree,
                                            (uint32_t*)out);
  return (int)cudaGetLastError();
}
