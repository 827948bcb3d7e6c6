// Elementwise Montgomery product over Fr in the two layouts of the TPU
// layout microbench (scripts/tpu_layout_bench.py):
//   K6 h2l_mont_mul_limbs_first: the port of make_mul_a (:88, pallas_call
//      :97), limbs-first (8, n);
//   K7 h2l_mont_mul_tiled: the port of make_mul_b (:108, pallas_call :120),
//      (8, n/128, 128) in (8, 8, 128) tiles of 1024 elements.
// Limb j of element e sits at a[j * n + e] in both: on Hopper the two TPU
// layouts are the same bytes, and the kernels differ only in how threads
// map onto them. The product is field.cuh's fe_mul, as in K4.
//
// Bound: bytes. Each element reads 64 bytes and writes 32 for 256 32-bit
// multiply-adds, far under the card's integer rate. K6 gives each thread
// one element, so each limb row is one coalesced warp load. K7 stages each
// 1024-element tile of a and b in shared memory with coalesced loads,
// computes from there and writes the tile back: the Hopper analogue of the
// TPU's VMEM block. Both mask the ragged edge.
#include "field.cuh"

namespace {

constexpr int kTile = 1024;         // elements per K7 block (the TPU's TILE)
constexpr int kTileThreads = 256;   // 4 elements per thread
constexpr int kTileSmem = 2 * 8 * kTile * 4;  // a and b tiles, 64 KiB

__global__ void mont_mul_limbs_first_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                            long long n) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fe x, y;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x.v[j] = a[j * n + e];
    y.v[j] = b[j * n + e];
  }
  Fe r = fe_mul<Fr>(x, y);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j * n + e] = r.v[j];
}

__global__ void mont_mul_tiled_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                      long long n) {
  extern __shared__ uint32_t smem[];
  uint32_t* sa = smem;             // [8][kTile]
  uint32_t* sb = smem + 8 * kTile;  // [8][kTile]
  const long long base = (long long)blockIdx.x * kTile;
  const int len = (int)min((long long)kTile, n - base);
  for (int j = 0; j < 8; ++j) {
    for (int t = threadIdx.x; t < len; t += kTileThreads) {
      sa[j * kTile + t] = a[j * n + base + t];
      sb[j * kTile + t] = b[j * n + base + t];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < len; t += kTileThreads) {
    Fe x, y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x.v[j] = sa[j * kTile + t];
      y.v[j] = sb[j * kTile + t];
    }
    Fe r = fe_mul<Fr>(x, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) sa[j * kTile + t] = r.v[j];
  }
  __syncthreads();
  for (int j = 0; j < 8; ++j) {
    for (int t = threadIdx.x; t < len; t += kTileThreads) out[j * n + base + t] = sa[j * kTile + t];
  }
}

}  // namespace

extern "C" int h2l_mont_mul_limbs_first(const void* a, const void* b, void* out, long long n,
                                        void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  mont_mul_limbs_first_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int h2l_mont_mul_tiled(const void* a, const void* b, void* out, long long n,
                                  void* stream) {
  if (n <= 0) return 0;
  // the 64 KiB opt-in, once per process and card (an attribute of the current device)
  static unsigned long long smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(smem_set >> dev & 1)) {
    err = cudaFuncSetAttribute(mont_mul_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set |= 1ull << dev;
  }
  long long blocks = (n + kTile - 1) / kTile;
  mont_mul_tiled_kernel<<<blocks, kTileThreads, kTileSmem, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
