// The K3 family's kernels over whole batches, each in four instances
// selected by `field`, the kernel_id of the coordinate field: 1 = BN254 G1
// over Fq (the TPU kernel's curve) and 0 = grumpkin over Fr here, 2 = Pallas
// and 3 = Vesta in csrc/ec_pasta.cu. The other curves' instances are the
// port of what the TPU computes for them through msm_jacobian.jac_add_lf (a
// complete add built from make_mont_mul launches,
// halo2_lasso_tpu/ops/msm_jacobian.py:90).
// The MSM's halving levels run in csrc/msm_level.cu. The device functions
// above the kernels also compile for the host (FIELD_HOST_TEST), where
// tests/test_torch_csrc.py runs them lane by lane against the plain versions.
//
// 1. ec_add_kernel: complete Jacobian addition, lane by lane, the port of
//    _ec_add_kernel (halo2_lasso_tpu/ops/pallas_ec.py:144; math
//    _ec_add_body :85, launcher _ec_add_call :154, pallas_call :167).
//    add-2007-bl for the generic lanes; dbl-2009-l for P = Q, computed only
//    when some lane of the warp needs it (csrc/ec.cuh); identity (x = y =
//    R mod p, z = 0) for P = -Q; pass-through when either input is the
//    identity. The choice per lane is a select, as in the TPU kernel. It
//    serves the IPA open's fold add (pcs/ipa.py) and the fixed-base MSM's
//    window tree (set-up). Bound: operations (16 Montgomery products a
//    generic lane against 288 bytes moved). The product is kept out of line
//    so the kernel bodies stay small enough for a build of seconds.
//
// 2. ec_ladder_kernel: the scalar ladder k * P, one launch a scaling, the
//    port of halo2_lasso_tpu/ops/ec.py:216 scalar_mul_bits (on the TPU 254
//    steps of two _ec_add_kernel launches each, as the port ran it before).
//    One thread walks one lane's bits from the top with its accumulator in
//    registers: a dedicated doubling (dbl-2009-l, 7 products, where the
//    complete add of the accumulator to itself computed 16 before its vote)
//    and, where the bit is set, the complete add of the point. A scalar
//    shared by every lane comes by value, so a ladder copies nothing to the
//    card and its branch on the bit is uniform; per-lane scalars are read
//    from the card and the add is kept by a select. Bound: operations, 7
//    products a step past the top bit and 16 a further set bit, against 192
//    bytes a lane. A ladder over 1 or 2 lanes is one thread's chain of some
//    3,800 dependent products: latency, which no launch shape removes.
//
// 3. plane_tree_kernel: the MSM's bit-plane bucket reduction, one launch
//    an MSM, the port of halo2_lasso_tpu/ops/msm_jacobian.py:299
//    _bitplane_expand_fn with its halving tree (:318 _tree_level_fn) over
//    _ec_add_kernel. The plane sum U_{j,w} adds the 2^(c-1) buckets (w, v)
//    whose bit j of v is set, read in place, in the nesting the old
//    gathered tree gave them once its masked leaves are dropped: a halving
//    over the other c - 1 bits of v, highest first, the lower half the
//    first operand. The old tree gathered 2^c c W rows and ran c launches
//    of c W 2^(c-1) ... c W lanes, half of whose leaves were masked
//    identities; this one reads each kept bucket once and adds c W
//    (2^(c-1) - 1) times. Bound: operations (16 products an add against
//    the buckets read once). One block takes one plane (c = 10) or several
//    (small c); its threads add the first level from the buckets into
//    shared memory, and a halving in shared memory finishes each plane.
#include "ec.cuh"

// A block of the ladder: 32, 64 and 128 measured alike at 2^15 lanes on an
// NVIDIA H100 80GB HBM3 at 700 W (4.40-4.42 ms by CUDA events). A block of
// the plane tree: 128 was the fastest of 32 to 256 at c = 10 and c = 4 on
// the same card. At c = 10 each thread takes two positions of the first
// level; at c = 2, 3 and 4 a block takes several planes.
#define LADDER_THREADS 128
#define TREE_MAX_C 10
#define TREE_THREADS 128

// One lane of the ladder: k * (px, py, pz) for the scalar k (little-endian
// 32-bit words, its low nbits bits read), from the identity (R, R, 0). Bit
// for bit the old loop of two complete adds a step (csrc/ec.cuh
// ec_dbl_lane). Where no lane of the warp has the bit set, the add is
// skipped; else every lane computes it and keeps it where its bit is set.
template <class P>
FD void ec_ladder_lane(const Fe& px, const Fe& py, const Fe& pz, const uint32_t* k, int nbits, Fe& ax,
                       Fe& ay, Fe& az) {
  ax = ay = fe_one<P>();
  az = fe_zero();
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {
    ec_dbl_lane<P>(ax, ay, az);
    const bool bit = (k[i >> 5] >> (i & 31)) & 1;
    if (H2L_WARP_ANY(bit)) {
      Fe sx, sy, sz;
      ec_add_lane<P>(ax, ay, az, px, py, pz, sx, sy, sz);
      ax = fe_sel(bit, sx, ax);
      ay = fe_sel(bit, sy, ay);
      az = fe_sel(bit, sz, az);
    }
  }
}

// The bucket row that position k of plane (j, w) reads: bucket v of window
// w, v the c-bit number with bit j set and its other c - 1 bits those of k,
// in order.
FD long long tree_row(int c, int j, int w, long long k) {
  const long long v = ((k >> j) << (j + 1)) | (1ll << j) | (k & ((1ll << j) - 1));
  return ((long long)w << c) + v;
}

// Shared slots of partial sums, limb-major (word l of coordinate d of slot
// s at (8 d + l) * cap + s), so that neighbouring threads touch
// neighbouring banks.
struct TreeSlots {
  uint32_t* base;
  int cap;
  FD void put(int s, const Fe& x, const Fe& y, const Fe& z) const {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      base[l * cap + s] = x.v[l];
      base[(8 + l) * cap + s] = y.v[l];
      base[(16 + l) * cap + s] = z.v[l];
    }
  }
  FD void get(int s, Fe& x, Fe& y, Fe& z) const {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      x.v[l] = base[l * cap + s];
      y.v[l] = base[(8 + l) * cap + s];
      z.v[l] = base[(16 + l) * cap + s];
    }
  }
};

// The tree's first level for plane (j, w): positions k and k + half (half
// = 2^(c-2)) of its kept buckets added into slot s.
template <class P>
FD void tree_first(const uint32_t* bx, const uint32_t* by, const uint32_t* bz, int c, int j, int w,
                   long long k, int half, TreeSlots S, int s) {
  const long long ra = tree_row(c, j, w, k), rb = tree_row(c, j, w, k + half);
  Fe x, y, z;
  ec_add_lane<P>(fe_load16(bx, ra), fe_load16(by, ra), fe_load16(bz, ra), fe_load16(bx, rb),
                 fe_load16(by, rb), fe_load16(bz, rb), x, y, z);
  S.put(s, x, y, z);
}

// A later level: slot a = slot a + slot b.
template <class P>
FD void tree_step(TreeSlots S, int a, int b) {
  Fe x1, y1, z1, x2, y2, z2, x, y, z;
  S.get(a, x1, y1, z1);
  S.get(b, x2, y2, z2);
  ec_add_lane<P>(x1, y1, z1, x2, y2, z2, x, y, z);
  S.put(a, x, y, z);
}

#ifndef FIELD_HOST_TEST
template <class P>
__global__ void ec_add_kernel(const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                              const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                              uint32_t* x3, uint32_t* y3, uint32_t* z3, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe ox, oy, oz;
  ec_add_lane<P>(fe_load(x1, i), fe_load(y1, i), fe_load(z1, i), fe_load(x2, i), fe_load(y2, i),
              fe_load(z2, i), ox, oy, oz);
  fe_store(x3, i, ox);
  fe_store(y3, i, oy);
  fe_store(z3, i, oz);
}

// A scalar shared by every lane, by value.
struct LadderScalar {
  uint32_t w[8];
};

template <class P>
__global__ void __launch_bounds__(LADDER_THREADS)
ec_ladder_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz, const uint32_t* lane_k,
                 const __grid_constant__ LadderScalar shared_k, int nbits, uint32_t* ox, uint32_t* oy,
                 uint32_t* oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* k = lane_k != nullptr ? lane_k + 8 * i : shared_k.w;
  Fe ax, ay, az;
  ec_ladder_lane<P>(fe_load16(px, i), fe_load16(py, i), fe_load16(pz, i), k, nbits, ax, ay, az);
  fe_store16(ox, i, ax);
  fe_store16(oy, i, ay);
  fe_store16(oz, i, az);
}

// tpp threads a plane, blockDim.x / tpp planes a block; the block's shared
// memory holds 2^(c-2) slots a plane.
template <class P>
__global__ void __launch_bounds__(TREE_THREADS)
plane_tree_kernel(const uint32_t* bx, const uint32_t* by, const uint32_t* bz, int c, int W, int tpp,
                  uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  extern __shared__ uint32_t tree_smem[];
  const int half = 1 << (c - 2), ppb = blockDim.x / tpp;
  const int pl = threadIdx.x / tpp, t = threadIdx.x % tpp, s0 = pl * half;
  const long long plane = (long long)blockIdx.x * ppb + pl;
  const bool live = plane < (long long)c * W;
  const int j = live ? (int)(plane / W) : 0, w = live ? (int)(plane % W) : 0;
  const TreeSlots S{tree_smem, ppb * half};
  if (live)
    for (int k = t; k < half; k += tpp) tree_first<P>(bx, by, bz, c, j, w, k, half, S, s0 + k);
  __syncthreads();
  for (int h = half / 2; h >= 1; h /= 2) {  // uniform across the block
    if (live)
      for (int k = t; k < h; k += tpp) tree_step<P>(S, s0 + k, s0 + k + h);
    __syncthreads();
  }
  if (live && t == 0) {
    Fe x, y, z;
    S.get(s0, x, y, z);
    fe_store16(ox, plane, x);
    fe_store16(oy, plane, y);
    fe_store16(oz, plane, z);
  }
}

template <class P>
int add_launch(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2, const void* z2,
               void* x3, void* y3, void* z3, long long n, cudaStream_t s) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  ec_add_kernel<P><<<blocks, threads, 0, s>>>((const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
                                              (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
                                              (uint32_t*)x3, (uint32_t*)y3, (uint32_t*)z3, n);
  return (int)cudaGetLastError();
}

template <class P>
int ladder_launch(const void* px, const void* py, const void* pz, const void* lane_k, const LadderScalar& sk,
                  int nbits, void* ox, void* oy, void* oz, long long n, cudaStream_t s) {
  const long long blocks = (n + LADDER_THREADS - 1) / LADDER_THREADS;
  ec_ladder_kernel<P><<<blocks, LADDER_THREADS, 0, s>>>((const uint32_t*)px, (const uint32_t*)py,
                                                        (const uint32_t*)pz, (const uint32_t*)lane_k, sk, nbits,
                                                        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

template <class P>
int tree_launch(const void* bx, const void* by, const void* bz, int c, int W, void* ox, void* oy, void* oz,
                cudaStream_t s) {
  const int half = 1 << (c - 2), tpp = half < TREE_THREADS ? half : TREE_THREADS, ppb = TREE_THREADS / tpp;
  const long long planes = (long long)c * W, blocks = (planes + ppb - 1) / ppb;
  const size_t smem = (size_t)ppb * half * 24 * sizeof(uint32_t);
  plane_tree_kernel<P><<<blocks, TREE_THREADS, smem, s>>>((const uint32_t*)bx, (const uint32_t*)by,
                                                          (const uint32_t*)bz, c, W, tpp, (uint32_t*)ox,
                                                          (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

// The Pallas and Vesta launchers, built in csrc/ec_pasta.cu.
int add_launch_pasta(int field, const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                     const void* z2, void* x3, void* y3, void* z3, long long n, cudaStream_t s);
int ladder_launch_pasta(int field, const void* px, const void* py, const void* pz, const void* lane_k,
                        const LadderScalar& sk, int nbits, void* ox, void* oy, void* oz, long long n,
                        cudaStream_t s);
int tree_launch_pasta(int field, const void* bx, const void* by, const void* bz, int c, int W, void* ox,
                      void* oy, void* oz, cudaStream_t s);

#ifndef H2L_PASTA_SOURCE
// field: the kernel_id of the coordinate field (0 = Fr, grumpkin; 1 = Fq,
// BN254 G1; 2 = Pallas' base field, the Pallas curve; 3 = Vesta's, the
// Vesta curve).
extern "C" int h2l_ec_add(int field, const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* x3, void* y3, void* z3,
                          long long n, void* stream) {
  if (!field_built(field, true)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return add_launch<Fr>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, s);
    case 1: return add_launch<Fq>(x1, y1, z1, x2, y2, z2, x3, y3, z3, n, s);
    default: return add_launch_pasta(field, x1, y1, z1, x2, y2, z2, x3, y3, z3, n, s);
  }
}

// px/py/pz, ox/oy/oz: device (n, 8) rows; lane_k: device (n, 8) canonical
// scalars, one a lane, or null for the scalar k (host array of 8 words)
// shared by every lane; nbits <= 256 bits of it read, from the top.
extern "C" int h2l_ec_ladder(int field, const void* px, const void* py, const void* pz,
                             const void* lane_k, const void* k, int nbits, void* ox, void* oy,
                             void* oz, long long n, void* stream) {
  if (!field_built(field, true) || nbits < 0 || nbits > 256) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  LadderScalar sk;
  for (int i = 0; i < 8; ++i) sk.w[i] = k != nullptr ? ((const uint32_t*)k)[i] : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return ladder_launch<Fr>(px, py, pz, lane_k, sk, nbits, ox, oy, oz, n, s);
    case 1: return ladder_launch<Fq>(px, py, pz, lane_k, sk, nbits, ox, oy, oz, n, s);
    default: return ladder_launch_pasta(field, px, py, pz, lane_k, sk, nbits, ox, oy, oz, n, s);
  }
}

// bx/by/bz: the W * 2^c bucket rows (window-major, more rows may follow);
// ox/oy/oz: the c * W plane sums, plane-major ([j * W + w]).
extern "C" int h2l_plane_tree(int field, const void* bx, const void* by, const void* bz, int c, int W,
                              void* ox, void* oy, void* oz, void* stream) {
  if (!field_built(field, true) || c < 2 || c > TREE_MAX_C || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return tree_launch<Fr>(bx, by, bz, c, W, ox, oy, oz, s);
    case 1: return tree_launch<Fq>(bx, by, bz, c, W, ox, oy, oz, s);
    default: return tree_launch_pasta(field, bx, by, bz, c, W, ox, oy, oz, s);
  }
}
#endif
#endif
