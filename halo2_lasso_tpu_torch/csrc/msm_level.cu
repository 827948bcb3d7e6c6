// One halving level of the Pippenger MSM in one launch: the port of the TPU's
// complete Jacobian add (_ec_add_kernel, halo2_lasso_tpu/ops/pallas_ec.py:144)
// together with the level step around it (_level_step,
// halo2_lasso_tpu/ops/msm_jacobian.py:168). Four instances, selected by
// `field` as in csrc/ec_add.cu: BN254 G1 over Fq and grumpkin over Fr here,
// Pallas and Vesta in csrc/msm_level_pasta.cu (on
// the TPU grumpkin's level step adds through jac_add_lf, :90).
//
// The slots of each window are sorted by digit, descending. One thread takes
// one pair lane (w, i), slots 2i and 2i+1 of window w (A and B):
//   da == db: the survivor is A + B;
//   da != db: A ends the run of digit da, so bucket[w, da] += A, written back
//             in place, and B survives.
// That is one complete add per lane, with its operands selected. The bucket
// scatter is conflict-free: the slots of a window stay sorted at every
// level, so the slots of digit da are contiguous, and only the pair that
// holds the last of them can see da != db. No bucket is touched by two lanes
// of a level (tests/test_torch_msm.py holds this on the data), and only
// flushed buckets are touched at all.
//
// At the first level the slots are read through the sort's permutation
// (`order`) straight from the point arrays, and a digit-0 slot becomes the
// identity (z = 0): the sorted coordinate arrays are never written. With
// pairs == 0 the launch is the final flush: lane w adds window w's last
// survivor into its bucket.
//
// Bound: operations. A generic lane needs 16 Montgomery products
// (add-2007-bl); a lane whose bucket is still the identity needs none. The
// design keeps the card on those products: no host sync and no torch op
// between the levels (the TPU version ran about 25 launches and four
// host syncs a level, and added the whole bucket array at every level),
// the doubling only under a warp vote (csrc/ec.cuh), 16-byte loads.
//
// Launch choices, measured on an NVIDIA H100 80GB HBM3 at 700 W over a
// 2^16 MSM's 17 launches (CUDA events, two calls): 128 threads a block
// 1.110 / 1.196 ms, 64 threads 1.207 / 1.718, 256 threads 1.373 / 2.134;
// the Fq product inlined 1.697 / 2.008 ms at 128 (170-176 registers), so it
// stays out of line (140-146 registers, no spills; the 192-byte stack frame
// is the calls' own); a register cap of 128 (4 blocks an SM) 1.458 ms and
// of 102 (5 blocks) 2.201 ms, so there is none. The launch takes 128
// threads a block.
#include "ec.cuh"

// One pair lane. Also compiled for the host (FIELD_HOST_TEST), where the
// CPU tests run every lane of a level in order against the plain version.
template <class P>
FD void msm_level_lane(const uint32_t* sx, const uint32_t* sy, const uint32_t* sz,
                       const int32_t* dig, const long long* order, long long pairs, int B,
                       long long lane, uint32_t* bx, uint32_t* by, uint32_t* bz, uint32_t* ox,
                       uint32_t* oy, uint32_t* oz, int32_t* odig) {
  long long w, ia, ib;
  int da, db;
  if (pairs == 0) {  // final flush: one survivor per window
    w = ia = ib = lane;
    da = dig[lane];
    db = -1;
  } else {
    w = lane / pairs;
    long long s = 2 * lane;  // = w * 2 * pairs + 2 * i
    if (order != nullptr) {
      long long n = 2 * pairs;
      ia = order[s];
      ib = order[s + 1];
      da = dig[w * n + ia];
      db = dig[w * n + ib];
    } else {
      ia = s;
      ib = s + 1;
      da = dig[ia];
      db = dig[ib];
    }
  }
  Fe ax = fe_load16(sx, ia), ay = fe_load16(sy, ia), az = fe_load16(sz, ia);
  Fe bxv = fe_load16(sx, ib), byv = fe_load16(sy, ib), bzv = fe_load16(sz, ib);
  if (order != nullptr) {
    if (da == 0) az = fe_zero();
    if (db == 0) bzv = fe_zero();
  }
  const bool same = da == db;
  const long long slot = w * B + da;
  Fe px, py, pz;
  if (same) {
    px = ax, py = ay, pz = az;
  } else {
    px = fe_load16(bx, slot), py = fe_load16(by, slot), pz = fe_load16(bz, slot);
  }
  Fe rx, ry, rz;
  ec_add_lane<P>(px, py, pz, same ? bxv : ax, same ? byv : ay, same ? bzv : az, rx, ry, rz);
  if (!same) {
    fe_store16(bx, slot, rx);
    fe_store16(by, slot, ry);
    fe_store16(bz, slot, rz);
  }
  if (pairs != 0) {
    fe_store16(ox, lane, same ? rx : bxv);
    fe_store16(oy, lane, same ? ry : byv);
    fe_store16(oz, lane, same ? rz : bzv);
    odig[lane] = db;
  }
}

#ifndef FIELD_HOST_TEST
#define LEVEL_THREADS 128

template <class P>
__global__ void __launch_bounds__(LEVEL_THREADS)
msm_level_kernel(const uint32_t* sx, const uint32_t* sy, const uint32_t* sz, const int32_t* dig,
                 const long long* order, long long pairs, int B, long long lanes, uint32_t* bx,
                 uint32_t* by, uint32_t* bz, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                 int32_t* odig) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  msm_level_lane<P>(sx, sy, sz, dig, order, pairs, B, lane, bx, by, bz, ox, oy, oz, odig);
}

template <class P>
int level_launch(const void* sx, const void* sy, const void* sz, const void* dig, const void* order,
                 long long pairs, int B, long long lanes, void* bx, void* by, void* bz, void* ox, void* oy,
                 void* oz, void* odig, cudaStream_t s) {
  const long long blocks = (lanes + LEVEL_THREADS - 1) / LEVEL_THREADS;
  msm_level_kernel<P><<<blocks, LEVEL_THREADS, 0, s>>>(
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz, (const int32_t*)dig,
      (const long long*)order, pairs, B, lanes, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int32_t*)odig);
  return (int)cudaGetLastError();
}

// The Pallas and Vesta launcher, built in csrc/msm_level_pasta.cu.
int level_launch_pasta(int field, const void* sx, const void* sy, const void* sz, const void* dig,
                       const void* order, long long pairs, int B, long long lanes, void* bx, void* by,
                       void* bz, void* ox, void* oy, void* oz, void* odig, cudaStream_t s);

#ifndef H2L_PASTA_SOURCE
// sx/sy/sz, dig: the level's slots (W * 2 * pairs rows and digits), or at the
// first level (order != null) the n points and the (W, n) unsorted digits;
// pairs: pairs per window, 0 for the final flush (W slots); bx/by/bz: the
// W * B buckets, updated in place; ox/oy/oz, odig: W * pairs survivors;
// field: the coordinate field's kernel_id (0 = Fr, grumpkin; 1 = Fq, BN254;
// 2 = Pallas' base field, the Pallas curve; 3 = Vesta's, the Vesta curve).
extern "C" int h2l_msm_level(int field, const void* sx, const void* sy, const void* sz, const void* dig,
                             const void* order, long long pairs, int W, int B, void* bx,
                             void* by, void* bz, void* ox, void* oy, void* oz, void* odig,
                             void* stream) {
  if (!field_built(field, true)) return (int)cudaErrorInvalidValue;
  long long lanes = pairs == 0 ? (long long)W : (long long)W * pairs;
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return level_launch<Fr>(sx, sy, sz, dig, order, pairs, B, lanes, bx, by, bz, ox, oy, oz, odig, s);
    case 1: return level_launch<Fq>(sx, sy, sz, dig, order, pairs, B, lanes, bx, by, bz, ox, oy, oz, odig, s);
    default:
      return level_launch_pasta(field, sx, sy, sz, dig, order, pairs, B, lanes, bx, by, bz, ox, oy, oz, odig, s);
  }
}
#endif
#endif
