// Prime-field arithmetic shared by every kernel of the port, over BN254's
// two fields and the Pasta cycle's two (every modulus below 2^255).
//
// An element is 8 little-endian 32-bit limbs in Montgomery form with
// R = 2^256, always fully reduced into [0, p): the same 256-bit numbers the
// JAX package keeps as 16 limbs of 16 bits (halo2_lasso_tpu/ops/field.py:86).
// These device functions replace the in-kernel bodies of the TPU kernels:
// _mul_rows (ops/pallas_field.py:106), _add_rows (:161), _sub_rows (:180),
// _neg_rows (:199), and _is_zero_lanes / _sel (ops/pallas_ec.py:66-74).
//
// The TPU has no 32x32->64 multiply, so its limbs are 16 bits wide and its
// carries are lazy. Hopper multiplies 32x32->64 in hardware; the product
// here is plain CIOS Montgomery multiplication over 32-bit limbs.
#pragma once

#include <cstdint>

// FIELD_HOST_TEST compiles the device functions for the host (g++), so the
// CPU tests can hold them against the plain PyTorch versions.
#ifndef FIELD_HOST_TEST
#include <cuda_runtime.h>
#define FD __device__ __forceinline__
#define FD_NOINLINE __device__ __noinline__
#else
#define FD inline
#define FD_NOINLINE inline
#endif

struct Fe {
  uint32_t v[8];
};

// The fields, each a struct of its modulus p, INV = -p^-1 mod 2^32 and
// one = R mod p. A C entry point takes its instance's `field`, the
// FieldSpec's kernel_id: 0 = Fr, 1 = Fq, 2 = Pallas (Pallas' base field,
// Vesta's scalar field), 3 = Vesta (the other way round); an id that the
// entry point was not built for returns cudaErrorInvalidValue.

// Fr: scalar field of BN254.
struct Fr {
  static constexpr uint32_t INV = 0xefffffffu;  // -p^-1 mod 2^32
  FD static uint32_t p(int i) {
    const uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  FD static uint32_t one(int i) {  // R mod p
    const uint32_t O[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
};

// Fq: base field of BN254 (G1 coordinates).
struct Fq {
  static constexpr uint32_t INV = 0xe4866389u;
  FD static uint32_t p(int i) {
    const uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  FD static uint32_t one(int i) {
    const uint32_t O[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
};

// Pallas: p = 2^254 + 45560315531419706090280762371685220353 (255 bits),
// the base field of the Pallas curve and the scalar field of Vesta.
struct Pallas {
  static constexpr uint32_t INV = 0xffffffffu;
  FD static uint32_t p(int i) {
    const uint32_t P[8] = {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
                           0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return P[i];
  }
  FD static uint32_t one(int i) {
    const uint32_t O[8] = {0xfffffffdu, 0x34786d38u, 0xe41914adu, 0x992c350bu,
                           0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
    return O[i];
  }
};

// Vesta: p = 2^254 + 45560315531506369815346746415080538113 (255 bits),
// the base field of the Vesta curve and the scalar field of Pallas.
struct Vesta {
  static constexpr uint32_t INV = 0xffffffffu;
  FD static uint32_t p(int i) {
    const uint32_t P[8] = {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
                           0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return P[i];
  }
  FD static uint32_t one(int i) {
    const uint32_t O[8] = {0xfffffffdu, 0x5b2b3e9cu, 0xe3420567u, 0x992c350bu,
                           0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
    return O[i];
  }
};

// Whether a C entry point takes the field id `field`: BN254's fields (0,
// 1) always, the Pasta cycle's (2, 3) where the kernel has their instances.
inline bool field_built(int field, bool pasta) {
  return field == 0 || field == 1 || (pasta && (field == 2 || field == 3));
}

FD Fe fe_load(const uint32_t* base, long long idx) {
  Fe r;
  const uint32_t* s = base + idx * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = s[i];
  return r;
}

// The same load for rows that start on a 16-byte boundary (every row of a
// contiguous (n, 8) tensor): two 16-byte loads per element on the card.
FD Fe fe_load16(const uint32_t* base, long long idx) {
#ifdef FIELD_HOST_TEST
  return fe_load(base, idx);
#else
  const uint4* s = reinterpret_cast<const uint4*>(base + idx * 8);
  uint4 a = s[0], b = s[1];
  return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
#endif
}

#ifndef FIELD_HOST_TEST
// A load through L2 only, for rows that other blocks of the same launch
// wrote (read after an atomic ticket): no stale L1 line.
__device__ __forceinline__ Fe fe_load_cg(const uint32_t* base, long long idx) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = __ldcg(base + idx * 8 + j);
  return r;
}
#else
inline Fe fe_load_cg(const uint32_t* base, long long idx) { return fe_load(base, idx); }
#endif

FD void fe_store(uint32_t* base, long long idx, const Fe& a) {
  uint32_t* d = base + idx * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = a.v[i];
}

FD void fe_store16(uint32_t* base, long long idx, const Fe& a) {
#ifdef FIELD_HOST_TEST
  fe_store(base, idx, a);
#else
  uint4* d = reinterpret_cast<uint4*>(base + idx * 8);
  d[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  d[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
#endif
}

FD Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  return r;
}

template <class P>
FD Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = P::one(i);
  return r;
}

FD bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

FD Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// r = a - p if a >= p else a, for a < 2p.
template <class P>
FD Fe fe_reduce_once(const Fe& a) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.v[i] - P::p(i) - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  return borrow ? a : d;
}

template <class P>
FD Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.v[i] + b.v[i] + carry;
    s.v[i] = (uint32_t)t;
    carry = t >> 32;
  }
  // p < 2^255, so a + b < 2p < 2^256 never carries out of limb 7
  return fe_reduce_once<P>(s);
}

template <class P>
FD Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t t = (uint64_t)d.v[i] + P::p(i) + carry;
      d.v[i] = (uint32_t)t;
      carry = t >> 32;
    }
  }
  return d;
}

template <class P>
FD Fe fe_neg(const Fe& a) {
  return fe_is_zero(a) ? a : fe_sub<P>(fe_zero(), a);
}

// Montgomery product a*b*2^-256 mod p (CIOS, 32-bit limbs, 64-bit products).
// For a, b < p < 2^255 each outer step ends with t < b + p < 2p < 2^256, so
// t[8] is 0 between steps; within a step t + a_i b + m p < 2^289 needs the
// tenth word t[9], whose carry the shift folds into t[8].
template <class P>
FD Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[i] * b.v[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * P::INV;
    s = (uint64_t)m * P::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * P::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // t < 2p < 2^256: t[8] is 0, and one conditional subtract reduces it
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return fe_reduce_once<P>(r);
}
