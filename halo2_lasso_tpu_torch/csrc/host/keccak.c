/* Keccak-f[1600] permutation + legacy Keccak-256 digest, C implementation
 * (the port's copy of the repository's csrc/keccak.c, with a batch entry).
 *
 * Host-side native component: the Fiat-Shamir transcript absorbs every
 * field element of a proof (tens of MB for a Brakedown proof) and Brakedown
 * hashes every codeword column and Merkle node; the pure-Python sponge runs
 * at ~0.15 MB/s. Built with the host C compiler on first use by
 * halo2_lasso_tpu_torch/ops/keccak.py into build/host/ and loaded with
 * ctypes (the pure-Python sponge stays only where no C compiler exists).
 * Not a CUDA source: it lies outside csrc/*.cu, so nvcc never sees it.
 */

#include <stdint.h>
#include <string.h>

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                             27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
static const int PILN[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8,  21, 24, 4,
                             15, 23, 19, 13, 12, 2,  20, 14, 22, 9,  6,  1};

void keccak_f1600(uint64_t st[25]) {
  uint64_t bc[5], t;
  for (int round = 0; round < 24; round++) {
    /* theta */
    for (int i = 0; i < 5; i++)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; i++) {
      t = bc[(i + 4) % 5] ^ ROTL64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    /* rho + pi */
    t = st[1];
    for (int i = 0; i < 24; i++) {
      int j = PILN[i];
      bc[0] = st[j];
      st[j] = ROTL64(t, ROTC[i]);
      t = bc[0];
    }
    /* chi */
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; i++) bc[i] = st[j + i];
      for (int i = 0; i < 5; i++)
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
    }
    /* iota */
    st[0] ^= RC[round];
  }
}

/* incremental sponge state: 25 lanes + byte buffer handled by caller.
 * absorb `len` bytes (len % 136 == 0) into the state. */
void keccak256_absorb_blocks(uint64_t st[25], const uint8_t *data,
                             uint64_t nblocks) {
  for (uint64_t b = 0; b < nblocks; b++) {
    for (int i = 0; i < 17; i++) {
      uint64_t lane;
      memcpy(&lane, data + b * 136 + i * 8, 8);
      st[i] ^= lane;
    }
    keccak_f1600(st);
  }
}

/* finalize a COPY of the state with legacy 0x01 padding over `rem` buffered
 * bytes, write 32-byte digest. */
void keccak256_finalize(const uint64_t st_in[25], const uint8_t *rem,
                        uint64_t rem_len, uint8_t out[32]) {
  uint64_t st[25];
  memcpy(st, st_in, sizeof(st));
  uint8_t block[136];
  memset(block, 0, sizeof(block));
  memcpy(block, rem, rem_len);
  block[rem_len] = 0x01;
  block[135] |= 0x80;
  for (int i = 0; i < 17; i++) {
    uint64_t lane;
    memcpy(&lane, block + i * 8, 8);
    st[i] ^= lane;
  }
  keccak_f1600(st);
  memcpy(out, st, 32);
}

/* n messages of `len` bytes each, laid end to end in `data`: the legacy
 * Keccak-256 digest of each into out[32 * i .. 32 * i + 32). The batch form
 * of a fresh sponge's absorb and finalize (Brakedown's Merkle leaves and
 * levels, hash_to_curve's candidates). */
void keccak256_many(const uint8_t *data, uint64_t n, uint64_t len,
                    uint8_t *out) {
  uint64_t full = len / 136;
  for (uint64_t m = 0; m < n; m++) {
    uint64_t st[25];
    const uint8_t *msg = data + m * len;
    memset(st, 0, sizeof(st));
    keccak256_absorb_blocks(st, msg, full);
    keccak256_finalize(st, msg + full * 136, len - full * 136, out + 32 * m);
  }
}
