"""Poseidon hash over BN254 Fr (host-side), the port's own copy of
halo2_lasso_tpu/ops/poseidon.py.

The reference re-exports the `poseidon` crate (util/hash.rs:10) as an
alternative transcript hash (Keccak256 is what its tests instantiate). This
is a self-contained Poseidon-128 implementation with x^5 S-box, t = RATE+1,
R_F = 8 full rounds, and R_P chosen per the Poseidon paper for 128-bit
security; round constants and the MDS matrix are generated with the
reference Grain-LFSR procedure (appendix of eprint 2019/458).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

from halo2_lasso_tpu_torch.ops.bn254 import FR_MODULUS as P


class _Grain:
    """Grain LFSR from the Poseidon reference implementation."""

    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int):
        state = []

        def add_bits(value, n):
            for i in range(n - 1, -1, -1):
                state.append((value >> i) & 1)

        add_bits(1, 2)  # field type: prime
        add_bits(1, 4)  # sbox: x^alpha
        add_bits(field_bits, 12)
        add_bits(t, 12)
        add_bits(r_f, 10)
        add_bits(r_p, 10)
        add_bits((1 << 30) - 1, 30)
        assert len(state) == 80
        self.state = state
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_filtered_bit(self) -> int:
        # evaluate bits in pairs: if first is 1, output second; else skip
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1 == 1:
                return b2

    def next_field_element(self, field_bits: int) -> int:
        # rejection sampling of field_bits-bit candidates
        while True:
            v = 0
            for _ in range(field_bits):
                v = (v << 1) | self.next_filtered_bit()
            if v < P:
                return v

    def next_field_element_no_reject(self, field_bits: int) -> int:
        v = 0
        for _ in range(field_bits):
            v = (v << 1) | self.next_filtered_bit()
        return v % P


@functools.lru_cache(maxsize=None)
def _constants(t: int, r_f: int, r_p: int):
    field_bits = 255
    grain = _Grain(field_bits, t, r_f, r_p)
    round_constants = [
        [grain.next_field_element(field_bits) for _ in range(t)]
        for _ in range(r_f + r_p)
    ]
    # Cauchy MDS from xs = G(..), ys = G(..)
    xs = [grain.next_field_element_no_reject(field_bits) for _ in range(t)]
    ys = [grain.next_field_element_no_reject(field_bits) for _ in range(t)]
    mds = [
        [pow((xs[i] + ys[j]) % P, -1, P) for j in range(t)] for i in range(t)
    ]
    return round_constants, mds


class Poseidon:
    """Sponge with fixed-length absorb/squeeze (rate = t - 1)."""

    def __init__(self, t: int = 3, r_f: int = 8, r_p: int = 57):
        self.t, self.r_f, self.r_p = t, r_f, r_p
        self.rc, self.mds = _constants(t, r_f, r_p)
        self.state = [0] * t
        self._buffer: List[int] = []

    def _sbox(self, x: int) -> int:
        x2 = x * x % P
        x4 = x2 * x2 % P
        return x4 * x % P

    def _permute(self):
        s = self.state
        t, r_f, r_p = self.t, self.r_f, self.r_p
        half = r_f // 2
        for rnd in range(r_f + r_p):
            s = [(v + c) % P for v, c in zip(s, self.rc[rnd])]
            if rnd < half or rnd >= half + r_p:
                s = [self._sbox(v) for v in s]
            else:
                s = [self._sbox(s[0])] + s[1:]
            s = [
                sum(self.mds[i][j] * s[j] for j in range(t)) % P for i in range(t)
            ]
        self.state = s

    def update(self, elements: Sequence[int]):
        rate = self.t - 1
        self._buffer.extend(v % P for v in elements)
        while len(self._buffer) >= rate:
            chunk, self._buffer = self._buffer[:rate], self._buffer[rate:]
            for i, v in enumerate(chunk):
                self.state[i + 1] = (self.state[i + 1] + v) % P
            self._permute()
        return self

    def squeeze(self) -> int:
        # absorb any remainder with a domain pad, then output state[1]
        rate = self.t - 1
        if self._buffer:
            for i, v in enumerate(self._buffer):
                self.state[i + 1] = (self.state[i + 1] + v) % P
            self.state[0] = (self.state[0] + 1) % P  # partial-block domain tag
            self._buffer = []
        self._permute()
        return self.state[1]


def poseidon_hash(elements: Sequence[int], t: int = 3) -> int:
    return Poseidon(t=t).update(list(elements)).squeeze()
