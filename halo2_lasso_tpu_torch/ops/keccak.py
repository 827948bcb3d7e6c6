"""Legacy Keccak-256 (pre-NIST padding 0x01), host-side pure Python.

The port's copy of halo2_lasso_tpu/ops/keccak.py without its native
backend: the transcript hashes a few dozen bytes per round, and the port
must not depend on a library that is built outside its checkout. The
Fiat-Shamir transcript needs original Keccak (pad byte 0x01), not NIST SHA3
(pad 0x06), so hashlib.sha3_256 cannot be used.
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state):
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        state[0][0] ^= rc
    return state


class Keccak256:
    """Pure-python incremental legacy Keccak-256: rate 136, pad 0x01...0x80."""

    RATE = 136
    DIGEST_SIZE = 32

    def __init__(self):
        self._state = [[0] * 5 for _ in range(5)]
        self._buffer = b""

    def update(self, data: bytes) -> "Keccak256":
        self._buffer += data
        while len(self._buffer) >= self.RATE:
            self._absorb(self._buffer[: self.RATE])
            self._buffer = self._buffer[self.RATE :]
        return self

    def _absorb(self, block: bytes):
        assert len(block) == self.RATE
        for i in range(self.RATE // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            self._state[x][y] ^= lane
        _keccak_f(self._state)

    def digest(self) -> bytes:
        # pad: 0x01 then zeros then 0x80 (legacy keccak domain)
        pad_len = self.RATE - len(self._buffer)
        if pad_len == 1:
            padding = b"\x81"
        else:
            padding = b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        state = [row[:] for row in self._state]
        block = self._buffer + padding
        for i in range(self.RATE // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        _keccak_f(state)
        out = b""
        i = 0
        while len(out) < self.DIGEST_SIZE:
            x, y = i % 5, i // 5
            out += state[x][y].to_bytes(8, "little")
            i += 1
        return out[: self.DIGEST_SIZE]

    def finalize_reset(self) -> bytes:
        d = self.digest()
        self._state = [[0] * 5 for _ in range(5)]
        self._buffer = b""
        return d


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).digest()
