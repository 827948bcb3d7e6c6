"""Legacy Keccak-256 (pre-NIST padding 0x01), host-side pure Python.

The port's copy of halo2_lasso_tpu/ops/keccak.py without its native
backend: the transcript hashes a few dozen bytes per round, and the port
must not depend on a library that is built outside its checkout. The
Fiat-Shamir transcript needs original Keccak (pad byte 0x01), not NIST SHA3
(pad 0x06), so hashlib.sha3_256 cannot be used.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

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


def _keccak_f_many(state: np.ndarray) -> np.ndarray:
    """``_keccak_f`` over many states at once: state (5, 5, N) uint64 lanes
    [x][y], every step one numpy operation across the N states."""
    def rotl(v, n):
        n %= 64
        return v if n == 0 else (v << np.uint64(n)) | (v >> np.uint64(64 - n))

    for rc in _ROUND_CONSTANTS:
        c = state[:, 0] ^ state[:, 1] ^ state[:, 2] ^ state[:, 3] ^ state[:, 4]
        d = np.roll(c, 1, axis=0) ^ rotl(np.roll(c, -1, axis=0), 1)
        state = state ^ d[:, None]
        b = np.empty_like(state)
        for x in range(5):
            for y in range(5):
                b[y, (2 * x + 3 * y) % 5] = rotl(state[x, y], _ROTATIONS[x][y])
        state = b ^ (~np.roll(b, -1, axis=0) & np.roll(b, -2, axis=0))
        state[0, 0] ^= np.uint64(rc)
    return state


def keccak256_many(messages: Sequence[bytes]) -> List[bytes]:
    """``keccak256`` of many messages of one length below the rate (one
    block each), vectorised across them with numpy: the same digests."""
    n = len(messages)
    if n == 0:
        return []
    size = len(messages[0])
    if size >= Keccak256.RATE or any(len(m) != size for m in messages):
        raise ValueError("keccak256_many: messages of one length below the rate")
    pad_len = Keccak256.RATE - size
    padding = b"\x81" if pad_len == 1 else b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    blocks = np.frombuffer(b"".join(m + padding for m in messages), dtype="<u8").reshape(n, 17)
    state = np.zeros((5, 5, n), dtype=np.uint64)
    for i in range(Keccak256.RATE // 8):
        state[i % 5, i // 5] = blocks[:, i]
    state = _keccak_f_many(state)
    lanes = np.stack([state[i % 5, i // 5] for i in range(4)], axis=1).astype("<u8")
    out = lanes.tobytes()
    return [out[32 * j : 32 * j + 32] for j in range(n)]
