"""Legacy Keccak-256 (pre-NIST padding 0x01), host-side.

The port's copy of halo2_lasso_tpu/ops/keccak.py:23-131: a native sponge
(``NativeKeccak256`` over csrc/host/keccak.c, the port's own copy of the C
source, built with the host C compiler on first use into build/host/ and
named by a hash of its source and flags) and the pure-Python sponge
(``PyKeccak256``), which stays only for a machine without a C compiler.
``Keccak256()`` gives the native one wherever it can be built; a compile
error of the source raises. ``keccak256_rows`` hashes n equal-length
messages in one native call (Brakedown's codeword columns and Merkle
levels). The Fiat-Shamir transcript needs original Keccak (pad byte 0x01),
not NIST SHA3 (pad 0x06), so hashlib.sha3_256 cannot be used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "keccak.c")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
CFLAGS = ["-O3", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 120

_native = None  # the loaded library; False where no C compiler exists


def _build(cc: str) -> str:
    """Compile csrc/host/keccak.c into build/host/ unless a library of the
    same source and flags is there; returns its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libkeccak_{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed on {SOURCE} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def native() -> Optional[ctypes.CDLL]:
    """The native sponge's library, built on first use; None where the
    machine has no C compiler."""
    global _native
    if _native is None:
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            _native = False
        else:
            dll = ctypes.CDLL(_build(cc))
            dll.keccak256_absorb_blocks.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p, ctypes.c_uint64]
            dll.keccak256_finalize.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ]
            dll.keccak256_many.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p]
            for fn in (dll.keccak256_absorb_blocks, dll.keccak256_finalize, dll.keccak256_many):
                fn.restype = None
            _native = dll
    return _native or None


def sponge() -> str:
    """Which sponge ``Keccak256()`` gives: "native" or "python"."""
    return "native" if native() is not None else "python"


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


class NativeKeccak256:
    """ctypes-backed incremental legacy Keccak-256 (csrc/host/keccak.c)."""

    RATE = 136
    DIGEST_SIZE = 32

    def __init__(self):
        self._dll = native()
        if self._dll is None:
            raise RuntimeError("no C compiler: the native Keccak sponge cannot be built")
        self._st = (ctypes.c_uint64 * 25)()
        self._buffer = b""

    def update(self, data: bytes) -> "NativeKeccak256":
        buf = self._buffer + bytes(data)
        nblocks = len(buf) // self.RATE
        if nblocks:
            self._dll.keccak256_absorb_blocks(self._st, buf[: nblocks * self.RATE], nblocks)
            buf = buf[nblocks * self.RATE :]
        self._buffer = buf
        return self

    def digest(self) -> bytes:
        out = ctypes.create_string_buffer(self.DIGEST_SIZE)
        self._dll.keccak256_finalize(self._st, self._buffer, len(self._buffer), out)
        return out.raw

    def finalize_reset(self) -> bytes:
        d = self.digest()
        ctypes.memset(self._st, 0, 25 * 8)
        self._buffer = b""
        return d


class PyKeccak256:
    """Pure-python incremental legacy Keccak-256: rate 136, pad 0x01...0x80."""

    RATE = 136
    DIGEST_SIZE = 32

    def __init__(self):
        self._state = [[0] * 5 for _ in range(5)]
        self._buffer = b""

    def update(self, data: bytes) -> "PyKeccak256":
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


def Keccak256():
    """An incremental legacy Keccak-256: the native sponge wherever a C
    compiler exists, else the pure-Python one."""
    return NativeKeccak256() if native() is not None else PyKeccak256()


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).digest()


def keccak256_rows(data: np.ndarray) -> np.ndarray:
    """``keccak256`` of each row of a (n, len) uint8 array: (n, 32) uint8
    digests, in one call of the native batch entry (a loop of the
    pure-Python sponge where there is no C compiler)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim != 2:
        raise ValueError("keccak256_rows: a (n, len) uint8 array of messages")
    n, size = data.shape
    out = np.empty((n, 32), dtype=np.uint8)
    dll = native()
    if dll is None:
        for i in range(n):
            out[i] = np.frombuffer(PyKeccak256().update(data[i].tobytes()).digest(), np.uint8)
    elif n:
        dll.keccak256_many(data.ctypes.data, n, size, out.ctypes.data)
    return out


def keccak256_many(messages: Sequence[bytes]) -> List[bytes]:
    """``keccak256`` of many messages of one length: the same digests."""
    if not messages:
        return []
    size = len(messages[0])
    if any(len(m) != size for m in messages):
        raise ValueError("keccak256_many: messages of one length")
    rows = np.frombuffer(b"".join(messages), dtype=np.uint8).reshape(len(messages), size)
    out = keccak256_rows(rows).tobytes()
    return [out[32 * j : 32 * j + 32] for j in range(len(messages))]
