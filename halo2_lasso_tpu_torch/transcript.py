"""Fiat-Shamir transcript (the port's copy of halo2_lasso_tpu/transcript.py).

Matches the Rust reference's plonkish_backend/src/util/transcript.rs semantics:
  * hash state absorbs field elements as 32-byte LITTLE-endian reprs
    (`update_field_element` -> `to_repr()`, hash.rs:19-21);
  * squeeze: h = keccak256(finalize+reset state); state.update(h);
    challenge = int_le(h) mod p (transcript.rs:127-131, fe_mod_from_le_bytes);
  * the proof byte stream stores field elements / EC coordinates BIG-endian
    (repr reversed, transcript.rs:146-166);
  * commitments absorb x then y base-field coordinates (transcript.rs:176-186).

Field elements cross this boundary as canonical python ints (host domain),
or in bulk as their canonical 32-byte little-endian reprs, a (n, 32) uint8
array (``write_field_reprs`` / ``read_field_reprs``): a batch is absorbed in
one ``update``, byte for byte what absorbing its elements one at a time
gives. Hash outputs (Brakedown's Merkle roots and paths) are streamed
without absorbing them (``write_hash``, ``write_stream``). Device arrays
are converted at the call sites.
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.ops.keccak import Keccak256


class TranscriptError(Halo2LassoError):
    pass


class Keccak256Transcript:
    """Write/read Fiat-Shamir transcript over a byte stream.

    `scalar_modulus` is the field challenges live in (Fr); `base_modulus` the
    commitment coordinate field (Fq). All values are canonical python ints.
    """

    def __init__(
        self,
        scalar_modulus: int,
        base_modulus: Optional[int] = None,
        proof: Optional[bytes] = None,
        curve_b: Optional[int] = None,
    ):
        self.scalar_modulus = scalar_modulus
        self.base_modulus = base_modulus or scalar_modulus
        # y^2 = x^3 + b coefficient of the commitment curve: when set,
        # `read_commitment` rejects off-curve points (the reference reads
        # points through halo2_curves' checked CurveRead deserialization,
        # util/transcript.rs:168-238 — accepting unchecked points would be an
        # invalid-curve soundness hole). All supported curves (BN254 G1,
        # grumpkin, pasta) have a = 0 and cofactor 1, so the curve equation
        # is also the full subgroup check.
        self.curve_b = curve_b
        self._state = Keccak256()
        self._stream = io.BytesIO(proof if proof is not None else b"")
        self._repr_bytes = 32

    # ---- state absorption ----

    def common_field_element(self, fe: int):
        self._state.update(int(fe).to_bytes(self._repr_bytes, "little"))

    def common_commitment(self, comm: Tuple[int, int]):
        """Absorb an affine EC point (x, y) in base-field canonical ints.

        (0, 0) encodes the IDENTITY point: for b != 0 curves no real point
        has x = y = 0 (0 != b), so the marker is collision-free and sound.
        Identity commitments arise legitimately (a committed zero poly —
        e.g. Lasso read_ts when every lookup address is fresh); the
        reference errors on them (coordinates() is None), which is a
        capability gap rather than behavior worth mirroring.
        """
        x, y = comm
        self._state.update(int(x).to_bytes(self._repr_bytes, "little"))
        self._state.update(int(y).to_bytes(self._repr_bytes, "little"))

    # ---- squeezing ----

    def squeeze_challenge(self) -> int:
        h = self._state.finalize_reset()
        self._state.update(h)
        return int.from_bytes(h, "little") % self.scalar_modulus

    def squeeze_challenges(self, n: int) -> List[int]:
        return [self.squeeze_challenge() for _ in range(n)]

    # ---- proof stream writes ----

    def write_field_element(self, fe: int):
        self.common_field_element(fe)
        self._stream.write(int(fe).to_bytes(self._repr_bytes, "big"))

    def write_field_elements(self, fes):
        le = b"".join(int(fe).to_bytes(self._repr_bytes, "little") for fe in fes)
        self.write_field_reprs(np.frombuffer(le, dtype=np.uint8).reshape(-1, self._repr_bytes))

    def common_field_reprs(self, le: bytes):
        """Absorb field elements given as their concatenated canonical
        little-endian reprs, in one update."""
        self._state.update(le)

    def write_field_reprs(self, le: np.ndarray):
        """Write the field elements of a (n, 32) uint8 array of canonical
        little-endian reprs: one update of the state, one write of their
        big-endian reprs."""
        le = np.ascontiguousarray(le, dtype=np.uint8).reshape(-1, self._repr_bytes)
        self.common_field_reprs(le.tobytes())
        self._stream.write(le[:, ::-1].tobytes())

    def write_commitment(self, comm: Tuple[int, int]):
        self.common_commitment(comm)
        x, y = comm
        self._stream.write(int(x).to_bytes(self._repr_bytes, "big"))
        self._stream.write(int(y).to_bytes(self._repr_bytes, "big"))

    def write_commitments(self, comms):
        for comm in comms:
            self.write_commitment(comm)

    # ---- proof stream reads ----

    def _read_exact(self, n: int) -> bytes:
        data = self._stream.read(n)
        if len(data) != n:
            raise TranscriptError("unexpected end of proof stream")
        return data

    def read_field_element(self) -> int:
        fe = int.from_bytes(self._read_exact(self._repr_bytes), "big")
        if fe >= self.scalar_modulus:
            raise TranscriptError("invalid field element encoding in proof")
        self.common_field_element(fe)
        return fe

    def read_field_reprs(self, n: int) -> np.ndarray:
        """Read n field elements as a (n, 32) uint8 array of canonical
        little-endian reprs, each checked below the modulus, absorbed in one
        update."""
        be = np.frombuffer(self._read_exact(n * self._repr_bytes), dtype=np.uint8).reshape(n, self._repr_bytes)
        le = np.ascontiguousarray(be[:, ::-1])
        if not below_modulus(le, self.scalar_modulus).all():
            raise TranscriptError("invalid field element encoding in proof")
        self.common_field_reprs(le.tobytes())
        return le

    def read_field_elements(self, n: int) -> List[int]:
        buf = self.read_field_reprs(n).tobytes()
        return [int.from_bytes(buf[i : i + self._repr_bytes], "little") for i in range(0, len(buf), self._repr_bytes)]

    def read_commitment(self) -> Tuple[int, int]:
        x = int.from_bytes(self._read_exact(self._repr_bytes), "big")
        y = int.from_bytes(self._read_exact(self._repr_bytes), "big")
        if x >= self.base_modulus or y >= self.base_modulus:
            raise TranscriptError("invalid point encoding in proof")
        if self.curve_b is not None and not (x == 0 and y == 0):
            # (0, 0) is the identity marker (see common_commitment)
            p = self.base_modulus
            if (y * y - x * x * x - self.curve_b) % p != 0:
                raise TranscriptError("off-curve point in proof")
        self.common_commitment((x, y))
        return (x, y)

    def read_commitments(self, n: int) -> List[Tuple[int, int]]:
        return [self.read_commitment() for _ in range(n)]

    # ---- hash commitments (Brakedown merkle roots and paths) ----
    # The reference streams hash outputs WITHOUT absorbing them
    # (transcript.rs:241-263, the Output<Keccak256> impls); absorption
    # happens only through explicit common_hash calls
    # (halo2_lasso_tpu/transcript.py:150-170).

    def write_hash(self, h: bytes):
        if len(h) != 32:
            raise ValueError("write_hash: a 32-byte hash")
        self._stream.write(h)

    def read_hash(self) -> bytes:
        return self._read_exact(32)

    def common_hash(self, h: bytes):
        self._state.update(h)

    def write_stream(self, data: bytes):
        """Bytes to the proof stream without absorbing them: hashes, or the
        big-endian reprs of elements the state already absorbed."""
        self._stream.write(data)

    def read_stream(self, n: int) -> bytes:
        """The next n bytes of the proof stream, not absorbed."""
        return self._read_exact(n)

    def squeeze_challenge_idx(self, cap: int) -> int:
        """Low 32 bits of a squeezed challenge, mod cap
        (pcs/multilinear/brakedown.rs squeeze_challenge_idx)."""
        return (self.squeeze_challenge() & 0xFFFFFFFF) % cap

    # ---- proof extraction ----

    def into_proof(self) -> bytes:
        return self._stream.getvalue()


def below_modulus(le: np.ndarray, modulus: int) -> np.ndarray:
    """Whether each row of a (n, 32) uint8 array of little-endian reprs is
    below `modulus`, compared as four 64-bit words from the top."""
    words = np.ascontiguousarray(le, dtype=np.uint8).view("<u8").reshape(-1, 4)
    lt = np.zeros(words.shape[0], dtype=bool)
    eq = np.ones(words.shape[0], dtype=bool)
    for i in (3, 2, 1, 0):
        w = np.uint64((modulus >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
        lt |= eq & (words[:, i] < w)
        eq &= words[:, i] == w
    return lt
