"""Fiat-Shamir transcript (the port's copy of halo2_lasso_tpu/transcript.py).

Matches the Rust reference's plonkish_backend/src/util/transcript.rs semantics:
  * hash state absorbs field elements as 32-byte LITTLE-endian reprs
    (`update_field_element` -> `to_repr()`, hash.rs:19-21);
  * squeeze: h = keccak256(finalize+reset state); state.update(h);
    challenge = int_le(h) mod p (transcript.rs:127-131, fe_mod_from_le_bytes);
  * the proof byte stream stores field elements / EC coordinates BIG-endian
    (repr reversed, transcript.rs:146-166);
  * commitments absorb x then y base-field coordinates (transcript.rs:176-186).

Field elements cross this boundary as canonical python ints (host domain);
device arrays are converted at the call sites.
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

from halo2_lasso_tpu_torch.ops.keccak import Keccak256


from halo2_lasso_tpu_torch.errors import Halo2LassoError


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
        for fe in fes:
            self.write_field_element(fe)

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

    def read_field_elements(self, n: int) -> List[int]:
        return [self.read_field_element() for _ in range(n)]

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

    # ---- proof extraction ----

    def into_proof(self) -> bytes:
        return self._stream.getvalue()
