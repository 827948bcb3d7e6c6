"""The port's native Keccak sponge (halo2_lasso_tpu_torch/ops/keccak.py over
csrc/host/keccak.c) against its pure-Python sponge and the published
legacy-Keccak-256 vectors of tests/test_keccak_kat.py (copied here): split
updates, message lengths around the 136-byte rate, the batch entry over n
equal-length messages in one call, and the Fiat-Shamir transcript's bytes
and challenges with either sponge."""

import os

import numpy as np
import pytest

from halo2_lasso_tpu_torch.ops import keccak as K
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, FR_MODULUS
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

KATS = [
    (b"", "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"),
    (b"abc", "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"),
    (
        b"The quick brown fox jumps over the lazy dog",
        "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15",
    ),
]
LENGTHS = [0, 1, 135, 136, 137, 256, 1000]


def test_native_sponge_is_built_from_the_ports_source():
    assert K.sponge() == "native"
    assert isinstance(K.Keccak256(), K.NativeKeccak256)
    lib = K._build("cc")
    assert os.path.dirname(lib) == K.BUILD_DIR and os.path.exists(lib)


@pytest.mark.parametrize("msg,digest", KATS)
@pytest.mark.parametrize("sponge", ["native", "python"])
def test_published_vectors(sponge, msg, digest):
    h = K.NativeKeccak256() if sponge == "native" else K.PyKeccak256()
    assert h.update(msg).digest().hex() == digest


@pytest.mark.parametrize("n", LENGTHS)
def test_split_updates_match_python(n):
    data = np.random.RandomState(n).bytes(n)
    want = K.PyKeccak256().update(data).digest()
    for cuts in ([], [n // 3], [1, n // 2, n - 1] if n > 2 else []):
        h = K.NativeKeccak256()
        for a, b in zip([0] + cuts, cuts + [n]):
            h.update(data[a:b])
        assert h.digest() == want


@pytest.mark.parametrize("n", LENGTHS)
def test_batch_entry_matches_python(n):
    """n equal-length messages hashed in one call of the native batch entry."""
    rng = np.random.RandomState(1000 + n)
    msgs = [rng.bytes(n) for _ in range(7)]
    rows = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(len(msgs), n)
    got = K.keccak256_rows(rows)
    assert got.shape == (7, 32)
    assert [r.tobytes() for r in got] == [K.PyKeccak256().update(m).digest() for m in msgs]
    assert K.keccak256_many(msgs) == [r.tobytes() for r in got]


def test_batch_entry_published_vector():
    rows = np.frombuffer(b"abc" * 3, dtype=np.uint8).reshape(3, 3)
    assert {r.tobytes().hex() for r in K.keccak256_rows(rows)} == {KATS[1][1]}
    assert K.keccak256_rows(np.zeros((0, 64), dtype=np.uint8)).shape == (0, 32)


def test_finalize_reset_matches_fresh():
    h = K.NativeKeccak256()
    h.update(b"first message")
    d1 = h.finalize_reset()
    h.update(b"second")
    assert (d1, h.finalize_reset()) == (K.keccak256(b"first message"), K.keccak256(b"second"))


def _transcript_run(sponge):
    t = Keccak256Transcript(FR_MODULUS, base_modulus=FQ_MODULUS, curve_b=3)
    t._state = sponge()
    rng = np.random.RandomState(7)
    out = []
    t.write_field_elements([int.from_bytes(rng.bytes(31), "little") for _ in range(300)])
    out.append(t.squeeze_challenges(3))
    t.write_commitment((1, 2))
    t.write_hash(rng.bytes(32))
    t.common_hash(rng.bytes(32))
    out.append(t.squeeze_challenge_idx(14091))
    le = np.frombuffer(rng.bytes(32 * 50), dtype=np.uint8).reshape(50, 32).copy()
    le[:, 31] &= 0x0F  # below the modulus
    t.write_field_reprs(le)
    out.append(t.squeeze_challenge())
    return t.into_proof(), out


def test_transcript_bytes_equal_with_either_sponge():
    proof, challenges = _transcript_run(K.NativeKeccak256)
    assert (proof, challenges) == _transcript_run(K.PyKeccak256)
    r = Keccak256Transcript(FR_MODULUS, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)
    r.read_field_elements(300)
    assert r.squeeze_challenges(3) == challenges[0]


def test_batch_writes_and_reads_equal_one_at_a_time():
    """A batch of field elements absorbed in one update gives the bytes and
    challenges of absorbing them one at a time."""
    rng = np.random.RandomState(8)
    fes = [int.from_bytes(rng.bytes(32), "little") % FR_MODULUS for _ in range(200)]
    one, batch = Keccak256Transcript(FR_MODULUS), Keccak256Transcript(FR_MODULUS)
    for fe in fes:
        one.write_field_element(fe)
    batch.write_field_elements(fes)
    assert one.squeeze_challenge() == batch.squeeze_challenge()
    assert one.into_proof() == batch.into_proof()
    r = Keccak256Transcript(FR_MODULUS, proof=batch.into_proof())
    reprs = r.read_field_reprs(200)
    assert [int.from_bytes(x.tobytes(), "little") for x in reprs] == fes
    check = Keccak256Transcript(FR_MODULUS)
    check.write_field_elements(fes)
    assert r.squeeze_challenge() == check.squeeze_challenge()
