"""Layout microbench of the elementwise Montgomery product over Fr: the
port of scripts/tpu_layout_bench.py.

    python -m halo2_lasso_tpu_torch.scripts.layout_bench [log2_n ...]

Three layouts of the same product, each a hand kernel on the card:
  K4 ``field.mont_mul``      rows (n, 8): each thread loads its own 32 bytes;
  K6 ``mont_mul_limbs_first`` (8, n): one thread per element, limb j at
     a[j, e], each limb row one coalesced warp load (the TPU's make_mul_a);
  K7 ``mont_mul_tiled``       (8, n/128, 128): one block per 1024-element
     tile staged in shared memory (the TPU's make_mul_b and its VMEM block).
(8, n) and (8, n/128, 128) are the same bytes on the card, so K6 and K7
differ only in how threads map onto them. All limbs are the port's 32-bit
limbs in int32 storage.

At each n (default 2^16, 2^20, 2^22) the bench draws two operand sets from
one seed, checks K4, K6 and K7 against each other (K4 transposed) and
against the plain PyTorch version bit for bit, then times each over 20
launches with CUDA events beside the bound: the larger of 96 bytes per
element over 3.35 TB/s and 256 32-bit multiply-adds per element over
16.75 T/s. It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, bound_ms, cuda_ms

LANES = 128
DEFAULT_LOG2_NS = (16, 20, 22)
DEVICE = "cuda"  # on the CPU the wrappers run their plain versions
REPS = 20  # timed launches per kernel and n
SEED = 3
BYTES_PER_MUL = 3 * 32  # read a and b, write the product


def mont_mul_limbs_first_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: (8, n) x (8, n) -> (8, n)."""
    return F.mont_mul_plain(Fr, a.T, b.T).T.contiguous()


def mont_mul_tiled_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: (8, n/128, 128) x (8, n/128, 128) -> the same."""
    return mont_mul_limbs_first_plain(a.reshape(F.LIMBS, -1), b.reshape(F.LIMBS, -1)).reshape(a.shape)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    native.require_cuda(name, a, b)
    out = torch.empty_like(a)
    native.launch(name, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // F.LIMBS)
    native.counts[name] += 1
    return out


def mont_mul_limbs_first(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product over Fr of limbs-first (8, n) int32
    tensors. Kernel: csrc/mont_mul_layouts.cu (port of
    tpu_layout_bench.make_mul_a)."""
    if a.ndim != 2 or a.shape[0] != F.LIMBS or a.shape != b.shape:
        raise ValueError(f"mont_mul_limbs_first: want two (8, n) tensors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return mont_mul_limbs_first_plain(a, b)
    return _launch("mont_mul_limbs_first", a, b)


def mont_mul_tiled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product over Fr of (8, n/128, 128) int32
    tensors, so n is a multiple of 128. Kernel: csrc/mont_mul_layouts.cu
    (port of tpu_layout_bench.make_mul_b)."""
    if a.ndim != 3 or a.shape[0] != F.LIMBS or a.shape[2] != LANES or a.shape != b.shape:
        raise ValueError(f"mont_mul_tiled: want two (8, n/128, 128) tensors, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return mont_mul_tiled_plain(a, b)
    return _launch("mont_mul_tiled", a, b)


def rand_rows(rng: np.random.RandomState, n: int, device, edges=()) -> torch.Tensor:
    """n random elements of [0, p) as (n, 8) rows, the given values first."""
    limbs = rng.randint(0, 1 << 32, size=(n, F.LIMBS), dtype=np.uint64).astype(np.uint32)
    limbs[:, -1] = rng.randint(0, Fr.modulus >> 224, size=n)  # below p
    if edges:
        limbs[: len(edges)] = F.ints_to_u32(edges)
    return F.from_numpy_u32(limbs, device)


def edge_values():
    p = Fr.modulus
    return [0, 1, p - 1, Fr.R], [p - 1, Fr.R, p - 1, 1]


def run(log2_ns=DEFAULT_LOG2_NS):
    """Check and time K4, K6 and K7 at each n = 2^k; returns one record per
    n. Raises if any two versions disagree."""
    rng = np.random.RandomState(SEED)
    ea, eb = edge_values()
    records = []
    for k in log2_ns:
        n = 1 << k
        a, b = rand_rows(rng, n, DEVICE, ea), rand_rows(rng, n, DEVICE, eb)
        a_lf, b_lf = a.T.contiguous(), b.T.contiguous()
        a_t, b_t = a_lf.view(F.LIMBS, n // LANES, LANES), b_lf.view(F.LIMBS, n // LANES, LANES)
        k4 = F.mont_mul(Fr, a, b)
        k6 = mont_mul_limbs_first(a_lf, b_lf)
        k7 = mont_mul_tiled(a_t, b_t)
        plain = F.mont_mul_plain(Fr, a, b)
        if not (torch.equal(k6, k4.T) and torch.equal(k7.reshape(F.LIMBS, n), k6) and torch.equal(plain, k4)):
            raise RuntimeError(f"layout bench: K4, K6, K7 and the plain version disagree at n = 2^{k}")
        b_ms, b_by = bound_ms(BYTES_PER_MUL * n, IMAD_PER_MONT_MUL * n)
        records.append({
            "n": n,
            "k4_ms": cuda_ms(lambda: F.mont_mul(Fr, a, b), REPS),
            "k6_ms": cuda_ms(lambda: mont_mul_limbs_first(a_lf, b_lf), REPS),
            "k7_ms": cuda_ms(lambda: mont_mul_tiled(a_t, b_t), REPS),
            "plain_ms": cuda_ms(lambda: F.mont_mul_plain(Fr, a, b), 2),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    return records


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("layout_bench: no CUDA device", file=sys.stderr)
        return 1
    log2_ns = tuple(int(v) for v in argv) or DEFAULT_LOG2_NS
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    for r in run(log2_ns):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
