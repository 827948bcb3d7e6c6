"""The card's peak rates and the two timing helpers that chip_smoke.py and
scripts/layout_bench.py share: a kernel's least time (its bound) and its
mean time over repeated launches with CUDA events.
"""

from __future__ import annotations

import torch

# Published H100 SXM peaks (NVIDIA H100 datasheet): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 on the CUDA cores, i.e. 33.5 T fma/s. Hopper issues int32
# multiply-adds at half the fp32 rate (64 vs 128 lanes per SM per clock),
# so 16.75 T IMAD/s; a 32x32->64-bit product costs two (low and high word).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
IMAD_PER_MONT_MUL = 2 * 2 * 8 * 8  # CIOS: 64 products a*b + 64 products m*p


def bound_ms(bytes_moved: int, imads: int):
    """(least time in ms, "bytes" or "operations") for work that moves
    `bytes_moved` bytes and does `imads` 32-bit multiply-adds."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
