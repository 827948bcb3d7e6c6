"""The card's peak rates and the timing helpers that chip_smoke.py and the
port's scripts share: a kernel's least time (its bound), its mean time over
repeated launches with CUDA events, and the device's own time per call from
torch.profiler.
"""

from __future__ import annotations

import re

import torch

# Published H100 SXM peaks (NVIDIA H100 datasheet): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 on the CUDA cores, i.e. 33.5 T fma/s. Hopper issues int32
# multiply-adds at half the fp32 rate (64 vs 128 lanes per SM per clock),
# so 16.75 T IMAD/s; a 32x32->64-bit product costs two (low and high word).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
IMAD_PER_MONT_MUL = 2 * 2 * 8 * 8  # CIOS over BN254: 64 products a*b + 64 products m*p
PROFILER_SESSIONS = 3


def imad_per_mont_mul(spec) -> int:
    """32-bit multiply-adds of one CIOS Montgomery product (8 limbs of 32
    bits) modulo FieldSpec `spec`'s modulus: two (the low and the high word)
    for each of the 64 products a_i * b_j and for each product m * p_j,
    where limb p_j is not 0, 1 or a power of two. The kernels read p's limbs
    as constants, and the compiler folds those three kinds into nothing, a
    move or a shift: BN254's limbs are all of the other kind (256), Pasta's
    limbs 4-6 are 0, limb 0 is 1 and limb 7 is 2^30 (176). The product
    m = t_0 * INV of each step is left out, as in IMAD_PER_MONT_MUL: the
    bound stays a least time."""
    limbs = [(spec.modulus >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    return 2 * (64 + 8 * sum(1 for v in limbs if v & (v - 1)))


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


def kernel_rows(rows, symbol: str):
    """The profiler rows of the __global__ function `symbol`."""
    return [e for e in rows if re.search(rf"(^|\W){symbol}\s*[<(]", e.key)]


def device_ms(fn, reps: int, symbols=(), expect=None) -> dict:
    """Per call over `reps` calls after one warm-up, from torch.profiler's
    device-side rows: "all", the device time of every kernel, copy and
    memset (the host's gaps between them excluded); each of `symbols` (a
    kernel's __global__ name), its device time; "DtoH" and "HtoD", the
    device-to-host and host-to-device copies. With `expect`, {symbol:
    launches a call}, a session whose rows hold another number of that
    kernel's launches is repeated: in a long process a session now and
    then loses the records of some launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_SESSIONS):  # a profiler session now and then records no device row: repeat it
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {"all": sum(e.self_device_time_total for e in rows) / 1e3 / reps}
        whole = all(sum(e.count for e in kernel_rows(rows, sym)) == n * reps for sym, n in (expect or {}).items())
        if out["all"] > 0 and whole:
            break
    else:
        raise RuntimeError(f"the profiler saw no device time, or not every launch, in {PROFILER_SESSIONS} sessions")
    for sym in symbols:
        out[sym] = sum(e.self_device_time_total for e in kernel_rows(rows, sym)) / 1e3 / reps
    for d in ("DtoH", "HtoD"):
        out[d] = sum(e.count for e in rows if e.key.startswith(f"Memcpy {d}")) / reps
    return out
