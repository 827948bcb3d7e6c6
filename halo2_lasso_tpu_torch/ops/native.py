"""Build, load and launch the hand-written CUDA kernels of the port.

All kernel sources (``halo2_lasso_tpu_torch/csrc/*.cu`` over the shared
``field.cuh``) are compiled by parallel ``nvcc -c`` jobs, one a source, all
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. Nothing includes PyTorch's headers, so the
build takes as long as its largest source, and nothing compiles after it:
the library is named by a hash of its sources, so a stale build is never
loaded and an existing one is reused.

The build happens on the first launch of any kernel (never at import time:
the CPU tests import every module and have no ``nvcc``). Every C entry point
returns ``cudaGetLastError()``; ``check`` raises on anything but 0.
``ptxas_info`` keeps what ``-Xptxas -v`` said of each kernel (registers,
shared memory, spills) when this process built the library.

``counts`` holds one launch counter per kernel, and one per field instance
that a kernel has beside its first (``INSTANCES``: the Fq instances of K1
and K2, the grumpkin instances of K3's add, level, ladder and plane tree,
and the Pallas and Vesta instances of K4's elementwise op, power and scan
and of those four K3 kernels). A wrapper adds one to its kernel's count
where it launches it, whatever the instance, and one to the instance's
count when it launches that instance, and nowhere else; ``reset_counts``
zeroes them.

``FIELD_IDS`` is each C entry point's table of field ids (a FieldSpec's
``kernel_id``); a wrapper takes its id through ``field_id``, which raises
for a field the kernel has no instance for, and the entry point itself
returns cudaErrorInvalidValue for any other id.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
BUILD_TIMEOUT_S = 600

KERNELS = (
    "mont_mul", "fold_all", "sumcheck_round", "ec_add", "fix_var", "mont_mul_limbs_first",
    "mont_mul_tiled", "msm_level", "mont_pow", "prefix_products", "eq_xy", "sum_reduce", "ec_ladder",
    "plane_tree",
)
# the field ids each C entry point dispatches (csrc/*.cu): 0 = BN254 Fr,
# 1 = BN254 Fq, 2 = Pallas' base field, 3 = Vesta's; the Pasta ids where a
# Pasta curve's group ops or inversions launch the kernel
BN254_IDS, ALL_IDS = (0, 1), (0, 1, 2, 3)
FIELD_IDS = {
    "mont_mul": ALL_IDS, "sum_reduce": BN254_IDS, "mont_pow": ALL_IDS, "prefix_products": ALL_IDS,
    "batch_inv": ALL_IDS, "eq_xy": BN254_IDS, "fold_all": BN254_IDS, "fix_var": BN254_IDS,
    "sumcheck_round": BN254_IDS, "ec_add": ALL_IDS, "msm_level": ALL_IDS, "ec_ladder": ALL_IDS,
    "plane_tree": ALL_IDS,
}
# the Pasta instances' names, by field id (a curve's by its coordinate
# field), and the kernels that have them (batch_inv launches mont_pow and
# prefix_products)
PASTA = {2: "pallas", 3: "vesta"}
PASTA_KERNELS = tuple(k for k in KERNELS if 2 in FIELD_IDS.get(k, ()))
# a curve's instance name by its coordinate field's id ("" for the first)
CURVES = {0: "grumpkin", 1: "", **PASTA}
# the instances counted apart: "<kernel>.<instance>", launched where a
# wrapper is given a field (K1, K2: Fq; K4: Pallas, Vesta) or a curve (K3:
# grumpkin, whose coordinates are Fr; Pallas, Vesta) other than its first
INSTANCES = ("sumcheck_round.fq", "fold_all.fq") + tuple(
    f"{k}.grumpkin" for k in ("ec_add", "msm_level", "ec_ladder", "plane_tree")) + tuple(
    f"{k}.{c}" for k in PASTA_KERNELS for c in PASTA.values())
counts = {k: 0 for k in KERNELS + INSTANCES}
# the __global__ function of each kernel, as a profiler names it
SYMBOLS = {
    "mont_mul": "mont_mul_kernel", "fold_all": "fold_all_kernel", "sumcheck_round": "round_kernel",
    "ec_add": "ec_add_kernel", "fix_var": "fix_var_kernel",
    "mont_mul_limbs_first": "mont_mul_limbs_first_kernel", "mont_mul_tiled": "mont_mul_tiled_kernel",
    "msm_level": "msm_level_kernel", "mont_pow": "mont_pow_kernel", "prefix_products": "scan_kernel",
    "eq_xy": "eq_xy_kernel", "sum_reduce": "sum_reduce_kernel", "ec_ladder": "ec_ladder_kernel",
    "plane_tree": "plane_tree_kernel",
}
build_seconds = None  # wall time of the build (the parallel compiles and the link), when this process built
ptxas_info = ""  # what -Xptxas -v printed, when this process built

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "h2l_mont_mul": [_I, _I, _P, _P, _P, _P, _LL, _LL, _P],
    "h2l_sum_reduce": [_I, _P, _LL, _I, _LL, _LL, _I, _P, _P, _P, _P],
    "h2l_fold_all": [_I, _P, _P, _I, _LL, _LL, _P, _P, _P],
    "h2l_fix_var": [_I, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "h2l_sumcheck_round": [_I, _P, _I, _P, _I, _P, _I, _P, _LL, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "h2l_ec_add": [_I] + [_P] * 9 + [_LL, _P],
    "h2l_msm_level": [_I] + [_P] * 5 + [_LL, _I, _I] + [_P] * 8,
    "h2l_ec_ladder": [_I] + [_P] * 5 + [_I] + [_P] * 3 + [_LL, _P],
    "h2l_plane_tree": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "h2l_mont_mul_limbs_first": [_P, _P, _P, _LL, _P],
    "h2l_mont_mul_tiled": [_P, _P, _P, _LL, _P],
    "h2l_mont_pow": [_I, _P, _P, _LL, _P, _I, _P],
    "h2l_prefix_products": [_I, _P, _P, _LL, _I, _P, _P],
    "h2l_batch_inv": [_I, _P, _P, _LL, _P, _P, _I, _P],
    "h2l_eq_xy": [_I, _P, _P, _I, _P, _P],
}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def field_id(entry: str, spec) -> int:
    """The kernel_id of FieldSpec `spec` for C entry point `entry`, which
    must have an instance for it (``FIELD_IDS``); else a ValueError, before
    anything is launched."""
    if spec.kernel_id not in FIELD_IDS[entry]:
        raise ValueError(f"{entry}: the kernel has no instance for {spec.name}")
    return spec.kernel_id


def count(name: str, instance: str = "", n: int = 1) -> None:
    """`n` launches of kernel `name`, of its instance `instance` where that
    is counted apart."""
    counts[name] += n
    if instance:
        counts[f"{name}.{instance}"] += n


_tickets = {}


def ticket(name: str, device: torch.device) -> torch.Tensor:
    """The block counter of kernel `name` on this device and its current
    stream: at 0 between launches (the kernel's last block resets it)."""
    key = (name, _index(device), stream(device))
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", key[1]))
    return _tickets[key]


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile every kernel source, one ``nvcc -c`` job each, all at once,
    and link them into one library; returns its path."""
    global build_seconds, ptxas_info
    h = hashlib.sha256()
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"libh2l_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    t0 = time.perf_counter()
    jobs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, s], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(cu, objs)
    ]
    try:
        outs = [j.communicate(timeout=max(1.0, BUILD_TIMEOUT_S - (time.perf_counter() - t0)))[0] for j in jobs]
        failed = [(s, j.returncode, o) for s, j, o in zip(cu, jobs, outs) if j.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{s} ({rc}):\n{o}" for s, rc, o in failed))
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    finally:
        for j in jobs:
            if j.poll() is None:
                j.kill()
                j.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    ptxas_info = "".join(outs)
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = dll
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream(device: torch.device) -> int:
    """The current CUDA stream of `device` as a raw pointer (without
    building a torch.cuda.Stream: a few microseconds less a launch)."""
    return torch._C._cuda_getCurrentRawStream(_index(device))


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def launch(entry: str, device, *args) -> None:
    """Call the C entry point ``h2l_<entry>`` with `args` and the current
    stream of `device`, that device current while it launches (so a kernel
    given another card's tensors runs on that card, whichever is current),
    and raise if the launch failed."""
    with torch.cuda.device(_index(device)):
        rc = getattr(lib(), "h2l_" + entry)(*args, stream(device))
    check(rc, entry)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Validate the tensors a kernel receives: int32 field rows on one card,
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every input must lie on the same CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous int32 tensors")
