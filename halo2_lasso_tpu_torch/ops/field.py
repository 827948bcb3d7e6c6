"""Prime-field arithmetic on torch tensors.

Layout (the port's one field layout, see the package docstring): an element
is a row of 8 little-endian 32-bit limbs held in ``torch.int32`` storage
(the bit pattern of ``uint32``), shape ``(..., 8)``, in Montgomery form with
R = 2^256 and always fully reduced into [0, p). The JAX package keeps the
same 256-bit numbers as 16 limbs of 16 bits (``ops/field.py:86``), so
``from_jax_limbs`` / ``to_jax_limbs`` are a repack, not a bigint decode.

The plain versions compute on 16-bit limbs in ``int64``, where every product
and lazy column sum fits exactly (torch has no general ``uint32`` arithmetic
on the CPU); their carry pass (``_norm``) loops until no carry is left,
reading a flag back from the tensor's device each pass. ``mont_mul``,
``mul_add``, ``add``, ``sub`` and ``neg`` launch ``csrc/mont_mul.cu``'s
elementwise kernel, one launch each, with any operand but the first a
tensor (broadcast rows are read in place) or a host int (by value);
``sum_reduce`` launches its row sum; ``pow_fixed``, ``prefix_products`` and
``batch_inv`` launch ``csrc/mont_chain.cu``, a fixed number of launches
each, whatever the length. On a CUDA tensor each launches its kernel or
raises; only a CPU tensor takes the plain version (``*_plain``).
``norm_on_card`` counts the plain carry passes run on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Union

import numpy as np
import torch

from halo2_lasso_tpu_torch.ops import native

LIMBS = 8  # 32-bit limbs per element
_M16 = 0xFFFF


def ints_to_u32(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> uint32 (n, 8) little-endian limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, LIMBS).astype(np.uint32)


def u32_to_ints(arr: np.ndarray) -> list:
    buf = np.ascontiguousarray(arr, dtype="<u4").tobytes()
    return [int.from_bytes(buf[i : i + 32], "little") for i in range(0, len(buf), 32)]


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def from_numpy_u32(arr: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def from_jax_limbs(arr, device="cpu") -> torch.Tensor:
    """JAX package limbs (uint32[..., 16], 16-bit) -> port tensor int32[..., 8]."""
    a = np.asarray(arr).astype(np.uint32)
    return from_numpy_u32(a[..., 0::2] | (a[..., 1::2] << np.uint32(16)), device)


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """Port tensor int32[..., 8] -> JAX package limbs uint32[..., 16]."""
    a = to_numpy_u32(t)
    out = np.empty(a.shape[:-1] + (2 * LIMBS,), np.uint32)
    out[..., 0::2] = a & np.uint32(_M16)
    out[..., 1::2] = a >> np.uint32(16)
    return out


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field in the port's Montgomery layout. ``kernel_id`` selects
    the modulus compiled into the CUDA kernels (0 = BN254 Fr, 1 = BN254 Fq,
    2 = Pallas' base field, 3 = Vesta's; csrc/field.cuh); None for a field
    that has no kernel (host arithmetic and CPU tensors only). A kernel
    wrapper given a CUDA tensor of a field its kernel has no instance for
    raises (``native.field_id``): K4's elementwise op, power and scan and
    K3 have all four, the other kernels BN254's two."""

    name: str
    modulus: int
    kernel_id: Optional[int]

    def __post_init__(self):
        p = self.modulus
        R = 1 << (32 * LIMBS)
        object.__setattr__(self, "R", R % p)
        object.__setattr__(self, "R2", R * R % p)
        object.__setattr__(self, "Rinv", pow(R, -1, p))
        object.__setattr__(self, "npr16", (-pow(p, -1, 1 << 16)) % (1 << 16))
        object.__setattr__(self, "num_bits", p.bit_length())

    def to_mont_int(self, x: int) -> int:
        return x * self.R % self.modulus

    def from_mont_int(self, x: int) -> int:
        return x * self.Rinv % self.modulus

    def encode(self, values, device="cpu") -> torch.Tensor:
        """Canonical ints (any shape) -> Montgomery tensor (..., 8)."""
        arr = np.asarray(values, dtype=object)
        flat = [self.to_mont_int(int(v) % self.modulus) for v in arr.reshape(-1)]
        out = from_numpy_u32(ints_to_u32(flat), device)
        return out.reshape(arr.shape + (LIMBS,))

    def canonical_limbs(self, values) -> np.ndarray:
        """Ints (any shape) -> uint32 (..., 8) canonical limbs, vectorised
        (the port of halo2_lasso_tpu/ops/field.py:116; pair it with
        ``encode_dev`` for the Montgomery conversion on the device). A
        machine-integer array takes a pure numpy path through uint64, as the
        JAX package's does, so a negative int64 x becomes 2^64 + x, not
        x mod p; Python ints and object arrays are reduced mod p and cut
        into limbs through one byte buffer."""
        arr = np.asarray(values)
        if arr.dtype != object and np.issubdtype(arr.dtype, np.integer):
            v = arr.astype(np.uint64)
            out = np.zeros(arr.shape + (LIMBS,), np.uint32)
            out[..., 0] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            out[..., 1] = (v >> np.uint64(32)).astype(np.uint32)
            return out
        flat = np.asarray(values, dtype=object).reshape(-1)
        p = self.modulus
        buf = b"".join(int(v % p).to_bytes(4 * LIMBS, "little") for v in flat)
        return np.frombuffer(buf, dtype="<u4").astype(np.uint32).reshape(arr.shape + (LIMBS,))

    def decode(self, t: torch.Tensor) -> np.ndarray:
        """Montgomery tensor (..., 8) -> object array of canonical ints."""
        ints = u32_to_ints(to_numpy_u32(t).reshape(-1, LIMBS))
        out = np.empty(len(ints), dtype=object)
        for i, v in enumerate(ints):
            out[i] = self.from_mont_int(v)
        return out.reshape(tuple(t.shape[:-1]))

    def decode_ints(self, t: torch.Tensor) -> list:
        return [int(v) for v in self.decode(t).reshape(-1)]

    def one(self, device="cpu") -> torch.Tensor:
        return _const(self, "one", str(device))

    def zeros(self, n: int, device="cpu") -> torch.Tensor:
        return torch.zeros((n, LIMBS), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _const(spec: FieldSpec, what: str, device: str) -> torch.Tensor:
    if what == "p16":
        p = spec.modulus
        return torch.tensor([(p >> (16 * i)) & _M16 for i in range(16)], dtype=torch.int64, device=device)
    val = {"one": spec.R, "r2": spec.R2, "canon_one": 1}[what]
    return from_numpy_u32(ints_to_u32([val])[0], device)


# ---------------------------------------------------------------------------
# plain versions on 16-bit limbs in int64
# ---------------------------------------------------------------------------


def _split(a: torch.Tensor) -> torch.Tensor:
    """int32 (..., 8) -> int64 (..., 16) 16-bit limbs."""
    a = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([a & _M16, a >> 16], dim=-1).flatten(-2)


def _join(t: torch.Tensor) -> torch.Tensor:
    """Normalized int64 (..., 16) -> int32 (..., 8)."""
    t = t.unflatten(-1, (LIMBS, 2))
    v = t[..., 0] | (t[..., 1] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


norm_on_card = 0  # plain carry passes run on a CUDA tensor (each reads the card back)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Resolve lazy (possibly negative) limbs of a non-negative number."""
    global norm_on_card
    if v.is_cuda:
        norm_on_card += 1
    v = v.clone()
    while True:
        c = v[..., :-1] >> 16
        if not bool(c.any()):
            return v
        v[..., :-1] -= c << 16
        v[..., 1:] += c


def _geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b for normalized limb arrays (broadcasting)."""
    d = a - b
    idx = ((d != 0) * torch.arange(d.shape[-1], device=d.device)).amax(-1, keepdim=True)
    return d.gather(-1, idx).squeeze(-1) >= 0


def _p16(spec: FieldSpec, device) -> torch.Tensor:
    return _const(spec, "p16", str(device))


# CPU tensors of at most this many elements take the plain ops in host
# ints: the limb programs below cost a fixed ~1 ms a product in torch op
# overhead, which the scalar ladders and small proofs of the CPU path pay
# hundreds of thousands of times; a CUDA tensor always takes the limb
# program (the kernels' oracle)
HOST_PLAIN_ROWS = 64


def _host_plain(spec: FieldSpec, fn, *ts: torch.Tensor) -> Optional[torch.Tensor]:
    """fn over the canonical ints of each element of the broadcast CPU
    tensors, when they are small enough (else None)."""
    if any(t.device.type != "cpu" for t in ts):
        return None
    ts = torch.broadcast_tensors(*ts)
    shape = ts[0].shape
    if math.prod(shape[:-1]) > HOST_PLAIN_ROWS:
        return None
    cols = [u32_to_ints(to_numpy_u32(t).reshape(-1, LIMBS)) for t in ts]
    p = spec.modulus
    return from_numpy_u32(ints_to_u32([fn(p, *xs) for xs in zip(*cols)])).reshape(shape)


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r = _host_plain(spec, lambda p, x, y: (x + y) % p, a, b)
    if r is not None:
        return r
    p16 = _p16(spec, a.device)
    s = _norm(_split(a) + _split(b))
    return _join(_norm(s - _geq(s, p16)[..., None] * p16))


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r = _host_plain(spec, lambda p, x, y: (x - y) % p, a, b)
    if r is not None:
        return r
    A, B = torch.broadcast_tensors(_split(a), _split(b))
    lt = ~_geq(A, B)
    return _join(_norm(A - B + lt[..., None] * _p16(spec, a.device)))


def neg_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    r = _host_plain(spec, lambda p, x: -x % p, a)
    if r is not None:
        return r
    A = _split(a)
    nz = A.any(-1, keepdim=True)
    return _join(_norm(nz * _p16(spec, a.device) - A))


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod p: schoolbook over 16-bit limbs, then
    limb-by-limb Montgomery reduction with -p^-1 mod 2^16. Columns stay
    below 2^38, exact in int64. Limb-major (16, n) so every row update is
    one contiguous slice."""
    r = _host_plain(spec, lambda p, x, y: x * y * spec.Rinv % p, a, b)
    if r is not None:
        return r
    A, B = torch.broadcast_tensors(_split(a), _split(b))
    shape = A.shape[:-1]
    A = A.reshape(-1, 16).T.contiguous()
    B = B.reshape(-1, 16).T.contiguous()
    t = torch.zeros((33, A.shape[1]), dtype=torch.int64, device=A.device)
    for i in range(16):
        t[i : i + 16] += A[i] * B
    p16 = _p16(spec, A.device)
    pcol = p16[:, None]
    for i in range(16):
        m = (t[i] * spec.npr16) & _M16
        t[i : i + 16] += m * pcol
        t[i + 1] += t[i] >> 16
    p17 = torch.cat([p16, p16.new_zeros(1)])
    r = _norm(t[16:].T)
    r = _norm(r - _geq(r, p17)[..., None] * p17)
    return _join(r[..., :16]).reshape(shape + (LIMBS,))


# csrc/mont_mul.cu's op codes and the operands each reads
EW_MUL, EW_MUL_ADD, EW_MUL_SUB, EW_ADD, EW_SUB, EW_NEG = range(6)
_EW_ARGS = (2, 3, 3, 2, 2, 1)
_PTRS3, _STRIDES6, _ZERO_ROW = ctypes.c_void_p * 3, ctypes.c_longlong * 6, bytes(32)
Operand = Union[torch.Tensor, int]


def _ew_plain(spec: FieldSpec, op: int, a, b=None, c=None) -> torch.Tensor:
    if op == EW_NEG:
        return neg_plain(spec, a)
    if op in (EW_ADD, EW_SUB):
        return (add_plain if op == EW_ADD else sub_plain)(spec, a, b)
    ab = mont_mul_plain(spec, a, b)
    if op == EW_MUL:
        return ab
    return (add_plain if op == EW_MUL_ADD else sub_plain)(spec, ab, c)


def _grid_strides(t: torch.Tensor):
    """t's rows over csrc/mont_mul.cu's (outer, inner) grid: (s0, s1) row
    strides, the inner index the last leading dim and the outer one the
    others merged; None where the strides cannot say it."""
    if t.data_ptr() % 16:
        return None
    if t.is_contiguous():
        return (t.shape[-2] if t.dim() > 2 else 0), 1
    lead, st = t.shape[:-1], t.stride()
    if st[-1] != 1 or any(s % LIMBS for s in st[:-1]):
        return None
    if not lead:
        return 0, 0
    rows = [(n, s // LIMBS) for n, s in zip(lead[:-1], st[:-1]) if n != 1]
    if any(s != s1 * n1 for (_, s), (n1, s1) in zip(rows, rows[1:])):
        return None
    return (rows[-1][1] if rows else 0), st[-2] // LIMBS


def _ew(spec: FieldSpec, op: int, a: torch.Tensor, b: Optional[Operand] = None, c: Optional[Operand] = None,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of csrc/mont_mul.cu's elementwise kernel, or its plain
    version on the CPU. ``a`` is a tensor of rows; ``b`` and ``c`` a tensor
    (broadcast against the others, read in place) or a host int (by value).
    The output has the broadcast shape; ``out``, a contiguous tensor of that
    shape, receives it."""
    args = [a, b, c][: _EW_ARGS[op]]
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    if not isinstance(a, torch.Tensor) or any(x is None for x in args):
        raise ValueError("field op: the first operand must be a tensor, and every operand given")
    if any(t.dtype != torch.int32 or t.dim() < 1 or t.shape[-1] != LIMBS for t in tensors):
        raise ValueError(f"field op: operands must be int32 (..., {LIMBS}) field rows")
    shape = a.shape if all(t.shape == a.shape for t in tensors) else torch.broadcast_shapes(*(t.shape for t in tensors))
    if out is not None and (out.shape != shape or out.dtype != torch.int32 or not out.is_contiguous()):
        raise ValueError(f"field op: out must be a contiguous int32 tensor of shape {tuple(shape)}")
    device = a.device
    if device.type == "cpu":
        r = _ew_plain(spec, op, *(x if isinstance(x, torch.Tensor) else spec.encode([x])[0] for x in args))
        return r if out is None else out.copy_(r)
    if any(not t.is_cuda or t.device != device for t in tensors + ([] if out is None else [out])):
        raise ValueError("field op: every tensor must lie on the same CUDA device")
    fid = native.field_id("mont_mul", spec)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=device)
    lead = shape[:-1]
    inner = lead[-1] if lead else 1
    outer = math.prod(lead[:-1])
    ptrs, strides, vals, keep = [], [], [], []
    for x in args + [0] * (3 - len(args)):
        if isinstance(x, torch.Tensor):
            if x.shape != shape:
                x = x.expand(shape)
            st = _grid_strides(x)
            if st is None:
                x = x.contiguous()
                st = _grid_strides(x)
            keep.append(x)
            ptrs.append(x.data_ptr())
            strides += st
            vals.append(_ZERO_ROW)
        else:
            ptrs.append(None)
            strides += (0, 0)
            vals.append(spec.to_mont_int(int(x) % spec.modulus).to_bytes(32, "little"))
    if outer * inner:
        native.launch(
            "mont_mul", device, fid, op, _PTRS3(*ptrs), _STRIDES6(*strides), b"".join(vals), out.data_ptr(),
            outer, inner,
        )
        native.count("mont_mul", native.PASTA.get(fid, ""))
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: Operand, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise Montgomery product a * b; ``b`` a tensor (broadcast, e.g.
    one (8,) element) or a host int. Kernel: csrc/mont_mul.cu (port of
    pallas_field.make_mont_mul)."""
    return _ew(spec, EW_MUL, a, b, out=out)


def mul_add(spec: FieldSpec, a: torch.Tensor, b: Operand, c: Operand, sub: bool = False) -> torch.Tensor:
    """a * b + c (a * b - c with ``sub``) in one launch of csrc/mont_mul.cu."""
    return _ew(spec, EW_MUL_SUB if sub else EW_MUL_ADD, a, b, c)


def add(spec: FieldSpec, a: torch.Tensor, b: Operand) -> torch.Tensor:
    """a + b in one launch of csrc/mont_mul.cu (field.cuh's carry chain)."""
    return _ew(spec, EW_ADD, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: Operand) -> torch.Tensor:
    """a - b in one launch of csrc/mont_mul.cu."""
    return _ew(spec, EW_SUB, a, b)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a in one launch of csrc/mont_mul.cu."""
    return _ew(spec, EW_NEG, a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, _const(spec, "r2", str(a.device)))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, _const(spec, "canon_one", str(a.device)))


def encode_dev(spec: FieldSpec, values, device="cpu") -> torch.Tensor:
    """Ints (any shape) -> Montgomery tensor (..., 8) on `device`: canonical
    limbs cut on the host (``FieldSpec.canonical_limbs``), then one product
    by R^2 on the device, one launch of csrc/mont_mul.cu on a CUDA tensor
    (the port of halo2_lasso_tpu/ops/field.py:362). The same limbs as
    ``spec.encode``, without its per-element loop."""
    return to_mont(spec, from_numpy_u32(spec.canonical_limbs(values), device))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def u32_to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Small non-negative integers (..., ) -> Montgomery elements (..., 8)."""
    x = x.to(torch.int64)
    limbs = torch.zeros(x.shape + (LIMBS,), dtype=torch.int64, device=x.device)
    limbs[..., 0] = x & 0xFFFFFFFF
    limbs = torch.where(limbs >= 1 << 31, limbs - (1 << 32), limbs).to(torch.int32)
    return to_mont(spec, limbs)


def pow_fixed_plain(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    result = spec.one(a.device).expand(a.shape).contiguous()
    base = a
    while exponent:
        if exponent & 1:
            result = mont_mul_plain(spec, result, base)
        exponent >>= 1
        if exponent:
            base = mont_mul_plain(spec, base, base)
    return result


def prefix_products_plain(spec: FieldSpec, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix products of the rows of (n, 8) (from the last row
    when ``reverse``): a log-depth Hillis-Steele scan, one plain product
    per level."""
    if reverse:
        return prefix_products_plain(spec, x.flip(0)).flip(0)
    k = 1
    while k < x.shape[0]:
        x = torch.cat([x[:k], mont_mul_plain(spec, x[k:], x[:-k])])
        k *= 2
    return x


def batch_inv_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    zero = is_zero(a)
    one = spec.one(a.device)
    aa = torch.where(zero[:, None], one, a)
    pre = prefix_products_plain(spec, aa)
    suf = prefix_products_plain(spec, aa, reverse=True)
    total_inv = pow_fixed_plain(spec, pre[-1:], spec.modulus - 2)
    pre_ex = torch.cat([one[None], pre[:-1]])
    suf_ex = torch.cat([suf[1:], one[None]])
    out = mont_mul_plain(spec, mont_mul_plain(spec, pre_ex, suf_ex), total_inv.expand_as(pre_ex))
    return torch.where(zero[:, None], torch.zeros_like(out), out)


# csrc/mont_chain.cu's compiled limits and tile (tests/test_torch_csrc.py
# holds them equal)
MAX_POW_WORDS = 8
SCAN_TILE = 1024


@functools.lru_cache(maxsize=None)
def _exponent(e: int):
    """(the exponent's 8 words as a host array, its bit length)."""
    if not 0 <= e < 1 << (32 * MAX_POW_WORDS):
        raise ValueError(f"pow_fixed: the kernel takes exponents below 2^{32 * MAX_POW_WORDS}")
    return np.ascontiguousarray(ints_to_u32([e])[0]), e.bit_length()


def _rows(name: str, a: torch.Tensor) -> int:
    """Check a kernel's (n, 8) field rows on the card; returns n."""
    if a.dim() != 2 or a.shape[1] != LIMBS:
        raise ValueError(f"{name}: expected (n, {LIMBS}) field rows, got {tuple(a.shape)}")
    native.require_cuda(name, a)
    if a.data_ptr() % 16:
        raise ValueError(f"{name}: rows must start on a 16-byte boundary")
    return a.shape[0]


def pow_fixed(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent for every row of (n, 8). Kernel: csrc/mont_chain.cu, one
    launch (the port of the fori_loop in halo2_lasso_tpu/ops/field.py:387)."""
    if a.device.type == "cpu":
        return pow_fixed_plain(spec, a, exponent)
    n = _rows("mont_pow", a)
    fid = native.field_id("mont_pow", spec)
    words, nbits = _exponent(exponent)
    out = torch.empty_like(a)
    if n:
        native.launch("mont_pow", a.device, fid, a.data_ptr(), out.data_ptr(), n, words.ctypes.data, nbits)
        native.count("mont_pow", native.PASTA.get(fid, ""))
    return out


def prefix_products(spec: FieldSpec, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix products of the rows of (n, 8), from the last row
    when ``reverse``. Kernel: csrc/mont_chain.cu's scan, 1 launch up to
    SCAN_TILE rows, else 3."""
    if x.device.type == "cpu":
        return prefix_products_plain(spec, x, reverse)
    n = _rows("prefix_products", x)
    fid = native.field_id("prefix_products", spec)
    out = torch.empty_like(x)
    if n:
        nb = -(-n // SCAN_TILE)
        scratch = torch.empty((3 * nb + 2, LIMBS), dtype=torch.int32, device=x.device)
        native.launch(
            "prefix_products", x.device, fid, x.data_ptr(), out.data_ptr(), n, int(reverse), scratch.data_ptr(),
        )
        native.count("prefix_products", native.PASTA.get(fid, ""), 1 if nb == 1 else 3)
    return out


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Invert every row of (n, 8) (zeros stay zero): prefix and suffix
    products and ONE Fermat inversion, as ops/field.py:416 does. Kernel:
    csrc/mont_chain.cu, the scan's phases around one mont_pow (3 launches
    up to SCAN_TILE rows, else 4), no host sync."""
    if a.device.type == "cpu":
        return batch_inv_plain(spec, a)
    n = _rows("batch_inv", a)
    fid = native.field_id("batch_inv", spec)
    words, nbits = _exponent(spec.modulus - 2)
    out = torch.empty_like(a)
    if n:
        nb = -(-n // SCAN_TILE)
        scratch = torch.empty((3 * nb + 2, LIMBS), dtype=torch.int32, device=a.device)
        native.launch(
            "batch_inv", a.device, fid, a.data_ptr(), out.data_ptr(), n, scratch.data_ptr(), words.ctypes.data, nbits,
        )
        instance = native.PASTA.get(fid, "")
        native.count("prefix_products", instance, 2 if nb == 1 else 3)
        native.count("mont_pow", instance)
    return out


def sum_reduce_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Field sum over axis 0 by a pairwise tree of adds."""
    while a.shape[0] > 1:
        if a.shape[0] % 2:
            a = torch.cat([a, torch.zeros_like(a[:1])])
        a = add_plain(spec, a[0::2], a[1::2])
    return a[0]


# csrc/mont_mul.cu's row sum: threads a block, and blocks a column at most
SUM_THREADS = 256
SUM_MAX_BLOCKS = 256


def sum_reduce(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Field sum over axis 0: (n, 8) -> (8,), or (n, *cols, 8) -> (*cols, 8)
    for every column at once. Kernel: csrc/mont_mul.cu's row sum, one
    launch, strided rows read in place, no host sync."""
    if a.dtype != torch.int32 or a.dim() < 2 or a.shape[-1] != LIMBS or a.shape[0] < 1:
        raise ValueError(f"sum_reduce: expected int32 (n, ..., {LIMBS}) field rows with n >= 1")
    if a.device.type == "cpu":
        return sum_reduce_plain(spec, a)
    if not a.is_cuda:
        raise ValueError("sum_reduce: the rows must lie on the CPU or a CUDA device")
    fid = native.field_id("sum_reduce", spec)
    n, cols = a.shape[0], a.shape[1:-1]
    m = math.prod(cols)
    if m > 65535:
        raise ValueError("sum_reduce: at most 65535 columns")
    out = torch.empty((m, LIMBS), dtype=torch.int32, device=a.device)
    if m == 0:
        return out.reshape(cols + (LIMBS,))
    t = a.reshape(n, m, LIMBS)  # (rows, columns): a view wherever the strides allow
    if _grid_strides(t) is None:
        t = t.contiguous()
    nb = max(1, min(-(-n // (4 * SUM_THREADS)), SUM_MAX_BLOCKS // m))
    partials = torch.empty((m * nb if nb > 1 else 0, LIMBS), dtype=torch.int32, device=a.device)
    native.launch(
        "sum_reduce", a.device, fid, t.data_ptr(), n, m, t.stride(0) // LIMBS, t.stride(1) // LIMBS, nb,
        partials.data_ptr(), native.ticket("sum_reduce", a.device).data_ptr(), out.data_ptr(),
    )
    native.counts["sum_reduce"] += 1
    return out.reshape(cols + (LIMBS,))
