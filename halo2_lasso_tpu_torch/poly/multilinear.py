"""Dense multilinear extensions over the boolean hypercube (the port of
halo2_lasso_tpu/poly/multilinear.py).

An MLE over k variables is an (2^k, 8) field tensor; hypercube index b has
X_0 as its least-significant bit, as in the JAX package.

Three kernels live here. ``fold_all`` is the port of make_fold_all
(ops/pallas_field.py:293): one launch of csrc/fold.cu binds one variable of
every table of a list (the sumcheck state), its pointers and an int
challenge by value. ``fix_var_chain`` is the port of make_fix_var
(ops/pallas_field.py:250) redesigned: one launch of csrc/fix_var.cu binds
any number of variables of one table, highest or lowest first, optionally
keeping every step's quotient (MLE evaluation, the KZG quotient chain,
rotated evaluations). ``eq_xy`` writes the eq table in one launch of csrc/mont_chain.cu.
On a CUDA tensor each launches its kernel or raises; only CPU tensors take
``fold_all_plain`` / ``fix_var_chain_plain`` / ``eq_xy_plain``.

Rotations (halo2 ``Rotation`` over the bh cyclic order) are materialised by
an index gather (``rotate_evals``) or evaluated at the 2^distance rotated
points (``evaluate_for_rotation``); the verifier's recombination
(``rotation_eval``) runs on host ints.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube


def _pairs(t: torch.Tensor, last: bool):
    if last:
        h = t.shape[0] // 2
        return t[:h], t[h:]
    return t[0::2], t[1::2]


def fold_all_plain(
    spec: FieldSpec, tables: Sequence[torch.Tensor], x: torch.Tensor, last: bool = False
) -> List[torch.Tensor]:
    h = tables[0].shape[0] // 2
    lo = torch.cat([_pairs(t, last)[0] for t in tables])
    hi = torch.cat([_pairs(t, last)[1] for t in tables])
    out = F.add_plain(spec, F.mont_mul_plain(spec, F.sub_plain(spec, hi, lo), x), lo)
    return list(out.split(h))


FOLD_MAX_TABLES = 64  # csrc/fold.cu's tables a launch


def fold_all(spec: FieldSpec, tables: Sequence[torch.Tensor], x, last: bool = False,
             out: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Bind one variable of every (2h, 8) table to the challenge x, a host
    int or an (8,) tensor on the tables' device: out = (hi - lo) * x + lo,
    with (lo, hi) = (t[2i], t[2i+1]) for the lowest variable, or (t[i],
    t[i+h]) for the highest (``last``). On the card the table pointers and
    an int challenge travel by value, one launch for up to FOLD_MAX_TABLES
    tables. ``out``, a contiguous (len(tables), h, 8) int32 tensor on the
    tables' device, receives the bound tables."""
    tables = list(tables)
    by_value = not isinstance(x, torch.Tensor)
    n = tables[0].shape[0]
    if out is not None and (out.shape != (len(tables), n // 2, F.LIMBS) or out.dtype != torch.int32
                            or not out.is_contiguous() or out.device != tables[0].device):
        raise ValueError(f"fold_all: out must be a contiguous int32 ({len(tables)}, {n // 2}, {F.LIMBS}) tensor "
                         "on the tables' device")
    if tables[0].device.type == "cpu":
        bound = fold_all_plain(spec, tables, spec.encode([x])[0] if by_value else x, last)
        return bound if out is None else list(out.copy_(torch.stack(bound)).unbind(0))
    fid = native.field_id("fold_all", spec)
    if any(t.shape != (n, F.LIMBS) for t in tables) or n % 2:
        raise ValueError("fold_all: tables must share one even length")
    native.require_cuda("fold_all", *tables, *([] if by_value else [x]))
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("fold_all: tables must start on a 16-byte boundary")
    if by_value:
        x_host, x_dev = spec.to_mont_int(int(x) % spec.modulus).to_bytes(32, "little"), None
    elif x.shape != (F.LIMBS,):
        raise ValueError("fold_all: the challenge must be one (8,) element")
    else:
        x_host, x_dev = None, x.data_ptr()
    h = n // 2
    if out is None:
        out = torch.empty((len(tables), h, F.LIMBS), dtype=torch.int32, device=tables[0].device)
    for g in range(0, len(tables), FOLD_MAX_TABLES):
        ins = tables[g : g + FOLD_MAX_TABLES]
        ins_p = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
        native.launch(
            "fold_all", tables[0].device, fid, ctypes.addressof(ins_p), out.data_ptr() + g * h * 4 * F.LIMBS,
            len(ins), h, h if last else 1, x_host, x_dev,
        )
        native.count("fold_all", "fq" if fid == 1 else "")
    return list(out.unbind(0))


def fix_var_plain(spec: FieldSpec, evals: torch.Tensor, x: torch.Tensor, last: bool = False) -> torch.Tensor:
    lo, hi = _pairs(evals, last)
    return F.add_plain(spec, F.mont_mul_plain(spec, F.sub_plain(spec, hi, lo), x), lo)


def fix_var_chain_plain(spec: FieldSpec, evals: torch.Tensor, point: torch.Tensor, last: bool,
                        quotients: bool = False):
    """``fix_var_chain`` one variable a step: point (j, 8)."""
    j = point.shape[0]
    quots = []
    for s in range(j):
        lo, hi = _pairs(evals, last)
        if quotients:
            quots.append(F.sub_plain(spec, hi, lo))
        evals = fix_var_plain(spec, evals, point[j - 1 - s] if last else point[s], last)
    return evals, (torch.cat(quots[::-1] or [spec.zeros(0, evals.device)]) if quotients else None)


MAX_CHAIN_VARS = 32  # csrc/fix_var.cu's coordinates by value
TAIL_BITS = 10  # csrc/fix_var.cu: the tail's rows in one block's shared memory


def fix_var_chain(spec: FieldSpec, evals: torch.Tensor, point, last: bool, quotients: bool = False):
    """Bind j = len(point) variables of an (n, 8) table, n a multiple of 2^j:
    highest first (``last``, the KZG order; point[i] is variable k - j + i)
    or lowest first (point[i] is variable i). The point is j host ints (at
    most MAX_CHAIN_VARS, by value) or a (j, 8) tensor on the table's
    device. Returns (the (n / 2^j, 8) bound table, the quotients or None):
    with ``quotients`` (n = 2^j), each step's hi - lo packed in one
    (n - 1, 8) buffer, the 2^i quotients against variable i at rows
    [2^i - 1, 2^(i+1) - 1). Kernel: csrc/fix_var.cu, one launch, no host
    sync."""
    by_value = not isinstance(point, torch.Tensor)
    j = len(point)
    n = evals.shape[0]
    if evals.dim() != 2 or evals.shape[1] != F.LIMBS or evals.dtype != torch.int32:
        raise ValueError(f"fix_var_chain: the table must be int32 (n, {F.LIMBS}) rows")
    if j > MAX_CHAIN_VARS:
        raise ValueError(f"fix_var_chain: the kernel binds at most {MAX_CHAIN_VARS} variables")
    if n < 1 or n % (1 << j):
        raise ValueError(f"fix_var_chain: {n} rows do not split into 2^{j} (an odd length)")
    if quotients and n != 1 << j:
        raise ValueError("fix_var_chain: quotients need every variable bound")
    if not by_value and point.shape != (j, F.LIMBS):
        raise ValueError(f"fix_var_chain: the point must be ({j}, {F.LIMBS})")
    if evals.device.type == "cpu":
        return fix_var_chain_plain(spec, evals, spec.encode(list(point)) if by_value else point, last, quotients)
    if j == 0:
        return evals.clone(), (spec.zeros(0, evals.device) if quotients else None)
    native.require_cuda("fix_var", evals, *([] if by_value else [point]))
    fid = native.field_id("fix_var", spec)
    if evals.data_ptr() % 16:
        raise ValueError("fix_var_chain: the table must start on a 16-byte boundary")
    if by_value:
        x_host, x_dev = b"".join(spec.to_mont_int(int(v) % spec.modulus).to_bytes(32, "little") for v in point), None
    else:
        x_host, x_dev = None, point.data_ptr()
    device = evals.device
    out = torch.empty((n >> j, F.LIMBS), dtype=torch.int32, device=device)
    mid = torch.empty((min(n, 1 << TAIL_BITS), F.LIMBS), dtype=torch.int32, device=device)
    quot = torch.empty((n - 1, F.LIMBS), dtype=torch.int32, device=device) if quotients else None
    native.launch(
        "fix_var", device, fid, evals.data_ptr(), n, j, int(last), x_host, x_dev, mid.data_ptr(),
        None if quot is None else quot.data_ptr(), out.data_ptr(), native.ticket("fix_var", device).data_ptr(),
    )
    native.counts["fix_var"] += 1
    return out, quot


def chain_quotients(quot: torch.Tensor) -> List[torch.Tensor]:
    """The packed quotients of ``fix_var_chain`` as views, by variable."""
    k = (quot.shape[0] + 1).bit_length() - 1
    return [quot[(1 << i) - 1 : (1 << (i + 1)) - 1] for i in range(k)]


def eq_xy_plain(spec: FieldSpec, y: torch.Tensor) -> torch.Tensor:
    evals = spec.one(y.device)[None]
    for i in range(y.shape[0] - 1, -1, -1):
        hi = F.mont_mul_plain(spec, evals, y[i])
        lo = F.sub_plain(spec, evals, hi)
        evals = torch.stack([lo, hi], dim=1).reshape(-1, F.LIMBS)
    return evals


MAX_EQ_VARS = 32  # csrc/mont_chain.cu's coordinates by value


def eq_xy(spec: FieldSpec, y, device=None) -> torch.Tensor:
    """eq(X, y) over 2^k points; index bit i pairs with y_i (the doubling
    expansion from the last variable, multilinear.rs:91-127). ``y`` is a
    (k, 8) tensor, or k host ints with the ``device`` to build on. Kernel:
    csrc/mont_chain.cu, one launch; host ints travel by value, so nothing
    is copied to the card."""
    by_value = not isinstance(y, torch.Tensor)
    if not by_value:
        device = y.device
    elif device is None:
        raise ValueError("eq_xy: give the device for a point of host ints")
    if torch.device(device).type == "cpu":
        return eq_xy_plain(spec, spec.encode(list(y)) if by_value else y)
    fid = native.field_id("eq_xy", spec)
    k = len(y)
    if k > MAX_EQ_VARS:
        raise ValueError(f"eq_xy: the kernel takes at most {MAX_EQ_VARS} variables")
    if by_value:
        y_host = b"".join(spec.to_mont_int(int(v) % spec.modulus).to_bytes(32, "little") for v in y) or None
        y_dev = None
    else:
        if y.shape != (k, F.LIMBS):
            raise ValueError("eq_xy: the point must be (k, 8)")
        native.require_cuda("eq_xy", y)
        y_host, y_dev = None, y.data_ptr()
    out = torch.empty((1 << k, F.LIMBS), dtype=torch.int32, device=device)
    native.launch("eq_xy", out.device, fid, y_host, y_dev, k, out.data_ptr())
    native.counts["eq_xy"] += 1
    return out


def evaluate(spec: FieldSpec, evals: torch.Tensor, x) -> torch.Tensor:
    """Evaluate the MLE at x, a (k, 8) tensor or k host ints -> (8,): one
    fix_var_chain launch."""
    assert evals.shape[0] == 1 << len(x)
    return fix_var_chain(spec, evals, x, last=False)[0][0]


def evaluate_stacked_ints(spec: FieldSpec, polys: Sequence[torch.Tensor], x: Sequence[int]) -> list:
    """Evaluate many same-size MLEs at one point (host ints) -> canonical
    ints, one fold launch per variable for all of them and one pull."""
    if not polys:
        return []
    cur = list(polys)
    for xi in x:
        cur = fold_all(spec, cur, int(xi))
    return spec.decode_ints(torch.cat(cur))


def evaluate_many(spec: FieldSpec, evals: torch.Tensor, xs) -> torch.Tensor:
    """Evaluate one MLE at many points, xs (m, k, 8) or m lists of k host
    ints -> (m, 8): one launch a point."""
    return torch.stack([evaluate(spec, evals, x) for x in xs])


# ---------------------------------------------------------------------------
# MLE wrapper
# ---------------------------------------------------------------------------


class MLE:
    """Thin wrapper (the port of halo2_lasso_tpu/poly/multilinear.py:181):
    (2^k, 8) Montgomery evals on a device and their field; ops return new
    MLEs. ``from_ints`` puts the evals on the card unless the caller asks
    for the CPU."""

    __slots__ = ("spec", "evals", "num_vars")

    def __init__(self, spec: FieldSpec, evals: torch.Tensor):
        n = evals.shape[0]
        if n & (n - 1) or n == 0 or evals.shape[1:] != (F.LIMBS,):
            raise ValueError("MLE: evals must be (2^k, 8) field rows")
        self.spec = spec
        self.num_vars = n.bit_length() - 1
        self.evals = evals

    @staticmethod
    def from_ints(spec: FieldSpec, values: Sequence[int], device="cuda") -> "MLE":
        return MLE(spec, spec.encode(list(values), device))

    @property
    def device(self) -> torch.device:
        return self.evals.device

    def to_ints(self) -> List[int]:
        return self.spec.decode_ints(self.evals)

    def evaluate_ints(self, x: Sequence[int]) -> int:
        """The MLE at the host point x, as a canonical int (one
        ``fix_var_chain`` launch on the card)."""
        return self.spec.decode_ints(evaluate(self.spec, self.evals, [int(v) for v in x])[None])[0]


# ---------------------------------------------------------------------------
# host-side scalar helpers (python ints mod p) — verifier-domain math
# ---------------------------------------------------------------------------


def lagrange_eval_host(p: int, x: Sequence[int], b: int) -> int:
    """prod_i (x_i if b_i else 1-x_i)  (piop/sum_check.rs:100-110)."""
    acc = 1
    for i, xi in enumerate(x):
        acc = acc * (xi if (b >> i) & 1 else (1 - xi) % p) % p
    return acc


def eq_xy_eval_host(p: int, x: Sequence[int], y: Sequence[int]) -> int:
    """prod_i (2 x_i y_i + 1 - x_i - y_i)  (piop/sum_check.rs:112-122)."""
    acc = 1
    for xi, yi in zip(x, y):
        acc = acc * ((2 * xi * yi + 1 - xi - yi) % p) % p
    return acc


def identity_eval_host(p: int, x: Sequence[int]) -> int:
    """sum_i x_i * 2^i  (piop/sum_check.rs:124-126)."""
    acc = 0
    for i, xi in enumerate(x):
        acc = (acc + (xi << i)) % p
    return acc


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


def _nth_bit(v: int, n: int) -> int:
    return (v >> n) & 1


def rotation_eval_point_pattern(next_: bool, num_vars: int, distance: int) -> List[int]:
    """Index patterns for the 2^distance rotated-evaluation points
    (multilinear.rs:472-494 semantics)."""
    bh = BooleanHypercube(num_vars)
    remainder = bh.primitive if next_ else bh.x_inv
    pattern = [0] * (1 << distance)
    for depth in range(distance):
        step = 1 << (distance - depth)
        half = step >> 1
        for e in range(0, len(pattern), step):
            o = e + half
            rotated = (pattern[e] << 1) if next_ else (pattern[e] >> 1)
            pattern[o] = rotated ^ remainder
            pattern[e] = rotated
    return pattern


def rotation_eval_coeff_pattern(next_: bool, num_vars: int, distance: int) -> List[int]:
    """Bit patterns steering the verifier recombination
    (multilinear.rs:496-518 semantics)."""
    bh = BooleanHypercube(num_vars)
    remainder = (bh.primitive - (1 << num_vars)) if next_ else (bh.x_inv << distance)
    pattern = [0] * (1 << (distance - 1))
    for depth in range(distance - 1):
        step = 1 << (distance - depth - 1)
        half = step >> 1
        for e in range(0, len(pattern), step):
            o = e + half
            rotated = (pattern[e] << 1) if next_ else (pattern[e] >> 1)
            pattern[o] = rotated ^ remainder
            pattern[e] = rotated
    return pattern


def rotation_eval_points(p: int, x: Sequence[int], rotation: int) -> List[List[int]]:
    """The 2^distance points whose evaluations determine f(rot(x))
    (multilinear.rs:472-530 semantics); host ints mod p."""
    if rotation == 0:
        return [list(x)]
    distance = abs(rotation)
    num_x = len(x) - distance
    if rotation < 0:
        pattern = rotation_eval_point_pattern(False, len(x), distance)
        xs = list(x[distance:])
        flipped = [(1 - xi) % p for xi in xs]
        points = []
        for pat in pattern:
            pt = [flipped[i] if _nth_bit(pat, i) else xs[i] for i in range(num_x)]
            pt += [_nth_bit(pat, i + num_x) for i in range(distance)]
            points.append(pt)
        return points
    pattern = rotation_eval_point_pattern(True, len(x), distance)
    xs = list(x[:num_x])
    flipped = [(1 - xi) % p for xi in xs]
    points = []
    for pat in pattern:
        pt = [_nth_bit(pat, i) for i in range(distance)]
        pt += [flipped[i] if _nth_bit(pat, i + distance) else xs[i] for i in range(num_x)]
        points.append(pt)
    return points


def rotation_eval(p: int, x: Sequence[int], rotation: int, evals_for_rotation: Sequence[int]) -> int:
    """Recombine the 2^distance point-evaluations into f(rot(x))
    (multilinear.rs:433-470 semantics); host ints mod p."""
    if rotation == 0:
        assert len(evals_for_rotation) == 1
        return evals_for_rotation[0] % p
    num_vars = len(x)
    distance = abs(rotation)
    assert len(evals_for_rotation) == 1 << distance
    assert distance <= num_vars

    if rotation < 0:
        pattern = rotation_eval_coeff_pattern(False, num_vars, distance)
        nths = list(range(distance, 0, -1))
        xs = [x[i] for i in range(distance - 1, -1, -1)]
    else:
        pattern = rotation_eval_coeff_pattern(True, num_vars, distance)
        nths = [num_vars - 1 + i for i in range(distance)]
        xs = [x[num_vars - distance + i] for i in range(distance)]

    evals = [v % p for v in evals_for_rotation]
    for idx, (x_i, nth) in enumerate(zip(xs, nths)):
        pats = pattern[:: 1 << idx]
        new_evals = []
        for j in range(0, len(evals), 2):
            e0, e1 = evals[j], evals[j + 1]
            if _nth_bit(pats[j // 2], nth):
                new_evals.append(((e0 - e1) * x_i + e1) % p)
            else:
                new_evals.append(((e1 - e0) * x_i + e0) % p)
        evals = new_evals
    return evals[0]


def evaluate_for_rotation(
    spec: FieldSpec, evals: torch.Tensor, x: Sequence[int], rotation: int
) -> List[int]:
    """Evaluations of the MLE at the 2^distance rotated points, as host ints
    (multilinear.rs:191-263 semantics), one chain launch a point, its
    coordinates by value."""
    pts = rotation_eval_points(spec.modulus, list(x), rotation)
    return spec.decode_ints(evaluate_many(spec, evals, pts))


def rotate_evals(spec: FieldSpec, evals: torch.Tensor, rotation: int) -> torch.Tensor:
    """Materialise the rotated poly: out[b] = evals[rotate(b, rotation)]
    (the round-0 gather of classic.rs:104-129), one index gather on the
    tensor's device."""
    k = evals.shape[0].bit_length() - 1
    rmap = torch.from_numpy(BooleanHypercube(k).rotation_map(rotation)).to(evals.device)
    return evals.index_select(0, rmap)
