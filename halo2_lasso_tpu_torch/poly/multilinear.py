"""Dense multilinear extensions over the boolean hypercube (the port of
halo2_lasso_tpu/poly/multilinear.py).

An MLE over k variables is an (2^k, 8) field tensor; hypercube index b has
X_0 as its least-significant bit, as in the JAX package.

``fold_all`` is the port of the TPU kernel make_fold_all
(ops/pallas_field.py:293): one launch of csrc/fold.cu binds one variable of
every table of a list. On a CUDA tensor it launches the kernel or raises;
only CPU tensors take ``fold_all_plain``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.field import FieldSpec


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
    out = F.add(spec, F.mont_mul(spec, F.sub(spec, hi, lo), x), lo)
    return list(out.split(h))


def fold_all(
    spec: FieldSpec, tables: Sequence[torch.Tensor], x: torch.Tensor, last: bool = False
) -> List[torch.Tensor]:
    """Bind one variable of every (2h, 8) table to the challenge x (8,):
    out = (hi - lo) * x + lo, with (lo, hi) = (t[2i], t[2i+1]) for the lowest
    variable, or (t[i], t[i+h]) for the highest (``last``)."""
    tables = list(tables)
    if tables[0].device.type == "cpu":
        return fold_all_plain(spec, tables, x, last)
    if spec.kernel_id != 0:
        raise ValueError("fold_all: the kernel is compiled for Fr only")
    n = tables[0].shape[0]
    if any(t.shape != (n, F.LIMBS) for t in tables) or n % 2:
        raise ValueError("fold_all: tables must share one even length")
    native.require_cuda("fold_all", x, *tables)
    h = n // 2
    outs = [torch.empty((h, F.LIMBS), dtype=torch.int32, device=x.device) for _ in tables]
    ins_p = native.pointer_table(tables, x.device)
    outs_p = native.pointer_table(outs, x.device)
    rc = native.lib().h2l_fold_all(
        ins_p.data_ptr(), outs_p.data_ptr(), len(tables), h, h if last else 1,
        x.data_ptr(), native.stream(),
    )
    native.check(rc, "fold_all")
    native.counts["fold_all"] += 1
    return outs


def fix_var(spec: FieldSpec, evals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fix X_0 := x: (n, 8) -> (n/2, 8)."""
    return fold_all(spec, [evals], x)[0]


def fix_last_var(spec: FieldSpec, evals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fix the highest variable := x: (n, 8) -> (n/2, 8)."""
    return fold_all(spec, [evals], x, last=True)[0]


def eq_xy(spec: FieldSpec, y: torch.Tensor) -> torch.Tensor:
    """eq(X, y) over 2^k points for y (k, 8); index bit i pairs with y_i
    (doubling expansion from the last variable, multilinear.rs:91-127)."""
    evals = spec.one(y.device)[None]
    for i in range(y.shape[0] - 1, -1, -1):
        hi = F.mont_mul(spec, evals, y[i])
        lo = F.sub(spec, evals, hi)
        evals = torch.stack([lo, hi], dim=1).reshape(-1, F.LIMBS)
    return evals


def evaluate(spec: FieldSpec, evals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the MLE at x (k, 8) -> (8,)."""
    assert evals.shape[0] == 1 << x.shape[0]
    for i in range(x.shape[0]):
        evals = fix_var(spec, evals, x[i])
    return evals[0]


def evaluate_stacked_ints(spec: FieldSpec, polys: Sequence[torch.Tensor], x: Sequence[int]) -> list:
    """Evaluate many same-size MLEs at one point (host ints) -> canonical
    ints, one fold launch per variable for all of them and one pull."""
    if not polys:
        return []
    xd = spec.encode(list(x), polys[0].device)
    cur = list(polys)
    for i in range(len(x)):
        cur = fold_all(spec, cur, xd[i])
    return spec.decode_ints(torch.cat(cur))


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
