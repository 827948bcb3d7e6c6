"""Lasso structured tables and Surge subtable decompositions (the port's
copy of halo2_lasso_tpu/lasso/tables.py).

The reference snapshot predates its Lasso code; this layer is designed from
the Lasso paper (eprint 2023/1216, acknowledged at reference README.md:7)
on top of the primitives in this repo (see SURVEY.md §0).

A `LassoTable` describes a table T of size 2^index_bits that is
"decomposable": T[r] = g(T_1[r_1], ..., T_alpha[r_alpha]) where the r_j are
b-bit chunks of the index r (operand tables interleave the two operands'
chunks) and each T_j is a materialized subtable of size 2^chunk_index_bits.
`g` is expressed as an `Expression` over polys E_0..E_{alpha-1} so both the
primary-sumcheck prover (device) and the verifier (host) reuse the shared
expression machinery.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, List, Sequence, Tuple

import numpy as np

from halo2_lasso_tpu_torch.expression import Expression, evaluate_host
from halo2_lasso_tpu_torch.ops.bn254 import Fr

P = Fr.modulus


@dataclasses.dataclass(frozen=True)
class Subtable:
    """A materialized subtable: values[k] for k in [0, 2^index_bits).

    `mle_eval(x) -> int`, when provided, evaluates the subtable's multilinear
    extension at a point in O(index_bits) — the whole point of structured
    Lasso tables: verifier cost independent of the subtable size. Convention:
    x[j] binds index bit j (lsb = x[0]), matching the prover-side fold order.
    """

    name: str
    index_bits: int
    fn: Callable[[int], int]
    mle_eval: Callable[[Sequence[int]], int] = None
    is_identity: bool = False  # T[k] = k; lets Surge alias E ≡ dim

    @functools.lru_cache(maxsize=None)
    def values(self) -> np.ndarray:
        out = np.empty(1 << self.index_bits, dtype=object)
        for k in range(1 << self.index_bits):
            out[k] = self.fn(k) % P
        return out


@dataclasses.dataclass(frozen=True)
class Memory:
    """One Surge 'memory': a (chunk index, subtable) pair. E_j reads
    subtable at dim_{chunk}."""

    chunk: int
    subtable: Subtable


@dataclasses.dataclass(frozen=True)
class LassoTable:
    name: str
    index_bits: int  # log2 of table size
    chunk_bits: int  # index bits consumed per chunk (operand tables: per operand)
    num_chunks: int
    memories: Tuple[Memory, ...]
    g: Expression  # over Expression.poly(j) = E_j for each memory j
    interleaved_operands: bool = False  # index = x||y, chunks pair (x_j, y_j)

    # ---- index chunking ----

    def chunk_indices(self, r: int) -> List[int]:
        """dim values (one per CHUNK) for table index r."""
        b = self.chunk_bits
        if self.interleaved_operands:
            half = self.index_bits // 2
            x = r >> half
            y = r & ((1 << half) - 1)
            out = []
            for j in range(self.num_chunks):
                xj = (x >> (b * j)) & ((1 << b) - 1)
                yj = (y >> (b * j)) & ((1 << b) - 1)
                out.append((xj << b) | yj)
            return out
        return [(r >> (b * j)) & ((1 << b) - 1) for j in range(self.num_chunks)]

    def chunk_indices_np(self, rs: np.ndarray) -> List[np.ndarray]:
        """Vectorized chunking of indices into int64 dim arrays: indices below
        2^64 (two 32-bit operands fill all 64 bits) through uint64, and those
        of a two-operand table of wider operands (lt_table(64, 8): 128-bit
        indices, Python ints) by their two operands, each below 2^64."""
        b = self.chunk_bits
        mask = (1 << b) - 1
        if not self.interleaved_operands:
            rs = np.asarray(rs, dtype=np.uint64)
            return [((rs >> (b * j)) & mask).astype(np.int64) for j in range(self.num_chunks)]
        half = self.index_bits // 2
        assert half <= 64, "operands above 64 bits"
        if self.index_bits > 64:
            x = np.array([int(r) >> half for r in rs], dtype=np.uint64)
            y = np.array([int(r) & ((1 << half) - 1) for r in rs], dtype=np.uint64)
        else:
            rs = np.asarray(rs, dtype=np.uint64)
            x, y = rs >> half, rs & ((1 << half) - 1)
        return [((((x >> (b * j)) & mask) << b) | ((y >> (b * j)) & mask)).astype(np.int64)
                for j in range(self.num_chunks)]

    def lookup(self, r: int) -> int:
        """Direct table evaluation (for witness generation / testing)."""
        dims = self.chunk_indices(r)
        e_vals = [int(m.subtable.values()[dims[m.chunk]]) for m in self.memories]
        return evaluate_host(
            self.g, P, lambda kind, q: e_vals[q.poly] if kind == "poly" else 0, []
        )


# ---------------------------------------------------------------------------
# closed-form subtable MLEs (verifier-side O(log N_sub) evaluation)
# ---------------------------------------------------------------------------
# Operand-subtable index layout: k = (x_chunk << b) | y_chunk, so for a point
# z of length 2b: y_j = z[j], x_j = z[b + j].


def _identity_mle(ib: int):
    def ev(z: Sequence[int]) -> int:
        return sum((1 << j) * z[j] for j in range(ib)) % P

    return ev


def _bitop_mle(b: int, combine):
    """MLE of sum_j 2^j op(x_j, y_j) with op multilinear per bit."""

    def ev(z: Sequence[int]) -> int:
        acc = 0
        for j in range(b):
            acc += (1 << j) * combine(z[b + j], z[j])
        return acc % P

    return ev


def _and_mle(b):
    return _bitop_mle(b, lambda x, y: x * y % P)


def _xor_mle(b):
    return _bitop_mle(b, lambda x, y: (x + y - 2 * x * y) % P)


def _or_mle(b):
    return _bitop_mle(b, lambda x, y: (x + y - x * y) % P)


def _eq_bit(x, y):
    return (x * y + (1 - x) * (1 - y)) % P


def _lt_mle(b: int):
    """MLE of [x < y]: sum_j (1-x_j) y_j prod_{k>j} eq(x_k, y_k)."""

    def ev(z: Sequence[int]) -> int:
        acc = 0
        suffix = 1  # prod_{k>j} eq_k, built from the top bit down
        for j in range(b - 1, -1, -1):
            x, y = z[b + j], z[j]
            acc = (acc + (1 - x) * y % P * suffix) % P
            suffix = suffix * _eq_bit(x, y) % P
        return acc

    return ev


def _eq_mle(b: int):
    def ev(z: Sequence[int]) -> int:
        acc = 1
        for j in range(b):
            acc = acc * _eq_bit(z[b + j], z[j]) % P
        return acc

    return ev


# ---------------------------------------------------------------------------
# standard tables
# ---------------------------------------------------------------------------


def _serializable(factory):
    """Record the (factory name, bound kwargs) spec on the built table, as
    the JAX package does (lasso/tables.py:189), so that a Lasso set-up
    round-trips through utils/serialize.py in either package: structured
    tables carry no arrays, the spec is the serialization."""

    @functools.wraps(factory)
    def wrapped(*args, **kwargs):
        table = factory(*args, **kwargs)
        bound = inspect.signature(factory).bind(*args, **kwargs)
        bound.apply_defaults()
        object.__setattr__(table, "spec", {"factory": factory.__name__, "kwargs": dict(bound.arguments)})
        return table

    return wrapped


@functools.lru_cache(maxsize=None)
def identity_subtable(index_bits: int) -> Subtable:
    """Shared identity subtable (range tables; Surge range memories)."""
    return Subtable(
        f"identity_{index_bits}",
        index_bits,
        lambda k: k,
        mle_eval=_identity_mle(index_bits),
        is_identity=True,
    )


def _weighted_sum(alpha: int, weight_bits: int) -> Expression:
    terms = [Expression.poly(j) * (1 << (weight_bits * j)) for j in range(alpha)]
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


@_serializable
@functools.lru_cache(maxsize=None)
def range_table(index_bits: int, chunk_bits: int = 16) -> LassoTable:
    """T[r] = r  (range check into [0, 2^index_bits))."""
    c = -(-index_bits // chunk_bits)
    ib = min(chunk_bits, index_bits)
    sub = identity_subtable(ib)
    # chunks may be uneven; use a full-width subtable per chunk, with the top
    # chunk's range enforced by table size. For simplicity require divisible.
    assert index_bits % chunk_bits == 0 or c == 1
    mems = tuple(Memory(j, sub) for j in range(c))
    return LassoTable(
        name=f"range_{index_bits}",
        index_bits=index_bits,
        chunk_bits=chunk_bits,
        num_chunks=c,
        memories=mems,
        g=_weighted_sum(c, chunk_bits),
    )


def _operand_table(name: str, op, operand_bits: int, chunk_bits: int, mle_eval=None) -> LassoTable:
    """Tables over two operands x, y with bitwise-chunkable op: index =
    x || y, subtable over (x_j || y_j)."""
    assert operand_bits % chunk_bits == 0
    c = operand_bits // chunk_bits
    b = chunk_bits
    sub = Subtable(
        f"{name}_{b}",
        2 * b,
        lambda k: op((k >> b) & ((1 << b) - 1), k & ((1 << b) - 1)),
        mle_eval=mle_eval,
    )
    mems = tuple(Memory(j, sub) for j in range(c))
    return LassoTable(
        name=f"{name}_{operand_bits}",
        index_bits=2 * operand_bits,
        chunk_bits=b,
        num_chunks=c,
        memories=mems,
        g=_weighted_sum(c, b),
        interleaved_operands=True,
    )


@_serializable
@functools.lru_cache(maxsize=None)
def and_table(operand_bits: int = 32, chunk_bits: int = 8) -> LassoTable:
    return _operand_table("and", lambda x, y: x & y, operand_bits, chunk_bits, _and_mle(chunk_bits))


@_serializable
@functools.lru_cache(maxsize=None)
def xor_table(operand_bits: int = 32, chunk_bits: int = 8) -> LassoTable:
    return _operand_table("xor", lambda x, y: x ^ y, operand_bits, chunk_bits, _xor_mle(chunk_bits))


@_serializable
@functools.lru_cache(maxsize=None)
def or_table(operand_bits: int = 32, chunk_bits: int = 8) -> LassoTable:
    return _operand_table("or", lambda x, y: x | y, operand_bits, chunk_bits, _or_mle(chunk_bits))


@_serializable
@functools.lru_cache(maxsize=None)
def lt_table(operand_bits: int = 32, chunk_bits: int = 8) -> LassoTable:
    """T[x||y] = 1 if x < y else 0 (unsigned).

    LT(x, y) = sum_j LT_b(x_j, y_j) * prod_{k > j} EQ_b(x_k, y_k), chunks
    little-endian; memories: LT per chunk (0..c-1), EQ per chunk (1..c-1).
    """
    assert operand_bits % chunk_bits == 0
    c = operand_bits // chunk_bits
    b = chunk_bits
    lt_sub = Subtable(
        f"lt_{b}",
        2 * b,
        lambda k: 1 if ((k >> b) & ((1 << b) - 1)) < (k & ((1 << b) - 1)) else 0,
        mle_eval=_lt_mle(b),
    )
    eq_sub = Subtable(
        f"eq_{b}",
        2 * b,
        lambda k: 1 if ((k >> b) & ((1 << b) - 1)) == (k & ((1 << b) - 1)) else 0,
        mle_eval=_eq_mle(b),
    )
    # memory layout: [LT_0..LT_{c-1}, EQ_1..EQ_{c-1}]
    mems = tuple(Memory(j, lt_sub) for j in range(c)) + tuple(
        Memory(j, eq_sub) for j in range(1, c)
    )

    def eq_mem(j):  # memory index of EQ_j (j >= 1)
        return c + (j - 1)

    terms = []
    for j in range(c):
        t = Expression.poly(j)  # LT_j
        for k in range(j + 1, c):
            t = t * Expression.poly(eq_mem(k))
        terms.append(t)
    g = terms[0]
    for t in terms[1:]:
        g = g + t
    return LassoTable(
        name=f"lt_{operand_bits}",
        index_bits=2 * operand_bits,
        chunk_bits=b,
        num_chunks=c,
        memories=mems,
        g=g,
        interleaved_operands=True,
    )
