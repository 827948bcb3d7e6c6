"""Native circuit-builder frontend (the port of
halo2_lasso_tpu/frontend/builder.py; the Rust reference's
frontend/halo2.rs adapter semantics).

Columns (instance / fixed / advice with phases), selectors, gates over
rotated column references, logup and Lasso lookups, and equality (copy)
constraints give a ``PlonkishCircuitInfo`` + ``PlonkishCircuit`` pair for the
port's HyperPlonk. Row-indexed assignments are scattered into hypercube
order through ``row_mapping``, and copy cells are translated to hypercube
indices, as the halo2 adapter does (halo2.rs:100-244).

The column index layout, the challenge numbering, the copy cycles and their
order are those of the JAX package's builder, so one circuit description
gives the same circuit info, witnesses and proof bytes in both packages. A
machine-integer witness column is encoded as the JAX package encodes it:
a negative int64 value x becomes 2^64 + x (ops/field.py canonical_limbs),
not x mod p.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from halo2_lasso_tpu_torch.backend import PlonkishCircuit, PlonkishCircuitInfo
from halo2_lasso_tpu_torch.backend.hyperplonk.prover import row_mapping
from halo2_lasso_tpu_torch.expression import Expression
from halo2_lasso_tpu_torch.lasso.integration import LassoLookup
from halo2_lasso_tpu_torch.ops.bn254 import Fr

P = Fr.modulus


@dataclasses.dataclass(frozen=True)
class Column:
    kind: str  # "instance" | "fixed" | "advice"
    index: int  # index within its kind
    phase: int = 0

    def rot(self, rotation: int) -> "ColumnQuery":
        return ColumnQuery(self, rotation)

    @property
    def cur(self) -> "ColumnQuery":
        return ColumnQuery(self, 0)

    @property
    def next(self) -> "ColumnQuery":
        return ColumnQuery(self, 1)

    @property
    def prev(self) -> "ColumnQuery":
        return ColumnQuery(self, -1)


@dataclasses.dataclass(frozen=True)
class ColumnQuery:
    column: Column
    rotation: int


class CircuitBuilder:
    """Collects circuit structure; ``build()`` returns (info, circuit)."""

    def __init__(self, k: int, num_phases: int = 1):
        self.k = k
        self.n = 1 << k
        self.num_phases = num_phases
        self._instance_cols: List[Column] = []
        self._fixed_cols: List[Column] = []
        self._advice_cols: List[List[Column]] = [[] for _ in range(num_phases)]
        self._challenges_per_phase = [0] * num_phases
        self._gates: List[Tuple[str, Callable]] = []
        self._lookups: List[Tuple[str, Callable]] = []
        self._lasso_lookups: List[Tuple[str, object, Callable]] = []
        self._copies: List[Tuple[ColumnQuery, int, ColumnQuery, int]] = []
        self.max_degree: Optional[int] = None

    # ---- structure ----

    def instance_column(self) -> Column:
        col = Column("instance", len(self._instance_cols))
        self._instance_cols.append(col)
        return col

    def fixed_column(self) -> Column:
        col = Column("fixed", len(self._fixed_cols))
        self._fixed_cols.append(col)
        return col

    selector = fixed_column

    def advice_column(self, phase: int = 0) -> Column:
        col = Column("advice", sum(len(c) for c in self._advice_cols), phase)
        self._advice_cols[phase].append(col)
        return col

    def challenge(self, phase: int = 0) -> int:
        """A new challenge squeezed after `phase`; returns its global index
        for ``Expression.challenge``."""
        idx = sum(self._challenges_per_phase[: phase + 1])
        self._challenges_per_phase[phase] += 1
        return idx

    def gate(self, name: str, fn: Callable[["CircuitBuilder"], Expression]):
        self._gates.append((name, fn))

    def lookup(self, name: str, fn: Callable[["CircuitBuilder"], List[Tuple[Expression, Expression]]]):
        """A logup lookup: ``fn(ctx)`` gives its (input, table) pairs."""
        self._lookups.append((name, fn))

    def lasso_lookup(self, name: str, table, fn):
        """A Lasso lookup (lasso/integration.py): ``table`` a LassoTable,
        ``fn(ctx) -> (inputs, output)`` with one index Expression (plain
        tables) or two operand Expressions (AND/XOR/OR/LT) as ``inputs`` and
        the looked-up value as ``output``, all over rotation-0 columns."""
        self._lasso_lookups.append((name, table, fn))

    def copy(self, a: Column, row_a: int, b: Column, row_b: int):
        """Equality constraint between two cells (row-indexed)."""
        self._copies.append((a.cur, row_a, b.cur, row_b))

    # ---- column index layout: [instance | fixed | advice by phase] ----

    def _poly_index(self, col: Column) -> int:
        if col.kind == "instance":
            return col.index
        if col.kind == "fixed":
            return len(self._instance_cols) + col.index
        return len(self._instance_cols) + len(self._fixed_cols) + col.index

    def expr(self, q) -> Expression:
        if isinstance(q, Column):
            q = q.cur
        if isinstance(q, ColumnQuery):
            return Expression.poly(self._poly_index(q.column), q.rotation)
        raise TypeError(type(q))

    # ---- build ----

    def build(
        self,
        fixed_assignments: Dict[Tuple[int, int], int],
        advice_fn: Callable[[int, Sequence[int]], List[List[int]]],
        instances: List[List[int]],
    ) -> Tuple[PlonkishCircuitInfo, "BuiltCircuit"]:
        """fixed_assignments: {(fixed column index, row): value};
        advice_fn(phase, challenges) -> that phase's row-indexed advice
        columns; instances: the values of each instance column."""
        rm = row_mapping(self.k)

        preprocess = []
        by_col: Dict[int, List[Tuple[int, int]]] = {}
        for (ci, row), v in fixed_assignments.items():
            by_col.setdefault(ci, []).append((row, v))
        for col in self._fixed_cols:
            vals = [0] * self.n
            for row, v in by_col.get(col.index, ()):
                vals[int(rm[row])] = v % P
            preprocess.append(vals)

        ctx = self
        constraints = [fn(ctx) for _, fn in self._gates]
        lookups = [fn(ctx) for _, fn in self._lookups]
        lasso_lookups = []
        for _, table, fn in self._lasso_lookups:
            inputs, output = fn(ctx)
            lasso_lookups.append(LassoLookup(table, tuple(inputs), output))

        permutations = _cycles_from_copies(
            [
                (self._poly_index(a.column), int(rm[ra]), self._poly_index(b.column), int(rm[rb]))
                for a, ra, b, rb in self._copies
            ]
        )

        info = PlonkishCircuitInfo(
            k=self.k,
            num_instances=[len(v) for v in instances],
            preprocess_polys=preprocess,
            num_witness_polys=[len(c) for c in self._advice_cols],
            num_challenges=(
                self._challenges_per_phase[:-1] + [max(self._challenges_per_phase[-1], 0)]
                if self.num_phases > 1
                else [self._challenges_per_phase[0]]
            ),
            constraints=constraints,
            lookups=lookups,
            permutations=permutations,
            max_degree=self.max_degree,
            lasso_lookups=lasso_lookups,
        )
        return info, BuiltCircuit(self, advice_fn, instances, rm)


class BuiltCircuit(PlonkishCircuit):
    def __init__(self, builder: CircuitBuilder, advice_fn, instances, rm):
        self._builder = builder
        self._advice_fn = advice_fn
        self._instances = instances
        self._rm = rm

    def instances(self):
        return self._instances

    def synthesize(self, round_: int, challenges):
        cols_rows = self._advice_fn(round_, list(challenges))
        n = self._builder.n
        out = []
        for col in cols_rows:
            if isinstance(col, np.ndarray) and col.dtype != object:
                # one int64 scatter for a machine-integer column (a Python
                # loop a row costs seconds a column at 2^20 rows)
                vals = np.zeros(n, dtype=np.int64)
                vals[self._rm[: len(col)]] = col
                out.append(vals)
                continue
            vals = [0] * n
            for row, v in enumerate(col):
                vals[int(self._rm[row])] = v % P
            out.append(vals)
        return out


def _cycles_from_copies(copies):
    """Union-find over cells -> closed cycles (frontend/halo2.rs:392-461).
    The cycles come out in the order of the set and dict iteration below,
    as in the JAX package's builder, which the permutation polys and the
    proof bytes depend on."""
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    cells = set()
    for pa, ia, pb, ib in copies:
        a, b = (pa, ia), (pb, ib)
        cells.add(a)
        cells.add(b)
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for c in cells:
        groups.setdefault(find(c), []).append(c)
    return [sorted(g) for g in groups.values()]
