"""Plonkish backend API (the port of halo2_lasso_tpu/backend/__init__.py).

Mirrors the reference trait surface (plonkish_backend/src/backend.rs:16-142):
`PlonkishCircuitInfo` IR, `PlonkishCircuit` witness interface, `MockCircuit`
fixture. Field values are canonical Python ints on this boundary; provers
encode them to device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from halo2_lasso_tpu_torch.expression import Expression


@dataclasses.dataclass
class PlonkishCircuitInfo:
    """backend.rs:47-73 semantics. Polynomial index space:
    [instances | preprocess | witness (by phase) | permutation | lookup m |
     lookup h | permutation z] — the tail indices are assigned by compose."""

    k: int
    num_instances: List[int]
    preprocess_polys: List[List[int]]
    num_witness_polys: List[int]
    num_challenges: List[int]
    constraints: List[Expression]
    lookups: List[List[Tuple[Expression, Expression]]]
    permutations: List[List[Tuple[int, int]]]
    max_degree: Optional[int] = None
    # Lasso lookups (lasso/integration.py LassoLookup): proven with Surge
    # and GKR memory checking instead of logup
    lasso_lookups: list = dataclasses.field(default_factory=list)

    def num_poly(self) -> int:
        return (
            len(self.num_instances)
            + len(self.preprocess_polys)
            + sum(self.num_witness_polys)
        )

    def permutation_polys(self) -> List[int]:
        return sorted({poly for cycle in self.permutations for poly, _ in cycle})

    def expressions(self):
        for c in self.constraints:
            yield c
        for lookup in self.lookups:
            for inp, tbl in lookup:
                yield inp
                yield tbl
        for ll in self.lasso_lookups:
            yield from ll.inputs
            yield ll.output

    def is_well_formed(self) -> bool:
        num_poly = self.num_poly()
        num_challenges = sum(self.num_challenges)
        polys = set(self.permutation_polys())
        challenges = set()
        for e in self.expressions():
            polys |= set(e.used_poly)
            challenges |= set(e.used_challenge)
        ok = len(self.num_witness_polys) == len(self.num_challenges)
        ok &= all(n > 0 for n in self.num_witness_polys)
        ok &= all(n > 0 for n in self.num_challenges[:-1])
        ok &= (not polys) or max(polys) < num_poly
        ok &= (not challenges) or max(challenges) < num_challenges
        if self.max_degree is not None:
            ok &= all(c.degree <= self.max_degree for c in self.constraints)
        return ok


class PlonkishCircuit:
    """Witness interface (backend.rs:132-140)."""

    def circuit_info(self) -> PlonkishCircuitInfo:
        raise NotImplementedError

    def instances(self) -> List[List[int]]:
        raise NotImplementedError

    def synthesize(self, round_: int, challenges: Sequence[int]) -> List[List[int]]:
        raise NotImplementedError


class MockCircuit(PlonkishCircuit):
    """Fixed-witness circuit (backend.rs:146-185)."""

    def __init__(self, instances: List[List[int]], witnesses: List[List[int]]):
        self._instances = instances
        self._witnesses = witnesses

    def instances(self):
        return self._instances

    def synthesize(self, round_, challenges):
        assert round_ == 0 and not challenges
        return self._witnesses
