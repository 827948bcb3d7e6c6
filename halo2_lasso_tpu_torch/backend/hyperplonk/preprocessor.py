"""HyperPlonk preprocessing (the port of
halo2_lasso_tpu/backend/hyperplonk/preprocessor.py): compose the zero-check
expression and build the permutation polynomials.

Semantics mirror plonkish_backend/src/backend/hyperplonk/preprocessor.rs:
`compose` (:25-60) builds the single alpha-batched expression [gate
constraints, logup lookup constraints (:79-109), chunked permutation
grand-product constraints (:111-170)] x eq, plus the per-lookup h-sum zero
checks; `permutation_polys` (:172-203) materialises sigma from copy cycles.
The Lasso polys sit right after the witness polys in the global index space,
and their pointwise bindings (`lasso/integration.py`) join the zero check.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from halo2_lasso_tpu_torch.backend import PlonkishCircuitInfo
from halo2_lasso_tpu_torch.expression import Expression
from halo2_lasso_tpu_torch.lasso import integration


def num_lasso_polys(circuit_info: PlonkishCircuitInfo) -> int:
    return integration.num_lasso_polys(circuit_info)


def batch_size(circuit_info: PlonkishCircuitInfo) -> int:
    num_lookups = len(circuit_info.lookups)
    num_permutation_polys = len(circuit_info.permutation_polys())
    md = max_degree(circuit_info)
    return sum(
        [
            len(circuit_info.preprocess_polys) + num_permutation_polys,
            *circuit_info.num_witness_polys,
            num_lookups,
            num_lookups + -(-num_permutation_polys // (md - 1)),
        ]
    )


def max_degree(circuit_info: PlonkishCircuitInfo, lookup_constraints_=None) -> int:
    if lookup_constraints_ is None:
        zero = Expression.constant(0)
        lookup_constraints_, _ = lookup_constraints(circuit_info, zero, zero)
    degrees = [c.degree for c in circuit_info.constraints]
    degrees += [c.degree for c in lookup_constraints_]
    degrees += [c.degree for c in lasso_zero_constraints(circuit_info)]
    if circuit_info.max_degree is not None:
        degrees.append(circuit_info.max_degree)
    degrees.append(2)
    return max(degrees)


def lasso_zero_constraints(circuit_info: PlonkishCircuitInfo):
    """Surge pointwise bindings (output = g(E...), index = chunk
    recombination) that join the zero check."""
    return integration.lasso_constraints(circuit_info, circuit_info.num_poly())


def lookup_constraints(
    circuit_info: PlonkishCircuitInfo, beta: Expression, gamma: Expression
) -> Tuple[List[Expression], List[Expression]]:
    """preprocessor.rs:79-109: per lookup, the logup identity
    h*(input+gamma)*(table+gamma) - (table+gamma) + m*(input+gamma) == 0 and
    the h-sum zero-check."""
    m_offset = circuit_info.num_poly() + num_lasso_polys(circuit_info) + len(circuit_info.permutation_polys())
    h_offset = m_offset + len(circuit_info.lookups)
    constraints = []
    for idx, lookup in enumerate(circuit_info.lookups):
        m = Expression.poly(m_offset + idx)
        h = Expression.poly(h_offset + idx)
        input_ = Expression.distribute_powers([inp for inp, _ in lookup], beta)
        table = Expression.distribute_powers([tbl for _, tbl in lookup], beta)
        constraints.append(
            h * (input_ + gamma) * (table + gamma)
            - (table + gamma)
            + m * (input_ + gamma)
        )
    sum_checks = [
        Expression.poly(h_offset + idx) for idx in range(len(circuit_info.lookups))
    ]
    return constraints, sum_checks


def permutation_constraints(
    circuit_info: PlonkishCircuitInfo,
    md: int,
    beta: Expression,
    gamma: Expression,
    num_builtin_witness_polys: int,
) -> Tuple[int, List[Expression]]:
    """preprocessor.rs:111-170: chunked grand-product constraints."""
    permutation_polys = circuit_info.permutation_polys()
    chunk_size = md - 1
    num_chunks = -(-len(permutation_polys) // chunk_size) if permutation_polys else 0
    permutation_offset = circuit_info.num_poly() + num_lasso_polys(circuit_info)
    z_offset = permutation_offset + len(permutation_polys) + num_builtin_witness_polys

    polys = [Expression.poly(i) for i in permutation_polys]
    ids = [
        Expression.constant(idx << circuit_info.k) + Expression.identity()
        for idx in range(len(polys))
    ]
    permutations = [
        Expression.poly(permutation_offset + i) for i in range(len(permutation_polys))
    ]
    zs = [Expression.poly(z_offset + i) for i in range(num_chunks)]
    constraints: List[Expression] = []
    if zs:
        z_0_next = Expression.poly(z_offset, rotation=1)
        l_1 = Expression.lagrange(1)
        one = Expression.constant(1)
        constraints.append(l_1 * (zs[0] - one))
        z_rhs_list = zs[1:] + [z_0_next]
        for c in range(num_chunks):
            sl = slice(c * chunk_size, (c + 1) * chunk_size)
            lhs = zs[c]
            for poly, id_ in zip(polys[sl], ids[sl]):
                lhs = lhs * (poly + beta * id_ + gamma)
            rhs = z_rhs_list[c]
            for poly, perm in zip(polys[sl], permutations[sl]):
                rhs = rhs * (poly + beta * perm + gamma)
            constraints.append(lhs - rhs)
    return num_chunks, constraints


def compose(circuit_info: PlonkishCircuitInfo) -> Tuple[int, Expression]:
    """preprocessor.rs:25-60."""
    challenge_offset = sum(circuit_info.num_challenges)
    beta = Expression.challenge(challenge_offset)
    gamma = Expression.challenge(challenge_offset + 1)
    alpha = Expression.challenge(challenge_offset + 2)

    lookup_cons, lookup_zero_checks = lookup_constraints(circuit_info, beta, gamma)
    lasso_cons = lasso_zero_constraints(circuit_info)
    md = max_degree(circuit_info, lookup_cons)
    num_permutation_z_polys, permutation_cons = permutation_constraints(
        circuit_info, md, beta, gamma, 2 * len(circuit_info.lookups)
    )

    constraints = list(circuit_info.constraints) + lasso_cons + lookup_cons + permutation_cons
    eq = Expression.eq_xy(0)
    zero_check_on_every_row = Expression.distribute_powers(constraints, alpha) * eq
    expression = Expression.distribute_powers(
        lookup_zero_checks + [zero_check_on_every_row], alpha
    )
    return num_permutation_z_polys, expression


def permutation_polys_values(
    num_vars: int,
    permutation_polys: List[int],
    cycles: List[List[Tuple[int, int]]],
) -> List[np.ndarray]:
    """preprocessor.rs:172-203: sigma_j[b] as host int arrays; the identity
    value of cell (poly j, row b) is (j << num_vars) + b, and each cell of a
    cycle maps to the previous cell's identity (rotated)."""
    poly_index = {poly: i for i, poly in enumerate(permutation_polys)}
    n = 1 << num_vars
    perms = [
        np.arange(idx << num_vars, (idx << num_vars) + n, dtype=np.int64)
        for idx in range(len(permutation_polys))
    ]
    for cycle in cycles:
        i0, j0 = cycle[0]
        last = perms[poly_index[i0]][j0]
        # rotate identities around the cycle (starting from the second cell,
        # wrapping back to the first)
        for (i, j) in cycle[1:] + [cycle[0]]:
            last, perms[poly_index[i]][j] = perms[poly_index[i]][j], last
    return perms
