"""Test and bench circuits: vanilla plonk with and without a logup lookup,
circuits with Lasso lookups, and a two-phase circuit with a challenge (the
port of halo2_lasso_tpu/backend/hyperplonk/fixtures.py; util.rs of the Rust
reference).

The same column layouts and constraint shapes, and the same draws from the
caller's np.random.RandomState streams in the same order, so one pair of
seeds gives the same circuit in both packages.
"""

from __future__ import annotations

from typing import List, Tuple

from halo2_lasso_tpu_torch.backend import MockCircuit, PlonkishCircuitInfo
from halo2_lasso_tpu_torch.backend.hyperplonk.prover import instance_poly_values
from halo2_lasso_tpu_torch.expression import Expression
from halo2_lasso_tpu_torch.lasso.integration import LassoLookup
from halo2_lasso_tpu_torch.lasso.tables import and_table, range_table
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube


def _rand_fe(rng, p: int = Fr.modulus) -> int:
    return int.from_bytes(rng.bytes(40), "little") % p


def vanilla_plonk_circuit_info(
    num_vars: int,
    num_instances: int,
    preprocess_polys: List[List[int]],
    permutations: List[List[Tuple[int, int]]],
) -> PlonkishCircuitInfo:
    """util.rs:30-49: columns [pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o]."""
    pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o = [Expression.poly(i) for i in range(9)]
    return PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[num_instances],
        preprocess_polys=preprocess_polys,
        num_witness_polys=[3],
        num_challenges=[0],
        constraints=[q_l * w_l + q_r * w_r + q_m * w_l * w_r + q_o * w_o + q_c + pi],
        lookups=[],
        permutations=permutations,
        max_degree=4,
    )


def vanilla_plonk_with_lookup_circuit_info(
    num_vars: int,
    num_instances: int,
    preprocess_polys: List[List[int]],
    permutations: List[List[Tuple[int, int]]],
) -> PlonkishCircuitInfo:
    """util.rs:63-86: columns [pi, q_l, q_r, q_m, q_o, q_c, q_lookup,
    t_l, t_r, t_o, w_l, w_r, w_o]."""
    (pi, q_l, q_r, q_m, q_o, q_c, q_lookup, t_l, t_r, t_o, w_l, w_r, w_o) = [
        Expression.poly(i) for i in range(13)
    ]
    return PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[num_instances],
        preprocess_polys=preprocess_polys,
        num_witness_polys=[3],
        num_challenges=[0],
        constraints=[q_l * w_l + q_r * w_r + q_m * w_l * w_r + q_o * w_o + q_c + pi],
        lookups=[[(q_lookup * w_l, t_l), (q_lookup * w_r, t_r), (q_lookup * w_o, t_o)]],
        permutations=permutations,
        max_degree=4,
    )


class Permutation:
    """Copy cycles (util.rs:376-405)."""

    def __init__(self):
        self.cycles: List[set] = []
        self.cycle_idx = {}

    def copy(self, lhs, rhs):
        idx = self.cycle_idx.get(lhs)
        if idx is not None:
            self.cycles[idx].add(rhs)
            self.cycle_idx[rhs] = idx
        else:
            idx = len(self.cycles)
            self.cycles.append({lhs, rhs})
            self.cycle_idx[lhs] = idx
            self.cycle_idx[rhs] = idx

    def into_cycles(self):
        return [sorted(c) for c in self.cycles]


def rand_vanilla_plonk_circuit(num_vars: int, preprocess_rng, witness_rng, field=Fr):
    """util.rs:100-169: random satisfied vanilla plonk circuit with random
    copy constraints."""
    P = field.modulus
    size = 1 << num_vars
    polys = [[0] * size for _ in range(9)]

    instances = [_rand_fe(witness_rng, P) for _ in range(num_vars)]
    polys[0] = instance_poly_values(num_vars, instances, field)

    permutation = Permutation()
    for poly in (6, 7, 8):
        permutation.copy((poly, 1), (poly, 1))
    for idx in range(size - 1):
        if preprocess_rng.randint(2) == 0 and idx > 1:
            l_copy = (6 + preprocess_rng.randint(3), 1 + preprocess_rng.randint(idx - 1))
            r_copy = (6 + preprocess_rng.randint(3), 1 + preprocess_rng.randint(idx - 1))
            permutation.copy(l_copy, (6, idx))
            permutation.copy(r_copy, (7, idx))
            w_l = polys[l_copy[0]][l_copy[1]]
            w_r = polys[r_copy[0]][r_copy[1]]
        else:
            w_l, w_r = _rand_fe(witness_rng, P), _rand_fe(witness_rng, P)
        q_c = _rand_fe(preprocess_rng, P)
        if preprocess_rng.randint(2) == 0:
            values = [
                (1, 1),
                (2, 1),
                (4, P - 1),
                (5, q_c),
                (6, w_l),
                (7, w_r),
                (8, (w_l + w_r + q_c + polys[0][idx]) % P),
            ]
        else:
            values = [
                (3, 1),
                (4, P - 1),
                (5, q_c),
                (6, w_l),
                (7, w_r),
                (8, (w_l * w_r + q_c + polys[0][idx]) % P),
            ]
        for poly, value in values:
            polys[poly][idx] = value

    circuit_info = vanilla_plonk_circuit_info(
        num_vars, len(instances), polys[1:6], permutation.into_cycles()
    )
    return circuit_info, MockCircuit([instances], polys[6:9])


def rand_vanilla_plonk_with_lookup_circuit(num_vars: int, preprocess_rng, witness_rng, field=Fr):
    """util.rs:216-316."""
    P = field.modulus
    size = 1 << num_vars
    polys = [[0] * size for _ in range(13)]

    for t in (7, 8, 9):
        col = [0, 0] + [_rand_fe(preprocess_rng, P) for _ in range(size - 2)]
        polys[t] = col[:size]

    instances = [_rand_fe(witness_rng, P) for _ in range(num_vars)]
    polys[0] = instance_poly_values(num_vars, instances, field)
    bh_seq = BooleanHypercube(num_vars).iter_indices()
    instance_rows = set(int(b) for b in bh_seq[: num_vars + 1])

    permutation = Permutation()
    for poly in (10, 11, 12):
        permutation.copy((poly, 1), (poly, 1))
    for idx in range(size - 1):
        use_copy = preprocess_rng.randint(2) == 0 and idx > 1
        if use_copy:
            l_copy = (10 + preprocess_rng.randint(3), 1 + preprocess_rng.randint(idx - 1))
            r_copy = (10 + preprocess_rng.randint(3), 1 + preprocess_rng.randint(idx - 1))
            permutation.copy(l_copy, (10, idx))
            permutation.copy(r_copy, (11, idx))
            w_l = polys[l_copy[0]][l_copy[1]]
            w_r = polys[r_copy[0]][r_copy[1]]
        else:
            w_l, w_r = _rand_fe(witness_rng, P), _rand_fe(witness_rng, P)
        q_c = _rand_fe(preprocess_rng, P)
        if use_copy or idx in instance_rows:
            if preprocess_rng.randint(2) == 0:
                values = [
                    (1, 1),
                    (2, 1),
                    (4, P - 1),
                    (5, q_c),
                    (10, w_l),
                    (11, w_r),
                    (12, (w_l + w_r + q_c + polys[0][idx]) % P),
                ]
            else:
                values = [
                    (3, 1),
                    (4, P - 1),
                    (5, q_c),
                    (10, w_l),
                    (11, w_r),
                    (12, (w_l * w_r + q_c + polys[0][idx]) % P),
                ]
        else:
            t_idx = 1 + witness_rng.randint(size - 1)
            values = [
                (6, 1),
                (10, polys[7][t_idx]),
                (11, polys[8][t_idx]),
                (12, polys[9][t_idx]),
            ]
        for poly, value in values:
            polys[poly][idx] = value

    circuit_info = vanilla_plonk_with_lookup_circuit_info(
        num_vars, len(instances), polys[1:10], permutation.into_cycles()
    )
    return circuit_info, MockCircuit([instances], polys[10:13])


def rand_lasso_circuit(num_vars: int, preprocess_rng, witness_rng, operand_bits: int = 8, chunk_bits: int = 4, range_bits: int = 8):
    """Random satisfied circuit with plonkish gates, a copy constraint and
    two Lasso lookups (a two-operand AND table and a range table).

    Columns (one witness phase): [w_x, w_y, w_and, w_s, w_r];
    gate: w_x + w_y - w_s = 0;  Lasso: w_and == AND[w_x, w_y],
    w_r == range[w_r];  copy: w_r[2] == w_r[5]."""
    P = Fr.modulus
    assert num_vars >= 3
    size = 1 << num_vars
    w_x = [int(v) for v in witness_rng.randint(0, 1 << operand_bits, size)]
    w_y = [int(v) for v in witness_rng.randint(0, 1 << operand_bits, size)]
    w_and = [x & y for x, y in zip(w_x, w_y)]
    w_s = [(x + y) % P for x, y in zip(w_x, w_y)]
    w_r = [int(v) for v in witness_rng.randint(0, 1 << range_bits, size)]
    w_r[5] = w_r[2]

    x, y, a, s, r = [Expression.poly(i) for i in range(5)]
    circuit_info = PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[],
        preprocess_polys=[],
        num_witness_polys=[5],
        num_challenges=[0],
        constraints=[x + y - s],
        lookups=[],
        permutations=[[(4, 2), (4, 5)]],
        max_degree=4,
        lasso_lookups=[
            LassoLookup(and_table(operand_bits, chunk_bits), (x, y), a),
            LassoLookup(range_table(range_bits, range_bits), (r,), r),
        ],
    )
    return circuit_info, MockCircuit([], [w_x, w_y, w_and, w_s, w_r])


def rand_full_feature_circuit(num_vars: int, preprocess_rng, witness_rng, operand_bits: int = 8, chunk_bits: int = 4, range_bits: int = 8):
    """Every prover feature in one circuit: plonkish gate, copy constraint,
    a logup lookup into a preprocessed table column and two Lasso lookups.

    Columns: [tbl (preprocess), w_x, w_y, w_and, w_s, w_r, w_t];
    gate: w_x + w_y - w_s = 0;  logup: w_t in tbl;  Lasso:
    w_and == AND[w_x, w_y], w_r == range[w_r];  copy: w_r[2] == w_r[5]."""
    P = Fr.modulus
    assert num_vars >= 3
    size = 1 << num_vars
    t_vals = [0, 0] + [int(v) for v in preprocess_rng.randint(0, 1 << range_bits, size - 2)]
    w_x = [int(v) for v in witness_rng.randint(0, 1 << operand_bits, size)]
    w_y = [int(v) for v in witness_rng.randint(0, 1 << operand_bits, size)]
    w_and = [x & y for x, y in zip(w_x, w_y)]
    w_s = [(x + y) % P for x, y in zip(w_x, w_y)]
    w_r = [int(v) for v in witness_rng.randint(0, 1 << range_bits, size)]
    w_r[5] = w_r[2]
    w_t = [t_vals[int(witness_rng.randint(size))] for _ in range(size)]

    tbl, x, y, a, s, r, t = [Expression.poly(i) for i in range(7)]
    circuit_info = PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[],
        preprocess_polys=[t_vals],
        num_witness_polys=[6],
        num_challenges=[0],
        constraints=[x + y - s],
        lookups=[[(t, tbl)]],
        permutations=[[(5, 2), (5, 5)]],
        max_degree=4,
        lasso_lookups=[
            LassoLookup(and_table(operand_bits, chunk_bits), (x, y), a),
            LassoLookup(range_table(range_bits, range_bits), (r,), r),
        ],
    )
    return circuit_info, MockCircuit([], [w_x, w_y, w_and, w_s, w_r, w_t])


class TwoPhaseCircuit(MockCircuit):
    """Two witness phases with a phase-0 challenge used in a gate (the port
    of fixtures.py:171).

    Phase 0 commits w0; the prover squeezes theta; phase 1 synthesizes
    w1 = theta*w0 + w0^2 against the squeezed theta (frontend/halo2.rs:
    222-244 semantics). `cheat=True` synthesizes w1 against theta + 1: the
    prover completes, and the verifier's zero check fails."""

    def __init__(self, w0: List[int], cheat: bool = False):
        super().__init__([], [w0])
        self.w0 = w0
        self.cheat = cheat

    def synthesize(self, round_, challenges):
        P = Fr.modulus
        if round_ == 0:
            return [self.w0]
        theta = (challenges[0] + (1 if self.cheat else 0)) % P
        return [[(theta * v + v * v) % P for v in self.w0]]


def rand_two_phase_circuit(num_vars: int, witness_rng, cheat: bool = False):
    """Circuit info and witness of the two-phase, one-challenge shape (the
    port of fixtures.py:192): columns [w0 (phase 0), w1 (phase 1)], gate
    w1 - theta*w0 - w0^2 = 0."""
    size = 1 << num_vars
    w0_e, w1_e = Expression.poly(0), Expression.poly(1)
    theta = Expression.challenge(0)
    circuit_info = PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[],
        preprocess_polys=[],
        num_witness_polys=[1, 1],
        num_challenges=[1, 0],
        constraints=[theta * w0_e + w0_e * w0_e - w1_e],
        lookups=[],
        permutations=[],
        max_degree=4,
    )
    w0 = [_rand_fe(witness_rng) for _ in range(size)]
    return circuit_info, TwoPhaseCircuit(w0, cheat=cheat)
