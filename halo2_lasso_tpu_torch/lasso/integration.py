"""Lasso as HyperPlonk's lookup argument (the port of
halo2_lasso_tpu/lasso/integration.py). The proof bytes are those of the JAX
package for the same circuit, SRS and witness.

  * a circuit declares `lasso_lookups` on its `PlonkishCircuitInfo`: a
    `LassoLookup(table, inputs, output)` constrains, on every row i,
    `output(i) == table[index(i)]` where `index` is `inputs[0]` for plain
    tables and `(inputs[0] << operand_bits) | inputs[1]` for two-operand
    tables (AND/XOR/OR/LT);
  * the prover commits the Surge witness columns (per-chunk `dim` polys,
    per-memory `E` and `read_ts` polys) right after the witness phases, and
    the table-sized `final_cts` after them;
  * the pointwise bindings join the main zero check as ordinary constraints:
    output - g(E...) = 0 and operand - sum_j 2^{jb} dim_j = 0
    (`lasso_constraints`);
  * the offline memory check (fingerprints h = ts*gamma^2 + val*gamma +
    addr - tau) runs as batched GKR grand products: one batch over the
    2^num_vars read/write sets, one per subtable size over init/final.

Soundness of the index binding: plain-table dims address subtables of
exactly the chunk domain, and each two-operand dim gets its own identity
subtable "range memory" (addr = val = dim), so every dim is forced into its
chunk range by the memory check itself.

The witness (input expressions, digits, subtable reads, read timestamps and
final counts) is built on the device of the circuit's polys; the only host
sync is one range flag per input expression.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, evaluate_torch, hypercube_leaves
from halo2_lasso_tpu_torch.lasso import (
    _init_final_fingerprints,
    _read_ts_and_final_dev,
    _read_write_fingerprints,
    _subtable_dev,
    _subtable_mle_eval,
)
from halo2_lasso_tpu_torch.lasso.tables import LassoTable, Subtable, identity_subtable
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.piop import gkr
from halo2_lasso_tpu_torch.poly import multilinear as mle

MAX_CHUNK_BITS = 16  # the JAX package's device digit extractor's limit


class LassoIntegrationError(Halo2LassoError):
    pass


@dataclasses.dataclass(frozen=True)
class LassoLookup:
    """A circuit-level Lasso lookup: on every row, output == table[index].

    `inputs`: one Expression (the index) for plain tables, two (x operand,
    y operand) for `interleaved_operands` tables; rotation 0 only."""

    table: LassoTable
    inputs: Tuple[Expression, ...]
    output: Expression


@dataclasses.dataclass(frozen=True)
class MemSpec:
    """One offline-checked memory. addr = sum coeff * local_poly over
    `addr_terms` [(local poly idx, coeff)]; `e_local`/`ts_local` are local
    poly slots (e_local may alias a dim slot for identity subtables);
    `is_real` memories feed the table's collation polynomial g."""

    addr_terms: Tuple[Tuple[int, int], ...]
    subtable: Subtable
    e_local: int
    ts_local: int
    is_real: bool


class LassoLayout:
    """Local committed-poly layout for one lookup: [dims | E and read_ts
    polys in memory order]. Every slot is a 2^num_vars poly."""

    def __init__(self, lookup: LassoLookup):
        t = lookup.table
        b = t.chunk_bits
        c = t.num_chunks
        want = 2 if t.interleaved_operands else 1
        if len(lookup.inputs) != want:
            what = "two operand expressions" if want == 2 else "one index expression"
            raise LassoIntegrationError(f"table {t.name} takes {what}")
        self.num_dims = want * c  # two-operand: x chunks [0, c), y chunks [c, 2c)
        self.table = t
        mems: List[MemSpec] = []
        slot = self.num_dims
        for mem in t.memories:
            if t.interleaved_operands:
                addr_terms = ((mem.chunk, 1 << b), (c + mem.chunk, 1))
            else:
                addr_terms = ((mem.chunk, 1),)
            if mem.subtable.is_identity and len(addr_terms) == 1 and addr_terms[0][1] == 1:
                e_local = addr_terms[0][0]  # E == dim: reuse the commitment
            else:
                e_local = slot
                slot += 1
            mems.append(MemSpec(addr_terms, mem.subtable, e_local, slot, True))
            slot += 1
        if t.interleaved_operands:
            # dedicated range memories force each operand chunk into [0, 2^b)
            sub = identity_subtable(b)
            for d in range(2 * c):
                mems.append(MemSpec(((d, 1),), sub, d, slot, False))
                slot += 1
        self.mems = mems
        self.num_local = slot

    def g_expression(self, offset: int, lookup: LassoLookup) -> Expression:
        """The table's collation g with memory-local polys remapped to global
        indices (global = offset + e_local of real memory j)."""
        real = [m for m in self.mems if m.is_real]
        return _remap_polys(lookup.table.g, {j: offset + m.e_local for j, m in enumerate(real)})


def _remap_polys(expr: Expression, mapping: Dict[int, int]) -> Expression:
    E = Expression
    return expr.evaluate(
        E.constant,
        lambda e: e,
        lambda q: E.poly(mapping[q.poly], q.rotation),
        E.challenge,
        lambda a: -a,
        lambda a, b: a + b,
        lambda a, b: a * b,
        lambda a, s: a * s,
    )


def layouts_for(circuit_info) -> List[LassoLayout]:
    return [LassoLayout(lk) for lk in circuit_info.lasso_lookups]


def num_lasso_polys(circuit_info) -> int:
    return sum(layout.num_local for layout in layouts_for(circuit_info))


def _weighted_dims(first: int, c: int, b: int) -> Expression:
    acc = None
    for j in range(c):
        term = Expression.poly(first + j) * (1 << (b * j))
        acc = term if acc is None else acc + term
    return acc


def lasso_constraints(circuit_info, offset: int) -> List[Expression]:
    """Pointwise bindings added to the zero check: per lookup,
    output - g(E...) = 0 plus one chunk-recombination constraint per
    operand. `offset` is the global index of the first Lasso poly."""
    cons: List[Expression] = []
    off = offset
    for lk, layout in zip(circuit_info.lasso_lookups, layouts_for(circuit_info)):
        t = lk.table
        cons.append(lk.output - layout.g_expression(off, lk))
        for op in range(len(lk.inputs)):
            cons.append(lk.inputs[op] - _weighted_dims(off + op * t.num_chunks, t.num_chunks, t.chunk_bits))
        off += layout.num_local
    return cons


# ---------------------------------------------------------------------------
# prover: Surge witness columns
# ---------------------------------------------------------------------------


def _digits_from_mont_dev(spec: FieldSpec, v_mont: torch.Tensor, bits: int, b: int, c: int):
    """Montgomery elements (n, 8) -> c int64 digit tensors of b bits each and
    a flag that every value lies below 2^bits, on the device.

    The limbs are 32 bits wide in int32 storage: they are widened to int64
    and masked to 32 bits first, so no shift extends a sign, and a digit
    that straddles two limbs takes its high part from the next one."""
    if b > MAX_CHUNK_BITS:
        raise LassoIntegrationError(f"chunk_bits > {MAX_CHUNK_BITS} unsupported on device")
    limbs = F.from_mont(spec, v_mont).to(torch.int64) & 0xFFFFFFFF  # canonical (n, 8)
    full, rem = divmod(bits, 32)
    in_range = (limbs[:, full + (1 if rem else 0):] == 0).all()
    if rem:
        in_range = in_range & (limbs[:, full] < (1 << rem)).all()
    digits = []
    for j in range(c):
        li, sh = divmod(b * j, 32)
        d = limbs[:, li] >> sh
        if sh + b > 32 and li + 1 < F.LIMBS:
            d = d | (limbs[:, li + 1] << (32 - sh))
        digits.append(d & ((1 << b) - 1))
    return digits, in_range


def build_lookup_witness(
    spec: FieldSpec,
    lookup: LassoLookup,
    layout: LassoLayout,
    polys: Sequence[torch.Tensor],
    challenges: Sequence[int],
    num_vars: int,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Evaluate the lookup's input expressions over all rows and build the
    committed local polys and the final_cts polys, on the polys' device."""
    t = lookup.table
    b, c = t.chunk_bits, t.num_chunks
    n = 1 << num_vars
    device = polys[0].device
    chal = list(spec.encode(list(challenges), device)) if challenges else []
    leaf = hypercube_leaves(spec, num_vars, polys)

    def eval_digits(e: Expression, bits: int) -> List[torch.Tensor]:
        v = evaluate_torch(spec, e, leaf, chal, device)
        if v.ndim == 1:
            v = v.expand(n, F.LIMBS).contiguous()
        digits, in_range = _digits_from_mont_dev(spec, v, bits, b, c)
        if not bool(in_range):
            raise LassoIntegrationError(f"lookup input out of range for table {t.name} ({bits} bits)")
        return digits

    if t.interleaved_operands:
        dims = eval_digits(lookup.inputs[0], b * c) + eval_digits(lookup.inputs[1], b * c)
    else:
        dims = eval_digits(lookup.inputs[0], t.index_bits)

    local: List = [None] * layout.num_local
    for j, d in enumerate(dims):
        local[j] = F.u32_to_mont(spec, d)
    fcs: List[torch.Tensor] = []
    for ms in layout.mems:
        addr = sum(dims[dl] * coeff for dl, coeff in ms.addr_terms)
        if ms.e_local >= layout.num_dims:
            local[ms.e_local] = _subtable_dev(ms.subtable, str(device))[addr]
        ts, fc = _read_ts_and_final_dev(addr, 1 << ms.subtable.index_bits)
        local[ms.ts_local] = F.u32_to_mont(spec, ts)
        fcs.append(F.u32_to_mont(spec, fc))
    return local, fcs


# ---------------------------------------------------------------------------
# memory check
# ---------------------------------------------------------------------------


def _addr_dev(spec: FieldSpec, locals_dev: Sequence[torch.Tensor], ms: MemSpec, tau: int) -> torch.Tensor:
    """The memory's address sum_i coeff_i * dim_i, less tau: one product
    kernel launch a term, the coefficients and tau by value."""
    (dl, coeff), *rest = ms.addr_terms
    acc = F.mul_add(spec, locals_dev[dl], coeff, tau, sub=True)
    for dl, coeff in rest:
        acc = F.mul_add(spec, locals_dev[dl], coeff, acc)
    return acc


def _n_groups(layouts: Sequence[LassoLayout]) -> Dict[int, List[Tuple[int, int]]]:
    """Subtable-size groups: nv_n -> [(lookup idx, memory idx)], sorted."""
    groups: Dict[int, List[Tuple[int, int]]] = {}
    for li, layout in enumerate(layouts):
        for mi, ms in enumerate(layout.mems):
            groups.setdefault(ms.subtable.index_bits, []).append((li, mi))
    return dict(sorted(groups.items()))


def _pure_grand_products(qs: List[torch.Tensor], transcript):
    nb = len(qs)
    return gkr.prove_fractional_sum_check([0] * nb, [None] * nb, [None] * nb, qs, transcript)[2]


def prove_memory_check(
    spec: FieldSpec,
    layouts: Sequence[LassoLayout],
    locals_by_lookup: Sequence[Sequence[torch.Tensor]],
    fcs_by_lookup: Sequence[Sequence[torch.Tensor]],
    gamma: int,
    tau: int,
    num_vars: int,
    transcript,
) -> Tuple[List[int], Dict[int, List[int]]]:
    """Batched grand products over the read/write/init/final fingerprint
    sets. Returns (x_m, {nv_n: x_n}), the GKR points whose leaf claims the
    caller opens through the PCS."""
    device = locals_by_lookup[0][0].device
    rs, ws = [], []
    for layout, locs in zip(layouts, locals_by_lookup):
        for ms in layout.mems:
            r, w = _read_write_fingerprints(_addr_dev(spec, locs, ms, tau), locs[ms.e_local], locs[ms.ts_local], gamma)
            rs.append(r)
            ws.append(w)
    x_m = _pure_grand_products(rs + ws, transcript)
    del rs, ws

    x_ns: Dict[int, List[int]] = {}
    for nv_n, members in _n_groups(layouts).items():
        addr_n_tau = F.sub(spec, F.u32_to_mont(spec, torch.arange(1 << nv_n, device=device)), tau)
        inits, finals = [], []
        for li, mi in members:
            tvals = _subtable_dev(layouts[li].mems[mi].subtable, str(device))
            init, final = _init_final_fingerprints(addr_n_tau, tvals, fcs_by_lookup[li][mi], gamma)
            inits.append(init)
            finals.append(final)
        x_ns[nv_n] = _pure_grand_products(inits + finals, transcript)
    return x_m, x_ns


def verify_memory_check(spec: FieldSpec, layouts: Sequence[LassoLayout], gamma: int, tau: int, num_vars: int, transcript):
    """Mirror of prove_memory_check. Returns (x_m, the read/write bottom
    claims at x_m in memory order, {nv_n: (x_n, init claims, final
    claims)}); raises on a failed multiset product check."""
    p = spec.modulus
    total = sum(len(layout.mems) for layout in layouts)
    _, q_m, x_m, (_, q0_m) = gkr.verify_fractional_sum_check(num_vars, [0] * (2 * total), [None] * (2 * total), transcript)
    rs_prods, ws_prods = q0_m[:total], q0_m[total:]

    n_claims: Dict[int, Tuple[List[int], List[int], List[int]]] = {}
    init_prod: Dict[Tuple[int, int], int] = {}
    final_prod: Dict[Tuple[int, int], int] = {}
    for nv_n, members in _n_groups(layouts).items():
        k = len(members)
        _, q_n, x_n, (_, q0_n) = gkr.verify_fractional_sum_check(nv_n, [0] * (2 * k), [None] * (2 * k), transcript)
        n_claims[nv_n] = (x_n, q_n[:k], q_n[k:])
        for pos, key in enumerate(members):
            init_prod[key] = q0_n[pos]
            final_prod[key] = q0_n[k + pos]

    # multiset equality per memory: RS * S_final == WS * S_init
    k = 0
    for li, layout in enumerate(layouts):
        for mi in range(len(layout.mems)):
            if rs_prods[k] * final_prod[(li, mi)] % p != ws_prods[k] * init_prod[(li, mi)] % p:
                raise LassoIntegrationError(f"memory check product mismatch (lookup {li}, memory {mi})")
            k += 1
    return x_m, q_m, n_claims


def check_m_fingerprints(
    spec: FieldSpec,
    layouts: Sequence[LassoLayout],
    local_evals_by_lookup: Sequence[Sequence[int]],
    q_m: Sequence[int],
    gamma: int,
    tau: int,
) -> None:
    """Verifier: the GKR bottom claims at x_m must equal the fingerprints
    recombined from the openings of dim/E/read_ts at x_m."""
    p = spec.modulus
    g2 = gamma * gamma % p
    total = sum(len(layout.mems) for layout in layouts)
    k = 0
    for li, (layout, evs) in enumerate(zip(layouts, local_evals_by_lookup)):
        for mi, ms in enumerate(layout.mems):
            addr = sum(evs[dl] * coeff for dl, coeff in ms.addr_terms) % p
            e_val, ts = evs[ms.e_local], evs[ms.ts_local]
            h_rs = (ts * g2 + e_val * gamma + addr - tau) % p
            h_ws = ((ts + 1) * g2 + e_val * gamma + addr - tau) % p
            if h_rs != q_m[k] or h_ws != q_m[total + k]:
                raise LassoIntegrationError(f"fingerprint opening mismatch (lookup {li}, memory {mi})")
            k += 1


def check_n_fingerprints(
    spec: FieldSpec,
    layouts: Sequence[LassoLayout],
    members: Sequence[Tuple[int, int]],
    x_n: Sequence[int],
    init_claims: Sequence[int],
    final_claims: Sequence[int],
    fc_evals: Sequence[int],
    gamma: int,
    tau: int,
) -> None:
    """Verifier: the init/final bottom claims at x_n against the public
    subtable MLE (closed form where the subtable has one) and the final_cts
    openings."""
    p = spec.modulus
    g2 = gamma * gamma % p
    addr_eval = mle.identity_eval_host(p, x_n)
    for pos, (li, mi) in enumerate(members):
        t_eval = _subtable_mle_eval(layouts[li].mems[mi].subtable, x_n)
        h_init = (t_eval * gamma + addr_eval - tau) % p
        h_final = (fc_evals[pos] * g2 + t_eval * gamma + addr_eval - tau) % p
        if h_init != init_claims[pos] or h_final != final_claims[pos]:
            raise LassoIntegrationError(f"init/final fingerprint mismatch (lookup {li}, memory {mi})")
