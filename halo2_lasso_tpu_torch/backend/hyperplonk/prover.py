"""HyperPlonk prover helpers (the port of
halo2_lasso_tpu/backend/hyperplonk/prover.py).

Semantics mirror plonkish_backend/src/backend/hyperplonk/prover.rs; the work
runs on the tensors' device:
  * lookup compressed polys: the lookup input/table expressions evaluated
    over all 2^k points with `evaluate_torch`;
  * lookup m polys: multiplicities by `torch.unique` over the table and the
    inputs and segment counts (the hashmap of prover.rs:139-192);
  * lookup h polys: one batch inversion (prover.rs:194-250);
  * permutation z polys: the sequential running product of prover.rs:307-323
    as a log-depth prefix product over the bh-ordered, chunk-interleaved
    factor sequence, then index gathers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.config import sanity_enabled
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, Query, evaluate_torch, hypercube_leaves
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.piop import sum_check
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube


class ProofError(Halo2LassoError):
    pass


def row_mapping(k: int) -> np.ndarray:
    """Witness row r -> hypercube index (hyperplonk.rs:365-369)."""
    seq = BooleanHypercube(k).iter_indices()
    return np.concatenate([seq[1:], seq[:1]])


def instance_poly_values(num_vars: int, instances: Sequence[int], spec: FieldSpec = Fr) -> List[int]:
    """prover.rs:32-48: place instance values at their bh rows."""
    rm = row_mapping(num_vars)
    out = [0] * (1 << num_vars)
    for r, v in enumerate(instances):
        out[int(rm[r])] = v % spec.modulus
    return out


def lookup_compressed_polys(
    lookups: Sequence[Sequence[Tuple[Expression, Expression]]],
    polys: Sequence[torch.Tensor],
    challenges: Sequence[int],
    betas: Sequence[int],
    spec: FieldSpec = Fr,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """prover.rs:50-137: per lookup, (compressed input, compressed table) =
    sum_i betas[i] * expr_i evaluated over all b."""
    if not lookups:
        return []
    device = polys[0].device
    n = polys[0].shape[0]
    leaf = hypercube_leaves(spec, n.bit_length() - 1, polys)
    chal = list(spec.encode(list(challenges), device)) if challenges else []
    out = []
    for lookup in lookups:
        pair = []
        for exprs in ([inp for inp, _ in lookup], [tbl for _, tbl in lookup]):
            acc = None
            for beta, e in zip(betas, exprs):
                v = evaluate_torch(spec, e, leaf, chal, device)  # (n, 8), or (8,) for a constant
                acc = F.mont_mul(spec, v.expand(n, F.LIMBS), beta) if acc is None else F.mul_add(spec, v, beta, acc)
            pair.append(acc)
        out.append((pair[0], pair[1]))
    return out


def _m_poly_counts(inp: torch.Tensor, tbl: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """m[idx] = #occurrences of table[idx] among the inputs, attributed to
    the LAST index of each distinct table value (prover.rs:150-180 hashmap
    semantics), by a sort (`torch.unique`) and segment counts. Returns
    (int64 counts (n,), invalid): invalid iff some input is not in the table."""
    n = tbl.shape[0]
    _, gid = torch.unique(torch.cat([tbl, inp]), dim=0, return_inverse=True)
    groups = int(gid.max()) + 1
    count = torch.bincount(gid[n:], minlength=groups)
    last = torch.full((groups,), -1, dtype=torch.int64, device=tbl.device)
    last.scatter_reduce_(0, gid[:n], torch.arange(n, device=tbl.device), reduce="amax")
    invalid = bool(((count > 0) & (last < 0)).any())
    m = torch.zeros(n, dtype=torch.int64, device=tbl.device)
    has = last >= 0
    m[last[has]] = count[has]
    return m, invalid


def lookup_m_polys(
    compressed: Sequence[Tuple[torch.Tensor, torch.Tensor]], spec: FieldSpec = Fr
) -> List[torch.Tensor]:
    """prover.rs:139-192: m[idx] = multiplicity of table[idx] among the
    inputs (idx = the LAST index of each distinct table value)."""
    out = []
    for inp, tbl in compressed:
        m, invalid = _m_poly_counts(inp, tbl)
        if invalid:
            raise ProofError("invalid lookup input")
        out.append(F.u32_to_mont(spec, m))
    return out


def lookup_h_polys(
    compressed: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    m_polys: Sequence[torch.Tensor],
    gamma: int,
    spec: FieldSpec = Fr,
) -> List[torch.Tensor]:
    """prover.rs:194-250: h = 1/(gamma+input) - m/(gamma+table), one batch
    inversion per lookup."""
    out = []
    for (inp, tbl), m in zip(compressed, m_polys):
        n = inp.shape[0]
        inv = F.batch_inv(spec, F.add(spec, torch.cat([inp, tbl]), gamma))
        h = F.sub(spec, inv[:n], F.mont_mul(spec, inv[n:], m))
        out.append(h)
        if sanity_enabled():  # prover.rs:245-247 (`sanity-check`): sum h == 0
            assert spec.decode_ints(F.sum_reduce(spec, h)[None])[0] == 0, "lookup h poly does not sum to zero"
    return out


def permutation_z_polys(
    num_chunks: int,
    permutation_polys: Sequence[Tuple[int, torch.Tensor]],
    polys: Sequence[torch.Tensor],
    beta: int,
    gamma: int,
    spec: FieldSpec = Fr,
) -> List[torch.Tensor]:
    """prover.rs:252-345 semantics via a parallel prefix product.

    products[j][b] = prod_{(poly,perm) in chunk j} (val + beta*id + gamma)
                     / (val + beta*perm + gamma);
    z_flat[t] for the (bh-order, chunk-interleaved) scan; z polys by gather.
    """
    if not permutation_polys:
        return []
    device = polys[0].device
    n = polys[0].shape[0]
    num_vars = n.bit_length() - 1
    chunk_size = -(-len(permutation_polys) // num_chunks)
    p = spec.modulus
    idx = F.u32_to_mont(spec, torch.arange(n, device=device))

    products = []
    global_idx = 0
    for c in range(num_chunks):
        numer = denom = None
        for poly_idx, perm_poly in permutation_polys[c * chunk_size : (c + 1) * chunk_size]:
            val = polys[poly_idx]
            # val + beta * perm + gamma, and val + beta * (idx + id_off) + gamma
            # with the id offset's beta * id_off folded into the host scalar
            d = F.add(spec, F.mul_add(spec, perm_poly, beta, val), gamma)
            denom = d if denom is None else F.mont_mul(spec, denom, d)
            id_gamma = (gamma + beta * (global_idx << num_vars)) % p
            nmr = F.add(spec, F.mul_add(spec, idx, beta, val), id_gamma)
            numer = nmr if numer is None else F.mont_mul(spec, numer, nmr)
            global_idx += 1
        products.append(F.mont_mul(spec, numer, F.batch_inv(spec, denom)))

    bh = BooleanHypercube(num_vars)
    seq = torch.from_numpy(bh.iter_indices()[1:]).to(device)  # (n-1,) bh order after 0
    # factor sequence f[t]: t = nth*num_chunks + j  ->  products[j][bh[nth+1]]
    interleaved = torch.stack([p.index_select(0, seq) for p in products], dim=1).reshape(-1, F.LIMBS)
    prefix = F.prefix_products(spec, interleaved)
    z_flat = torch.cat([
        spec.zeros(num_chunks, device),
        spec.one(device)[None],
        prefix[: num_chunks * n - num_chunks - 1],
    ])
    if sanity_enabled():  # prover.rs:325-331: the grand product closes
        total = prefix[-1]
        for prod in products:
            total = F.mont_mul(spec, total, prod[0])
        assert spec.decode_ints(total[None])[0] == 1, "permutation grand product does not close"

    nth_map = torch.from_numpy(bh.nth_map() * num_chunks).to(device)
    return [z_flat.index_select(0, nth_map + offset) for offset in range(num_chunks)]


# ---------------------------------------------------------------------------
# zero check + PCS query bookkeeping (shared with the verifier)
# ---------------------------------------------------------------------------


def pcs_query(expression: Expression, num_instance_poly: int) -> List[Query]:
    """Sorted queries on committed polys (verifier.rs:147-153). BTreeSet
    order = (poly, rotation) lexicographic."""
    qs = [q for q in expression.used_query if q.poly >= num_instance_poly]
    return sorted(qs, key=lambda q: (q.poly, q.rotation))


def sorted_rotations(queries: Sequence[Query]) -> List[int]:
    return sorted({q.rotation for q in queries})


def point_offset(queries: Sequence[Query]) -> Dict[int, int]:
    """verifier.rs:168-182: offset of each rotation's point block."""
    out = {}
    off = 0
    for r in sorted_rotations(queries):
        out[r] = off
        off += 1 << abs(r)
    return out


def points_for_queries(p: int, queries: Sequence[Query], x: Sequence[int]) -> List[List[int]]:
    """verifier.rs:155-166: all rotated evaluation points, rotation-sorted."""
    pts = []
    for r in sorted_rotations(queries):
        pts.extend(mle.rotation_eval_points(p, list(x), r))
    return pts


def prove_sum_check(
    num_instance_poly: int,
    expression: Expression,
    sum_: int,
    polys: Sequence[torch.Tensor],
    challenges: Sequence[int],
    y: Sequence[int],
    transcript,
    spec: FieldSpec = Fr,
) -> Tuple[List[List[int]], List[Evaluation]]:
    """prover.rs:347-409: run the zero/sum check, evaluate rotated queries,
    write eval values, return (points, Evaluations)."""
    num_vars = polys[0].shape[0].bit_length() - 1
    vp = sum_check.VirtualPolynomial(expression, polys, challenges, [list(y)])
    x, final_evals = sum_check.prove(spec, num_vars, vp, sum_, transcript)

    queries = pcs_query(expression, num_instance_poly)
    offsets = point_offset(queries)
    evals: List[Evaluation] = []
    for q in queries:
        if q.rotation == 0:
            vals = [final_evals[q.poly]]
        else:
            vals = mle.evaluate_for_rotation(spec, polys[q.poly], x, q.rotation)
        for i, v in enumerate(vals):
            evals.append(Evaluation(q.poly, offsets[q.rotation] + i, v))

    transcript.write_field_elements([e.value for e in evals])
    return points_for_queries(spec.modulus, queries, x), evals


def prove_zero_check(num_instance_poly, expression, polys, challenges, y, transcript, spec: FieldSpec = Fr):
    return prove_sum_check(num_instance_poly, expression, 0, polys, challenges, y, transcript, spec=spec)
