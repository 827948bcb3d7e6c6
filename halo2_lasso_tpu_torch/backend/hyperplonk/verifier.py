"""HyperPlonk verifier on host ints (the port of
halo2_lasso_tpu/backend/hyperplonk/verifier.py; verifier.rs semantics).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from halo2_lasso_tpu_torch.backend.hyperplonk.prover import pcs_query, point_offset, points_for_queries
from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, Query
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.piop import sum_check
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube


class VerifyError(Halo2LassoError):
    pass


def instance_evals(
    num_vars: int,
    expression: Expression,
    instances: Sequence[Sequence[int]],
    x: Sequence[int],
    spec: FieldSpec = Fr,
) -> Dict[Query, int]:
    """verifier.rs:92-145: evaluate instance polys at x via Lagrange sums."""
    p = spec.modulus
    queries = [q for q in expression.used_query if q.poly < len(instances)]
    if not queries:
        return {}
    lo, hi = 0, 0
    for q in queries:
        i = -q.rotation
        lo = min(lo, i)
        hi = max(hi, i + len(instances[q.poly]))
    if lo < 0:
        lo -= 1
    if hi > 0:
        hi += 1

    bh_seq = BooleanHypercube(num_vars).iter_indices()
    lagrange_evals = {}
    for i in range(lo, hi):
        if i != 0:
            lagrange_evals[i] = mle.lagrange_eval_host(p, x, int(bh_seq[i % (1 << num_vars)]))

    out = {}
    for q in queries:
        vals = instances[q.poly]
        if q.rotation > 0:
            is_ = list(range(-q.rotation, 0)) + list(range(1, len(vals) - q.rotation + 1))
        else:
            is_ = list(range(1 - q.rotation, 1 - q.rotation + len(vals)))
        out[q] = sum(v * lagrange_evals[i] for v, i in zip(vals, is_)) % p
    return out


def verify_sum_check(
    num_vars: int,
    expression: Expression,
    sum_: int,
    instances: Sequence[Sequence[int]],
    challenges: Sequence[int],
    y: Sequence[int],
    transcript,
    spec: FieldSpec = Fr,
) -> Tuple[List[List[int]], List[Evaluation]]:
    """verifier.rs:38-90."""
    p = spec.modulus
    x_eval, x = sum_check.verify(p, num_vars, expression.degree, sum_, transcript)

    queries = pcs_query(expression, len(instances))
    evals_for_rotation = []
    evals: Dict[Query, int] = {}
    for q in queries:
        efr = transcript.read_field_elements(1 << abs(q.rotation))
        evals_for_rotation.append(efr)
        evals[q] = mle.rotation_eval(p, x, q.rotation, efr)

    evals.update(instance_evals(num_vars, expression, instances, x, spec=spec))
    got = sum_check.evaluate_at_point(expression, p, num_vars, evals, challenges, [list(y)], x)
    if got != x_eval:
        raise VerifyError("unmatched sum_check output vs query evaluation")

    offsets = point_offset(queries)
    out_evals = []
    for q, efr in zip(queries, evals_for_rotation):
        for i, v in enumerate(efr):
            out_evals.append(Evaluation(q.poly, offsets[q.rotation] + i, v))
    return points_for_queries(p, queries, x), out_evals


def verify_zero_check(num_vars, expression, instances, challenges, y, transcript, spec: FieldSpec = Fr):
    return verify_sum_check(num_vars, expression, 0, instances, challenges, y, transcript, spec=spec)
