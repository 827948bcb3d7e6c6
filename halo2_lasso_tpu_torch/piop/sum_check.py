"""Sumcheck PIOP, EvaluationsProver semantics (the port of
halo2_lasso_tpu/piop/sum_check.py).

Each round writes the round polynomial's evaluations at t = 0..degree
(evals[0] = sum - evals[1]), squeezes a challenge and folds every leaf
table; the verifier checks evals[0] + evals[1] == claim and interpolates at
the challenge. Leaf tables are uniform MLEs (polys, eq tables, identity and
Lagrange columns, each rotated query materialised as its own column by an
index gather), `_leaf_keys` as in the reference.

``round_message`` is the port of the TPU kernel make_sumcheck_round
(ops/pallas_field.py:376). Instead of generating a kernel per expression,
the host lowers the expression ONCE per structural key to a postfix program
(``lower_expression``) that csrc/sumcheck_round.cu interprets; the message
is summed exactly on the card, in one launch that takes the program, its
constants and the leaf pointers by value (no host-to-device copy). On a
CUDA tensor the wrapper launches the kernel or raises; only CPU tensors
take ``round_message_plain``, which runs the same program with plain field
ops. The TPU policies of the reference
(host tail rounds, PALLAS_MIN, the 40-leaf cap) are dropped: every round of
every size goes through the kernel and the proof bytes are unchanged. A
program past the kernel's compiled limits (MAX_LEAVES, MAX_OPS,
MAX_CONSTS, MAX_STACK) is split as the JAX package chunks its terms
(``plan_round``): chunks of whole challenge-weighted terms, one launch a
chunk, the messages added on the device before the round's one read. A
round of degree d past MAX_DEGREE (8) is split into ceil(d / 8) chunks of
points, t0 + 1 .. t0 + 8 from t0 = 0, 8, 16, ..., one launch a point chunk
(and term chunk), the messages concatenated on the device: the JAX
package's message is the evaluations at 1..d whatever d is. A single term
that alone passes a limit (a product of more than MAX_LEAVES tables) is
evaluated as the JAX package's chunked round evaluation does
(piop/sum_check.py:198-250, ``evaluated_message``): at each point t its
leaf tables bound to t by ``fold_all`` (K2), the term over them by
``evaluate_torch`` (K4's op codes), the pairs summed by ``sum_reduce``; its
message is added to the chunks' on the device. No expression is refused.

Under a mesh (``parallel/sharding.py``'s ``use_mesh``) the leaf tables are
built whole and split by their high index bits over the mesh's shards;
while each shard holds at least one pair of rows, a round launches the
kernel once a shard on its own rows and the partials are added exactly, and
a fold binds X_0 on each shard. Below that the tables are gathered to the
mesh's first device and the rounds go on there. The coefficient prover
splits the same way. The bytes do not change.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, Query, evaluate_host, evaluate_torch, split_challenge_terms
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import native
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.parallel import sharding
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript


class SumcheckError(Halo2LassoError):
    pass


# ---------------------------------------------------------------------------
# host scalar helpers
# ---------------------------------------------------------------------------


def barycentric_weights(p: int, points: Sequence[int]) -> List[int]:
    ws = []
    for j, pj in enumerate(points):
        w = 1
        for i, pi in enumerate(points):
            if i != j:
                w = w * (pj - pi) % p
        ws.append(pow(w, -1, p))
    return ws


def barycentric_interpolate(
    p: int, weights: Sequence[int], points: Sequence[int], evals: Sequence[int], x: int
) -> int:
    coeffs = [pow((x - pt) % p, -1, p) * w % p for pt, w in zip(points, weights)]
    s = sum(coeffs) % p
    num = sum(c * e for c, e in zip(coeffs, evals)) % p
    return num * pow(s, -1, p) % p


def evaluate_at_point(
    expr: Expression,
    p: int,
    num_vars: int,
    evals: Dict[Query, int],
    challenges: Sequence[int],
    ys: Sequence[Sequence[int]],
    x: Sequence[int],
) -> int:
    """Verifier-side evaluation of the composed expression at point x
    (piop/sum_check.rs:60-98 semantics)."""
    bh_seq = BooleanHypercube(num_vars).iter_indices()
    identity = mle.identity_eval_host(p, x)
    eq_vals = [mle.eq_xy_eval_host(p, x, y) for y in ys]

    def leaf(kind, arg):
        if kind == "identity":
            return identity
        if kind == "lagrange":
            b = int(bh_seq[arg % (1 << num_vars)])
            return mle.lagrange_eval_host(p, x, b)
        if kind == "eq_xy":
            return eq_vals[arg]
        if kind == "poly":
            return evals[arg]
        raise ValueError(kind)

    return evaluate_host(expr, p, leaf, list(challenges))


# ---------------------------------------------------------------------------
# the round kernel: postfix program + launcher + plain version
# ---------------------------------------------------------------------------

OP_LEAF, OP_CONST, OP_CHAL, OP_NEG, OP_ADD, OP_MUL, OP_SCALED = range(7)
# csrc/sumcheck_round.cu's compiled limits (tests/test_torch_csrc.py holds
# them equal); round_message raises before a launch that would exceed one
MAX_STACK = 8
MAX_DEGREE = 8
MAX_LEAVES = 128
MAX_OPS = 640
MAX_CONSTS = 32
ROUND_THREADS = 128  # threads a block, at most (csrc/sumcheck_round.cu gives the times)
EVAL_BYTES = 4 << 30  # the device memory one pass of ``evaluated_message`` takes at most
_MAX_BLOCKS = 2048
_SMEM_MAX = 226 * 1024  # the card's shared memory a block, less the kernel's own


@dataclasses.dataclass
class RoundProgram:
    """Postfix form of an expression over leaf tables: (op, arg) pairs;
    ``consts`` are the canonical ints that CONST / SCALED args index."""

    ops: Tuple[Tuple[int, int], ...]
    consts: Tuple[int, ...]
    max_stack: int
    _args: dict = dataclasses.field(default_factory=dict)

    def kernel_args(self, spec: FieldSpec):
        """Host arrays the kernel takes by value, built once: the program as
        op | arg << 3 (uint16) and the constants in Montgomery form."""
        if spec.name not in self._args:
            ops = np.array([op | arg << 3 for op, arg in self.ops], dtype=np.uint16)
            consts = F.ints_to_u32([spec.to_mont_int(c % spec.modulus) for c in self.consts] or [0])
            self._args[spec.name] = (ops, np.ascontiguousarray(consts, dtype=np.uint32))
        return self._args[spec.name]


_PROGRAMS: Dict[Tuple, RoundProgram] = {}


def _stack_need(e: Expression, memo: Dict[int, int]) -> int:
    """Stack slots the postfix program of `e` needs, children of a sum or
    product emitted deeper first (Sethi-Ullman)."""
    got = memo.get(id(e))
    if got is not None:
        return got
    k = e.kind
    if k in ("neg", "scaled"):
        need = _stack_need(e.args[0], memo)
    elif k in ("sum", "product"):
        a, b = (_stack_need(x, memo) for x in e.args)
        need = max(a, b) + (a == b)
    elif k == "powers":
        exprs, base = e.args
        need = max([_stack_need(exprs[-1], memo), 1 + _stack_need(base, memo)]
                   + [1 + _stack_need(x, memo) for x in exprs[:-1]])
    else:
        need = 1
    memo[id(e)] = need
    return need


def _emit(expression: Expression, leaf_index: Dict[Tuple, int], ops: List[Tuple[int, int]], const) -> None:
    """Append the postfix program of `expression` to `ops`. DistributePowers
    becomes Horner's rule: e0 + b(e1 + b(e2 + ...)); of a sum's or a
    product's children the one that needs the deeper stack comes first
    (both ops commute), so a right-deep tree needs no more stack than a
    left-deep one."""
    memo: Dict[int, int] = {}

    def emit(e: Expression):
        k = e.kind
        if k == "const":
            ops.append((OP_CONST, const(e.args[0])))
        elif k == "challenge":
            ops.append((OP_CHAL, e.args[0]))
        elif k == "poly":
            q = e.args[0]
            ops.append((OP_LEAF, leaf_index[("poly", q.poly, q.rotation)]))
        elif k == "eq_xy":
            ops.append((OP_LEAF, leaf_index[("eq", e.args[0])]))
        elif k == "identity":
            ops.append((OP_LEAF, leaf_index[("identity",)]))
        elif k == "lagrange":
            ops.append((OP_LEAF, leaf_index[("lagrange", e.args[0])]))
        elif k == "neg":
            emit(e.args[0])
            ops.append((OP_NEG, 0))
        elif k in ("sum", "product"):
            a, b = e.args
            if _stack_need(b, memo) > _stack_need(a, memo):
                a, b = b, a
            emit(a)
            emit(b)
            ops.append((OP_ADD if k == "sum" else OP_MUL, 0))
        elif k == "scaled":
            emit(e.args[0])
            ops.append((OP_SCALED, const(e.args[1])))
        elif k == "powers":
            exprs, base = e.args
            emit(exprs[-1])
            for ex in reversed(exprs[:-1]):
                emit(base)
                ops.append((OP_MUL, 0))
                emit(ex)
                ops.append((OP_ADD, 0))
        else:
            raise ValueError(f"unknown kind {k}")

    emit(expression)


def _program(ops: List[Tuple[int, int]], consts: Dict[int, int]) -> RoundProgram:
    depth = max_depth = 0
    for op, _ in ops:
        depth += 1 if op in (OP_LEAF, OP_CONST, OP_CHAL) else (-1 if op in (OP_ADD, OP_MUL) else 0)
        max_depth = max(max_depth, depth)
    return RoundProgram(tuple(ops), tuple(consts), max_depth)


def _lower(expression: Expression, keys: Sequence[Tuple]) -> RoundProgram:
    """The postfix program of the expression over the leaf tables in `keys`
    order, whatever its size."""
    ops: List[Tuple[int, int]] = []
    consts: Dict[int, int] = {}  # value -> its slot, so a repeated constant takes one of MAX_CONSTS
    _emit(expression, {k: i for i, k in enumerate(keys)}, ops, lambda v: consts.setdefault(int(v), len(consts)))
    return _program(ops, consts)


def lower_expression(expression: Expression, keys: Sequence[Tuple]) -> RoundProgram:
    """Lower the expression to a postfix program over the leaf tables in
    `keys` order, cached on its structural key (see ``_emit``). Raises if
    the program needs more than the kernel's MAX_STACK slots."""
    cache_key = (expression.structural_key, tuple(keys))
    prog = _PROGRAMS.get(cache_key)
    if prog is not None:
        return prog
    prog = _lower(expression, keys)
    if prog.max_stack > MAX_STACK:
        raise SumcheckError(
            f"expression of depth {_depth(expression)} needs a stack of {prog.max_stack} > {MAX_STACK}"
        )
    _PROGRAMS[cache_key] = prog
    return prog


def _depth(e: Expression) -> int:
    """Nodes on the longest path from the root to a leaf."""
    if e.kind == "powers":
        return 1 + max(_depth(x) for x in (*e.args[0], e.args[1]))
    if e.kind in ("neg", "scaled"):
        return 1 + _depth(e.args[0])
    if e.kind in ("sum", "product"):
        return 1 + max(_depth(x) for x in e.args)
    return 1


def _fits(prog: RoundProgram, leaves: int) -> bool:
    return (leaves <= MAX_LEAVES and len(prog.ops) <= MAX_OPS and len(prog.consts) <= MAX_CONSTS
            and prog.max_stack <= MAX_STACK)


@dataclasses.dataclass
class RoundChunk:
    """One launch of a split round: its program over the leaf tables
    `leaves` (indices into the round's tables) computes sum_j c_j * t_j over
    its terms, each coefficient c_j read as the challenge row
    ``num_challenges + term index`` (see ``RoundPlan.challenge_rows``)."""

    program: RoundProgram
    leaves: Tuple[int, ...]


def point_chunks(degree: int) -> Tuple[Tuple[int, int], ...]:
    """The round's points 1..degree as launches of at most MAX_DEGREE: (t0,
    D) evaluates t0 + 1 .. t0 + D."""
    return tuple((t0, min(MAX_DEGREE, degree - t0)) for t0 in range(0, degree, MAX_DEGREE))


@dataclasses.dataclass
class EvaluatedTerm:
    """A term that alone passes the round kernel's limits, evaluated with
    the field ops (``evaluated_message``): its leaf tables `leaves`
    (indices into the round's tables) under their `keys`, its coefficient
    the challenge row `row`; `field_ops` is the K4 launches one evaluation
    makes on the card (``_field_ops``)."""

    term: Expression
    leaves: Tuple[int, ...]
    keys: Tuple[Tuple, ...]
    row: int
    field_ops: int


@dataclasses.dataclass
class RoundPlan:
    """How a sumcheck's round message is computed. Within the kernel's
    limits: one program over every leaf table, one launch a round. Past
    them: the expression split into challenge-weighted terms
    (``split_challenge_terms``), packed into chunks of whole terms that each
    fit every limit, one launch a chunk; a term that fits no chunk alone is
    ``evaluated``. The coefficients are challenge-only expressions
    evaluated on the host, as the JAX package does
    (piop/sum_check.py:555-560), and the chunks' and evaluated terms'
    messages are added on the device (a stack, one ``sum_reduce``) before
    the round's one read. Either way, a degree past MAX_DEGREE is evaluated
    in the chunks of points ``points`` (``point_chunks``), one launch (or
    one a term chunk) each, their messages concatenated on the device."""

    program: Optional[RoundProgram]
    chunks: Tuple[RoundChunk, ...] = ()
    coeffs: Tuple[Expression, ...] = ()
    points: Tuple[Tuple[int, int], ...] = ()  # set by plan_round
    evaluated: Tuple[EvaluatedTerm, ...] = ()

    def challenge_rows(self, p: int, challenges: Sequence[int]) -> List[int]:
        """The challenges the launches read: the sumcheck's own and, for a
        split round, each term's coefficient after them."""
        def leaf(kind, arg):
            raise ValueError("coefficient expressions must be challenge-only")

        return list(challenges) + [evaluate_host(c, p, leaf, list(challenges)) for c in self.coeffs]


_PLANS: Dict[Tuple, RoundPlan] = {}


def plan_round(expression: Expression, keys: Sequence[Tuple], p: int, num_challenges: int) -> RoundPlan:
    """The round plan of a sumcheck (see ``RoundPlan``), cached on the
    expression's structural key. Decided on the host the same way on every
    device."""
    cache_key = (expression.structural_key, tuple(keys), p, num_challenges)
    plan = _PLANS.get(cache_key)
    if plan is not None:
        return plan
    whole = _lower(expression, keys)
    if _fits(whole, len(keys)):
        plan = RoundPlan(_PROGRAMS.setdefault((expression.structural_key, tuple(keys)), whole))
    else:
        plan = _split_plan(expression, keys, p, num_challenges)
    plan.points = point_chunks(expression.degree)
    _PLANS[cache_key] = plan
    return plan


def _split_plan(expression: Expression, keys: Sequence[Tuple], p: int, num_challenges: int) -> RoundPlan:
    terms = split_challenge_terms(expression, p)
    index = {k: i for i, k in enumerate(keys)}

    def reads(term: Expression) -> set:
        used = {("poly", q.poly, q.rotation) for q in term.used_query}
        used |= {("eq", i) for i in term.used_eq_xy} | {("lagrange", i) for i in term.used_lagrange}
        if term.used_identity:
            used.add(("identity",))
        return {index[k] for k in used}

    def lower(members: List[int]):
        leaves = sorted(set().union(*(reads(terms[j][1]) for j in members))) or [0]
        local = {keys[g]: i for i, g in enumerate(leaves)}
        ops: List[Tuple[int, int]] = []
        consts: Dict[int, int] = {}
        for n, j in enumerate(members):
            _emit(terms[j][1], local, ops, lambda v: consts.setdefault(int(v), len(consts)))
            ops += [(OP_CHAL, num_challenges + j), (OP_MUL, 0)] + ([(OP_ADD, 0)] if n else [])
        return RoundChunk(_program(ops, consts), tuple(leaves))

    chunks: List[RoundChunk] = []
    evaluated: List[EvaluatedTerm] = []
    members: List[int] = []
    for j, (_, term) in enumerate(terms):
        if members:
            trial = lower(members + [j])
            if _fits(trial.program, len(trial.leaves)):
                members.append(j)
                continue
        alone = lower([j])
        if not _fits(alone.program, len(alone.leaves)):
            leaves = tuple(sorted(reads(term)))
            evaluated.append(EvaluatedTerm(term, leaves, tuple(keys[i] for i in leaves), num_challenges + j,
                                           _field_ops(term)))
            continue
        if members:
            chunks.append(lower(members))
        members = [j]
    if members:
        chunks.append(lower(members))
    return RoundPlan(None, tuple(chunks), tuple(c for c, _ in terms), evaluated=tuple(evaluated))


def _field_ops(term: Expression) -> int:
    """The K4 launches of one ``evaluate_torch`` of `term`: every negation,
    sum or product with a tensor operand (a leaf or a challenge row) once,
    shared subexpressions once; constants fold on the host."""
    ops = 0

    def op(*args):
        nonlocal ops
        tensor = any(args)
        ops += tensor
        return tensor

    term.evaluate(lambda _: False, lambda _: True, lambda _: True, lambda _: True, op, op, op, lambda a, _: op(a))
    return ops


def round_message_planned(spec: FieldSpec, tables: Sequence[torch.Tensor], plan: RoundPlan,
                          challenges: Optional[torch.Tensor]) -> torch.Tensor:
    """(degree, 8): the round message by `plan`, for each chunk of points
    one ``round_message`` a term chunk (one for a plan within the limits)
    and one ``evaluated_message`` an evaluated term, their messages added on
    the tables' device with one ``sum_reduce``, the point chunks'
    concatenated there."""
    outs = []
    for t0, d in plan.points:
        if plan.program is not None:
            outs.append(round_message(spec, tables, plan.program, challenges, d, t0))
            continue
        parts = [round_message(spec, [tables[i] for i in c.leaves], c.program, challenges, d, t0) for c in plan.chunks]
        parts += [evaluated_message(spec, tables, e, challenges, d, t0) for e in plan.evaluated]
        outs.append(F.sum_reduce(spec, torch.stack(parts)))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def point_batch(ev: EvaluatedTerm, h: int) -> int:
    """The points that ``evaluated_message`` evaluates in one pass over h
    pairs: as many as EVAL_BYTES holds with the bound tables and the
    evaluation's intermediates, 1 to MAX_DEGREE."""
    per_point = (len(ev.leaves) + ev.field_ops) * h * 4 * F.LIMBS
    return max(1, min(MAX_DEGREE, EVAL_BYTES // max(1, per_point)))


def evaluated_message(spec: FieldSpec, tables: Sequence[torch.Tensor], ev: EvaluatedTerm, challenges: torch.Tensor,
                      degree: int, t0: int = 0) -> torch.Tensor:
    """(degree, 8): an evaluated term's message c * sum over pairs of the
    term at t = t0+1..t0+degree, as the JAX package's ``_make_chunk_fn``
    (piop/sum_check.py:198-250) computes it, a batch of points
    (``point_batch``) a pass: at each t the term's leaf tables bound to t
    (``fold_all``: lo + t (hi - lo), its e1 + (t - 1) step) into one (points,
    tables, h, 8) buffer, the term over the batch (``evaluate_torch``, each
    op one launch for every point), the pairs of every point summed (one
    ``sum_reduce``; a term constant over the hypercube is half * v), then
    one product by its coefficient row. On a CUDA tensor each step launches
    K2, K4 or the row sum, or raises; CPU tensors take their plain
    versions."""
    leaves = [tables[i] for i in ev.leaves]
    h = tables[0].shape[0] // 2
    device = tables[0].device
    step = point_batch(ev, h)
    sums = []
    for b in range(t0, t0 + degree, step):
        ts = range(b + 1, min(b + step, t0 + degree) + 1)
        values = {}
        if leaves:
            bound = torch.empty((len(ts), len(leaves), h, F.LIMBS), dtype=torch.int32, device=device)
            for j, t in enumerate(ts):
                mle.fold_all(spec, leaves, t, out=bound[j])
            values = {k: bound[:, i] for i, k in enumerate(ev.keys)}

        def leaf(kind, arg):
            if kind == "poly":
                return values[("poly", arg.poly, arg.rotation)]
            if kind == "eq_xy":
                return values[("eq", arg)]
            return values[(kind,) if kind == "identity" else (kind, arg)]

        v = evaluate_torch(spec, ev.term, leaf, challenges, device)
        sums.append(F.sum_reduce(spec, v.transpose(0, 1)) if v.dim() > 1
                    else F.mont_mul(spec, v, h).expand(len(ts), F.LIMBS))
    return F.mont_mul(spec, torch.cat(sums), challenges[ev.row])


def round_message_plain(
    spec: FieldSpec,
    tables: Sequence[torch.Tensor],
    program: RoundProgram,
    challenges: torch.Tensor,
    degree: int,
    t0: int = 0,
) -> torch.Tensor:
    """(degree, 8): sum over pairs of the program at t = t0+1..t0+degree."""
    device = tables[0].device
    h = tables[0].shape[0] // 2
    lo = [t[0::2] for t in tables]
    vals = [t[1::2] for t in tables]
    steps = [F.sub_plain(spec, v, l) for v, l in zip(vals, lo)] if degree > 1 or t0 else None
    if t0:
        t0_m = spec.encode([t0], device)[0]
        vals = [F.add_plain(spec, v, F.mont_mul_plain(spec, s, t0_m)) for v, s in zip(vals, steps)]
    consts = spec.encode(list(program.consts) or [0], device)
    out = []
    for t in range(degree):
        if t:
            vals = [F.add_plain(spec, v, s) for v, s in zip(vals, steps)]
        st: List[torch.Tensor] = []
        for op, arg in program.ops:
            if op == OP_LEAF:
                st.append(vals[arg])
            elif op == OP_CONST:
                st.append(consts[arg])
            elif op == OP_CHAL:
                st.append(challenges[arg])
            elif op == OP_NEG:
                st.append(F.neg_plain(spec, st.pop()))
            elif op == OP_ADD:
                b = st.pop()
                st.append(F.add_plain(spec, st.pop(), b))
            else:
                b = st.pop() if op == OP_MUL else consts[arg]
                st.append(F.mont_mul_plain(spec, st.pop(), b))
        out.append(F.sum_reduce_plain(spec, st[0].expand(h, F.LIMBS)))
    return torch.stack(out)


def round_message(
    spec: FieldSpec,
    tables: Sequence[torch.Tensor],
    program: RoundProgram,
    challenges: torch.Tensor,
    degree: int,
    t0: int = 0,
) -> torch.Tensor:
    """Round message at t = t0+1..t0+degree over the leaf tables (each (2h,
    8), pairs (2i, 2i+1)); challenges (c, 8) or None; degree at most
    MAX_DEGREE on the card (``round_message_planned`` splits a larger one
    into chunks of points). Kernel: csrc/sumcheck_round.cu."""
    tables = list(tables)
    if tables[0].device.type == "cpu":
        return round_message_plain(spec, tables, program, challenges, degree, t0)
    fid = native.field_id("sumcheck_round", spec)
    if not 1 <= degree <= MAX_DEGREE:
        raise SumcheckError(f"{degree} points a launch, outside 1..{MAX_DEGREE}")
    if not 0 <= t0 < 1 << 31:
        raise SumcheckError(f"the first point t0 = {t0} is outside 0..2^31 - 1")
    if len(tables) > MAX_LEAVES or len(program.ops) > MAX_OPS or len(program.consts) > MAX_CONSTS:
        raise SumcheckError(
            f"program of {len(tables)} leaves, {len(program.ops)} ops and {len(program.consts)} "
            f"constants exceeds the kernel's {MAX_LEAVES}, {MAX_OPS} and {MAX_CONSTS}"
        )
    n = tables[0].shape[0]
    if any(t.shape != (n, F.LIMBS) for t in tables) or n % 2:
        raise ValueError("sumcheck_round: tables must share one even length")
    native.require_cuda("sumcheck_round", *tables, *([] if challenges is None else [challenges]))
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("sumcheck_round: tables must start on a 16-byte boundary")
    device = tables[0].device
    h = n // 2
    threads = round_threads(program.max_stack, degree)
    blocks = max(1, min(_MAX_BLOCKS, -(-h // threads)))
    partials = torch.empty((blocks * degree, F.LIMBS), dtype=torch.int32, device=device)
    out = torch.empty((degree, F.LIMBS), dtype=torch.int32, device=device)
    ops, consts = program.kernel_args(spec)
    leaves = (ctypes.c_void_p * len(tables))(*[t.data_ptr() for t in tables])
    t0_m = spec.to_mont_int(t0 % spec.modulus).to_bytes(32, "little") if t0 else None
    native.launch(
        "sumcheck_round", device, fid, ctypes.addressof(leaves), len(tables), ops.ctypes.data, len(ops),
        consts.ctypes.data, len(program.consts), None if challenges is None else challenges.data_ptr(), h, degree,
        t0, t0_m, program.max_stack, threads, blocks, partials.data_ptr(),
        native.ticket("sumcheck_round", device).data_ptr(), out.data_ptr(),
    )
    native.count("sumcheck_round", "fq" if fid == 1 else "")
    return out


def round_threads(max_stack: int, degree: int) -> int:
    """ROUND_THREADS, halved until the block's stack fits in shared memory."""
    threads = ROUND_THREADS
    while threads > 32 and max_stack * degree * 32 * threads > _SMEM_MAX:
        threads //= 2
    return threads


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


class VirtualPolynomial:
    """expression over polys ((2^k, 8) tensors) + challenges + ys (host ints)."""

    def __init__(
        self,
        expression: Expression,
        polys: Sequence[torch.Tensor],
        challenges: Sequence[int],
        ys: Sequence[Sequence[int]],
    ):
        self.expression = expression
        self.polys = list(polys)
        self.challenges = list(challenges)
        self.ys = [list(y) for y in ys]


def _leaf_keys(expression: Expression, num_polys: int):
    keys = [("poly", i, 0) for i in range(num_polys)]
    for q in sorted(expression.used_query, key=lambda q: (q.poly, q.rotation)):
        if q.rotation != 0:
            keys.append(("poly", q.poly, q.rotation))
    for idx in sorted(expression.used_eq_xy):
        keys.append(("eq", idx))
    if expression.used_identity:
        keys.append(("identity",))
    for i in sorted(expression.used_lagrange):
        keys.append(("lagrange", i))
    return keys


def _leaf_table(spec: FieldSpec, key, vp: VirtualPolynomial, num_vars: int, device):
    kind = key[0]
    n = 1 << num_vars
    if kind == "poly":
        poly = vp.polys[key[1]]
        if not key[2]:
            return poly
        if isinstance(poly, sharding.Shards):
            raise SumcheckError("a rotated query of a table already split over the mesh")
        return mle.rotate_evals(spec, poly, key[2])
    if kind == "eq":
        return mle.eq_xy(spec, vp.ys[key[1]], device)
    if kind == "identity":
        return F.u32_to_mont(spec, torch.arange(n, device=device))
    if kind == "lagrange":
        b = int(BooleanHypercube(num_vars).iter_indices()[key[1] % n])
        onehot = torch.zeros(n, dtype=torch.int64, device=device)
        onehot[b] = 1
        return F.u32_to_mont(spec, onehot)
    raise ValueError(key)


def prove(
    spec: FieldSpec,
    num_vars: int,
    virtual_poly: VirtualPolynomial,
    sum_: int,
    transcript: Keccak256Transcript,
) -> Tuple[List[int], List[int]]:
    """Run the sumcheck prover; returns (challenges, final poly evals as ints).
    Mirrors ClassicSumCheck::prove (classic.rs:208-240): message per round,
    squeeze, fold."""
    expression = virtual_poly.expression
    degree = expression.degree
    p = spec.modulus
    assert num_vars > 0 and expression.max_used_rotation_distance() <= num_vars
    mesh = sharding.active_mesh()
    first = virtual_poly.polys[0]
    device = first[0].device if isinstance(first, sharding.Shards) else first.device
    keys = _leaf_keys(expression, len(virtual_poly.polys))
    tables = _Tables(spec, [_leaf_table(spec, k, virtual_poly, num_vars, device) for k in keys], num_vars, mesh)
    plan = plan_round(expression, keys, p, len(virtual_poly.challenges))
    rows = plan.challenge_rows(p, virtual_poly.challenges)
    chal = spec.encode(rows, device) if rows else None

    def message(tabs: List[torch.Tensor]) -> torch.Tensor:
        return round_message_planned(spec, tabs, plan, None if chal is None else chal.to(tabs[0].device))

    challenges: List[int] = []
    current_sum = sum_ % p
    points = list(range(degree + 1))
    weights = barycentric_weights(p, points)
    for _ in range(num_vars):
        msg_tail = tables.message(message)
        evals = [(current_sum - msg_tail[0]) % p] + msg_tail
        transcript.write_field_elements(evals)
        r = transcript.squeeze_challenge()
        challenges.append(r)
        current_sum = barycentric_interpolate(p, weights, points, evals, r)
        tables.fold(r)
    n_polys = len(virtual_poly.polys)
    return challenges, spec.decode_ints(torch.cat([t[:1] for t in tables.whole()[:n_polys]]))


class _Tables:
    """A sumcheck's tables: whole on one device, or under a mesh split over
    its shards while each shard holds at least one pair of rows (a table may
    come already split, ``sharding.Shards``). A round message is each
    shard's (one kernel launch a shard) combined exactly; a fold binds X_0
    on each shard (``fold_all``, no exchange); when a shard would hold a
    single row the tables are gathered to the mesh's first device and the
    rounds go on there."""

    def __init__(self, spec: FieldSpec, tables: Sequence, num_vars: int, mesh):
        self.spec = spec
        self.mesh = mesh if mesh is not None and mesh.holds(1 << num_vars) else None
        if self.mesh is None:
            if any(isinstance(t, sharding.Shards) for t in tables):
                raise SumcheckError("tables split over a mesh that is not active")
            self.shards = [list(tables)]
        else:
            split = [t if isinstance(t, sharding.Shards) else self.mesh.split(t) for t in tables]
            self.shards = [list(s) for s in zip(*split)]

    def message(self, fn) -> List[int]:
        outs = [fn(tabs) for tabs in self.shards]
        return self.spec.decode_ints(outs[0]) if self.mesh is None else self.mesh.combine(self.spec, outs)

    def fold(self, r: int) -> None:
        self.shards = [mle.fold_all(self.spec, tabs, r) for tabs in self.shards]
        if self.mesh is not None and self.shards[0][0].shape[0] < 2:
            whole = self.mesh.gather([torch.stack(tabs) for tabs in self.shards], 1)
            self.shards, self.mesh = [list(whole.unbind(0))], None

    def whole(self) -> List[torch.Tensor]:
        if self.mesh is not None:
            raise SumcheckError("the tables are still split over the mesh")
        return self.shards[0]


# ---------------------------------------------------------------------------
# coefficients prover (degree-2, for PCS additive batch-open)
# ---------------------------------------------------------------------------


def prove_coeff_products(
    spec: FieldSpec,
    num_vars: int,
    terms: Sequence[Tuple[int, torch.Tensor, torch.Tensor]],
    sum_: int,
    transcript: Keccak256Transcript,
) -> Tuple[List[int], List[torch.Tensor]]:
    """Sumcheck with COEFFICIENT round messages for sum_j s_j * eq_j * poly_j
    (pcs/multilinear.rs:186-201): per round [c0, c1, c2] with
    c1 = sum - 2*c0 - c2 (coeff.rs:137-147). terms: (scalar, eq table,
    poly). Returns (challenges, final folded polys, each (1, 8))."""
    p = spec.modulus
    T = len(terms)
    tables = _Tables(spec, [t[1] for t in terms] + [t[2] for t in terms], num_vars, sharding.active_mesh())
    scalars = [t[0] % p for t in terms]

    def sums_of(tabs: List[torch.Tensor]) -> torch.Tensor:
        """(2T, 8): the c0 and c2 column sums of each term over these rows."""
        st = torch.stack(tabs)  # (2T, n, 8): eq tables, then polys
        lo = st[:, 0::2]
        diff = F.sub(spec, st[:, 1::2], lo)  # (2T, h, 8), the strided halves read in place
        prods = torch.empty((2 * T,) + lo.shape[1:], dtype=torch.int32, device=st.device)
        F.mont_mul(spec, lo[:T], lo[T:], out=prods[:T])  # c0 terms: e0 * p0
        F.mont_mul(spec, diff[:T], diff[T:], out=prods[T:])  # c2 terms: (e1 - e0)(p1 - p0)
        return F.sum_reduce(spec, prods.transpose(0, 1))

    challenges: List[int] = []
    current_sum = sum_ % p
    for _ in range(num_vars):
        sums = tables.message(sums_of)
        c0 = sum(s * v for s, v in zip(scalars, sums[:T])) % p
        c2 = sum(s * v for s, v in zip(scalars, sums[T:])) % p
        c1 = (current_sum - 2 * c0 - c2) % p
        transcript.write_field_elements([c0, c1, c2])
        r = transcript.squeeze_challenge()
        challenges.append(r)
        current_sum = (c0 + c1 * r + c2 * r * r) % p
        tables.fold(r)
    return challenges, tables.whole()[T:]


def verify_coeff(
    p: int,
    num_vars: int,
    degree: int,
    sum_: int,
    transcript: Keccak256Transcript,
) -> Tuple[int, List[int]]:
    """Verifier for coefficient round messages: consistency via
    2*c0 + c1 + ... + cd == sum, evaluation via Horner (coeff.rs:20-39)."""
    msgs, challenges = [], []
    for _ in range(num_vars):
        msgs.append(transcript.read_field_elements(degree + 1))
        challenges.append(transcript.squeeze_challenge())
    current = sum_ % p
    for rnd, (msg, r) in enumerate(zip(msgs, challenges)):
        if current != (2 * msg[0] + sum(msg[1:])) % p:
            raise SumcheckError(f"coeff consistency failure at round {rnd}")
        acc = 0
        for c in reversed(msg):
            acc = (acc * r + c) % p
        current = acc
    return current, challenges


# ---------------------------------------------------------------------------
# verifier (host)
# ---------------------------------------------------------------------------


def verify(
    p: int,
    num_vars: int,
    degree: int,
    sum_: int,
    transcript: Keccak256Transcript,
) -> Tuple[int, List[int]]:
    """Read round messages, check consistency, return (final_eval, challenges)
    (classic.rs:242-263 + RoundMessage::verify_consistency semantics)."""
    points = list(range(degree + 1))
    weights = barycentric_weights(p, points)
    msgs = []
    challenges = []
    for _ in range(num_vars):
        msgs.append(transcript.read_field_elements(degree + 1))
        challenges.append(transcript.squeeze_challenge())

    current = sum_ % p
    for rnd, (msg, r) in enumerate(zip(msgs, challenges)):
        if current != (msg[0] + msg[1]) % p:
            raise SumcheckError(f"consistency failure at round {rnd}")
        current = barycentric_interpolate(p, weights, points, msg, r)
    return current, challenges
