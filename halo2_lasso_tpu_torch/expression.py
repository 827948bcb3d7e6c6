"""Constraint-system expression IR (the port's copy of
halo2_lasso_tpu/expression.py).

Semantics mirror the Rust reference AST (util/expression.rs): Constant /
CommonPolynomial{Identity, Lagrange(i), EqXY(idx)} / Polynomial(Query{poly,
rotation}) / Challenge(idx) / Neg / Sum / Product / Scaled /
DistributePowers (expr0 + sum_{i>=1} base^i * expr_i).

`evaluate_host` evaluates over Python ints (the verifier); `evaluate_torch`
over field tensors (the prover), with `hypercube_leaves` supplying the leaf
tables over all rows; `from_foreign` rebuilds a tree made by the
JAX package (for parameters carried across); `expression_to_obj` /
`expression_from_obj` write and read the JAX package's JSON tree
(utils/serialize.py). The sumcheck round kernel does not walk this tree:
piop/sum_check.py lowers it to a postfix program once per
`structural_key`, and past the kernel's limits splits it into
challenge-weighted terms first (`split_challenge_terms`).

Constants/scalars are canonical python ints (mod p applied by the evaluators).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, FrozenSet, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.field import FieldSpec
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.poly.bh import BooleanHypercube


@dataclasses.dataclass(frozen=True)
class Query:
    poly: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class Expression:
    """Algebraic expression node. `kind` in {const, identity, lagrange, eq_xy,
    poly, challenge, neg, sum, product, scaled, powers}."""

    kind: str
    args: Tuple = ()

    # ---- constructors ----

    @staticmethod
    def constant(v: int) -> "Expression":
        return Expression("const", (int(v),))

    @staticmethod
    def identity() -> "Expression":
        return Expression("identity")

    @staticmethod
    def lagrange(i: int) -> "Expression":
        return Expression("lagrange", (int(i),))

    @staticmethod
    def eq_xy(idx: int) -> "Expression":
        return Expression("eq_xy", (int(idx),))

    @staticmethod
    def poly(idx: int, rotation: int = 0) -> "Expression":
        return Expression("poly", (Query(idx, rotation),))

    @staticmethod
    def challenge(idx: int) -> "Expression":
        return Expression("challenge", (int(idx),))

    @staticmethod
    def distribute_powers(exprs: Sequence["Expression"], base: "Expression") -> "Expression":
        exprs = list(exprs)
        assert exprs
        if len(exprs) == 1:
            return exprs[0]
        return Expression("powers", (tuple(exprs), base))

    # ---- operators ----

    def __neg__(self):
        return Expression("neg", (self,))

    def __add__(self, other):
        other = _coerce(other)
        return Expression("sum", (self, other))

    def __radd__(self, other):
        return _coerce(other) + self

    def __sub__(self, other):
        return self + (-_coerce(other))

    def __rsub__(self, other):
        return _coerce(other) + (-self)

    def __mul__(self, other):
        if isinstance(other, int):
            return Expression("scaled", (self, other))
        return Expression("product", (self, other))

    def __rmul__(self, other):
        return self.__mul__(other)

    # ---- generic catamorphism with DAG memoization ----

    def evaluate(
        self,
        constant: Callable,
        common_poly: Callable,
        poly: Callable,
        challenge: Callable,
        negated: Callable,
        sum_: Callable,
        product: Callable,
        scaled: Callable,
    ):
        memo: Dict[int, object] = {}

        def go(e: "Expression"):
            key = id(e)
            if key in memo:
                return memo[key]
            k = e.kind
            if k == "const":
                r = constant(e.args[0])
            elif k in ("identity", "lagrange", "eq_xy"):
                r = common_poly(e)
            elif k == "poly":
                r = poly(e.args[0])
            elif k == "challenge":
                r = challenge(e.args[0])
            elif k == "neg":
                r = negated(go(e.args[0]))
            elif k == "sum":
                r = sum_(go(e.args[0]), go(e.args[1]))
            elif k == "product":
                r = product(go(e.args[0]), go(e.args[1]))
            elif k == "scaled":
                r = scaled(go(e.args[0]), e.args[1])
            elif k == "powers":
                exprs, base = e.args
                if len(exprs) == 1:
                    r = go(exprs[0])
                else:
                    b = go(base)
                    acc = go(exprs[0])
                    power = b
                    for i, ex in enumerate(exprs[1:]):
                        if i > 0:
                            power = product(power, b)
                        acc = sum_(acc, product(power, go(ex)))
                    r = acc
            else:
                raise ValueError(f"unknown kind {k}")
            memo[key] = r
            return r

        return go(self)

    # ---- queries ----

    @functools.cached_property
    def degree(self) -> int:
        return self.evaluate(
            lambda _: 0,
            lambda _: 1,
            lambda _: 1,
            lambda _: 0,
            lambda a: a,
            lambda a, b: max(a, b),
            lambda a, b: a + b,
            lambda a, _: a,
        )

    def _collect(self, select: Callable) -> FrozenSet:
        return self.evaluate(
            lambda v: frozenset(),
            lambda e: select("common", e),
            lambda q: select("poly", q),
            lambda c: select("challenge", c),
            lambda a: a,
            lambda a, b: a | b,
            lambda a, b: a | b,
            lambda a, _: a,
        )

    @functools.cached_property
    def used_query(self) -> FrozenSet[Query]:
        return self._collect(
            lambda t, v: frozenset([v]) if t == "poly" else frozenset()
        )

    @functools.cached_property
    def used_poly(self) -> FrozenSet[int]:
        return frozenset(q.poly for q in self.used_query)

    @functools.cached_property
    def used_rotation(self) -> FrozenSet[int]:
        return frozenset(q.rotation for q in self.used_query)

    def max_used_rotation_distance(self) -> int:
        return max((abs(r) for r in self.used_rotation), default=0)

    @functools.cached_property
    def used_lagrange(self) -> FrozenSet[int]:
        return self._collect(
            lambda t, v: frozenset([v.args[0]])
            if t == "common" and v.kind == "lagrange"
            else frozenset()
        )

    @functools.cached_property
    def used_eq_xy(self) -> FrozenSet[int]:
        return self._collect(
            lambda t, v: frozenset([v.args[0]])
            if t == "common" and v.kind == "eq_xy"
            else frozenset()
        )

    @functools.cached_property
    def used_identity(self) -> bool:
        return bool(
            self._collect(
                lambda t, v: frozenset([0])
                if t == "common" and v.kind == "identity"
                else frozenset()
            )
        )

    @functools.cached_property
    def used_challenge(self) -> FrozenSet[int]:
        return self._collect(
            lambda t, v: frozenset([v]) if t == "challenge" else frozenset()
        )

    @functools.cached_property
    def structural_key(self) -> Tuple:
        """Canonical hashable tree: equal keys <=> identical computations.
        Used to share compiled round-kernel chunks across circuits/provers
        (id()-based caching only dedups within one prover param object)."""
        k = self.kind
        if k == "const":
            return ("const", self.args[0])
        if k in ("identity",):
            return ("identity",)
        if k in ("lagrange", "eq_xy", "challenge"):
            return (k, self.args[0])
        if k == "poly":
            q = self.args[0]
            return ("poly", q.poly, q.rotation)
        if k == "powers":
            exprs, base = self.args
            return ("powers", tuple(e.structural_key for e in exprs), base.structural_key)
        if k == "scaled":
            return ("scaled", self.args[0].structural_key, self.args[1])
        return (k,) + tuple(a.structural_key for a in self.args)


    @functools.cached_property
    def mul_count(self) -> int:
        """Number of field multiplications one evaluation of this expression
        performs (the JAX package's proxy for a chunk's size)."""
        return self.evaluate(
            lambda _: 0,
            lambda _: 0,
            lambda _: 0,
            lambda _: 0,
            lambda a: a,
            lambda a, b: a + b,
            lambda a, b: a + b + 1,
            lambda a, _: a + 1,
        )

    def is_challenge_only(self) -> bool:
        """True if the expression references no polynomial/common leaves, so it
        can be evaluated on host from the challenges alone."""
        return (
            not self.used_query
            and not self.used_eq_xy
            and not self.used_lagrange
            and not self.used_identity
        )

    def simplified(self, p: int) -> "Expression":
        """Constant-folded copy mod p (reference: Expression::simplified,
        util/expression.rs:326-486 — semantics only; this is a plain
        bottom-up fold): constant arithmetic collapsed, 0/1-identities
        eliminated, nested Scaled merged."""

        def const(v):
            return Expression.constant(v % p)

        def is_const(e):
            return e.kind == "const"

        def cval(e):
            return e.args[0] % p

        def neg(a):
            if is_const(a):
                return const(-cval(a))
            return Expression("neg", (a,))

        def add(a, b):
            if is_const(a) and cval(a) == 0:
                return b
            if is_const(b) and cval(b) == 0:
                return a
            if is_const(a) and is_const(b):
                return const(cval(a) + cval(b))
            return Expression("sum", (a, b))

        def mul(a, b):
            if is_const(a):
                a, b = b, a
            if is_const(b):
                v = cval(b)
                if v == 0:
                    return const(0)
                if v == 1:
                    return a
                if is_const(a):
                    return const(cval(a) * v)
                return scale(a, v)
            return Expression("product", (a, b))

        def scale(a, s):
            s = s % p
            if s == 0 or (is_const(a) and cval(a) == 0):
                return const(0)
            if s == 1:
                return a
            if is_const(a):
                return const(cval(a) * s)
            if a.kind == "scaled":
                return scale(a.args[0], a.args[1] * s)
            return Expression("scaled", (a, s))

        return self.evaluate(
            lambda v: const(v),
            lambda e: e,
            lambda q: Expression("poly", (q,)),
            lambda c: Expression.challenge(c),
            neg,
            add,
            mul,
            scale,
        )


def from_foreign(e) -> Expression:
    """An expression tree of the same shape built by another package (the
    JAX package's Expression: `kind`, `args`, queries with `poly` and
    `rotation`) -> the port's Expression."""
    k, args = e.kind, e.args
    if k == "poly":
        return Expression.poly(args[0].poly, args[0].rotation)
    if k in ("const", "identity", "lagrange", "eq_xy", "challenge"):
        return Expression(k, tuple(args))
    if k == "scaled":
        return Expression(k, (from_foreign(args[0]), int(args[1])))
    if k == "powers":
        return Expression(k, (tuple(from_foreign(x) for x in args[0]), from_foreign(args[1])))
    return Expression(k, tuple(from_foreign(a) for a in args))


def split_challenge_terms(expr: Expression, p: int):
    """Decompose `expr` into [(coeff, term)] with expr == sum_i coeff_i * term_i,
    where every coeff is a challenge-only Expression (host-evaluable) and the
    terms are the individual constraint polynomials.

    This undoes the alpha-batching of DistributePowers at the TOP of the
    composed zero-check expression (backend/hyperplonk/preprocessor.rs:25-60
    builds alpha-powers of [lookup h sums, eq * alpha-powers of constraints]):
    the sumcheck round message is linear in the terms, so a program past the
    round kernel's limits is cut into chunks of whole terms, each chunk's
    message weighted by its coefficients and the messages added
    (piop/sum_check.py ``plan_round``; the JAX package's reason was its
    compile size, the port's is csrc/sumcheck_round.cu's fixed limits).
    """
    out = []

    def go(e: Expression, coeff: Expression):
        k = e.kind
        if k == "sum":
            go(e.args[0], coeff)
            go(e.args[1], coeff)
        elif k == "neg":
            go(e.args[0], Expression("scaled", (coeff, -1)))
        elif k == "scaled":
            go(e.args[0], Expression("scaled", (coeff, e.args[1])))
        elif k == "powers" and e.args[1].is_challenge_only():
            exprs, base = e.args
            power = Expression.constant(1)
            for i, sub in enumerate(exprs):
                if i > 0:
                    power = Expression("product", (power, base))
                go(sub, Expression("product", (coeff, power)))
        elif k == "product":
            a, b = e.args
            if a.is_challenge_only() and not b.is_challenge_only():
                go(b, Expression("product", (coeff, a)))
            elif b.is_challenge_only() and not a.is_challenge_only():
                go(a, Expression("product", (coeff, b)))
            elif a.kind == "powers" and a.args[1].is_challenge_only():
                exprs, base = a.args
                power = Expression.constant(1)
                for i, sub in enumerate(exprs):
                    if i > 0:
                        power = Expression("product", (power, base))
                    go(
                        Expression("product", (sub, b)),
                        Expression("product", (coeff, power)),
                    )
            elif b.kind == "powers" and b.args[1].is_challenge_only():
                go(Expression("product", (b, a)), coeff)
            else:
                out.append((coeff, e))
        else:
            out.append((coeff, e))

    go(expr, Expression.constant(1))
    simplified = [(c.simplified(p), t.simplified(p)) for c, t in out]
    # structurally-zero terms (e.g. the const-0 p-slot placeholders of the
    # pure-grand-product GKR expression) contribute nothing to any message
    return [
        (c, t)
        for c, t in simplified
        if not (c.kind == "const" and c.args[0] % p == 0)
        and not (t.kind == "const" and t.args[0] % p == 0)
    ]


def expression_to_obj(e: Expression):
    """Expression -> JSON-serializable tree, the JAX package's format
    (utils/serialize.py; the Rust params are serde/bincode,
    backend.rs:18-19)."""
    k = e.kind
    if k == "const":
        return {"k": k, "v": str(e.args[0])}
    if k == "identity":
        return {"k": k}
    if k in ("lagrange", "eq_xy", "challenge"):
        return {"k": k, "i": e.args[0]}
    if k == "poly":
        q = e.args[0]
        return {"k": k, "p": q.poly, "r": q.rotation}
    if k == "scaled":
        return {"k": k, "a": expression_to_obj(e.args[0]), "s": str(e.args[1])}
    if k == "powers":
        exprs, base = e.args
        return {
            "k": k,
            "es": [expression_to_obj(x) for x in exprs],
            "b": expression_to_obj(base),
        }
    return {"k": k, "as": [expression_to_obj(a) for a in e.args]}


def expression_from_obj(o) -> Expression:
    k = o["k"]
    if k == "const":
        return Expression.constant(int(o["v"]))
    if k == "identity":
        return Expression.identity()
    if k == "lagrange":
        return Expression.lagrange(o["i"])
    if k == "eq_xy":
        return Expression.eq_xy(o["i"])
    if k == "challenge":
        return Expression.challenge(o["i"])
    if k == "poly":
        return Expression.poly(o["p"], o["r"])
    if k == "scaled":
        return Expression("scaled", (expression_from_obj(o["a"]), int(o["s"])))
    if k == "powers":
        return Expression(
            "powers",
            (tuple(expression_from_obj(x) for x in o["es"]), expression_from_obj(o["b"])),
        )
    return Expression(k, tuple(expression_from_obj(a) for a in o["as"]))


def _coerce(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Expression.constant(v)
    raise TypeError(f"cannot coerce {type(v)} to Expression")


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------


def evaluate_host(expr: Expression, p: int, leaf_fn: Callable, challenges: Sequence[int]) -> int:
    """Evaluate over python ints mod p. `leaf_fn(kind, arg)` supplies values for
    'identity' / ('lagrange', i) / ('eq_xy', idx) / Query leaves."""
    return expr.evaluate(
        lambda v: v % p,
        lambda e: leaf_fn(e.kind, e.args[0] if e.args else None) % p,
        lambda q: leaf_fn("poly", q) % p,
        lambda c: challenges[c] % p,
        lambda a: (-a) % p,
        lambda a, b: (a + b) % p,
        lambda a, b: (a * b) % p,
        lambda a, s: (a * s) % p,
    )


def evaluate_torch(
    spec: FieldSpec,
    expr: Expression,
    leaf_fn: Callable,
    challenges: Sequence[torch.Tensor],
    device,
):
    """Evaluate the expression over field tensors on `device`.

    `leaf_fn(kind, arg)` returns an (n, 8) tensor for 'identity' /
    ('lagrange', i) / ('eq_xy', idx) / Query leaves. Challenges are (8,)
    Montgomery rows. Constants and scalars stay host ints, by value in the
    field kernels, until a constant is the whole result."""
    p = spec.modulus

    def binary(op, fold):
        def fn(a, b):
            if isinstance(a, int) and isinstance(b, int):
                return fold(a, b) % p
            return op(spec, b, a) if isinstance(a, int) else op(spec, a, b)
        return fn

    out = expr.evaluate(
        lambda v: v % p,
        lambda e: leaf_fn(e.kind, e.args[0] if e.args else None),
        lambda q: leaf_fn("poly", q),
        lambda c: challenges[c],
        lambda a: (-a) % p if isinstance(a, int) else F.neg(spec, a),
        binary(F.add, lambda a, b: a + b),
        binary(F.mont_mul, lambda a, b: a * b),
        binary(F.mont_mul, lambda a, s: a * s),
    )
    return spec.encode([out], device)[0] if isinstance(out, int) else out


def hypercube_leaves(spec: FieldSpec, num_vars: int, polys: Sequence[torch.Tensor]):
    """The `leaf_fn` of `evaluate_torch` over all 2^k points of the
    hypercube: polys rotated by gathers, the identity column, one-hot
    Lagrange columns, each built once."""
    n = 1 << num_vars
    device = polys[0].device
    cache: Dict = {}

    def leaf(kind, arg):
        if kind == "poly":
            key = ("poly", arg.poly, arg.rotation)
            if key not in cache:
                cache[key] = mle.rotate_evals(spec, polys[arg.poly], arg.rotation) if arg.rotation else polys[arg.poly]
        elif kind == "identity":
            key = ("identity",)
            if key not in cache:
                cache[key] = F.u32_to_mont(spec, torch.arange(n, device=device))
        elif kind == "lagrange":
            key = ("lagrange", arg)
            if key not in cache:
                onehot = torch.zeros(n, dtype=torch.int64, device=device)
                onehot[int(BooleanHypercube(num_vars).iter_indices()[arg % n])] = 1
                cache[key] = F.u32_to_mont(spec, onehot)
        else:
            raise ValueError(kind)
        return cache[key]

    return leaf
