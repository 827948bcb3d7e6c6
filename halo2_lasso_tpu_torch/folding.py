"""Folding-scheme expression helpers (Sangria/Protostar-style infrastructure),
the port's copy of halo2_lasso_tpu/folding.py.

The Rust reference's util/expression/relaxed.rs semantics: split
constraints into preprocess x foldee products (`products`, relaxed.rs:150),
relax by powers of the homogenizing challenge u (`relaxed_expression`,
:132), and derive the cross-term expressions used by folding provers
(`cross_term_expressions`, :34). Exported-but-unused by the
HyperPlonk snapshot, mirrored here for parity. Host expressions only: no
tensor and no device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from halo2_lasso_tpu_torch.expression import Expression, Query


@dataclasses.dataclass
class PolynomialSet:
    preprocess: Set[int]
    folding: Set[int]


@dataclasses.dataclass
class Product:
    preprocess: Expression  # preprocess-only factor (constants/commons/fixed)
    foldees: List[Expression]  # witness polys / challenges being folded

    @property
    def folding_degree(self) -> int:
        return len(self.foldees)

    def expression(self) -> Expression:
        e = self.preprocess
        for f in self.foldees:
            e = e * f
        return e


def products(preprocess_polys: Set[int], constraint: Expression) -> List[Product]:
    """relaxed.rs:150-241: distribute the constraint into products of a
    preprocess part and foldee factors."""

    def mul_products(lhs: List[Product], rhs: List[Product]) -> List[Product]:
        out = []
        for a in lhs:
            for b in rhs:
                out.append(
                    Product(a.preprocess * b.preprocess, a.foldees + b.foldees)
                )
        return out

    prods = constraint.evaluate(
        lambda c: [Product(Expression.constant(c), [])],
        lambda e: [Product(e, [])],
        lambda q: (
            [Product(Expression.poly(q.poly, q.rotation), [])]
            if q.poly in preprocess_polys
            else [Product(Expression.constant(1), [Expression.poly(q.poly, q.rotation)])]
        ),
        lambda ch: [Product(Expression.constant(1), [Expression.challenge(ch)])],
        lambda ps: [Product(-p.preprocess, p.foldees) for p in ps],
        lambda a, b: a + b,
        mul_products,
        lambda ps, s: [Product(p.preprocess * s, p.foldees) for p in ps],
    )
    # normalize each preprocess factor into scalar * common-product
    out = []
    for p in prods:
        scalar, pre = _normalize_preprocess(p.preprocess)
        if pre is None:
            pre_expr = Expression.constant(scalar)
        elif scalar == 1:
            pre_expr = pre
        else:
            pre_expr = pre * scalar
        out.append(Product(pre_expr, p.foldees))
    return out


def _normalize_preprocess(e: Expression) -> Tuple[int, Expression]:
    def prod_opt(a, b):
        (sa, pa), (sb, pb) = a, b
        if pa is not None and pb is not None:
            p = pa * pb
        else:
            p = pa if pa is not None else pb
        return (sa * sb, p)

    return e.evaluate(
        lambda c: (c, None),
        lambda cp: (1, cp),
        lambda q: (1, Expression.poly(q.poly, q.rotation)),
        lambda ch: (_unreachable(),),
        lambda a: (-a[0], a[1]),
        lambda a, b: (_unreachable(),),
        prod_opt,
        lambda a, s: (a[0] * s, a[1]),
    )


def _unreachable():
    raise AssertionError("unexpected node in preprocess expression")


def folding_degree(prods: Sequence[Product]) -> int:
    return max((p.folding_degree for p in prods), default=0)


def relaxed_expression(prods: Sequence[Product], u: int) -> Expression:
    """relaxed.rs:132-148: homogenize with powers of Challenge(u)."""
    fd = folding_degree(prods)
    acc = None
    for p in prods:
        term = p.expression()
        for _ in range(fd - p.folding_degree):
            term = term * Expression.challenge(u)
        acc = term if acc is None else acc + term
    return acc


def cross_term_expressions(
    poly_set: PolynomialSet, prods: Sequence[Product], num_challenges: int
) -> List[Expression]:
    """relaxed.rs:34-130: the folding cross-terms T_1..T_{d-1}.

    Polynomial index space of the output: [preprocess | lhs folding |
    rhs folding]; challenge space: [lhs challenges, lhs u, rhs challenges,
    rhs u].
    """
    fd = folding_degree(prods)
    num_ts = max(fd - 1, 0)
    u = num_challenges
    pre_idx = {p: i for i, p in enumerate(sorted(poly_set.preprocess))}
    fold_idx = {p: i for i, p in enumerate(sorted(poly_set.folding))}

    buckets: List[Dict[Tuple, Expression]] = [dict() for _ in range(num_ts)]
    for product in prods:
        c_scalar, c_polys = _split_preprocess(product.preprocess, pre_idx)
        slots = [None] * (fd - product.folding_degree) + list(product.foldees)
        for idx in range(1, (1 << fd) - 1):
            scalar = Expression.constant(c_scalar)
            polys = list(c_polys)
            for nth, foldee in enumerate(slots):
                if (idx >> nth) & 1:
                    poly_offset = len(pre_idx) + len(fold_idx)
                    challenge_offset = num_challenges + 1
                else:
                    poly_offset = len(pre_idx)
                    challenge_offset = 0
                if foldee is None:
                    scalar = scalar * Expression.challenge(challenge_offset + u)
                elif foldee.kind == "challenge":
                    scalar = scalar * Expression.challenge(
                        challenge_offset + foldee.args[0]
                    )
                elif foldee.kind == "poly":
                    q = foldee.args[0]
                    polys.append(
                        ("poly", poly_offset + fold_idx[q.poly], q.rotation)
                    )
                else:
                    raise AssertionError("unexpected foldee")
            key = tuple(sorted(polys))
            b = buckets[bin(idx).count("1") - 1]
            b[key] = b[key] + scalar if key in b else scalar

    out = []
    for bucket in buckets:
        acc = None
        for polys, scalar in bucket.items():
            term = scalar
            for p in polys:
                if p[0] == "poly":
                    term = term * Expression.poly(p[1], p[2])
                else:  # ("common", kind, args)
                    term = term * Expression(p[1], p[2])
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else Expression.constant(0))
    return out


def _split_preprocess(e: Expression, pre_idx: Dict[int, int]) -> Tuple[int, List[Tuple]]:
    """preprocess expr -> (scalar, canonical poly keys remapped to pre_idx)."""

    def prod(a, b):
        return (a[0] * b[0], a[1] + b[1])

    return e.evaluate(
        lambda c: (c, []),
        lambda cp: (1, [("common", cp.kind, cp.args)]),
        lambda q: (1, [("poly", pre_idx[q.poly], q.rotation)]),
        lambda ch: (_unreachable(),),
        lambda a: (-a[0], a[1]),
        lambda a, b: (_unreachable(),),
        prod,
        lambda a, s: (a[0] * s, a[1]),
    )
