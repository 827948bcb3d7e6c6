"""GKR for batched fractional sumchecks ([PH23] §3), the port of
halo2_lasso_tpu/piop/gkr.py (fractional_sum_check.rs semantics).

Claims sum_b p_i(b)/q_i(b) are proved through a layered circuit
p' = p_l*q_r + p_r*q_l, q' = q_l*q_r (split on the HIGHEST variable), one
batched degree-3 sumcheck per layer from the top down, and a mu-fold that
pushes the claim one layer down. A pure grand product is the q side with
p = 0: the Lasso memory check passes ``None`` for every p and the prover
skips all p-side work while writing the same transcript bytes.

Every layer stays on the device; the reference's host-built small layers
(ops/host_field.py) are a TPU latency policy and are not carried over.

Under a mesh (``parallel/sharding.py``) a layer whose quadrants hold at
least two rows a shard is split over the mesh's shards (the port of
_place_sharded, gkr.py:166-176): its products run on each shard, and each
half of the next layer, which spans half the shards, is split over all of
them again. Smaller layers are gathered to the first device. With no host
tail, every layer large enough to split runs split (the reference caps its
host tail below 2D rows for the same reason, :206-217).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, Query
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.parallel import sharding
from halo2_lasso_tpu_torch.piop import sum_check
from halo2_lasso_tpu_torch.transcript import Keccak256Transcript


class GkrError(Halo2LassoError):
    pass


_expr_cache: Dict[Tuple[int, bool], Expression] = {}


def sum_check_expression(num_batching: int) -> Expression:
    """distribute_powers([p_l q_r + p_r q_l, q_l q_r]_i, gamma) * eq
    (fractional_sum_check.rs:272-283)."""
    key = (num_batching, False)
    if key not in _expr_cache:
        exprs = []
        for i in range(num_batching):
            p_l, p_r, q_l, q_r = (Expression.poly(4 * i + j) for j in range(4))
            exprs.append(p_l * q_r + p_r * q_l)
            exprs.append(q_l * q_r)
        _expr_cache[key] = (
            Expression.distribute_powers(exprs, Expression.challenge(0)) * Expression.eq_xy(0)
        )
    return _expr_cache[key]


def sum_check_expression_pure(num_batching: int) -> Expression:
    """Pure-grand-product round expression: the p-slots are constant 0, so
    the gamma powers line up with the full expression and round messages are
    those of the full circuit on zero ps."""
    key = (num_batching, True)
    if key not in _expr_cache:
        exprs = []
        for i in range(num_batching):
            exprs.append(Expression.constant(0))  # p-slot: gamma^{2i}
            exprs.append(Expression.poly(2 * i) * Expression.poly(2 * i + 1))
        _expr_cache[key] = (
            Expression.distribute_powers(exprs, Expression.challenge(0)) * Expression.eq_xy(0)
        )
    return _expr_cache[key]


def _sum_check_claim(p_ys: Sequence[int], q_ys: Sequence[int], gamma: int, p: int) -> int:
    acc = 0
    power = 1
    for pv, qv in zip(p_ys, q_ys):
        acc = (acc + power * pv) % p
        power = power * gamma % p
        acc = (acc + power * qv) % p
        power = power * gamma % p
    return acc


def _layer_down_claim(evals: Sequence[int], mu: int, p: int) -> Tuple[List[int], List[int]]:
    p_xs, q_xs = [], []
    for i in range(0, len(evals), 4):
        p_l, p_r, q_l, q_r = evals[i : i + 4]
        p_xs.append((p_l + mu * (p_r - p_l)) % p)
        q_xs.append((q_l + mu * (q_r - q_l)) % p)
    return p_xs, q_xs


def _halves(st: torch.Tensor, mesh=None):
    """(b, m, 8) -> low and high halves on the highest variable, each split
    over the mesh where it stays split (``_place``)."""
    mid = st.shape[1] // 2
    return _place(st[:, :mid], mesh), _place(st[:, mid:], mesh)


def _place(st: torch.Tensor, mesh):
    """A stacked (b, m, 8) quadrant, split over the mesh's shards on axis 1
    while each shard holds at least one pair of rows (the port of
    _place_sharded, gkr.py:166-176)."""
    if mesh is None or not mesh.holds(st.shape[1]):
        return st
    return sharding.Shards(mesh.split(st, 1))


def _width(st, mesh) -> int:
    """m of a (b, m, 8) quadrant, whole or split."""
    return st[0].shape[1] * mesh.size if isinstance(st, sharding.Shards) else st.shape[1]


def _products(layer, pure: bool):
    """The next layer's stacks (p', q'), or (q',) for a pure grand product,
    from one layer's quadrants on one device."""
    if pure:
        ql, qr = layer
        return (F.mont_mul(Fr, ql, qr),)
    pl, pr, ql, qr = layer
    return F.mul_add(Fr, pl, qr, F.mont_mul(Fr, pr, ql)), F.mont_mul(Fr, ql, qr)


def _layer_up(layer: Tuple, pure: bool, mesh):
    """One layer step over stacked (b, m, 8) quadrants, on each shard where
    they are split. A product's halves on the highest variable each span
    half the shards: each is split over all of them again
    (``Mesh.halves``), or gathered to the first device where it would not
    stay split."""
    if not isinstance(layer[0], sharding.Shards):
        return tuple(h for st in _products(layer, pure) for h in _halves(st, mesh))
    out = []
    for parts in zip(*[_products(quads, pure) for quads in zip(*layer)]):
        if mesh.holds(parts[0].shape[1] * mesh.size // 2):
            out.extend(sharding.Shards(h) for h in mesh.halves(parts, 1))
        else:
            out.extend(_halves(mesh.gather(parts, 1)))
    return tuple(out)


def _flat(layer, num_batching: int) -> List:
    """A layer's tables in wire order, its quadrants a batch element: (m, 8)
    views of the stacks, or of their shards."""
    return [
        sharding.Shards(part[i] for part in st) if isinstance(st, sharding.Shards) else st[i]
        for i in range(num_batching)
        for st in layer
    ]


def prove_fractional_sum_check(
    claimed_p_0s: Sequence[Optional[int]],
    claimed_q_0s: Sequence[Optional[int]],
    ps: Sequence[Optional[torch.Tensor]],
    qs: Sequence[torch.Tensor],
    transcript: Keccak256Transcript,
):
    """fractional_sum_check.rs:89-190. ps/qs: (2^n, 8) tensors, or every p
    None for pure grand products. Returns (p evals at x, q evals at x, x,
    (top p claims, top q claims))."""
    p = Fr.modulus
    num_batching = len(qs)
    assert num_batching and len(ps) == num_batching == len(claimed_p_0s) == len(claimed_q_0s)
    pure = all(x is None for x in ps)
    assert pure or all(x is not None for x in ps), "mixed zero/nonzero ps unsupported"
    nq = 2 if pure else 4  # quadrants per batch element
    mesh = sharding.active_mesh()

    layer = _halves(torch.stack(list(qs)), mesh)
    if not pure:
        layer = _halves(torch.stack(list(ps)), mesh) + layer
    layers = [layer]
    while _width(layers[-1][0], mesh) > 1:
        layers.append(_layer_up(layers[-1], pure, mesh))

    # top-layer claims
    top = Fr.decode_ints(torch.stack([st[:, 0] for st in layers[-1]], dim=1).reshape(-1, F.LIMBS))
    p_0s, q_0s = [], []
    for i in range(num_batching):
        vals = top[nq * i : nq * i + nq]
        p_l, p_r, q_l, q_r = ([0, 0] + vals) if pure else vals
        p_0s.append((p_l * q_r + p_r * q_l) % p)
        q_0s.append(q_l * q_r % p)
    for claimed, computed in ((claimed_p_0s, p_0s), (claimed_q_0s, q_0s)):
        for cl, co in zip(claimed, computed):
            if cl is not None:
                transcript.common_field_element(co)
            else:
                transcript.write_field_element(co)

    expression = sum_check_expression_pure(num_batching) if pure else sum_check_expression(num_batching)
    top_claims = (list(p_0s), list(q_0s))
    claimed_p_ys, claimed_q_ys = p_0s, q_0s
    y: List[int] = []
    for layer_idx in range(len(layers) - 1, -1, -1):
        nv = _width(layers[layer_idx][0], mesh).bit_length() - 1
        polys = _flat(layers[layer_idx], num_batching)
        layers[layer_idx] = None
        if nv == 0:
            x = []
            evals = Fr.decode_ints(torch.cat(polys))
        else:
            gamma = transcript.squeeze_challenge()
            claim = _sum_check_claim(claimed_p_ys, claimed_q_ys, gamma, p)
            vp = sum_check.VirtualPolynomial(expression, polys, [gamma], [y])
            x, evals = sum_check.prove(Fr, nv, vp, claim, transcript)
        if pure:
            # the structurally-zero p evals keep the wire layout [p_l, p_r, q_l, q_r]*b
            evals = [v for i in range(num_batching) for v in (0, 0, evals[2 * i], evals[2 * i + 1])]
        transcript.write_field_elements(evals)
        mu = transcript.squeeze_challenge()
        claimed_p_ys, claimed_q_ys = _layer_down_claim(evals, mu, p)
        x.append(mu)
        y = x
    return claimed_p_ys, claimed_q_ys, y, top_claims


def verify_fractional_sum_check(
    num_vars: int,
    claimed_p_0s: Sequence[Optional[int]],
    claimed_q_0s: Sequence[Optional[int]],
    transcript: Keccak256Transcript,
):
    """fractional_sum_check.rs:193-270."""
    p = Fr.modulus
    num_batching = len(claimed_p_0s)
    assert num_batching and len(claimed_q_0s) == num_batching

    p_0s, q_0s = [], []
    for claimed, out in ((claimed_p_0s, p_0s), (claimed_q_0s, q_0s)):
        for cl in claimed:
            if cl is not None:
                transcript.common_field_element(cl)
                out.append(cl % p)
            else:
                out.append(transcript.read_field_element())

    expression = sum_check_expression(num_batching)
    top_claims = (list(p_0s), list(q_0s))
    claimed_p_ys, claimed_q_ys = p_0s, q_0s
    y: List[int] = []
    for nv in range(num_vars):
        if nv == 0:
            evals = transcript.read_field_elements(4 * num_batching)
            for i, (cp, cq) in enumerate(zip(claimed_p_ys, claimed_q_ys)):
                p_l, p_r, q_l, q_r = evals[4 * i : 4 * i + 4]
                if cp != (p_l * q_r + p_r * q_l) % p or cq != q_l * q_r % p:
                    raise GkrError("unmatched sum_check output (top layer)")
            x = []
        else:
            gamma = transcript.squeeze_challenge()
            claim = _sum_check_claim(claimed_p_ys, claimed_q_ys, gamma, p)
            x_eval, x = sum_check.verify(p, nv, expression.degree, claim, transcript)
            evals = transcript.read_field_elements(4 * num_batching)
            eval_map = {Query(i, 0): v for i, v in enumerate(evals)}
            got = sum_check.evaluate_at_point(expression, p, nv, eval_map, [gamma], [y], x)
            if got != x_eval:
                raise GkrError("unmatched sum_check output")
        mu = transcript.squeeze_challenge()
        claimed_p_ys, claimed_q_ys = _layer_down_claim(evals, mu, p)
        x.append(mu)
        y = x
    return claimed_p_ys, claimed_q_ys, y, top_claims
