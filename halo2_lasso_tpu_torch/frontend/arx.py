"""ARX-chain structured circuit (the port of halo2_lasso_tpu/frontend/arx.py):
an add-rotate-xor permutation chain, the building block of sha256's message
schedule, chacha and speck, whose bitwise ops go through Lasso tables.

Per row i (w-bit words, chained through rotation gates):
    s_i = (x_i + y_i) mod 2^w           carry c_i in {0,1}
    y_i = hi_i * 2^(w-rot) + lo_i       (rotate-left-rot decomposition)
    r_i = lo_i * 2^rot + hi_i           = rot_w(y_i, rot)
    xo_i = s_i XOR r_i                  (Lasso xor table, chunked)
    x_{i+1} = xo_i,  y_{i+1} = x_i      (selector-gated rotation gates)

The XOR lookup's chunk recombination forces s, r < 2^w, which with a
boolean c pins the add mod 2^w; lo and hi are range-checked by identity
Lasso tables (w - rot and rot bits), which pins the rotation split.

The witness is vectorised numpy; the chain itself is the one Python loop
(one iteration a row).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from halo2_lasso_tpu_torch.frontend.builder import CircuitBuilder
from halo2_lasso_tpu_torch.lasso.tables import range_table, xor_table

# the range subtable's chunk for each lo / hi width, so that range_table's
# divisibility holds
_RANGE_CHUNK = {25: 5, 7: 7, 5: 5, 3: 3, 4: 4, 6: 3, 12: 6, 24: 6, 8: 4}


def _range(bits: int):
    return range_table(bits, _RANGE_CHUNK.get(bits, bits))


def _arx_trace(n_rows: int, seed_x: int, seed_y: int, w: int, rot: int):
    """Run the ARX chain on the host; returns the per-row column arrays."""
    mw = (1 << w) - 1
    x = np.empty(n_rows, dtype=np.int64)
    y = np.empty(n_rows, dtype=np.int64)
    cx, cy = seed_x & mw, seed_y & mw
    for i in range(n_rows):
        x[i], y[i] = cx, cy
        s = (cx + cy) & mw
        r = ((cy << rot) | (cy >> (w - rot))) & mw
        cx, cy = s ^ r, cx
    s_full = x + y
    s = s_full & mw
    c = s_full >> w
    lo = y & ((1 << (w - rot)) - 1)
    hi = y >> (w - rot)
    r = ((lo << rot) | hi) & mw
    xo = s ^ r
    return x, y, s, c, lo, hi, r, xo


def arx_chain_circuit(
    k: int,
    word_bits: int = 32,
    chunk_bits: int = 8,
    rot: int = 7,
    seed_x: int = 0x6A09E667,
    seed_y: int = 0xBB67AE85,
) -> Tuple[object, object]:
    """The ARX chain over all usable rows of a 2^k hypercube, through the
    CircuitBuilder: one selector, 8 advice columns, 6 gates, 3 Lasso
    lookups. At the default 32-bit words the XOR subtables are 2^16 and
    k = 19 is a ~2^22-constraint circuit (BASELINE config 4's scale).
    Returns (PlonkishCircuitInfo, PlonkishCircuit)."""
    w = word_bits
    assert 0 < rot < w and w % chunk_bits == 0
    b = CircuitBuilder(k)
    q = b.selector()
    cols = [b.advice_column() for _ in range(8)]
    x, y, s, c, lo, hi, r, xo = cols
    b.max_degree = 4

    b.gate(
        "add_modw",
        lambda ctx: ctx.expr(x) + ctx.expr(y) - ctx.expr(s) - ctx.expr(c) * (1 << w),
    )
    b.gate("carry_bool", lambda ctx: ctx.expr(c) * (ctx.expr(c) - 1))
    b.gate(
        "rot_split",
        lambda ctx: ctx.expr(y) - ctx.expr(hi) * (1 << (w - rot)) - ctx.expr(lo),
    )
    b.gate(
        "rot_join",
        lambda ctx: ctx.expr(r) - ctx.expr(lo) * (1 << rot) - ctx.expr(hi),
    )
    b.gate("chain_x", lambda ctx: ctx.expr(q) * (ctx.expr(x.next) - ctx.expr(xo)))
    b.gate("chain_y", lambda ctx: ctx.expr(q) * (ctx.expr(y.next) - ctx.expr(x)))
    b.lasso_lookup(
        "xor_w",
        xor_table(w, chunk_bits),
        lambda ctx: ((ctx.expr(s), ctx.expr(r)), ctx.expr(xo)),
    )
    b.lasso_lookup("range_lo", _range(w - rot), lambda ctx: ((ctx.expr(lo),), ctx.expr(lo)))
    b.lasso_lookup("range_hi", _range(rot), lambda ctx: ((ctx.expr(hi),), ctx.expr(hi)))

    n = 1 << k
    n_use = n - 1  # the bh row layout leaves the last row zero
    trace = _arx_trace(n_use, seed_x, seed_y, w, rot)
    fixed = {(q.index, row): 1 for row in range(n_use - 1)}

    def advice_fn(phase, challenges):
        return list(trace)

    return b.build(fixed, advice_fn, [])
