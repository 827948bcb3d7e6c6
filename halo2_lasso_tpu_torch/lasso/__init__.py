"""Lasso lookup argument (Surge decomposition + grand-product memory check),
the port of halo2_lasso_tpu/lasso/__init__.py. The proof bytes are those
of the JAX package for the same SRS, table and indices.

Proof layout (Keccak256 Fiat-Shamir):
  1. commit a (lookup outputs, log m vars), dim_j (chunks), E_j (reads),
     read_ts_j (all log m vars), final_cts_j (log N_sub vars);
  2. squeeze r (log m challenges); write v = a~(r);
  3. primary sumcheck:  sum_i eq(r, i) * g(E(i)) = v;
  4. squeeze gamma, tau; batched grand products via GKR:
       one batch for the 2*alpha m-sized products  (RS_j, WS_j),
       one batch for the 2*alpha N-sized products  (S_init_j, S_final_j);
     multiset check  prod RS_j * prod S_final_j == prod WS_j * prod S_init_j;
  5. write PCS openings: batch-open the m-sized polys at {primary point,
     GKR m-point}; batch-open the final_cts polys at {GKR N-point}.

Fingerprints: h(addr, val, ts) = ts*gamma^2 + val*gamma + addr - tau.
The witness (subtable reads, read timestamps, final counts) is built on
the prover's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np
import torch

from halo2_lasso_tpu_torch.errors import Halo2LassoError
from halo2_lasso_tpu_torch.expression import Expression, Query, evaluate_host, evaluate_torch
from halo2_lasso_tpu_torch.lasso.tables import LassoTable, Subtable
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
from halo2_lasso_tpu_torch.piop import gkr, sum_check
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.utils.timer import timed

P = Fr.modulus


class LassoError(Halo2LassoError):
    pass


@dataclasses.dataclass
class LassoWitness:
    """Host-side witness tables (numpy) + device encodings."""

    num_lookup_vars: int  # log m
    dims: List[np.ndarray]  # per chunk: (m,) int64
    e_vals: List[np.ndarray]  # per memory: (m,) object ints
    read_ts: List[np.ndarray]  # per memory: (m,) int64
    final_cts: List[np.ndarray]  # per memory: (N_sub,) int64
    outputs: np.ndarray  # (m,) object ints


def build_witness(table: LassoTable, indices: Sequence[int]) -> LassoWitness:
    """Compute dim/E/read_ts/final_cts/outputs for the lookup indices.

    read_ts via sort + segment ranks (the TPU-friendly replacement for the
    sequential per-address counters of classic offline memory checking).
    """
    m = len(indices)
    assert m & (m - 1) == 0, "pad lookups to a power of two"
    dims = table.chunk_indices_np(indices)
    n_sub = 1 << table.memories[0].subtable.index_bits

    e_vals, read_ts, final_cts = [], [], []
    for mem in table.memories:
        addr = dims[mem.chunk]
        tbl = mem.subtable.values()
        e_vals.append(tbl[addr])
        order = np.argsort(addr, kind="stable")
        sorted_addr = addr[order]
        # rank within each address group = read timestamp
        boundaries = np.nonzero(np.diff(sorted_addr))[0] + 1
        starts = np.concatenate([[0], boundaries])
        counts = np.diff(np.concatenate([starts, [m]]))
        group_start = np.repeat(starts, counts)
        ranks = np.arange(m, dtype=np.int64) - group_start
        ts = np.empty(m, dtype=np.int64)
        ts[order] = ranks
        read_ts.append(ts)
        fc = np.zeros(n_sub, dtype=np.int64)
        uniq = sorted_addr[starts]
        fc[uniq] = counts
        final_cts.append(fc)

    # outputs via g over E values: evaluate_host is elementwise over numpy
    # object arrays, so one pass computes all m outputs
    e_arrs = [np.asarray(e, dtype=object) for e in e_vals]
    outputs = np.asarray(
        evaluate_host(
            table.g, P, lambda kind, q: e_arrs[q.poly] if kind == "poly" else 0, []
        ),
        dtype=object,
    )

    return LassoWitness(
        num_lookup_vars=m.bit_length() - 1,
        dims=dims,
        e_vals=e_vals,
        read_ts=read_ts,
        final_cts=final_cts,
        outputs=outputs,
    )


def _read_ts_and_final_dev(addr: torch.Tensor, n_sub: int):
    """Offline-memory counters on the device (the port of
    lasso/integration.py:230): read timestamp = rank of the read within
    its address group (stable sort + segment start); final count = reads
    per address."""
    m = addr.shape[0]
    sa, order = torch.sort(addr, stable=True)
    i = torch.arange(m, device=addr.device)
    is_start = torch.ones(m, dtype=torch.bool, device=addr.device)
    is_start[1:] = sa[1:] != sa[:-1]
    group_start = torch.cummax(torch.where(is_start, i, 0), 0).values
    ts = torch.empty_like(i).scatter_(0, order, i - group_start)
    fc = torch.bincount(addr, minlength=n_sub)
    return ts, fc


@functools.lru_cache(maxsize=None)
def _subtable_dev(subtable: Subtable, device: str) -> torch.Tensor:
    """Subtable values as Montgomery elements on the device (the port of
    lasso/integration.py:381): limbs cut on the host, one product on the
    device."""
    return F.encode_dev(Fr, subtable.values(), device)


def _fingerprint(addr_tau, val, ts, gamma: int) -> torch.Tensor:
    """h = ts*gamma^2 + val*gamma + addr - tau over field tensors, given
    addr_tau = addr - tau (ts None for 0): one product kernel launch a
    term, gamma by value."""
    acc = F.mul_add(Fr, val, gamma, addr_tau)
    return acc if ts is None else F.mul_add(Fr, ts, gamma * gamma % P, acc)


def _read_write_fingerprints(addr_tau, val, ts, gamma: int):
    """A memory's read fingerprint (timestamps ts) and write fingerprint
    (ts + 1: the read's plus gamma^2); three launches."""
    rs = _fingerprint(addr_tau, val, ts, gamma)
    return rs, F.add(Fr, rs, gamma * gamma % P)


def _init_final_fingerprints(addr_tau, tvals, final_cts, gamma: int):
    """A subtable's init fingerprint (timestamps 0) and final one (the final
    counts: init plus final_cts * gamma^2); two launches."""
    init = _fingerprint(addr_tau, tvals, None, gamma)
    return init, F.mul_add(Fr, final_cts, gamma * gamma % P, init)


@timed("lasso_prove")
def prove(pp, table: LassoTable, indices: Sequence[int], transcript, pcs=MultilinearKzg, device="cuda") -> None:
    """Prove that outputs[i] = T[indices[i]] for all i, on `device` (where
    the prover parameters live)."""
    spec = Fr
    alpha = len(table.memories)
    m = len(indices)
    assert m & (m - 1) == 0, "pad lookups to a power of two"
    nv_m = m.bit_length() - 1
    nv_n = table.memories[0].subtable.index_bits

    with timed.scope("lasso_encode"):
        dims_host = table.chunk_indices_np(indices)
        dims = [torch.from_numpy(d).to(device) for d in dims_host]
        dim_polys = [F.u32_to_mont(spec, d) for d in dims]
        e_polys, ts_polys, fc_polys = [], [], []
        for mem in table.memories:
            addr = dims[mem.chunk]
            e_polys.append(_subtable_dev(mem.subtable, str(device))[addr])
            ts, fc = _read_ts_and_final_dev(addr, 1 << mem.subtable.index_bits)
            ts_polys.append(F.u32_to_mont(spec, ts))
            fc_polys.append(F.u32_to_mont(spec, fc))
        a_poly = evaluate_torch(spec, table.g, lambda kind, q: e_polys[q.poly], [], device)
    m_sized = [a_poly] + dim_polys + e_polys + ts_polys
    with timed.scope("lasso_commit"):
        m_comms = pcs.batch_commit(pp, m_sized)
        n_comms = pcs.batch_commit(pp, fc_polys)
    pcs.write_commitments(m_comms, transcript)
    pcs.write_commitments(n_comms, transcript)

    # ---- primary sumcheck ----
    r = transcript.squeeze_challenges(nv_m)
    v = spec.decode_ints(mle.evaluate(spec, a_poly, r)[None])[0]
    transcript.write_field_element(v)

    expression = Expression.eq_xy(0) * table.g
    with timed.scope("lasso_primary_sumcheck"):
        vp = sum_check.VirtualPolynomial(expression, e_polys, [], [r])
        x_primary, e_evals_primary = sum_check.prove(spec, nv_m, vp, v, transcript)
    transcript.write_field_elements(e_evals_primary)

    # ---- memory checking ----
    gamma = transcript.squeeze_challenge()
    tau = transcript.squeeze_challenge()

    with timed.scope("lasso_fingerprints"):
        addr_n_tau = F.sub(spec, F.u32_to_mont(spec, torch.arange(1 << nv_n, device=device)), tau)
        dims_tau = [F.sub(spec, d, tau) for d in dim_polys]
        rs_polys, ws_polys, init_polys, final_polys = [], [], [], []
        for j, mem in enumerate(table.memories):
            rs, ws = _read_write_fingerprints(dims_tau[mem.chunk], e_polys[j], ts_polys[j], gamma)
            tvals = _subtable_dev(mem.subtable, str(device))
            init, final = _init_final_fingerprints(addr_n_tau, tvals, fc_polys[j], gamma)
            rs_polys.append(rs)
            ws_polys.append(ws)
            init_polys.append(init)
            final_polys.append(final)

    # ps = None: pure grand products
    none = [None] * (2 * alpha)
    with timed.scope("lasso_grand_products_m"):
        _, _, x_m, _ = gkr.prove_fractional_sum_check([0] * (2 * alpha), none, none, rs_polys + ws_polys, transcript)
    with timed.scope("lasso_grand_products_n"):
        _, _, x_n, _ = gkr.prove_fractional_sum_check([0] * (2 * alpha), none, none, init_polys + final_polys, transcript)

    # ---- PCS openings ----
    # m-sized polys at [r, x_primary, x_m]: a at r (value v), E_j at
    # x_primary (the sumcheck's final evals), every m-sized poly at x_m
    # (values written here, used for the GKR leaf fingerprint checks)
    points = [list(r), x_primary, x_m]
    evals: List[Evaluation] = [Evaluation(0, 0, v)]
    for j in range(alpha):
        evals.append(Evaluation(1 + len(dim_polys) + j, 1, e_evals_primary[j]))
    with timed.scope("lasso_open_evals"):
        xm_vals = mle.evaluate_stacked_ints(spec, m_sized, x_m)
        for poly_idx, val in enumerate(xm_vals):
            evals.append(Evaluation(poly_idx, 2, val))
        transcript.write_field_elements(xm_vals)
    with timed.scope("lasso_batch_open_m"):
        pcs.batch_open(pp, m_sized, None, points, evals, transcript)

    # final_cts at x_n
    with timed.scope("lasso_batch_open_n"):
        n_vals = mle.evaluate_stacked_ints(spec, fc_polys, x_n)
        n_evals = [Evaluation(j, 0, val) for j, val in enumerate(n_vals)]
        transcript.write_field_elements(n_vals)
        pcs.batch_open(pp, fc_polys, None, [x_n], n_evals, transcript)


@timed("lasso_verify")
def verify(
    vp,
    table: LassoTable,
    num_lookup_vars: int,
    transcript,
    pcs=MultilinearKzg,
) -> None:
    """Verify a Lasso proof; raises LassoError on rejection."""
    spec = Fr
    alpha = len(table.memories)
    nv_m = num_lookup_vars
    nv_n = table.memories[0].subtable.index_bits
    num_m_polys = 1 + table.num_chunks + 2 * alpha

    m_comms = pcs.read_commitments(vp, num_m_polys, transcript)
    n_comms = pcs.read_commitments(vp, alpha, transcript)

    r = transcript.squeeze_challenges(nv_m)
    v = transcript.read_field_element()

    expression = Expression.eq_xy(0) * table.g
    x_eval, x_primary = sum_check.verify(P, nv_m, expression.degree, v, transcript)
    e_evals_primary = transcript.read_field_elements(alpha)
    eval_map = {Query(j, 0): ev for j, ev in enumerate(e_evals_primary)}
    got = sum_check.evaluate_at_point(
        expression, P, nv_m, eval_map, [], [r], x_primary
    )
    if got != x_eval:
        raise LassoError("primary sumcheck final check failed")

    gamma = transcript.squeeze_challenge()
    tau = transcript.squeeze_challenge()

    _, q_m, x_m, (_, q0_m) = gkr.verify_fractional_sum_check(
        nv_m, [0] * (2 * alpha), [None] * (2 * alpha), transcript
    )
    _, q_n, x_n, (_, q0_n) = gkr.verify_fractional_sum_check(
        nv_n, [0] * (2 * alpha), [None] * (2 * alpha), transcript
    )
    # multiset equality per memory on the PRODUCT claims (GKR top layer)
    rs_prods, ws_prods = q0_m[:alpha], q0_m[alpha:]
    init_prods, final_prods = q0_n[:alpha], q0_n[alpha:]
    for j in range(alpha):
        if rs_prods[j] * final_prods[j] % P != ws_prods[j] * init_prods[j] % P:
            raise LassoError(f"memory check product mismatch (memory {j})")

    # ---- m-sized openings at [r, x_primary, x_m] ----
    xm_vals = transcript.read_field_elements(num_m_polys)
    evals: List[Evaluation] = [Evaluation(0, 0, v)]
    for j in range(alpha):
        evals.append(Evaluation(1 + table.num_chunks + j, 1, e_evals_primary[j]))
    for poly_idx in range(num_m_polys):
        evals.append(Evaluation(poly_idx, 2, xm_vals[poly_idx]))

    # GKR leaf checks at x_m: RS_j/WS_j from dim/E/ts openings
    dim_evals = xm_vals[1 : 1 + table.num_chunks]
    e_evals = xm_vals[1 + table.num_chunks : 1 + table.num_chunks + alpha]
    ts_evals = xm_vals[1 + table.num_chunks + alpha :]
    g2 = gamma * gamma % P
    for j, mem in enumerate(table.memories):
        h_rs = (ts_evals[j] * g2 + e_evals[j] * gamma + dim_evals[mem.chunk] - tau) % P
        h_ws = ((ts_evals[j] + 1) * g2 + e_evals[j] * gamma + dim_evals[mem.chunk] - tau) % P
        if h_rs != q_m[j] or h_ws != q_m[alpha + j]:
            raise LassoError(f"fingerprint opening mismatch (memory {j})")

    pcs.batch_verify(
        vp, m_comms, [list(r), x_primary, x_m], evals, transcript
    )

    # ---- N-sized openings at x_n ----
    n_vals = transcript.read_field_elements(alpha)
    n_evals = [Evaluation(j, 0, n_vals[j]) for j in range(alpha)]
    # init/final fingerprints at x_n against table MLEs (subtables are
    # public/structured, evaluated directly by the verifier)
    addr_eval = mle.identity_eval_host(P, x_n)
    for j, mem in enumerate(table.memories):
        t_eval = _subtable_mle_eval(mem.subtable, x_n)
        h_init = (t_eval * gamma + addr_eval - tau) % P
        h_final = (n_vals[j] * g2 + t_eval * gamma + addr_eval - tau) % P
        if h_init != q_n[j] or h_final != q_n[alpha + j]:
            raise LassoError(f"init/final fingerprint mismatch (memory {j})")

    pcs.batch_verify(vp, n_comms, [x_n], n_evals, transcript)


def _subtable_mle_eval(subtable, x: Sequence[int]) -> int:
    """Evaluate the subtable's MLE at x on host.

    Structured subtables carry an O(log N_sub) closed form (`mle_eval`,
    lasso/tables.py) — verifier cost independent of the subtable size, which
    is the point of Lasso/Surge. The O(N) fold remains as the fallback for
    ad-hoc tables (and as the test oracle for the closed forms)."""
    if subtable.mle_eval is not None:
        return subtable.mle_eval([xi % P for xi in x])
    vals = [int(v) for v in subtable.values()]
    for xi in reversed(x):
        half = len(vals) // 2
        vals = [
            (lo + (hi - lo) * xi) % P for lo, hi in zip(vals[:half], vals[half:])
        ]
    return vals[0]
