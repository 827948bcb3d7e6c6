"""Brakedown: transparent hash-based multilinear PCS over an expander code
(the port of halo2_lasso_tpu/pcs/brakedown.py; util/code/brakedown.rs and
pcs/multilinear/brakedown.rs): the [GLSTW21] linear code with sparse
expander matrices A and B and a Reed-Solomon base case, six 128-bit
parameter specs; commit = encode the rows, hash each codeword column, and
merklize (Keccak-256); open = proximity rows and column openings; verify
re-encodes and checks Merkle paths.

Codeword layout (brakedown.rs:88-126):
  [ x | A_0 x | A_1 A_0 x | ... | RS(A_last ...) | B_last out | ... | B_0 out ]
where B_j consumes the contiguous b_j.n-long block starting at A_j's output.

On the card: a sparse matrix is kept grouped by output (m outputs x its
largest in-degree D, padded with coefficient 0), so its product is a gather,
one K4 ``a*b`` launch and one ``sum_reduce`` launch over D, with every row
of a polynomial (and, in verify, every combined row) encoded in one pass of
shape (row_len, rows, 8). The code is linear, so it keeps the
representation of its input: a canonical row (from_mont of the Montgomery
polynomial, or a row read from the proof) gives a canonical codeword. A
combination of rows (the open's proximity and t_0 rows, the verifier's
column checks and its consistency check) is one K4 launch of Montgomery
values by canonical coefficients, or the reverse, and one ``sum_reduce``.
Hashing stays on the host, as in the JAX package: the codeword crosses to
the host once a commit, as canonical little-endian bytes, and its columns
and each Merkle level are hashed in one call of the native batch sponge
(``ops/keccak.py`` ``keccak256_rows``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.ops.keccak import keccak256_rows
from halo2_lasso_tpu_torch.pcs import Evaluation
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import PcsError
from halo2_lasso_tpu_torch.poly import multilinear as mle
from halo2_lasso_tpu_torch.transcript import TranscriptError, below_modulus

P = Fr.modulus
LOG2_Q = 254  # Fr::NUM_BITS
REPR = 32  # bytes of a field element's repr
SUM_COLUMNS = 65535  # the most columns one sum_reduce launch takes


def _h(p: float) -> float:
    return -p * math.log2(p) - (1 - p) * math.log2(1 - p)


def _ceil(v: float) -> int:
    return int(math.ceil(v))


@dataclasses.dataclass(frozen=True)
class BrakedownSpec:
    """Figure 2 of [GLSTW21]; lambda = 128 (brakedown.rs:237-260). The
    float formulas are the JAX package's, operation for operation: the
    dimensions decide every byte of a proof."""

    alpha: float
    beta: float
    r: float
    lambda_: float = 128.0

    @property
    def delta(self):
        return self.beta / self.r

    @property
    def mu(self):
        return self.r - 1.0 - self.r * self.alpha

    @property
    def nu(self):
        return self.beta + self.alpha * self.beta + 0.03

    def c_n(self, n: int) -> int:
        a, b = self.alpha, self.beta
        nf = float(n)
        return min(
            max(_ceil(1.28 * b * nf), _ceil(b * nf) + 4),
            _ceil(
                ((110.0 / nf) + _h(b) + a * _h(1.28 * b / a))
                / (b * math.log2(a / (1.28 * b)))
            ),
        )

    def d_n(self, log2_q: int, n: int) -> int:
        a, b, r = self.alpha, self.beta, self.r
        mu, nu = self.mu, self.nu
        nf = float(n)
        return min(
            _ceil((2.0 * b + ((r - 1.0) + 110.0 / nf) / log2_q) * nf),
            _ceil(
                (r * a * _h(b / r) + mu * _h(nu / mu) + 110.0 / nf)
                / (a * b * math.log2(mu / nu))
            ),
        )

    def num_column_opening(self) -> int:
        return _ceil(-self.lambda_ / math.log2(1.0 - self.delta / 3.0))

    def num_proximity_testing(self, log2_q: int, n: int, n_0: int) -> int:
        return _ceil(
            self.lambda_
            / (log2_q - math.log2(float(self.codeword_len(log2_q, n, n_0))))
        )

    def dimensions(self, log2_q: int, n: int, n_0: int):
        """(a_dims, b_dims) as (n, m, d) triples (brakedown.rs:184-206)."""
        assert n > n_0
        a_dims = []
        cur = n
        while cur > n_0:
            m = _ceil(cur * self.alpha)
            a_dims.append((cur, m, min(self.c_n(cur), m)))
            cur = m
        b_dims = []
        for (an, am, _) in a_dims:
            n_prime = _ceil(am * self.r)
            m_prime = _ceil(an * self.r) - an - n_prime
            b_dims.append((n_prime, m_prime, min(self.d_n(log2_q, an), m_prime)))
        return a_dims, b_dims

    def codeword_len(self, log2_q: int, n: int, n_0: int) -> int:
        a, b = self.dimensions(log2_q, n, n_0)
        return a[0][0] + sum(x[1] for x in a[:-1]) + b[-1][0] + sum(x[1] for x in b)


SPEC1 = BrakedownSpec(0.1195, 0.0284, 1.420)
SPEC2 = BrakedownSpec(0.1380, 0.0444, 1.470)
SPEC3 = BrakedownSpec(0.1780, 0.0610, 1.521)
SPEC4 = BrakedownSpec(0.2000, 0.0820, 1.640)
SPEC5 = BrakedownSpec(0.2110, 0.0970, 1.616)
SPEC6 = BrakedownSpec(0.2380, 0.1205, 1.720)


class SparseMatrix:
    """An n x m sparse matrix with min(d, m) distinct columns a row: entry
    (rows_idx[e], cols_idx[e]) holds coeffs[e] (Montgomery, (nnz, 8) on the
    device). ``idx`` (D, m) and ``coeff`` (D, m, 8) hold the same entries
    grouped by column (output), D the largest in-degree, padded with row 0
    and coefficient 0."""

    def __init__(self, n: int, m: int, d: int, rows_idx: np.ndarray, cols_idx: np.ndarray, coeffs: torch.Tensor):
        self.n, self.m, self.d = n, m, d
        self.rows_idx = np.asarray(rows_idx, dtype=np.int64)
        self.cols_idx = np.asarray(cols_idx, dtype=np.int64)
        self.coeffs = coeffs
        device = coeffs.device
        order = np.argsort(self.cols_idx, kind="stable")
        counts = np.bincount(self.cols_idx, minlength=m)
        starts = np.cumsum(counts) - counts
        cols = self.cols_idx[order]
        slot = np.arange(len(order)) - starts[cols]
        self.width = int(counts.max())
        idx = np.zeros((self.width, m), dtype=np.int64)
        idx[slot, cols] = self.rows_idx[order]
        self.idx = torch.from_numpy(idx).to(device)
        self.coeff = torch.zeros((self.width, m, F.LIMBS), dtype=torch.int32, device=device)
        self.coeff[torch.from_numpy(slot).to(device), torch.from_numpy(cols).to(device)] = (
            coeffs[torch.from_numpy(order).to(device)]
        )

    @classmethod
    def random(cls, n: int, m: int, d: int, rng: np.random.RandomState, device) -> "SparseMatrix":
        """The JAX package's draws, in its order (brakedown.py:131-142): a
        row's columns by ``randint(m)`` until min(d, m) are distinct, then
        one ``bytes(40)`` mod p a column, in sorted column order."""
        rows_idx, cols_idx, coeffs = [], [], []
        for row in range(n):
            cols = set()
            while len(cols) < min(d, m):
                cols.add(int(rng.randint(m)))
            for col in sorted(cols):
                rows_idx.append(row)
                cols_idx.append(col)
                coeffs.append(int.from_bytes(rng.bytes(40), "little") % P)
        return cls(n, m, d, np.array(rows_idx), np.array(cols_idx),
                   F.encode_dev(Fr, np.array(coeffs, dtype=object), device))

    def dot(self, inp: torch.Tensor) -> torch.Tensor:
        """(n, L, 8) -> (m, L, 8): a gather, one K4 ``a*b`` launch and one
        ``sum_reduce`` launch over the in-degree (at most 65535 // L
        outputs)."""
        prods = F.mont_mul(Fr, inp[self.idx], self.coeff[:, :, None, :])
        return F.sum_reduce(Fr, prods)


class BrakedownCode:
    """brakedown.rs Brakedown::new_multilinear + encode, over matrices
    already drawn (``random`` draws them)."""

    def __init__(self, row_len: int, n_0: int, spec: BrakedownSpec, a: List[SparseMatrix], b: List[SparseMatrix]):
        self.row_len, self.n_0, self.spec = row_len, n_0, spec
        self.a, self.b = a, b
        self.codeword_len = spec.codeword_len(LOG2_Q, row_len, n_0)
        self.num_column_opening = spec.num_column_opening()
        self.num_proximity_testing = spec.num_proximity_testing(LOG2_Q, row_len, n_0)
        self.device = a[0].coeffs.device
        # the Reed-Solomon base case: the last A output's ncoef values as
        # coefficients evaluated at x = 1 ... rs_len, a (ncoef, rs_len)
        # Vandermonde (x^j, Montgomery) summed over j
        rs_len, ncoef = b[-1].n, a[-1].m
        xs = np.arange(1, rs_len + 1, dtype=object)
        pw = np.ones((ncoef, rs_len), dtype=object)
        for j in range(1, ncoef):
            pw[j] = pw[j - 1] * xs % P
        self.vandermonde = Fr.encode(pw, self.device)
        self.a_n_prefix = np.cumsum([x.n for x in a])
        self.max_outputs = max([x.m for x in a + b] + [rs_len])

    @staticmethod
    def choose_row_len(num_vars: int, n_0: int, spec: BrakedownSpec) -> int:
        """The row length of the smallest proof (brakedown.py:163-172)."""
        assert (1 << num_vars) > n_0
        min_log2_n = (n_0 + 1 - 1).bit_length()
        best = (None, None)
        for log2_n in range(min_log2_n, num_vars + 1):
            c = 1 << log2_n
            r = 1 << (num_vars - log2_n)
            num_ldt = spec.num_proximity_testing(LOG2_Q, c, n_0)
            proof_size = (1 + num_ldt) * c + spec.num_column_opening() * r
            if best[0] is None or proof_size < best[0]:
                best = (proof_size, c)
        return best[1]

    @classmethod
    def random(cls, num_vars: int, n_0: int, spec: BrakedownSpec, rng: np.random.RandomState, device) -> "BrakedownCode":
        """Draw the A matrices, then the B matrices, from `rng`."""
        row_len = cls.choose_row_len(num_vars, n_0, spec)
        a_dims, b_dims = spec.dimensions(LOG2_Q, row_len, n_0)
        a = [SparseMatrix.random(n, m, d, rng, device) for (n, m, d) in a_dims]
        b = [SparseMatrix.random(n, m, d, rng, device) for (n, m, d) in b_dims]
        return cls(row_len, n_0, spec, a, b)

    def encode(self, rows: torch.Tensor) -> torch.Tensor:
        """(row_len, L, 8) -> (codeword_len, L, 8): L rows at once, in
        passes of at most 65535 // (the most outputs of a stage) rows."""
        if rows.dim() != 3 or rows.shape[0] != self.row_len or rows.shape[2] != F.LIMBS:
            raise ValueError(f"encode: expected ({self.row_len}, L, {F.LIMBS}) rows")
        step = max(1, SUM_COLUMNS // self.max_outputs)
        if rows.shape[1] > step:
            return torch.cat([self.encode(rows[:, i : i + step]) for i in range(0, rows.shape[1], step)], dim=1)
        out = torch.empty((self.codeword_len,) + tuple(rows.shape[1:]), dtype=torch.int32, device=rows.device)
        out[: self.row_len] = rows
        at, inp = self.row_len, rows
        for a in self.a[:-1]:
            inp = a.dot(inp)
            out[at : at + a.m] = inp
            at += a.m
        tmp = self.a[-1].dot(inp)
        rs_len = self.b[-1].n
        out[at : at + rs_len] = F.sum_reduce(Fr, F.mont_mul(Fr, tmp[:, None], self.vandermonde[:, :, None, :]))
        at += rs_len
        # B stages, last to first: B_j reads the contiguous block of length
        # b_j.n starting at A_j's output position sum_{i<=j} a_i.n
        for j in range(len(self.b) - 1, -1, -1):
            start = int(self.a_n_prefix[j])
            bj = self.b[j]
            out[at : at + bj.m] = bj.dot(out[start : start + bj.n])
            at += bj.m
        if at != self.codeword_len:
            raise AssertionError(f"encode wrote {at} of {self.codeword_len} codeword entries")
        return out


# ---------------------------------------------------------------------------
# PCS layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BrakedownParams:
    num_vars: int
    num_rows: int
    code: BrakedownCode

    @property
    def device(self):
        return self.code.device


@dataclasses.dataclass
class BrakedownCommitment:
    columns: np.ndarray  # (codeword_len, num_rows * 32) uint8: each column's canonical little-endian reprs, row by row
    tree: List[np.ndarray]  # (width, 32) uint8 a level: 0 = the leaf hashes padded to a power of two, ..., the root
    root: bytes


def merkle_tree(leaves: np.ndarray) -> List[np.ndarray]:
    """The levels of a Keccak-256 Merkle tree over (n, 32) leaf hashes,
    padded with zero hashes to a power of two (brakedown.py:242-256); each
    level hashed in one call."""
    n = leaves.shape[0]
    level = np.zeros((1 << max((n - 1).bit_length(), 0), 32), dtype=np.uint8)
    level[:n] = leaves
    levels = [level]
    while level.shape[0] > 1:
        level = keccak256_rows(level.reshape(-1, 64))
        levels.append(level)
    return levels


def _reprs(t: torch.Tensor) -> np.ndarray:
    """Canonical field rows (..., 8) -> (..., 32) uint8 little-endian reprs
    on the host."""
    return F.to_numpy_u32(t).view(np.uint8)


def _from_reprs(le: np.ndarray, device) -> torch.Tensor:
    """(..., 32) uint8 little-endian reprs -> (..., 8) limb rows on `device`."""
    return F.from_numpy_u32(np.ascontiguousarray(le, dtype=np.uint8).view("<u4"), device)


def _combine(values: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """(R, N, 8) values and (T, R, 8) coefficients -> (T, N, 8) sums over r
    of coeffs[t, r] * values[r, n]: one K4 launch and one sum_reduce a pass
    of at most 65535 // T columns (one pass up to nv = 18). A Montgomery
    side and a canonical side give canonical sums."""
    step = max(1, SUM_COLUMNS // coeffs.shape[0])
    if values.shape[1] > step:
        return torch.cat([_combine(values[:, i : i + step], coeffs) for i in range(0, values.shape[1], step)], dim=1)
    return F.sum_reduce(Fr, F.mont_mul(Fr, values[:, None], coeffs.transpose(0, 1)[:, :, None, :]))


def point_to_tensor(num_rows: int, point: Sequence[int], device):
    """brakedown.rs point_to_tensor: the point split (hi, lo); t_0 = eq(lo)
    over the rows, t_1 = eq(hi) over a row's entries, Montgomery tensors
    (one eq_xy launch each on the card)."""
    k = len(point)
    log_rows = max(num_rows.bit_length() - 1, 0)
    hi, lo = list(point[: k - log_rows]), list(point[k - log_rows :])
    return mle.eq_xy(Fr, lo, device), mle.eq_xy(Fr, hi, device)


class MultilinearBrakedown:
    SPEC = SPEC6
    FIELD = Fr

    @classmethod
    def setup(cls, poly_size: int, batch_size: int = 1, rng=None, device="cuda") -> BrakedownParams:
        """The code for polys of `poly_size` evaluations, its matrices drawn
        from `rng` (RandomState(0) if None) and kept on `device`. Brakedown
        commits each poly alone, so `batch_size` changes nothing (the
        reference's setup takes it for every PCS)."""
        if rng is None:
            rng = np.random.RandomState(0)
        num_vars = poly_size.bit_length() - 1
        n_0 = min(20, poly_size - 1)
        code = BrakedownCode.random(num_vars, n_0, cls.SPEC, rng, device)
        return BrakedownParams(num_vars=num_vars, num_rows=poly_size // code.row_len, code=code)

    @classmethod
    def from_jax_params(cls, params, device="cuda") -> BrakedownParams:
        """The JAX package's BrakedownParams (its code's spec, dimensions and
        matrices) -> the port's."""
        code = params.code

        def matrix(x):
            return SparseMatrix(x.n, x.m, x.d, np.asarray(x.rows_idx), np.asarray(x.cols_idx),
                                F.from_jax_limbs(np.asarray(x.coeffs), device))

        spec = BrakedownSpec(code.spec.alpha, code.spec.beta, code.spec.r, code.spec.lambda_)
        return BrakedownParams(
            num_vars=params.num_vars, num_rows=params.num_rows,
            code=BrakedownCode(code.row_len, code.n_0, spec, [matrix(x) for x in code.a], [matrix(x) for x in code.b]),
        )

    @staticmethod
    def from_jax_commitment(comm) -> BrakedownCommitment:
        """The JAX package's BrakedownCommitment (its rows as host ints, its
        tree as lists of hashes) -> the port's."""
        rows = np.asarray(comm.rows, dtype=object)
        columns = F.ints_to_u32(rows.T.reshape(-1)).view(np.uint8).reshape(rows.shape[1], rows.shape[0] * REPR)
        tree = [np.frombuffer(b"".join(level), dtype=np.uint8).reshape(-1, 32) for level in comm.tree]
        return BrakedownCommitment(columns=columns, tree=tree, root=comm.root)

    @classmethod
    def trim(cls, param: BrakedownParams, poly_size: int):
        if poly_size != 1 << param.num_vars:
            raise PcsError("can't trim Brakedown params to a different size")
        return param, param

    @classmethod
    def commit(cls, pp: BrakedownParams, evals: torch.Tensor) -> BrakedownCommitment:
        """Encode every row in one pass (canonical: from_mont of the rows),
        copy the codeword to the host once, hash its columns in one call and
        merklize."""
        code, rows = pp.code, pp.num_rows
        if evals.shape != (rows * code.row_len, F.LIMBS):
            raise PcsError(f"Brakedown commits polys of {rows * code.row_len} evaluations")
        canon = F.from_mont(Fr, evals.reshape(rows, code.row_len, F.LIMBS).transpose(0, 1))
        columns = _reprs(code.encode(canon)).reshape(code.codeword_len, rows * REPR)
        tree = merkle_tree(keccak256_rows(columns))
        return BrakedownCommitment(columns=columns, tree=tree, root=tree[-1][0].tobytes())

    @classmethod
    def batch_commit(cls, pp: BrakedownParams, polys) -> List[BrakedownCommitment]:
        return [cls.commit(pp, p) for p in polys]

    # generic PCS transcript IO (backend-facing). As in the reference, hash
    # commitments are streamed WITHOUT state absorption
    # (util/transcript.rs:240-263: the Output<Keccak256> write/read impls do
    # not call common_commitment)
    @staticmethod
    def write_commitments(comms: Sequence[BrakedownCommitment], transcript) -> None:
        for c in comms:
            transcript.write_hash(c.root)

    @staticmethod
    def read_commitments(vp: BrakedownParams, n: int, transcript) -> List[bytes]:
        return [transcript.read_hash() for _ in range(n)]

    @staticmethod
    def verifier_commitment(comm: BrakedownCommitment) -> bytes:
        return comm.root

    @classmethod
    def open(cls, pp: BrakedownParams, evals: torch.Tensor, comm: BrakedownCommitment, point: Sequence[int],
             eval_, transcript) -> None:
        """The proximity rows and the t_0-combined row (the first proximity
        row and the t_0 row in one pass and one copy to the host), then the
        columns: squeezed and absorbed one by one, streamed in one write
        with their paths."""
        code, rows = pp.code, pp.num_rows
        cw = code.codeword_len
        values = evals.reshape(rows, code.row_len, F.LIMBS)  # Montgomery
        t_0 = F.from_mont(Fr, point_to_tensor(rows, point, evals.device)[0])  # canonical coefficients
        t0_row = None
        for _ in range(code.num_proximity_testing if rows > 1 else 0):
            coeffs = F.from_numpy_u32(F.ints_to_u32(transcript.squeeze_challenges(rows)), evals.device)
            if t0_row is None:  # the first proximity row and the t_0 row, copied to the host together
                row, t0_row = _reprs(_combine(values, torch.stack([coeffs, t_0])))
            else:
                row = _reprs(_combine(values, coeffs[None]))[0]
            transcript.write_field_reprs(row)
        if t0_row is None:
            t0_row = _reprs(_combine(values, t_0[None]))[0]
        transcript.write_field_reprs(t0_row)

        depth = max((cw - 1).bit_length(), 0)
        columns = np.empty(code.num_column_opening, dtype=np.int64)
        for i in range(code.num_column_opening):
            columns[i] = transcript.squeeze_challenge_idx(cw)
            transcript.common_field_reprs(comm.columns[columns[i]].tobytes())
        items = comm.columns[columns].reshape(-1, rows, REPR)[:, :, ::-1].reshape(-1, rows * REPR)
        paths = [comm.tree[lvl][(columns >> lvl) ^ 1] for lvl in range(depth)]
        transcript.write_stream(np.concatenate([items] + paths, axis=1).tobytes())

    @classmethod
    def verify(cls, vp: BrakedownParams, root: bytes, point: Sequence[int], eval_: int, transcript) -> None:
        """Read the combined rows and encode them on the device of `vp` in
        one pass; read every column (items absorbed, paths not); then check
        all columns at once: the items' combinations against the encoded
        rows, the leaf hashes and the paths level by level, one hash call a
        level; last the t_0 row against the claimed evaluation."""
        code, rows = vp.code, vp.num_rows
        cw, row_len, device = code.codeword_len, code.row_len, vp.device
        t_0, t_1 = point_to_tensor(rows, point, device)  # Montgomery coefficients
        coeffs, combined = [], []
        for _ in range(code.num_proximity_testing if rows > 1 else 0):
            coeffs.append(Fr.encode(transcript.squeeze_challenges(rows), device))
            combined.append(transcript.read_field_reprs(row_len))
        coeffs.append(t_0)
        combined.append(transcript.read_field_reprs(row_len))
        combined = _from_reprs(np.stack(combined), device)  # (T, row_len, 8) canonical
        encoded = code.encode(combined.transpose(0, 1))

        depth = max((cw - 1).bit_length(), 0)
        n, width, rs = code.num_column_opening, (rows + depth) * REPR, rows * REPR
        columns, opened = np.empty(n, dtype=np.int64), []
        for i in range(n):
            columns[i] = transcript.squeeze_challenge_idx(cw)
            opened.append(transcript.read_stream(width))
            transcript.common_field_reprs(np.frombuffer(opened[i], np.uint8, rs).reshape(rows, REPR)[:, ::-1].tobytes())
        opened = np.frombuffer(b"".join(opened), dtype=np.uint8).reshape(n, width)
        items = np.ascontiguousarray(opened[:, :rs].reshape(n, rows, REPR)[:, :, ::-1])
        if not below_modulus(items.reshape(-1, REPR), P).all():
            raise TranscriptError("invalid field element encoding in proof")

        got = _combine(_from_reprs(items.transpose(1, 0, 2), device), torch.stack(coeffs))
        want = encoded[torch.from_numpy(columns).to(device)].transpose(0, 1)
        if not torch.equal(got, want):
            raise PcsError("Brakedown proximity failure")

        output = keccak256_rows(items.reshape(n, rs))
        paths = opened[:, rs:].reshape(n, depth, REPR)
        for lvl in range(depth):
            right = ((columns >> lvl) & 1).astype(bool)[:, None]
            sibling = paths[:, lvl]
            output = keccak256_rows(np.concatenate([np.where(right, sibling, output), np.where(right, output, sibling)],
                                                   axis=1))
        if not (output == np.frombuffer(root, dtype=np.uint8)).all():
            raise PcsError("Brakedown invalid merkle opening")

        got = _combine(combined[-1][:, None], t_1[None])  # <t_0 row, t_1>
        if F.u32_to_ints(F.to_numpy_u32(got).reshape(-1, F.LIMBS))[0] != eval_ % P:
            raise PcsError("Brakedown consistency failure")

    @classmethod
    def batch_open(cls, pp, polys, comms, points, evals: Sequence[Evaluation], transcript):
        """One open an evaluation (Brakedown is not additive)."""
        for ev in evals:
            cls.open(pp, polys[ev.poly], comms[ev.poly], points[ev.point], ev.value, transcript)

    @classmethod
    def batch_verify(cls, vp, roots, points, evals: Sequence[Evaluation], transcript):
        for ev in evals:
            cls.verify(vp, roots[ev.poly], points[ev.point], ev.value, transcript)
