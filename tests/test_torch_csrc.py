"""The device arithmetic of the CUDA kernels, compiled for the host.

csrc/field.cuh and csrc/ec.cuh build with g++ under FIELD_HOST_TEST, so the
Montgomery product, add, sub, neg and the complete EC add that the kernels
run can be held against the plain PyTorch versions on the CPU, bit for bit,
without a GPU, and so are csrc/mont_mul.cu's elementwise op (every op code,
strided, broadcast and by-value operands), csrc/fix_var.cu's chain (its
column phase and its tail's steps, emulated in order, with the quotients)
and the power and eq table entries of csrc/mont_chain.cu, each kernel in
the field instances it has: the field ops, the elementwise op and the power
over BN254's Fr and Fq and the Pasta fields (255-bit moduli, with 0, 1,
p - 1, p - 2 and R mod p among the rows); the EC lane, the MSM level, the
scalar ladder's lane and the plane tree's planes over BN254 G1, grumpkin,
Pallas and Vesta; the round evaluation over Fr and Fq, also from a point
offset t0 > 0 (a round of degree past 8 in chunks of points). (The
kernels' launch and reduction code runs only on the card:
tests/test_torch_kernels.py.)
"""

import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu_torch.ops import curves, ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fq, Fr

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
CSRC = pathlib.Path(__file__).resolve().parent.parent / "halo2_lasso_tpu_torch" / "csrc"
HARNESS = r"""
#define FIELD_HOST_TEST
#include <cstdio>
#include <cstdlib>
#include "ec.cuh"
#include "ec_add.cu"
#include "fix_var.cu"
#include "fold.cu"
#include "mont_mul.cu"
#include "mont_chain.cu"
#include "msm_level.cu"
#include "sumcheck_round.cu"
#include <vector>
static Fe rd() {
  Fe r;
  for (int i = 0; i < 8; ++i) if (scanf("%u", &r.v[i]) != 1) exit(1);
  return r;
}
static void wr(const Fe& a) { for (int i = 0; i < 8; ++i) printf("%u ", a.v[i]); }
static long long rdi() {
  long long v;
  if (scanf("%lld", &v) != 1) exit(1);
  return v;
}
// fn(P{}) for the field id character c ('0' Fr, '1' Fq, '2' Pallas, '3'
// Vesta), `dflt` where the op letter has none
template <class Fn>
static void by_field(char c, char dflt, Fn fn) {
  switch (c ? c : dflt) {
    case '0': fn(Fr{}); break;
    case '1': fn(Fq{}); break;
    case '2': fn(Pallas{}); break;
    case '3': fn(Vesta{}); break;
    default: exit(2);
  }
}
static std::vector<uint32_t> rows(long long n) {  // n elements of 8 words
  std::vector<uint32_t> t(8 * n + 8);
  for (long long i = 0; i < n; ++i) {
    Fe e = rd();
    for (int j = 0; j < 8; ++j) t[8 * i + j] = e.v[j];
  }
  return t;
}
template <class P, int D>
static void round_sum(const RoundParams& p, int stack) {  // one line: the D sums
  std::vector<uint32_t> st(stack * D * 8);
  Fe acc[D];
  for (int t = 0; t < D; ++t) acc[t] = fe_zero();
  for (long long i = 0; i < p.h; ++i) {
    eval_pair<P, D>(p, i, Stack<D>{st.data(), 1});
    for (int t = 0; t < D; ++t) acc[t] = fe_add<P>(acc[t], Stack<D>{st.data(), 1}.get(0, t));
  }
  for (int t = 0; t < D; ++t) wr(acc[t]);
}
template <class P>
static void round_sum_degree(const RoundParams& p, int D, int stack) {
  switch (D) {
    case 1: round_sum<P, 1>(p, stack); break;
    case 2: round_sum<P, 2>(p, stack); break;
    case 3: round_sum<P, 3>(p, stack); break;
    case 4: round_sum<P, 4>(p, stack); break;
    case 5: round_sum<P, 5>(p, stack); break;
    case 6: round_sum<P, 6>(p, stack); break;
    case 7: round_sum<P, 7>(p, stack); break;
    default: round_sum<P, 8>(p, stack);
  }
}
template <class P>
static void chain(ChainParams& p) {  // one line: the bound table, then the quotients
  const long long cols = p.n >> p.m;
  std::vector<uint32_t> mid(8 * cols), out(8 * (p.n >> p.j) + 8), sm(8 * cols);
  const int g = chain_lane_bits(p.m), d = p.m - g;
  for (long long i = 0; p.m > 0 && i < cols; ++i) {  // a column: its lanes, then their combination
    std::vector<Fe> v(1 << g);
    for (int l = 0; l < (1 << g); ++l) v[l] = chain_rows<P>(p, i, (long long)l << d, d);
    for (int q = 0; q < g; ++q)
      for (int l = 0; l < (1 << g); l += 2 << q)
        v[l] = chain_step<P>(p, d + q, chain_qi(p, i, d + q, l >> (q + 1)), v[l], v[l + (1 << q)]);
    fe_store(p.m == p.j ? out.data() : mid.data(), i, v[0]);
  }
  if (p.m < p.j) {  // the tail, one step at a time over every element
    for (long long e = 0; e < cols; ++e) tput(sm.data(), cols, e, fe_load(p.m > 0 ? mid.data() : p.evals, e));
    long long h = cols;
    for (int s = p.m; s < p.j; ++s) {
      h >>= 1;
      std::vector<Fe> r(h);
      for (long long e = 0; e < h; ++e) r[e] = tail_elem<P>(p, sm.data(), cols, s, h, e);
      for (long long e = 0; e < h; ++e) tput(sm.data(), cols, e, r[e]);
    }
    for (long long e = 0; e < h; ++e) fe_store(out.data(), e, tget(sm.data(), cols, e));
  }
  for (long long i = 0; i < (p.n >> p.j); ++i) wr(fe_load(out.data(), i));
  for (long long i = 0; p.quot && i < p.n - 1; ++i) wr(fe_load(p.quot, i));
}
static EwOperand operand(std::vector<uint32_t>& keep) {  // 0 value | 1 rows offset s0 s1 row...
  EwOperand x;
  x.p = nullptr;
  x.s0 = x.s1 = 0;
  if (rdi() == 0) {
    x.v = rd();
    return x;
  }
  long long rows_n = rdi(), off = rdi();
  x.s0 = rdi();
  x.s1 = rdi();
  keep = rows(rows_n);
  x.p = keep.data() + 8 * off;
  x.v = fe_zero();
  return x;
}
int main() {
  char op[8];
  while (scanf("%7s", op) == 1) {
    if (op[0] == 'c') {  // c<field> n j m last quot, the j point rows, the n table rows
      static ChainParams p;
      p.n = rdi();
      p.j = (int)rdi();
      p.m = (int)rdi();
      p.last = (int)rdi();
      const bool quot = rdi();
      for (int i = 0; i < p.j; ++i) p.x[i] = rd();
      p.x_dev = nullptr;
      std::vector<uint32_t> t = rows(p.n), q(8 * p.n);
      p.evals = t.data();
      p.quot = quot ? q.data() : nullptr;
      by_field(op[1], '0', [&](auto f) { chain<decltype(f)>(p); });
    } else if (op[0] == 'w') {  // w<field> op outer inner, then the operands a, b, c
      EwParams p;
      int ewop = (int)rdi();
      p.outer = rdi();
      p.inner = rdi();
      std::vector<uint32_t> ka, kb, kc;
      p.a = operand(ka);
      p.b = operand(kb);
      p.c = operand(kc);
      for (long long g = 0; g < p.outer * p.inner; ++g)
        by_field(op[1], '0', [&](auto f) { wr(ew_elem_op<decltype(f)>(ewop, p, g)); });
    } else if (op[0] == 'l') {  // l[id] W B m n first: one MSM level, every lane in order (l: BN254 G1)
      long long W = rdi(), B = rdi(), m = rdi(), n = rdi(), first = rdi();
      std::vector<uint32_t> x = rows(n), y = rows(n), z = rows(n);
      std::vector<int32_t> dig(first ? W * n : W * m);
      for (auto& d : dig) d = (int32_t)rdi();
      std::vector<long long> order(first ? W * m : 0);
      for (auto& o : order) o = rdi();
      std::vector<uint32_t> bx = rows(W * B), by = rows(W * B), bz = rows(W * B);
      long long pairs = m / 2, lanes = pairs ? W * pairs : W;
      std::vector<uint32_t> ox(8 * W * pairs + 8), oy(ox.size()), oz(ox.size());
      std::vector<int32_t> odig(W * pairs + 1);
      by_field(op[1], '1', [&](auto f) {
        for (long long lane = 0; lane < lanes; ++lane)
          msm_level_lane<decltype(f)>(x.data(), y.data(), z.data(), dig.data(), first ? order.data() : nullptr,
                                      pairs, (int)B, lane, bx.data(), by.data(), bz.data(), ox.data(), oy.data(),
                                      oz.data(), odig.data());
      });
      for (auto* t : {&ox, &oy, &oz})
        for (long long i = 0; i < 8 * W * pairs; ++i) printf("%u ", (*t)[i]);
      for (long long i = 0; i < W * pairs; ++i) printf("%d ", odig[i]);
      for (auto* t : {&bx, &by, &bz})
        for (long long i = 0; i < 8 * W * B; ++i) printf("%u ", (*t)[i]);
    } else if (op[0] == 'r') {  // r[id] D nleaves nops nconsts h nchals stack t0 [t0_m]: one round message
      static RoundParams p;
      int D = (int)rdi(), nleaves = (int)rdi(), nops = (int)rdi(), nconsts = (int)rdi();
      long long h = rdi();
      int nchals = (int)rdi(), stack = (int)rdi();
      p.t0 = (int)rdi();
      p.t0_m = p.t0 ? rd() : fe_zero();
      std::vector<std::vector<uint32_t>> leaves;
      for (int l = 0; l < nleaves; ++l) leaves.push_back(rows(2 * h));
      for (int l = 0; l < nleaves; ++l) p.leaves[l] = leaves[l].data();
      for (int k = 0; k < nops; ++k) p.ops[k] = (unsigned short)rdi();
      for (int k = 0; k < nconsts; ++k) p.consts[k] = rd();
      std::vector<uint32_t> chals = rows(nchals);
      p.chals = chals.data();
      p.h = h;
      p.nops = nops;
      by_field(op[1], '0', [&](auto f) { round_sum_degree<decltype(f)>(p, D, stack); });
    } else if (op[0] == 'p') {  // p<field> nbits w0..w7 a: a^e
      PowExp e;
      e.nbits = (int)rdi();
      for (int i = 0; i < 8; ++i) e.w[i] = (uint32_t)rdi();
      Fe a = rd();
      by_field(op[1], '0', [&](auto f) { wr(fe_pow<decltype(f)>(a, e)); });
    } else if (op[0] == 'q') {  // q k y_0..y_{k-1}: the 2^k eq table, entry by entry
      static EqParams p;
      p.k = (int)rdi();
      p.y_dev = nullptr;
      for (int i = 0; i < p.k; ++i) p.y[i] = rd();
      for (long long b = 0; b < (1ll << p.k); ++b) wr(eq_xy_elem<Fr>(p, b));
    } else if (op[0] == 'g') {  // g[id] nbits k0..k7 px py pz: one ladder lane (g: BN254 G1)
      int nbits = (int)rdi();
      uint32_t k[8];
      for (auto& w : k) w = (uint32_t)rdi();
      Fe px = rd(), py = rd(), pz = rd(), ox, oy, oz;
      by_field(op[1], '1', [&](auto f) { ec_ladder_lane<decltype(f)>(px, py, pz, k, nbits, ox, oy, oz); });
      wr(ox); wr(oy); wr(oz);
    } else if (op[0] == 't') {  // t[id] c W tpp: the plane tree, each plane's threads in turn (t: BN254 G1)
      int c = (int)rdi(), W = (int)rdi(), tpp = (int)rdi();
      std::vector<uint32_t> bx = rows((long long)W << c), by = rows((long long)W << c), bz = rows((long long)W << c);
      const int half = 1 << (c - 2);
      std::vector<uint32_t> sm(24 * half);
      const TreeSlots S{sm.data(), half};
      by_field(op[1], '1', [&](auto f) {
        using P = decltype(f);
        for (int j = 0; j < c; ++j)
          for (int w = 0; w < W; ++w) {
            for (int t = 0; t < tpp; ++t)
              for (int k = t; k < half; k += tpp)
                tree_first<P>(bx.data(), by.data(), bz.data(), c, j, w, k, half, S, k);
            for (int h = half / 2; h >= 1; h /= 2)
              for (int t = 0; t < tpp; ++t)
                for (int k = t; k < h; k += tpp) tree_step<P>(S, k, k + h);
            Fe x, y, z;
            S.get(0, x, y, z);
            wr(x); wr(y); wr(z);
          }
      });
    } else if (op[0] == 'e') {  // e[id]: one EC lane (e: BN254 G1 over Fq)
      Fe x1 = rd(), y1 = rd(), z1 = rd(), x2 = rd(), y2 = rd(), z2 = rd(), ox, oy, oz;
      by_field(op[1], '1', [&](auto f) { ec_add_lane<decltype(f)>(x1, y1, z1, x2, y2, z2, ox, oy, oz); });
      wr(ox); wr(oy); wr(oz);
    } else {
      Fe a = rd(), b = rd(), r;
      by_field(op[1], '0', [&](auto f) {
        using P = decltype(f);
        switch (op[0]) {
          case 'm': r = fe_mul<P>(a, b); break;
          case 'a': r = fe_add<P>(a, b); break;
          case 's': r = fe_sub<P>(a, b); break;
          default: r = fe_neg<P>(a);
        }
      });
      wr(r);
    }
    printf("\n");
  }
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the device arithmetic for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "h.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-O0", "-std=c++17", "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(d / "h"), str(d / "h.cpp")],
                   check=True, capture_output=True, timeout=120)
    return d / "h"


def run(harness, lines):
    out = subprocess.run([str(harness)], input="\n".join(lines) + "\n", capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()
    return np.array([[int(v) for v in line.split()] for line in out], dtype=np.uint64).astype(np.uint32)


def rows(t):
    return [" ".join(map(str, r)) for r in F.to_numpy_u32(t).reshape(t.shape[0], -1).tolist()]


FIELDS = [Fr, Fq, curves.Fp_pallas, curves.Fq_vesta]
FIELD_IDS = ["fr", "fq", "pallas", "vesta"]


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
def test_field_ops_match_plain(harness, spec):
    rng = random.Random(3)
    p = spec.modulus
    xs = [0, 1, p - 1, spec.R, p - 2] + [rng.randrange(p) for _ in range(195)]
    ys = [p - 1, p - 1, p - 1, 1, 0] + [rng.randrange(p) for _ in range(195)]
    a, b = spec.encode(xs), spec.encode(ys)
    ops = {"m": F.mont_mul_plain, "a": F.add, "s": F.sub, "n": lambda s, x, _: F.neg(s, x)}
    for op, fn in ops.items():
        lines = [f"{op}{spec.kernel_id} {ra} {rb}" for ra, rb in zip(rows(a), rows(b))]
        assert np.array_equal(run(harness, lines), F.to_numpy_u32(fn(spec, a, b))), op


def test_ec_add_lane_matches_plain(harness):
    ps, qs = chip_smoke.ec_cases(np, np.random.RandomState(8), MJ, FQ_MODULUS, 200)
    P = {k: Fq.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    Q = {k: Fq.encode([pt[i] for pt in qs]) for i, k in enumerate(ec.COORDS)}
    cols = [rows(P[k]) for k in ec.COORDS] + [rows(Q[k]) for k in ec.COORDS]
    got = run(harness, ["e " + " ".join(c[i] for c in cols) for i in range(len(ps))])
    want = ec.ec_add_plain(P, Q)
    assert np.array_equal(got, np.concatenate([F.to_numpy_u32(want[k]) for k in ec.COORDS], axis=1))


@pytest.mark.parametrize("last", [False, True], ids=["fix_var", "fix_last_var"])
def test_fix_var_elem_matches_plain(harness, last):
    """csrc/fix_var.cu's one-variable case (a column a pair, as fix_var
    launches it at a wide table) and its tail step (one block over a
    narrow one), at a ragged half-length, against the plain fold."""
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    rng = random.Random(5)
    p = Fr.modulus
    vals = [0, 1, p - 1, Fr.R, p - 1, 0] + [rng.randrange(p) for _ in range(58)]
    t, x = Fr.encode(vals), Fr.encode([rng.randrange(p)])
    want = F.to_numpy_u32(mle.fix_var_plain(Fr, t, x[0], last))
    for m in (0, 1):
        line = f"c0 {t.shape[0]} 1 {m} {int(last)} 0 " + " ".join(rows(x) + rows(t))
        assert np.array_equal(run(harness, [line]).reshape(-1, 8), want), m


def ew_operand(spec, x):
    """The harness's operand: 0 and the value (Montgomery, as the wrapper
    passes a host int), or 1, the rows of x's storage, x's first row in it
    and its two row strides as the wrapper computes them."""
    if isinstance(x, int):
        return "0 " + " ".join(rows(spec.encode([x])))
    store = torch.empty(0, dtype=torch.int32).set_(x.untyped_storage()).reshape(-1, 8)
    s0, s1 = F._grid_strides(x)
    return f"1 {store.shape[0]} {x.storage_offset() // 8} {s0} {s1} " + " ".join(rows(store))


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
def test_ew_elem_matches_plain(harness, spec):
    """csrc/mont_mul.cu's element op for every op code, with operands read
    as the wrapper passes them: full rows, a table's even and odd rows
    (pair stride 2), one broadcast row (stride 0), a 2-D grid of halves, and
    host ints by value; against the plain versions."""
    rng = random.Random(17)
    p = spec.modulus
    table = spec.encode([0, 1, p - 1, spec.R] + [rng.randrange(p) for _ in range(3 * 40 - 4)]).reshape(3, 40, 8)
    flat = table.reshape(-1, 8)
    one = spec.encode([rng.randrange(p)])[0]
    cases = [  # (a, b, c), each a (..., 8) view of the shape of a
        (flat[:40], flat[40:80], flat[80:]),
        (table[:, 1::2], table[:, 0::2], one.expand(3, 20, 8)),
        (flat[0::2], one.expand(60, 8), flat[1::2]),
        (table[:2, :20], table[1:, 20:], table[:2, 20:]),
    ]
    consts = [0, 1, p - 1, rng.randrange(p)]
    for op in range(6):
        nargs = F._EW_ARGS[op]
        for ci, (a, b, c) in enumerate(cases):
            for by_value in ((False, False), (True, False), (False, True)):
                args = [a, consts[ci] if by_value[0] else b, consts[-1 - ci] if by_value[1] else c][:nargs]
                shape = a.shape
                lead = shape[:-1]
                outer, inner = (int(np.prod(lead[:-1])), lead[-1])
                text = " ".join([ew_operand(spec, x if isinstance(x, int) else x.expand(shape)) for x in args]
                                + [ew_operand(spec, 0)] * (3 - nargs))
                got = run(harness, [f"w{spec.kernel_id} {op} {outer} {inner} {text}"]).reshape(-1, 8)
                vals = [x if isinstance(x, torch.Tensor) else spec.encode([x])[0] for x in args]
                want = F.to_numpy_u32(F._ew_plain(spec, op, *vals).expand(shape).reshape(-1, 8))
                assert np.array_equal(got, want), (op, ci, by_value)


@pytest.mark.parametrize("spec", [Fr, Fq], ids=["fr", "fq"])
def test_fix_var_chain_matches_plain(harness, spec):
    """csrc/fix_var.cu's chain, its column phase (each lane's rows, then
    the lanes' combination as the warp shuffles do it) and tail emulated in
    order, at every split m of the steps between the columns and the tail,
    both directions, with its packed quotients, on a 2^5 table with 0, 1,
    p - 1 and R mod p among the rows and the point; binding 4 of the 6
    variables of a 3 * 2^4 table; and a 2^7 table at m = 6 and 7 (lanes
    that fold two and four rows before the shuffles)."""
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    rng = random.Random(23)
    p = spec.modulus
    for n, j, splits in ((32, 5, range(6)), (48, 4, range(5)), (128, 7, (6, 7))):
        t = spec.encode([0, 1, p - 1, spec.R] + [rng.randrange(p) for _ in range(n - 4)])
        pt = spec.encode(([0, 1, p - 1] + [rng.randrange(p) for _ in range(j)])[:j])
        for last in (False, True):
            quot = n == 1 << j
            want_t, want_q = mle.fix_var_chain_plain(spec, t, pt, last, quotients=quot)
            want = F.to_numpy_u32(torch.cat([want_t] + ([want_q] if quot else [])))
            for m in splits:
                line = f"c{spec.kernel_id} {n} {j} {m} {int(last)} {int(quot)} " + " ".join(rows(pt) + rows(t))
                assert np.array_equal(run(harness, [line]).reshape(-1, 8), want), (n, j, last, m)


def words(t):
    return " ".join(map(str, F.to_numpy_u32(t).reshape(-1).tolist()))


def test_msm_level_lane_matches_plain(harness):
    """csrc/msm_level.cu's lane, every lane of each level in order, against
    msm_level_plain over a whole 8-point MSM (c = 3): the first level read
    through the sort, the later ones, and the final flush. Two base points
    (rescaled, some negated) make P = Q and P = -Q lanes frequent."""
    rng = np.random.RandomState(12)
    points = chip_smoke.msm_edge_points(np, rng, MJ, FQ_MODULUS, "cpu", n=8)
    scal = Fr.encode([int(rng.randint(0, 1 << 62)) * (i % 3 != 0) for i in range(8)])
    c = 3
    B, W = 1 << c, -(-Fr.num_bits // c)
    digits = MJ.digits_all(F.from_mont(Fr, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = ec.identity_point(W * B + 1)
    lvl_pts, lvl_dig, first = points, digits, True
    while True:
        n = lvl_pts["x"].shape[0]
        m = 8 if first else lvl_dig.shape[0] // W
        line = " ".join([f"l {W} {B} {m} {n} {int(first)}"] + [words(lvl_pts[k]) for k in ec.COORDS]
                        + [" ".join(map(str, lvl_dig.reshape(-1).tolist()))]
                        + ([" ".join(map(str, order.reshape(-1).tolist()))] if first else [])
                        + [words(bucket[k][: W * B]) for k in ec.COORDS])
        got = run(harness, [line])[0].astype(np.int64)
        lvl_pts, lvl_dig = MJ.msm_level_plain(lvl_pts, lvl_dig, bucket, W, B, order=order if first else None)
        rows_out = W * (m // 2)
        want = np.concatenate([F.to_numpy_u32(lvl_pts[k]).reshape(-1) for k in ec.COORDS]
                              + [lvl_dig.numpy().astype(np.uint32)]
                              + [F.to_numpy_u32(bucket[k][: W * B]).reshape(-1) for k in ec.COORDS])
        assert np.array_equal(got, want.astype(np.int64)), f"level m={m}"
        first = False
        if m == 1:
            break
        assert rows_out == lvl_dig.shape[0]


@pytest.mark.parametrize("name", ["degree1", "lasso_primary", "gkr_pure", "degree6_neg_const", "degree8"])
def test_round_eval_pair_matches_plain(harness, name):
    """csrc/sumcheck_round.cu's one-pass evaluation (every degree point of a
    pair in one walk of the program), summed over the pairs, against
    round_message_plain."""
    from halo2_lasso_tpu_torch.expression import Expression as E
    from halo2_lasso_tpu_torch.lasso.tables import range_table
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.piop import sum_check as sc

    expr, n_polys = {
        "degree1": (E.poly(0) * 3 + E.challenge(0) - E.constant(9), 1),
        "lasso_primary": (E.eq_xy(0) * range_table(8, 4).g, 2),
        "gkr_pure": (gkr.sum_check_expression_pure(2), 4),
        "degree6_neg_const": (E.distribute_powers(
            [E.poly(0) * E.poly(1) * E.poly(2) * E.poly(3) - E.poly(1), -(E.poly(2) * 7) + E.constant(5)],
            E.challenge(1)) * E.eq_xy(0) * E.lagrange(1) + E.identity(), 4),
        "degree8": (E.poly(0) * E.poly(1) * E.poly(2) * E.poly(3) * E.poly(0) * E.poly(1) * E.poly(2)
                    * E.eq_xy(0), 4),
    }[name]
    keys = sc._leaf_keys(expr, n_polys)
    prog = sc.lower_expression(expr, keys)
    rng = random.Random(len(name))
    p = Fr.modulus
    h = 9
    tables = [Fr.encode([rng.randrange(p) for _ in range(2 * h)]) for _ in keys]
    tables[0][:4] = Fr.encode([0, p - 1, 1, Fr.R])
    chals = Fr.encode([rng.randrange(p) for _ in range(2)])
    ops, consts = prog.kernel_args(Fr)
    line = " ".join([f"r {expr.degree} {len(keys)} {len(ops)} {len(prog.consts)} {h} 2 {prog.max_stack} 0"]
                    + [words(t) for t in tables] + [" ".join(map(str, ops.tolist()))]
                    + [" ".join(map(str, consts[: len(prog.consts)].reshape(-1).tolist()))] + [words(chals)])
    want = sc.round_message_plain(Fr, tables, prog, chals, expr.degree)
    assert np.array_equal(run(harness, [line]).reshape(-1, 8), F.to_numpy_u32(want))


def test_round_eval_pair_matches_plain_at_arx_gkr_batch(harness):
    """The same one-pass evaluation on the largest program of the 32-bit ARX
    chain's memory check: a GKR layer batching 36 pure grand products, 73
    leaves and 359 ops, beyond the 64 leaves and 384 ops the kernel took
    before."""
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.piop import sum_check as sc

    expr = gkr.sum_check_expression_pure(36)
    keys = sc._leaf_keys(expr, 72)
    prog = sc.lower_expression(expr, keys)
    assert (len(keys), len(prog.ops)) == (73, 359)
    rng = random.Random(36)
    p = Fr.modulus
    h = 5
    tables = [Fr.encode([rng.randrange(p) for _ in range(2 * h)]) for _ in keys]
    chals = Fr.encode([rng.randrange(p)])
    ops, consts = prog.kernel_args(Fr)
    line = " ".join([f"r {expr.degree} {len(keys)} {len(ops)} {len(prog.consts)} {h} 1 {prog.max_stack} 0"]
                    + [words(t) for t in tables] + [" ".join(map(str, ops.tolist()))]
                    + [" ".join(map(str, consts[: len(prog.consts)].reshape(-1).tolist()))] + [words(chals)])
    want = sc.round_message_plain(Fr, tables, prog, chals, expr.degree)
    assert np.array_equal(run(harness, [line]).reshape(-1, 8), F.to_numpy_u32(want))


def test_round_kernel_limits_match_wrapper():
    """The limits compiled into csrc/sumcheck_round.cu are the ones the
    wrapper checks before a launch."""
    import re

    from halo2_lasso_tpu_torch.piop import sum_check as sc

    src = (CSRC / "sumcheck_round.cu").read_text()
    defines = dict(re.findall(r"#define (MAX_\w+) (\d+)", src))
    assert {k: int(v) for k, v in defines.items()} == {
        k: getattr(sc, k) for k in ("MAX_STACK", "MAX_DEGREE", "MAX_LEAVES", "MAX_OPS", "MAX_CONSTS")
    }


@pytest.mark.parametrize("spec", FIELDS, ids=FIELD_IDS)
def test_pow_matches_plain(harness, spec):
    """csrc/mont_chain.cu's per-row power (left-to-right square and
    multiply, the exponent by value) against pow_fixed's plain loop, at
    exponents 0, 1, 2, p - 2 and a random 254-bit one, on rows with 0, 1,
    p - 1, p - 2 and R mod p."""
    rng = random.Random(9)
    p = spec.modulus
    a = spec.encode([0, 1, p - 1, spec.R, p - 2] + [rng.randrange(p) for _ in range(3)])
    for e in (0, 1, 2, p - 2, rng.getrandbits(254) | 1 << 253):
        words, nbits = F._exponent(e)
        head = f"p{spec.kernel_id} {nbits} " + " ".join(map(str, words.tolist()))
        got = run(harness, [f"{head} {r}" for r in rows(a)])
        assert np.array_equal(got, F.to_numpy_u32(F.pow_fixed_plain(spec, a, e))), e


def test_eq_xy_elem_matches_plain(harness):
    """csrc/mont_chain.cu's eq table entry (two 4-variable tables times the
    product over the higher variables) at k = 5 and k = 0, against the
    doubling, with 0, 1 and p - 1 among the coordinates."""
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    rng = random.Random(4)
    p = Fr.modulus
    for y in ([0, 1, p - 1] + [rng.randrange(p) for _ in range(2)], []):
        ty = Fr.encode(y) if y else Fr.zeros(0)
        got = run(harness, [" ".join([f"q {len(y)}"] + (rows(ty) if y else []))]).reshape(-1, 8)
        assert np.array_equal(got, F.to_numpy_u32(mle.eq_xy_plain(Fr, ty)))


def test_chain_and_fold_limits_match_wrappers():
    """The limits compiled into csrc/mont_chain.cu and csrc/fold.cu are the
    ones their wrappers use."""
    import re

    from halo2_lasso_tpu_torch.poly import multilinear as mle

    chain = dict(re.findall(r"#define (\w+) (\d+)", (CSRC / "mont_chain.cu").read_text()))
    fold = dict(re.findall(r"#define (\w+) (\d+)", (CSRC / "fold.cu").read_text()))
    tile = int(chain["SCAN_THREADS"]) * int(chain["SCAN_ITEMS"])
    assert (int(chain["MAX_POW_WORDS"]), tile, int(chain["MAX_EQ_VARS"]), int(fold["FOLD_MAX_TABLES"])) == (
        F.MAX_POW_WORDS, F.SCAN_TILE, mle.MAX_EQ_VARS, mle.FOLD_MAX_TABLES)


def test_mont_mul_and_fix_var_limits_match_wrappers():
    """The op codes and limits compiled into csrc/mont_mul.cu and
    csrc/fix_var.cu are the ones their wrappers use."""
    import re

    from halo2_lasso_tpu_torch.poly import multilinear as mle

    ew = dict(re.findall(r"#define (\w+) (\d+)", (CSRC / "mont_mul.cu").read_text()))
    chain = dict(re.findall(r"#define (\w+) (\d+)", (CSRC / "fix_var.cu").read_text()))
    codes = [int(ew[k]) for k in ("EW_MUL", "EW_MUL_ADD", "EW_MUL_SUB", "EW_ADD", "EW_SUB", "EW_NEG")]
    assert codes == [F.EW_MUL, F.EW_MUL_ADD, F.EW_MUL_SUB, F.EW_ADD, F.EW_SUB, F.EW_NEG]
    assert (int(ew["SUM_THREADS"]), int(ew["SUM_MAX_BLOCKS"])) == (F.SUM_THREADS, F.SUM_MAX_BLOCKS)
    assert (int(chain["MAX_CHAIN_VARS"]), int(chain["TAIL_BITS"])) == (mle.MAX_CHAIN_VARS, mle.TAIL_BITS)


# the field instances of the grumpkin SNARK: the same device functions over
# the other field (e0: the lane add over grumpkin's Fr; l0: an MSM level over
# grumpkin; r1: the round's one-pass evaluation over Fq)


def test_ec_add_lane_grumpkin_instance_matches_plain(harness):
    from halo2_lasso_tpu_torch.ops import curves

    ps, qs = chip_smoke.ec_cases(np, np.random.RandomState(9), MJ, Fr.modulus, 200, curves.GRUMPKIN.generator)
    P = {k: Fr.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    Q = {k: Fr.encode([pt[i] for pt in qs]) for i, k in enumerate(ec.COORDS)}
    cols = [rows(P[k]) for k in ec.COORDS] + [rows(Q[k]) for k in ec.COORDS]
    got = run(harness, ["e0 " + " ".join(c[i] for c in cols) for i in range(len(ps))])
    want = ec.ec_add_plain(P, Q, Fr)
    assert np.array_equal(got, np.concatenate([F.to_numpy_u32(want[k]) for k in ec.COORDS], axis=1))


def test_msm_level_lane_grumpkin_instance_matches_plain(harness):
    """The MSM level's lanes over grumpkin (coordinates in Fr, scalars in
    Fq), every level of an 8-point MSM (c = 3), against msm_level_plain."""
    from halo2_lasso_tpu_torch.ops import curves

    rng = np.random.RandomState(13)
    points = chip_smoke.msm_edge_points(np, rng, MJ, Fr.modulus, "cpu", n=8, curve=curves.GRUMPKIN)
    scal = Fq.encode([int(rng.randint(0, 1 << 62)) * (i % 3 != 0) for i in range(8)])
    c = 3
    B, W = 1 << c, -(-Fq.num_bits // c)
    digits = MJ.digits_all(F.from_mont(Fq, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = ec.identity_point(W * B + 1, "cpu", Fr)
    lvl_pts, lvl_dig, first = points, digits, True
    while True:
        n = lvl_pts["x"].shape[0]
        m = 8 if first else lvl_dig.shape[0] // W
        line = " ".join([f"l0 {W} {B} {m} {n} {int(first)}"] + [words(lvl_pts[k]) for k in ec.COORDS]
                        + [" ".join(map(str, lvl_dig.reshape(-1).tolist()))]
                        + ([" ".join(map(str, order.reshape(-1).tolist()))] if first else [])
                        + [words(bucket[k][: W * B]) for k in ec.COORDS])
        got = run(harness, [line])[0].astype(np.int64)
        lvl_pts, lvl_dig = MJ.msm_level_plain(lvl_pts, lvl_dig, bucket, W, B, order=order if first else None, base=Fr)
        want = np.concatenate([F.to_numpy_u32(lvl_pts[k]).reshape(-1) for k in ec.COORDS]
                              + [lvl_dig.numpy().astype(np.uint32)]
                              + [F.to_numpy_u32(bucket[k][: W * B]).reshape(-1) for k in ec.COORDS])
        assert np.array_equal(got, want.astype(np.int64)), f"level m={m}"
        first = False
        if m == 1:
            break


def test_round_eval_pair_fq_instance_matches_plain(harness):
    """The one-pass evaluation over Fq on the grumpkin SNARK's zero check
    (the vanilla circuit with lookup: 23 leaves, degree 5), summed over the
    pairs, against round_message_plain over Fq."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor
    from halo2_lasso_tpu_torch.piop import sum_check as sc

    ci = fixtures.vanilla_plonk_with_lookup_circuit_info(4, 4, [[0]] * 9, [[(10, 1), (11, 1), (12, 1)]])
    nz, expr = preprocessor.compose(ci)
    keys = sc._leaf_keys(expr, ci.num_poly() + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz)
    prog = sc.lower_expression(expr, keys)
    rng = random.Random(12)
    p = Fq.modulus
    h = 5
    tables = [Fq.encode([rng.randrange(p) for _ in range(2 * h)]) for _ in keys]
    tables[0][:4] = Fq.encode([0, p - 1, 1, Fq.R])
    chals = Fq.encode([rng.randrange(p) for _ in range(3)])
    ops, consts = prog.kernel_args(Fq)
    line = " ".join([f"r1 {expr.degree} {len(keys)} {len(ops)} {len(prog.consts)} {h} 3 {prog.max_stack} 0"]
                    + [words(t) for t in tables] + [" ".join(map(str, ops.tolist()))]
                    + [" ".join(map(str, consts[: len(prog.consts)].reshape(-1).tolist()))] + [words(chals)])
    want = sc.round_message_plain(Fq, tables, prog, chals, expr.degree)
    assert np.array_equal(run(harness, [line]).reshape(-1, 8), F.to_numpy_u32(want))


# csrc/ec_add.cu's ladder and plane tree, in both curve instances (g0 / t0:
# grumpkin over Fr; g1 / t1: BN254 G1 over Fq)


def ladder_points(curve, n=5):
    """n points of `curve` (ops/curves.py) as a Jacobian batch, z not 1, the
    last the identity."""
    pts, _ = chip_smoke.ec_cases(np, np.random.RandomState(31), MJ, curve.base.modulus, n - 1, curve.generator)
    pts = pts + [(1, 1, 0)]
    return {k: curve.base.encode([pt[i] for pt in pts]) for i, k in enumerate(ec.COORDS)}


CURVES = ["BN254_G1", "GRUMPKIN", "PALLAS", "VESTA"]
CURVE_IDS = ["bn254", "grumpkin", "pallas", "vesta"]


@pytest.mark.parametrize("curve_name", CURVES, ids=CURVE_IDS)
def test_ec_ladder_lane_matches_plain(harness, curve_name):
    """The ladder's lane (a dedicated doubling, the complete add where the
    bit is set) against scalar_mul_bits_plain's loop of two complete adds a
    bit, bit for bit in Jacobian limbs: scalars 0, 1, p - 1 and a random
    254-bit one (p the scalar field's modulus), shared by every lane and
    one a lane, over four points and the identity."""
    from halo2_lasso_tpu_torch.ops import curves

    curve = getattr(curves, curve_name)
    pts = ladder_points(curve)
    q, nbits = curve.scalar.modulus, curve.scalar.num_bits
    ks = [0, 1, q - 1, random.Random(7).getrandbits(254) | 1 << 253]
    cols = [rows(pts[k]) for k in ec.COORDS]
    n = len(cols[0])

    def lanes(per_lane):
        words = [" ".join(map(str, F.ints_to_u32([k])[0].tolist())) for k in per_lane]
        return run(harness, [f"g{curve.base.kernel_id} {nbits} {words[i]} " + " ".join(c[i] for c in cols)
                             for i in range(n)])

    def flat(r):
        return np.concatenate([F.to_numpy_u32(r[k]) for k in ec.COORDS], axis=1)

    for k in ks:
        want = ec.scalar_mul_bits_plain(pts, [(k >> i) & 1 for i in range(nbits)], curve.base)
        assert np.array_equal(lanes([k] * n), flat(want)), k
    per = (ks + ks)[1 : n + 1]
    bits = torch.tensor([[(k >> i) & 1 for i in range(nbits)] for k in per], dtype=torch.uint8)
    assert np.array_equal(lanes(per), flat(ec.scalar_mul_bits_plain(pts, bits, curve.base)))


@pytest.mark.parametrize("curve_name", CURVES, ids=CURVE_IDS)
@pytest.mark.parametrize("c", [3, 4])
def test_plane_tree_planes_match_plain(harness, curve_name, c):
    """The plane tree's first level from the buckets and its halving in the
    shared slots, each plane's threads run in turn at 1, 2 and 2^(c-2)
    threads a plane, against bucket_planes_plain; the buckets hold empty
    ones (the identity), equal points and negations (P = Q, P = -Q)."""
    from halo2_lasso_tpu_torch.ops import curves

    curve = getattr(curves, curve_name)
    W = 3
    rng = np.random.RandomState(40 + c)
    bucket = chip_smoke.msm_edge_points(np, rng, MJ, curve.base.modulus, "cpu", n=W << c, curve=curve)
    empty = ec.identity_point(1, "cpu", curve.base)
    for r in (0, 3, 9, (W << c) - 1):
        for k in ec.COORDS:
            bucket[k][r] = empty[k][0]
    want = MJ.bucket_planes_plain(bucket, c, W, curve.base)
    want = np.concatenate([F.to_numpy_u32(want[k]) for k in ec.COORDS], axis=1)
    text = " ".join(" ".join(rows(bucket[k])) for k in ec.COORDS)
    for tpp in sorted({1, 2, 1 << (c - 2)}):
        got = run(harness, [f"t{curve.base.kernel_id} {c} {W} {tpp} {text}"]).reshape(-1, 24)
        assert np.array_equal(got, want), tpp


def test_plane_tree_limits_match_wrapper():
    """The plane tree's limit on c compiled into csrc/ec_add.cu is the one
    its wrapper checks, and its block is a power of two of at least a warp
    that holds 2^(c-2) first-level positions a thread at most twice at
    c = TREE_MAX_C (the shape the kernel's shared slots are sized for)."""
    import re

    defines = dict(re.findall(r"#define (\w+) (\d+)", (CSRC / "ec_add.cu").read_text()))
    assert int(defines["TREE_MAX_C"]) == MJ.TREE_MAX_C
    t = int(defines["TREE_THREADS"])
    assert t >= 32 and t & (t - 1) == 0 and (1 << (MJ.TREE_MAX_C - 2)) <= 2 * t


# the Pasta instances (ids 2 and 3) of the EC lane and the MSM level, and
# the round evaluation from a point offset


@pytest.mark.parametrize("curve_name", ["PALLAS", "VESTA"], ids=["pallas", "vesta"])
def test_ec_add_lane_pasta_instances_match_plain(harness, curve_name):
    """The complete add's lane over Pallas and Vesta (csrc/ec_pasta.cu's
    instances) on the five cases (generic, P = Q rescaled, P = -Q, P = O,
    Q = O), against ec_add_plain over the curve's base field."""
    curve = getattr(curves, curve_name)
    base = curve.base
    ps, qs = chip_smoke.ec_cases(np, np.random.RandomState(10), MJ, base.modulus, 100, curve.generator)
    P = {k: base.encode([pt[i] for pt in ps]) for i, k in enumerate(ec.COORDS)}
    Q = {k: base.encode([pt[i] for pt in qs]) for i, k in enumerate(ec.COORDS)}
    cols = [rows(P[k]) for k in ec.COORDS] + [rows(Q[k]) for k in ec.COORDS]
    got = run(harness, [f"e{base.kernel_id} " + " ".join(c[i] for c in cols) for i in range(len(ps))])
    want = ec.ec_add_plain(P, Q, base)
    assert np.array_equal(got, np.concatenate([F.to_numpy_u32(want[k]) for k in ec.COORDS], axis=1))


@pytest.mark.parametrize("curve_name", ["PALLAS", "VESTA"], ids=["pallas", "vesta"])
def test_msm_level_lane_pasta_instances_match_plain(harness, curve_name):
    """The MSM level's lanes over Pallas and Vesta (csrc/msm_level_pasta.cu's
    instances; 255-bit scalars, so W = 85 windows at c = 3), every level of
    an 8-point MSM, against msm_level_plain."""
    curve = getattr(curves, curve_name)
    base, scalar = curve.base, curve.scalar
    rng = np.random.RandomState(14)
    points = chip_smoke.msm_edge_points(np, rng, MJ, base.modulus, "cpu", n=8, curve=curve)
    scal = scalar.encode([int(rng.randint(0, 1 << 62)) * (i % 3 != 0) for i in range(7)] + [scalar.modulus - 1])
    c = 3
    B, W = 1 << c, -(-scalar.num_bits // c)
    assert W == 85
    digits = MJ.digits_all(F.from_mont(scalar, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bucket = ec.identity_point(W * B + 1, "cpu", base)
    lvl_pts, lvl_dig, first = points, digits, True
    while True:
        n = lvl_pts["x"].shape[0]
        m = 8 if first else lvl_dig.shape[0] // W
        line = " ".join([f"l{base.kernel_id} {W} {B} {m} {n} {int(first)}"] + [words(lvl_pts[k]) for k in ec.COORDS]
                        + [" ".join(map(str, lvl_dig.reshape(-1).tolist()))]
                        + ([" ".join(map(str, order.reshape(-1).tolist()))] if first else [])
                        + [words(bucket[k][: W * B]) for k in ec.COORDS])
        got = run(harness, [line])[0].astype(np.int64)
        lvl_pts, lvl_dig = MJ.msm_level_plain(lvl_pts, lvl_dig, bucket, W, B, order=order if first else None, base=base)
        want = np.concatenate([F.to_numpy_u32(lvl_pts[k]).reshape(-1) for k in ec.COORDS]
                              + [lvl_dig.numpy().astype(np.uint32)]
                              + [F.to_numpy_u32(bucket[k][: W * B]).reshape(-1) for k in ec.COORDS])
        assert np.array_equal(got, want.astype(np.int64)), f"level m={m}"
        first = False
        if m == 1:
            break


def degree17(E):
    """eq * p0 p1 ... p15: degree 17."""
    acc = E.eq_xy(0)
    for i in range(16):
        acc = acc * E.poly(i % 4)
    return acc


@pytest.mark.parametrize("t0,points", [(8, 8), (16, 1)])
def test_round_eval_pair_at_a_point_offset_matches_plain(harness, t0, points):
    """The one-pass evaluation of a launch from a point offset: the points
    t0 + 1 .. t0 + D of a degree-17 round (D = 8 from t0 = 8, D = 1 from
    t0 = 16, the chunks plan_round gives it), summed over the pairs, against
    round_message_plain at that offset and against its rows of the whole
    degree-17 message."""
    from halo2_lasso_tpu_torch.expression import Expression as E
    from halo2_lasso_tpu_torch.piop import sum_check as sc

    expr = degree17(E)
    assert expr.degree == 17 and sc.point_chunks(17) == ((0, 8), (8, 8), (16, 1))
    keys = sc._leaf_keys(expr, 4)
    prog = sc.lower_expression(expr, keys)
    rng = random.Random(t0)
    p = Fr.modulus
    h = 6
    tables = [Fr.encode([rng.randrange(p) for _ in range(2 * h)]) for _ in keys]
    tables[0][:4] = Fr.encode([0, p - 1, 1, Fr.R])
    ops, consts = prog.kernel_args(Fr)
    line = " ".join([f"r {points} {len(keys)} {len(ops)} {len(prog.consts)} {h} 0 {prog.max_stack} {t0}",
                     " ".join(rows(Fr.encode([t0])))] + [words(t) for t in tables]
                    + [" ".join(map(str, ops.tolist()))]
                    + [" ".join(map(str, consts[: len(prog.consts)].reshape(-1).tolist()))])
    want = sc.round_message_plain(Fr, tables, prog, None, points, t0)
    got = run(harness, [line]).reshape(-1, 8)
    assert np.array_equal(got, F.to_numpy_u32(want))
    whole = sc.round_message_plain(Fr, tables, prog, None, 17)
    assert np.array_equal(got, F.to_numpy_u32(whole[t0 : t0 + points]))


def test_field_id_tables_match_the_entry_points():
    """Each C entry point's table of field ids (``field_built(field,
    pasta)`` at its top, BN254's ids and with `pasta` the Pasta ones) is
    ops/native.py's FIELD_IDS for it, and ``native.field_id`` refuses, before
    any launch, an id outside it: no id reaches another field's kernel."""
    import re

    from halo2_lasso_tpu_torch.ops import native

    tables = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int h2l_(\w+)\(int field,[^{]*\{(.*?)\n}', text, re.S):
            built = re.search(r"field_built\(field, (true|false)\)", m.group(2))
            assert built, f"h2l_{m.group(1)} takes a field id it does not check"
            tables[m.group(1)] = native.ALL_IDS if built.group(1) == "true" else native.BN254_IDS
    assert tables == native.FIELD_IDS
    unknown = F.FieldSpec(name="unknown", modulus=Fr.modulus, kernel_id=4)
    for entry, ids in native.FIELD_IDS.items():
        for spec in (unknown, curves.Fp_pallas, curves.Fq_vesta, Fr, Fq):
            if spec.kernel_id in ids:
                assert native.field_id(entry, spec) == spec.kernel_id
            else:
                with pytest.raises(ValueError, match="no instance"):
                    native.field_id(entry, spec)
