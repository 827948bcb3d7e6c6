"""The device arithmetic of the CUDA kernels, compiled for the host.

csrc/field.cuh and csrc/ec.cuh build with g++ under FIELD_HOST_TEST, so the
Montgomery product, add, sub, neg and the complete EC add that the kernels
run can be held against the plain PyTorch versions on the CPU, bit for bit,
without a GPU, and so is the fold of csrc/fix_var.cu. (The kernels' launch and reduction code runs only on the
card: tests/test_torch_kernels.py.)
"""

import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from halo2_lasso_tpu_torch.ops import ec
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
#include "fix_var.cu"
#include <vector>
static Fe rd() {
  Fe r;
  for (int i = 0; i < 8; ++i) if (scanf("%u", &r.v[i]) != 1) exit(1);
  return r;
}
static void wr(const Fe& a) { for (int i = 0; i < 8; ++i) printf("%u ", a.v[i]); }
int main() {
  char op[8];
  while (scanf("%7s", op) == 1) {
    if (op[0] == 'v') {  // v <n> <step>: a table of n, then x; one fold per line
      long long n, step;
      if (scanf("%lld %lld", &n, &step) != 2) exit(1);
      std::vector<Fe> t(n);
      for (auto& e : t) e = rd();
      Fe x = rd();
      const uint32_t* lo = t[0].v;
      const uint32_t* hi = step == 2 ? t[1].v : t[n / 2].v;
      for (long long i = 0; i < n / 2; ++i) {
        wr(fix_var_elem(lo, hi, step, i, x));
        if (i + 1 < n / 2) printf("\n");
      }
    } else if (op[0] == 'e') {
      Fe x1 = rd(), y1 = rd(), z1 = rd(), x2 = rd(), y2 = rd(), z2 = rd(), ox, oy, oz;
      ec_add_lane(x1, y1, z1, x2, y2, z2, ox, oy, oz);
      wr(ox); wr(oy); wr(oz);
    } else {
      bool q = op[1] == '1';
      Fe a = rd(), b = rd(), r;
      switch (op[0]) {
        case 'm': r = q ? fe_mul<Fq>(a, b) : fe_mul<Fr>(a, b); break;
        case 'a': r = q ? fe_add<Fq>(a, b) : fe_add<Fr>(a, b); break;
        case 's': r = q ? fe_sub<Fq>(a, b) : fe_sub<Fr>(a, b); break;
        default: r = q ? fe_neg<Fq>(a) : fe_neg<Fr>(a);
      }
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
    subprocess.run([gxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(d / "h"), str(d / "h.cpp")],
                   check=True, capture_output=True, timeout=120)
    return d / "h"


def run(harness, lines):
    out = subprocess.run([str(harness)], input="\n".join(lines) + "\n", capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()
    return np.array([[int(v) for v in line.split()] for line in out], dtype=np.uint64).astype(np.uint32)


def rows(t):
    return [" ".join(map(str, r)) for r in F.to_numpy_u32(t).reshape(t.shape[0], -1).tolist()]


@pytest.mark.parametrize("spec", [Fr, Fq], ids=["fr", "fq"])
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
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    rng = random.Random(5)
    p = Fr.modulus
    vals = [0, 1, p - 1, Fr.R, p - 1, 0] + [rng.randrange(p) for _ in range(58)]
    t, x = Fr.encode(vals), Fr.encode([rng.randrange(p)])
    line = f"v {t.shape[0]} {1 if last else 2} " + " ".join(rows(t) + rows(x))
    want = mle.fix_var_plain(Fr, t, x[0], last)
    assert np.array_equal(run(harness, [line]), F.to_numpy_u32(want))
