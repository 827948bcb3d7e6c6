#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall time:
  1. environment: torch / CUDA versions, the card, its power limit;
  2. build: the one nvcc call that compiles every kernel (csrc/*.cu);
  3. kernels: mont_mul, fold_all, sumcheck_round, ec_add and fix_var against
     their plain PyTorch versions on the card, bit for bit, then timed;
  4. small proof: a Lasso range proof (range_table(8, 4), 16 lookups, SRS
     seed 3) on the card and through the plain path on the CPU; both must
     hash to SMALL_PROOF_SHA256, the hash of the JAX package's proof
     (tests/test_torch_lasso.py holds the two packages to it);
  5. the slice: 2^16 lookups into range_table(16, 16), SRS setup, prove and
     verify on the card with per-stage times; a proof with one flipped byte
     must be rejected;
  6. small HyperPlonk proof: rand_vanilla_plonk_circuit at nv = 3 (seeds 42,
     43, setup seed 0) on the card and through the plain path on the CPU;
     both must equal the JAX package's golden proof (GOLDEN_SHA256,
     tests/test_golden_proof.py);
  7. HyperPlonk at full size: rand_vanilla_plonk_with_lookup_circuit at
     nv = 16, setup, preprocess, prove and verify on the card with per-stage
     times and the kernel launches of the prove alone; a proof with one
     flipped byte must be rejected; then one more prove under torch.profiler
     for the card's busy share;
  8. two-operand Lasso: 2^16 lookups into and_table(32, 8) (operands from
     RandomState(1), SRS seed 3), setup, prove and verify with per-stage
     times; a proof with one flipped byte must be rejected;
  9. Lasso inside HyperPlonk: rand_lasso_circuit at nv = 3 (seeds 3, 503,
     setup seed 0) on the card and through the plain path on the CPU, both
     hashing to LASSO_PLONK_SHA256, the JAX package's proof
     (tests/test_torch_lasso_hyperplonk.py holds the two packages to it);
     then at nv = 16 with 32-bit AND in 8-bit chunks and a 16-bit range
     (seeds 16, 516, setup seed 0): setup, preprocess, prove and verify with
     per-stage times, the prove's launches, tamper, one profiled prove;
 10. the layout microbench (halo2_lasso_tpu_torch/scripts/layout_bench.py):
     K4, K6 and K7 bit-exact against each other and the plain version at
     2^16, 2^20 and 2^22, and timed.
Kernel launch counts are reset just before each main path (phases 5, 7, 8,
the nv = 16 part of 9, and 10) and read just after it; each path must
launch every kernel it names in PATH_KERNELS.

The last lines are a JSON object with every kernel's numbers, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Any failure exits non-zero; a watchdog turns a hang into a traceback and a
non-zero exit. Without a CUDA device, or without the package beside it, the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import subprocess
import sys
import time

WATCHDOG_S = 1000  # below the smoke's 1200 s limit, with a margin
SMALL_PROOF_SHA256 = "efdcdbf4dea8fa963635aa51725015c5674d43549b67e0e11f91054ed81db806"
SMALL = {"index_bits": 8, "chunk_bits": 4, "lookups": 16, "srs_seed": 3, "index_seed": 77}
SLICE = {"index_bits": 16, "chunk_bits": 16, "lookups": 1 << 16, "srs_seed": 3, "index_seed": 1}
GOLDEN_SHA256 = "c7716e87345611deed36d015513aecec8da288a8433e74610cf420cf687be3c0"
PLONK_SMALL = {"circuit": "rand_vanilla_plonk_circuit", "num_vars": 3, "seeds": (42, 43), "setup_seed": 0}
PLONK = {"circuit": "rand_vanilla_plonk_with_lookup_circuit", "num_vars": 16, "seeds": (42, 43), "setup_seed": 0}
AND_SLICE = {"table": ("and_table", 32, 8), "lookups": 1 << 16, "srs_seed": 3, "index_seed": 1}
LASSO_PLONK_SHA256 = "ef5584e41f26c9e55e0c31a125efbcd7757c2f8a6ff56c47aa115283bfda0292"
LASSO_PLONK_SMALL = {"circuit": "rand_lasso_circuit", "num_vars": 3, "seeds": (3, 503), "setup_seed": 0}
LASSO_PLONK = {
    "circuit": "rand_lasso_circuit", "num_vars": 16, "seeds": (16, 516), "setup_seed": 0,
    "kwargs": {"operand_bits": 32, "chunk_bits": 8, "range_bits": 16},
}
PROOF_KERNELS = ("mont_mul", "fold_all", "sumcheck_round", "ec_add", "fix_var")
PATH_KERNELS = {
    "lasso": PROOF_KERNELS,
    "hyperplonk": PROOF_KERNELS,
    "lasso_and": PROOF_KERNELS,
    "lasso_hyperplonk": PROOF_KERNELS,
    "layout": ("mont_mul", "mont_mul_limbs_first", "mont_mul_tiled"),
}


def stage(name, t0, msg=""):
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {msg}".rstrip(), flush=True)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from halo2_lasso_tpu_torch.ops import native

    # 1. environment
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    stage("env", t0, f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} | {smi}")

    # 2. build
    t0 = time.perf_counter()
    native.lib()
    stage("build", t0, f"nvcc {native.build_seconds:.1f}s" if native.build_seconds else "cached")

    # 3. kernels
    t0 = time.perf_counter()
    kernels = check_kernels(torch, np, dev)
    stage("kernels", t0, "bit-exact: " + ", ".join(k["name"] for k in kernels))
    print("kernels " + " ".join(f"{k['name']}={k['ms']:.4f}ms(plain {k['plain_ms']:.3f}ms)" for k in kernels), flush=True)
    fix_var = next(k for k in kernels if k["name"] == "fix_var")
    print(f"fix_var vs fold_all on one table: {fix_var['k2_one_table_ms']:.4f}ms", flush=True)

    # 4. small proof against the JAX package's bytes
    proof_gate(np, lasso_proof, SMALL, SMALL_PROOF_SHA256, "small_proof", "range_table(8,4), 16 lookups")

    # 5. the Lasso slice
    launches = {}
    run_path(launches, "lasso", "slice", "2^16 lookups range_table(16,16)",
             lambda: lasso_proof(np, SLICE, "cuda", tamper=True))

    # 6. small HyperPlonk proof against the JAX package's golden bytes
    proof_gate(np, hyperplonk_proof, PLONK_SMALL, GOLDEN_SHA256, "plonk_small", "nv=3 vanilla")

    # 7. HyperPlonk at full size
    run_hyperplonk_path(torch, np, launches, "hyperplonk", "plonk", "nv=16 vanilla plonk with lookup", PLONK)

    # 8. two-operand Lasso at 2^16
    run_path(launches, "lasso_and", "lasso_and", "2^16 lookups and_table(32,8)",
             lambda: lasso_proof(np, AND_SLICE, "cuda", tamper=True))

    # 9. Lasso inside HyperPlonk: the small proof against the JAX package's
    # bytes, then the full-size circuit
    proof_gate(np, hyperplonk_proof, LASSO_PLONK_SMALL, LASSO_PLONK_SHA256, "lasso_plonk_small", "nv=3 Lasso lookups")
    run_hyperplonk_path(torch, np, launches, "lasso_hyperplonk", "lasso_plonk",
                        "nv=16 32-bit AND + 16-bit range Lasso lookups", LASSO_PLONK)

    # 10. the layout microbench
    from halo2_lasso_tpu_torch.scripts import layout_bench

    t0 = time.perf_counter()
    native.reset_counts()
    layouts = layout_bench.run()
    launches["layout"] = dict(native.counts)
    stage("layout", t0, "K4, K6, K7 and plain bit-exact at " + ", ".join(f"2^{r['n'].bit_length() - 1}" for r in layouts))
    for r in layouts:
        print("  " + json.dumps(r), flush=True)

    for path, counts in launches.items():
        missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
        if missing:
            raise SystemExit(f"the {path} path did not launch: {missing}")
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in launches.items()}
        k["launches"] = sum(k["launches_by_path"].values())

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def proof_gate(np, prove_fn, cfg, want_sha, name, label):
    """A small proof on the card and through the plain path on the CPU must
    both hash to `want_sha`, the SHA-256 of the JAX package's proof."""
    t0 = time.perf_counter()
    gpu_proof = prove_fn(np, cfg, "cuda")[0]
    cpu_proof = prove_fn(np, cfg, "cpu")[0]
    sha = hashlib.sha256(gpu_proof).hexdigest()
    if sha != want_sha or cpu_proof != gpu_proof:
        raise SystemExit(f"{name} proof mismatch: gpu {sha}, cpu {hashlib.sha256(cpu_proof).hexdigest()}")
    stage(name, t0, f"{label}: {len(gpu_proof)} bytes sha256 {sha[:16]} == JAX, == CPU plain path")


def run_path(launches, path, name, label, run):
    """One main path: launch counts reset just before `run` (which returns
    the proof and its stage records) and kept in `launches[path]` just after."""
    from halo2_lasso_tpu_torch.ops import native

    t0 = time.perf_counter()
    native.reset_counts()
    proof, records = run()
    launches[path] = dict(native.counts)
    stage(name, t0, f"{label}: {len(proof)} bytes, verified, tamper rejected")
    print_stages(records)


def run_hyperplonk_path(torch, np, launches, path, name, label, cfg):
    """A full-size HyperPlonk main path, then the prove's own launches and a
    second, profiled prove."""
    extra = {}
    run_path(launches, path, name, label, lambda: hyperplonk_proof(np, cfg, "cuda", tamper=True, extra=extra))
    print("  launches in prove: " + json.dumps(extra["prove_launches"]), flush=True)
    print("  second prove under torch.profiler: " + profile_prove(torch, extra["pp"], extra["circuit"]), flush=True)


def profile_prove(torch, pp, circuit):
    """Wall time of one more prove and the device's busy time in it, from
    torch.profiler's kernel times; "not measured" if the profiler gives no
    device time on this machine."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            HyperPlonk.prove(pp, circuit, new_transcript())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side rows only (kernels, copies, memsets): one stream, so
        # their sum is the time the card was busy
        dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    except Exception as exc:  # the profiler is untried on that machine
        return f"not measured ({type(exc).__name__}: {exc})"
    if busy_ms <= 0:
        return f"wall {wall_ms:.1f}ms, device time not measured (profiler gave none)"
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    tops = "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.1f}ms" for e in top)
    return f"wall {wall_ms:.1f}ms, device busy {busy_ms:.1f}ms ({100 * busy_ms / wall_ms:.1f}%); top: {tops}"


def print_stages(records):
    for name, ms in records:
        print(f"  stage {name}: {ms:.1f}ms", flush=True)


def rejects_flipped_byte(verify_fn, proof):
    """A proof with one flipped byte in its middle must fail to verify."""
    from halo2_lasso_tpu_torch.errors import Halo2LassoError

    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 0x01
    try:
        verify_fn(bytes(bad))
    except Halo2LassoError:
        return
    raise SystemExit("a proof with a flipped byte was accepted")


def hyperplonk_proof(np, cfg, device, tamper=False, extra=None):
    """Setup, preprocess, prove and verify one HyperPlonk proof of a fixture
    circuit; returns (proof bytes, stage records). `extra`, a dict, receives
    the prover's kernel launches and what a second prove needs."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, fixtures, new_transcript
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.utils.timer import timed

    timed.clear()
    with timed.scope("fixture"):
        ci, circuit = getattr(fixtures, cfg["circuit"])(
            cfg["num_vars"], *(np.random.RandomState(s) for s in cfg["seeds"]), **cfg.get("kwargs", {})
        )
    with timed.scope("setup"):
        param = HyperPlonk.setup(ci, np.random.RandomState(cfg["setup_seed"]), device=device)
    pp, vp = HyperPlonk.preprocess(param, ci)
    tw = new_transcript()
    before = dict(native.counts)
    HyperPlonk.prove(pp, circuit, tw)
    if extra is not None:
        extra.update(pp=pp, circuit=circuit, prove_launches={k: native.counts[k] - before[k] for k in before})
    proof = tw.into_proof()
    HyperPlonk.verify(vp, circuit.instances(), new_transcript(proof))
    if tamper:
        rejects_flipped_byte(lambda bad: HyperPlonk.verify(vp, circuit.instances(), new_transcript(bad)), proof)
    return proof, timed.records()


def lasso_indices(np, cfg):
    """The lookup indices of a standalone Lasso config: uniform below
    2^index_bits, or for a two-operand table (x << bits) | y with the x
    operands drawn first, then the y operands."""
    rng = np.random.RandomState(cfg["index_seed"])
    m = cfg["lookups"]
    if "table" not in cfg:
        return [int(rng.randint(1 << cfg["index_bits"])) for _ in range(m)]
    bits = cfg["table"][1]
    x, y = (rng.randint(0, 1 << bits, size=m, dtype=np.int64) for _ in range(2))
    return [(int(a) << bits) | int(b) for a, b in zip(x, y)]


def lasso_table(cfg):
    from halo2_lasso_tpu_torch.lasso import tables

    if "table" in cfg:
        name, *args = cfg["table"]
        return getattr(tables, name)(*args)
    return tables.range_table(cfg["index_bits"], cfg["chunk_bits"])


def lasso_proof(np, cfg, device, tamper=False):
    """Setup, prove and verify one standalone Lasso proof; returns (proof
    bytes, stage records). With `tamper`, a proof with one flipped byte
    must fail."""
    from halo2_lasso_tpu_torch.lasso import prove, verify
    from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
    from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
    from halo2_lasso_tpu_torch.transcript import Keccak256Transcript
    from halo2_lasso_tpu_torch.utils.timer import timed

    def transcript(proof=None):
        return Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)

    table = lasso_table(cfg)
    nv_m = cfg["lookups"].bit_length() - 1
    nv = max(nv_m, table.memories[0].subtable.index_bits)
    indices = lasso_indices(np, cfg)
    timed.clear()
    with timed.scope("lasso_setup"):
        param = MultilinearKzg.setup(1 << nv, np.random.RandomState(cfg["srs_seed"]), device=device)
        pp, vp = MultilinearKzg.trim(param, 1 << nv)
    tw = transcript()
    prove(pp, table, indices, tw, device=device)
    proof = tw.into_proof()
    verify(vp, table, nv_m, transcript(proof))
    if tamper:
        rejects_flipped_byte(lambda bad: verify(vp, table, nv_m, transcript(bad)), proof)
    return proof, timed.records()


def check_kernels(torch, np, dev):
    """Each kernel against its plain version on the same card inputs."""
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.lasso.tables import range_table
    from halo2_lasso_tpu_torch.ops import ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle
    from halo2_lasso_tpu_torch.scripts import layout_bench as LB
    from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, bound_ms, cuda_ms

    rng = np.random.RandomState(2024)

    def rand_field(spec, n, edges=()):
        limbs = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        limbs[:, 7] = rng.randint(0, spec.modulus >> 224, size=n)  # below p
        t = F.from_numpy_u32(limbs, dev)
        if edges:
            t[: len(edges)] = F.from_numpy_u32(F.ints_to_u32(edges), dev)
        return t

    def same(name, kernel_fn, plain_fn):
        """Bit-exact check; returns the largest limb difference (0)."""
        flat_k = torch.cat([t.reshape(-1) for t in kernel_fn()])
        flat_p = torch.cat([t.reshape(-1) for t in plain_fn()])
        if not torch.equal(flat_k, flat_p):
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        return int(((flat_k.long() & 0xFFFFFFFF) - (flat_p.long() & 0xFFFFFFFF)).abs().max())

    results = {}

    def record(name, src, replaces, kernel_fn, plain_fn, bytes_moved, imads, err):
        """Check and time one kernel at a shape of the main path."""
        err = max(err, same(name, kernel_fn, plain_fn))
        b_ms, b_by = bound_ms(bytes_moved, imads)
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": 0, "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, 20), "plain_ms": cuda_ms(plain_fn, 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }

    # K4 mont_mul, Fr and Fq, 2^16 elements (the witness encodes) with
    # 0, 1, p-1, R mod p among the inputs
    n = 1 << 16
    err = 0
    for spec in (Fq, Fr):
        p = spec.modulus
        a = rand_field(spec, n, [0, 1, p - 1, spec.R])
        b = rand_field(spec, n, [p - 1, spec.R, p - 1, 1])
        kernel_fn, plain_fn = (lambda: [F.mont_mul(spec, a, b)]), (lambda: [F.mont_mul_plain(spec, a, b)])
        err = max(err, same("mont_mul", kernel_fn, plain_fn))
    record("mont_mul", "halo2_lasso_tpu_torch/csrc/mont_mul.cu", "halo2_lasso_tpu/ops/pallas_field.py:225",
           kernel_fn, plain_fn, 96 * n, n * IMAD_PER_MONT_MUL, err)

    # K2 fold_all: 8 tables of 2^14; timed at the batch open's first fold
    # (3 eq tables + 3 polys of 2^16)
    x = rand_field(Fr, 1)[0]
    tabs = [rand_field(Fr, 1 << 14) for _ in range(8)]
    err = same("fold_all", lambda: mle.fold_all(Fr, tabs, x), lambda: mle.fold_all_plain(Fr, tabs, x))
    tabs = [rand_field(Fr, n) for _ in range(6)]
    record("fold_all", "halo2_lasso_tpu_torch/csrc/fold.cu", "halo2_lasso_tpu/ops/pallas_field.py:293",
           lambda: mle.fold_all(Fr, tabs, x), lambda: mle.fold_all_plain(Fr, tabs, x),
           6 * n * 48, 6 * (n // 2) * IMAD_PER_MONT_MUL, err)

    # K1 round message: the Lasso primary expression and a GKR degree-3
    # layer at 2^14; timed at the primary sumcheck's first round (2^16)
    err = 0
    for expr, n_polys, size in (
        (gkr.sum_check_expression_pure(2), 4, 1 << 14),
        (Expression.eq_xy(0) * range_table(16, 16).g, 1, 1 << 14),
        (Expression.eq_xy(0) * range_table(16, 16).g, 1, n),
    ):
        keys = SC._leaf_keys(expr, n_polys)
        prog = SC.lower_expression(expr, keys)
        leaves = [rand_field(Fr, size) for _ in keys]
        chal = rand_field(Fr, 1) if expr.used_challenge else None
        kernel_fn = lambda: [SC.round_message(Fr, leaves, prog, chal, expr.degree)]  # noqa: E731
        plain_fn = lambda: [SC.round_message_plain(Fr, leaves, prog, chal, expr.degree)]  # noqa: E731
        err = max(err, same("sumcheck_round", kernel_fn, plain_fn))
    muls = sum(op in (SC.OP_MUL, SC.OP_SCALED) for op, _ in prog.ops)
    record("sumcheck_round", "halo2_lasso_tpu_torch/csrc/sumcheck_round.cu",
           "halo2_lasso_tpu/ops/pallas_field.py:376", kernel_fn, plain_fn,
           len(leaves) * n * 32, expr.degree * muls * (n // 2) * IMAD_PER_MONT_MUL, err)

    # K3 ec_add: 2^12 lanes over the five cases (generic, P = Q, P = -Q,
    # P = O, Q = O), also against host arithmetic; timed at the first level
    # of a 2^16-point MSM (26 windows x 2^15 pairs + 26 x 2^10 buckets)
    pts_p, pts_q = ec_cases(np, rng, MJ, Fq.modulus, 1 << 12)
    P = {k: Fq.encode([pt[i] for pt in pts_p], dev) for i, k in enumerate(ec.COORDS)}
    Q = {k: Fq.encode([pt[i] for pt in pts_q], dev) for i, k in enumerate(ec.COORDS)}
    err = same("ec_add", lambda: list(ec.ec_add(P, Q).values()), lambda: list(ec.ec_add_plain(P, Q).values()))
    want = MJ.host_batch_affine([MJ.host_jac_add(a, b, Fq.modulus) for a, b in zip(pts_p, pts_q)], Fq.modulus)
    if ec.jacobian_to_affine(ec.ec_add(P, Q)) != want:
        raise SystemExit("ec_add disagrees with host arithmetic")
    c = MJ.best_c(n)
    windows = -(-Fr.num_bits // c)
    lanes = windows * (n // 2 + (1 << c))
    reps = -(-lanes // (1 << 12))
    P = {k: v.repeat(reps, 1)[:lanes] for k, v in P.items()}
    Q = {k: v.repeat(reps, 1)[:lanes] for k, v in Q.items()}
    record("ec_add", "halo2_lasso_tpu_torch/csrc/ec_add.cu", "halo2_lasso_tpu/ops/pallas_ec.py:144",
           lambda: list(ec.ec_add(P, Q).values()), lambda: list(ec.ec_add_plain(P, Q).values()),
           lanes * 9 * 32, lanes * 23 * IMAD_PER_MONT_MUL, err)

    # K5 fix_var: a table of 2^16 with 0, 1, p-1, R mod p among its entries
    # and the challenge, both pair strides, and a ragged half-length; timed
    # at the first fold of a KZG open at nv = 16 (fix_last_var on 2^16),
    # beside fold_all (K2) called with that one table, which it replaces
    p = Fr.modulus
    err = 0
    for size in (n, 2 * 1037):
        tab = rand_field(Fr, size, [0, 1, p - 1, Fr.R, p - 1, 0, 1, p - 1])
        for xv in ([0], [1], [p - 1], [Fr.R], []):
            x = rand_field(Fr, 1, xv)[0]
            for last in (False, True):
                fold = mle.fix_last_var if last else mle.fix_var
                err = max(err, same("fix_var", lambda: [fold(Fr, tab, x)],
                                    lambda: [mle.fix_var_plain(Fr, tab, x, last)]))
    tab = rand_field(Fr, n)
    record("fix_var", "halo2_lasso_tpu_torch/csrc/fix_var.cu", "halo2_lasso_tpu/ops/pallas_field.py:250",
           lambda: [mle.fix_last_var(Fr, tab, x)], lambda: [mle.fix_var_plain(Fr, tab, x, True)],
           n * 32 + (n // 2) * 32, (n // 2) * IMAD_PER_MONT_MUL, err)
    results["fix_var"]["k2_one_table_ms"] = cuda_ms(lambda: mle.fold_all(Fr, [tab], x, last=True), 20)

    # K1 on the HyperPlonk zero check: the composed expression of the
    # nv = 16 with-lookup circuit (23 leaf tables, degree 5) at 2^14
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor

    ci = fixtures.vanilla_plonk_with_lookup_circuit_info(16, 16, [[0]] * 9, [[(10, 1), (11, 1), (12, 1)]])
    nz, expr = preprocessor.compose(ci)
    keys = SC._leaf_keys(expr, ci.num_poly() + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz)
    prog = SC.lower_expression(expr, keys)
    leaves = [rand_field(Fr, 1 << 14) for _ in keys]
    chal = rand_field(Fr, 3)
    same("sumcheck_round", lambda: [SC.round_message(Fr, leaves, prog, chal, expr.degree)],
         lambda: [SC.round_message_plain(Fr, leaves, prog, chal, expr.degree)])

    # K1 on the Lasso-in-HyperPlonk zero check: the composed expression of
    # the nv = 16 circuit of phase 9 (5 witness + 26 Lasso polys) at 2^14
    ci, _ = fixtures.rand_lasso_circuit(16, np.random.RandomState(16), np.random.RandomState(516),
                                        **LASSO_PLONK["kwargs"])
    nz, expr = preprocessor.compose(ci)
    n_polys = ci.num_poly() + preprocessor.num_lasso_polys(ci) + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz
    keys = SC._leaf_keys(expr, n_polys)
    prog = SC.lower_expression(expr, keys)
    leaves = [rand_field(Fr, 1 << 14) for _ in keys]
    chal = rand_field(Fr, 3)
    same("sumcheck_round", lambda: [SC.round_message(Fr, leaves, prog, chal, expr.degree)],
         lambda: [SC.round_message_plain(Fr, leaves, prog, chal, expr.degree)])
    print(f"K1 on the Lasso-in-HyperPlonk zero check: {len(keys)} leaves, degree {expr.degree}, "
          f"stack {prog.max_stack}, bit-exact at 2^14", flush=True)

    # K6 / K7 (the layout microbench's limbs-first and tiled products): at
    # 2^16 with 0, 1, p-1, R mod p among the inputs, at ragged lengths (a
    # partial tile for K7), against the plain version and K4; timed at 2^22
    ea, eb = LB.edge_values()
    errs = {"mont_mul_limbs_first": 0, "mont_mul_tiled": 0}
    for size in (n, 1037, 9 * 128):
        a, b = rand_field(Fr, size, ea), rand_field(Fr, size, eb)
        a_lf, b_lf = a.T.contiguous(), b.T.contiguous()
        want = F.mont_mul(Fr, a, b).T
        k6 = same("mont_mul_limbs_first", lambda: [LB.mont_mul_limbs_first(a_lf, b_lf)],
                  lambda: [LB.mont_mul_limbs_first_plain(a_lf, b_lf)])
        if not torch.equal(LB.mont_mul_limbs_first(a_lf, b_lf), want):
            raise SystemExit("kernel mont_mul_limbs_first disagrees with mont_mul")
        errs["mont_mul_limbs_first"] = max(errs["mont_mul_limbs_first"], k6)
        if size % LB.LANES == 0:
            a_t, b_t = a_lf.view(8, -1, LB.LANES), b_lf.view(8, -1, LB.LANES)
            k7 = same("mont_mul_tiled", lambda: [LB.mont_mul_tiled(a_t, b_t)], lambda: [LB.mont_mul_tiled_plain(a_t, b_t)])
            if not torch.equal(LB.mont_mul_tiled(a_t, b_t).reshape(8, -1), want):
                raise SystemExit("kernel mont_mul_tiled disagrees with mont_mul")
            errs["mont_mul_tiled"] = max(errs["mont_mul_tiled"], k7)
    big = 1 << 22
    a_lf, b_lf = rand_field(Fr, big).T.contiguous(), rand_field(Fr, big).T.contiguous()
    a_t, b_t = a_lf.view(8, -1, LB.LANES), b_lf.view(8, -1, LB.LANES)
    record("mont_mul_limbs_first", "halo2_lasso_tpu_torch/csrc/mont_mul_layouts.cu",
           "scripts/tpu_layout_bench.py:88", lambda: [LB.mont_mul_limbs_first(a_lf, b_lf)],
           lambda: [LB.mont_mul_limbs_first_plain(a_lf, b_lf)], 96 * big, big * IMAD_PER_MONT_MUL,
           errs["mont_mul_limbs_first"])
    record("mont_mul_tiled", "halo2_lasso_tpu_torch/csrc/mont_mul_layouts.cu",
           "scripts/tpu_layout_bench.py:108", lambda: [LB.mont_mul_tiled(a_t, b_t)],
           lambda: [LB.mont_mul_tiled_plain(a_t, b_t)], 96 * big, big * IMAD_PER_MONT_MUL,
           errs["mont_mul_tiled"])
    return [results[k] for k in native.KERNELS]


def ec_cases(np, rng, MJ, mod, n):
    """Jacobian lane pairs over the five cases of the complete add."""
    def mul(k):
        acc, base = (0, 0, 0), (1, 2, 1)
        while k:
            if k & 1:
                acc = MJ.host_jac_add(acc, base, mod)
            base = MJ.host_jac_double(base, mod)
            k >>= 1
        return acc

    def rescale(pt, lam):
        return (pt[0] * lam * lam % mod, pt[1] * lam ** 3 % mod, pt[2] * lam % mod)

    base = [mul(int(rng.randint(1, 1 << 62))) for _ in range(64)]
    ident = (1, 1, 0)
    ps, qs = [], []
    for i in range(n):
        a = rescale(base[i % 64], int(rng.randint(1, 1 << 62)))
        b = rescale(base[(i * 7 + 3) % 64], int(rng.randint(1, 1 << 62)))
        case = i % 5
        if case == 1:
            b = rescale(a, 3)
        elif case == 2:
            b = (a[0], (-a[1]) % mod, a[2])
        elif case == 3:
            a = ident
        elif case == 4:
            b = ident
        ps.append(a)
        qs.append(b)
    return ps, qs


if __name__ == "__main__":
    sys.exit(main())
