"""Time the heaviest shapes of the round kernel, the MSM, the IPA ladders,
the fold and the Montgomery chains for two checkouts of the port on one card, in turns, so
that a change to any is compared with its parent in one run.

    python3 halo2_lasso_tpu_torch/scripts/compare_trees.py BASE [HEAD]

BASE and HEAD are the roots of two checkouts (HEAD defaults to the one that
holds this file). Run it as a file, not with ``-m``: each measurement is a
process of its own that imports the package from its root, in the order
base, head, head, base. Each process builds its tree's kernels and, on
inputs drawn from fixed seeds, measures

  - the round message at the nv = 16 Lasso-in-HyperPlonk zero check's first
    round (``rand_lasso_circuit`` with 32-bit AND and 16-bit range lookups:
    37 leaf tables of 2^16, degree 3): CUDA events per call over 20 calls,
    and the profiler's device time per call, in all (kernels and copies)
    and in ``round_kernel``;
  - one variable-base MSM of 2^16 points (``msm_jacobian.msm``): host wall
    time per call, and per call the profiler's device time in all, in the
    ``ec_add``, ``msm_level`` and ``plane_tree`` kernels (a tree without the
    plane tree shows 0 there, its bit-plane tree in ``ec_add``), and the
    device-to-host copies;
  - the IPA open's scalings at nv = 16 (``pcs/ipa.py``): the first round's
    b_r scaled by one shared 254-bit scalar (``ec.scalar_mul_bits`` over
    2^15 bases, every 9th the identity), and c_l h', c_r h' (a tree with
    ``ec.ec_ladder`` makes one 2-lane ladder with a scalar a lane, an older
    one two 1-lane ``scalar_mul_bits``, as its open does): CUDA events per
    call, host wall time (each call followed by a synchronize) and the
    profiler's device time per call, in all and in the ``ec_add`` and
    ``ec_ladder`` kernels, from a session that recorded every launch of
    the kernel the tree's ladder runs;
  - ``fold_all`` of 6 tables of 2^16 (the batch open's first fold) with the
    challenge as the tree's sumchecks pass it: CUDA events per call, the
    profiler's device time in all and in ``fold_all_kernel``, and the
    host-to-device copies per call;
  - ``batch_inv`` of 2^17 rows (Fr) and ``eq_xy`` at k = 16 with the point
    as the tree's callers pass it: CUDA events, host wall time (each call
    followed by a synchronize) and the profiler's device time per call, and
    the host-to-device copies;
  - a KZG open of a 2^16 polynomial (``MultilinearKzg.open``: the quotient
    chain and its 16 MSMs, SRS from ``RandomState(3)``) and one round of
    the coefficient prover (``sum_check.prove_coeff_products`` with one
    variable over 3 terms of 2^16, the batch open's shape): host wall time
    per call, the profiler's device time, and the device-to-host and
    host-to-device copies per call; the proof bytes and folded tables
    hashed.

Trees from the one whose ``eq_xy`` takes a ``device`` on take the fold's
challenge and the eq point as host ints; older trees take card tensors,
encoded on the host and copied over in each call, as their callers did.
The timing helpers are this file's tree's (``utils/bench.py``), whichever
tree is measured. Each process prints one JSON line, with SHA-256 hashes of
every output; the script fails unless they agree across the trees. It
needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HEAD_ROOT = os.path.dirname(os.path.dirname(HERE))
N = 1 << 16
REPS_K1, REPS_MSM, REPS_CHAIN, REPS_LADDER = 20, 3, 20, 3


def _bench():
    path = os.path.join(HEAD_ROOT, "halo2_lasso_tpu_torch", "utils", "bench.py")
    spec = importlib.util.spec_from_file_location("h2l_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    """The numbers of one tree (see the module's docstring)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor
    from halo2_lasso_tpu_torch.ops import ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import G1_GEN, Fq, Fr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    if not native.__file__.startswith(os.path.join(root, "")):
        raise SystemExit(f"imported {native.__file__}, not the package under {root}")
    bench = _bench()
    rng = np.random.RandomState(7)

    def rand_fr(n):
        limbs = rng.randint(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        limbs[:, 7] = rng.randint(0, Fr.modulus >> 224, size=n)  # below p
        return F.from_numpy_u32(limbs, "cuda")

    native.lib()
    out = {"root": root, "build_s": native.build_seconds}

    ci, _ = fixtures.rand_lasso_circuit(16, np.random.RandomState(16), np.random.RandomState(516),
                                        operand_bits=32, chunk_bits=8, range_bits=16)
    nz, expr = preprocessor.compose(ci)
    n_polys = ci.num_poly() + preprocessor.num_lasso_polys(ci) + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz
    keys = SC._leaf_keys(expr, n_polys)
    prog = SC.lower_expression(expr, keys)
    leaves = [rand_fr(N) for _ in keys]
    chal = rand_fr(3)

    def k1():
        return SC.round_message(Fr, leaves, prog, chal, expr.degree)

    out["k1_shape"] = f"{len(keys)} leaves of 2^16, degree {expr.degree}"
    out["k1_sha"] = hashlib.sha256(k1().cpu().numpy().tobytes()).hexdigest()
    out["k1_event_ms"] = bench.cuda_ms(k1, REPS_K1)
    dev = bench.device_ms(k1, REPS_K1, ["round_kernel"])
    out["k1_device_ms"], out["k1_round_kernel_ms"] = dev["all"], dev["round_kernel"]

    points = ec.fixed_base_msm(G1_GEN, rand_fr(N))
    scal = rand_fr(N)

    def msm():
        return MJ.msm(points, scal)

    out["msm_sha"] = hashlib.sha256(repr(MJ.host_batch_affine([msm()], Fq.modulus)).encode()).hexdigest()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS_MSM):
        msm()  # reads its result back, so each call ends synchronized
    out["msm_wall_ms"] = (time.perf_counter() - t0) * 1e3 / REPS_MSM
    dev = bench.device_ms(msm, REPS_MSM, ["ec_add_kernel", "msm_level_kernel", "plane_tree_kernel"])
    out.update(msm_device_ms=dev["all"], msm_ec_add_ms=dev["ec_add_kernel"],
               msm_level_ms=dev["msm_level_kernel"], msm_plane_tree_ms=dev["plane_tree_kernel"],
               msm_dtoh=dev["DtoH"])

    # the IPA open's scalings (see the module's docstring)
    one_launch = hasattr(ec, "ec_ladder")
    nbits = Fr.num_bits
    lpts = ec.fixed_base_msm(G1_GEN, rand_fr(N // 2))
    lpts["z"][::9] = 0
    k = Fr.decode_ints(rand_fr(1))[0]
    bits = [(k >> i) & 1 for i in range(nbits)]
    h = ec.fixed_base_msm(G1_GEN, rand_fr(1))
    h2 = {c: v.expand(2, 8).contiguous() for c, v in h.items()}
    c_lr = Fr.decode_ints(rand_fr(2))
    c_lr_limbs = F.from_numpy_u32(F.ints_to_u32(c_lr), "cuda")
    c_lr_bits = [[(x >> i) & 1 for i in range(nbits)] for x in c_lr]

    def ladder_c_lr():
        if one_launch:
            return ec.ec_ladder(h2, c_lr_limbs, nbits)
        return ec.cat_points(*(ec.scalar_mul_bits(h, b) for b in c_lr_bits))

    for name, fn, calls in (("ladder_b_r", lambda: ec.scalar_mul_bits(lpts, bits), 1),
                            ("ladder_c_lr", ladder_c_lr, 1 if one_launch else 2)):
        out[f"{name}_sha"] = digest(torch.cat(list(fn().values())))
        out[f"{name}_event_ms"] = bench.cuda_ms(fn, REPS_LADDER)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS_LADDER):
            fn()
            torch.cuda.synchronize()
        out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / REPS_LADDER
        expect = {"ec_ladder_kernel": calls} if one_launch else {"ec_add_kernel": 2 * nbits * calls}
        dev = bench.device_ms(fn, REPS_LADDER, ["ec_add_kernel", "ec_ladder_kernel"], expect=expect)
        out.update({f"{name}_device_ms": dev["all"], f"{name}_ec_add_ms": dev["ec_add_kernel"],
                    f"{name}_ec_ladder_ms": dev["ec_ladder_kernel"]})

    by_value = "device" in inspect.signature(mle.eq_xy).parameters
    tabs = [rand_fr(N) for _ in range(6)]
    r = Fr.decode_ints(rand_fr(1))[0]

    def fold():
        return mle.fold_all(Fr, tabs, r if by_value else Fr.encode([r], "cuda")[0])

    out["fold_sha"] = digest(torch.cat(fold()))
    out["fold_event_ms"] = bench.cuda_ms(fold, REPS_CHAIN)
    dev = bench.device_ms(fold, REPS_CHAIN, ["fold_all_kernel"])
    out.update(fold_device_ms=dev["all"], fold_kernel_ms=dev["fold_all_kernel"], fold_htod=dev["HtoD"])

    inv_in = rand_fr(1 << 17)
    y = Fr.decode_ints(rand_fr(16))
    for name, fn in (
        ("batch_inv", lambda: F.batch_inv(Fr, inv_in)),
        ("eq_xy", lambda: mle.eq_xy(Fr, y, "cuda") if by_value else mle.eq_xy(Fr, Fr.encode(y, "cuda"))),
    ):
        out[f"{name}_sha"] = digest(fn())
        out[f"{name}_event_ms"] = bench.cuda_ms(fn, REPS_CHAIN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS_CHAIN):
            fn()
            torch.cuda.synchronize()
        out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / REPS_CHAIN
        dev = bench.device_ms(fn, REPS_CHAIN)
        out.update({f"{name}_device_ms": dev["all"], f"{name}_htod": dev["HtoD"]})

    from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS
    from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
    from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

    def transcript():
        return Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, curve_b=3)

    pp, _ = MultilinearKzg.trim(MultilinearKzg.setup(N, np.random.RandomState(3), device="cuda"), N)
    poly, point = rand_fr(N), Fr.decode_ints(rand_fr(16))
    terms = [(Fr.decode_ints(rand_fr(1))[0], mle.eq_xy(Fr, Fr.decode_ints(rand_fr(16)), "cuda") if by_value
              else mle.eq_xy(Fr, rand_fr(16)), rand_fr(N)) for _ in range(3)]

    def kzg_open():
        t = transcript()
        MultilinearKzg.open(pp, poly, point, None, t)
        return t.into_proof()

    def coeff_round():
        t = transcript()
        _, tables = SC.prove_coeff_products(Fr, 1, terms, 0, t)
        return t.into_proof() + b"".join(x.cpu().numpy().tobytes() for x in tables)

    for name, fn in (("kzg_open", kzg_open), ("coeff_round", coeff_round)):
        out[f"{name}_sha"] = hashlib.sha256(fn()).hexdigest()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS_MSM):
            fn()  # reads its result back, so each call ends synchronized
        out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / REPS_MSM
        dev = bench.device_ms(fn, REPS_MSM)
        out.update({f"{name}_device_ms": dev["all"], f"{name}_dtoh": dev["DtoH"], f"{name}_htod": dev["HtoD"]})
    return out


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(argv[1]))), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    base = os.path.abspath(argv[0])
    head = os.path.abspath(argv[1]) if len(argv) > 1 else HEAD_ROOT
    recs = []
    for tree, root in (("base", base), ("head", head), ("head", head), ("base", base)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=900, check=False)
        if proc.returncode != 0:
            raise SystemExit(f"the {tree} tree failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        rec = {"tree": tree, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    for key in ("k1_sha", "msm_sha", "ladder_b_r_sha", "ladder_c_lr_sha", "fold_sha", "batch_inv_sha", "eq_xy_sha",
                "kzg_open_sha", "coeff_round_sha"):
        if len({r[key] for r in recs}) != 1:
            raise SystemExit(f"the trees disagree on {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
