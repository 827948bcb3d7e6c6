#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall time:
  1. environment: torch / CUDA versions, the card, its power limit;
  2. build: one nvcc -c job a kernel source (csrc/*.cu), all started
     together, and one link, its seconds, and the registers, shared memory
     and spills of each kernel (each field instance apart);
  3. kernels: every kernel against its plain PyTorch version on the card,
     bit for bit, then timed at a shape of a main path: K4's elementwise
     kernel (every op code at Fr and Fq, n = 1, 257, 1037, 2^16, full,
     strided, broadcast and by-value operands; timed at 2^16 for mul,
     mul_add, add, sub and neg), its row sum sum_reduce (n = 1, 257,
     2^15 + 3, batched over 2 x 6 columns and the coefficient prover's
     transposed view; timed at 2^16 and at that view), K5's fix_var chain
     (k = 0, 1, 5, 12, 13, 16, both directions, with and without quotients,
     Fr and Fq, and k = 19 in Fr; timed at k = 16 and k = 19 as a KZG
     open's quotient chain and as an evaluation), each of them one launch with no host sync; sumcheck_round at
     the Lasso-in-HyperPlonk zero check's first round (37 leaves, degree 3,
     2^16) and the Lasso primary sumcheck's, and at the ARX chain's zero
     check (48 leaves, 2^19) and its largest GKR layer (73 leaves, 2^18),
     msm_level over every level of a 2^16 MSM (17 launches and one
     plane_tree launch, no host sync, no ec_add; the profiler's device time)
     and of a 2^19 MSM (the ARX chain's commits),
     ec_add at the IPA open's first fold add (2^15 lanes) and over
     878,592 lanes of the five cases; the scalar ladder ec_ladder at the
     IPA open's first scaling (2^15 lanes, a shared scalar) and the 2-lane
     per-lane ladder, one launch each and none of ec_add, scalar_mul_bits
     included; the plane tree plane_tree over the buckets of the 2^16 and
     2^19 MSMs and of a Hyrax row MSM (256 points, c = 4, W = 64); the
     device times of msm_level, ec_ladder and plane_tree in one fresh
     process after phase 17 (with phases 16's and 17's), which fails unless
     the profiler records every launch, the phase's timed lines printed
     then; fold_all (1, 37, 64, 65 tables, the
     challenge as a host int and on the card) at 6 tables of 2^16; the
     Montgomery chains of csrc/mont_chain.cu: mont_pow (exponents 0, 1, 2,
     p - 2, random) on batch_inv's one total, the scan both ways and
     batch_inv with zero rows at n = 1 ... 2^17 + 3 and timed at 2^17,
     eq_xy at k = 0, 1, 5, 16 and timed at k = 16; fold_all, the scan,
     batch_inv and eq_xy must make no host sync or copy;
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
     for the card's busy share, each hand kernel's device time and launches,
     and the device-to-host copies (a failure there fails the run);
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
 10. the circuit-builder frontend and multi-phase witnesses: three small
     proofs on the card and through the plain path on the CPU, each hashing
     to the JAX package's proof (ARX_SMALL_SHA256: arx_chain_circuit(4)
     with 8-bit words, 4-bit chunks, rot 3; TWO_PHASE_SHA256:
     rand_two_phase_circuit(3, RandomState(103)), whose cheating witness
     must be rejected; BUILDER_SHA256: the builder's copy circuit of
     tests/test_frontend.py::test_builder_e2e; setup seed 0 each); then the
     ARX chain at full width, arx_chain_circuit(ARX["num_vars"]) with 32-bit
     words, 8-bit XOR chunks and rot 7 (BASELINE config 4's widths, at 2^18
     rows), its
     shape checked, build, setup, preprocess, prove and verify with
     per-stage times, the prove's launches, tamper, one profiled prove and
     one with its host syncs counted by site; then rand_two_phase_circuit at
     nv = 16 (RandomState(116), setup seed 0): prove, verify, stage times,
     launches, tamper, its cheating witness rejected (outside the path's
     launch count), one profiled prove and one with its host syncs counted;
 11. the layout microbench (halo2_lasso_tpu_torch/scripts/layout_bench.py):
     K4, K6 and K7 bit-exact against each other and the plain version at
     2^16, 2^20 and 2^22, and timed;
 12. HyperPlonk and Lasso over the secondary BN254 PCS: the nv = 3 vanilla
     plonk proof (seeds 3, 103, setup seed 0) under Gemini, Zeromorph,
     MultilinearIpa and MultilinearHyrax, and a Lasso proof over Gemini
     (range_table(16, 8), 8 lookups, SRS seed 3), each on the card and
     through the plain path on the CPU, hashing to the JAX package's proof
     (PCS_PLONK_SHA256, LASSO_GEMINI_SHA256); then phase 7's circuit at
     nv = 16 under each of the four PCS, MultilinearHyrax and MultilinearIpa
     at nv = 14 for the smoke's time (SECONDARY_NUM_VARS; setup with IPA's hash_to_curve
     timed apart, preprocess, prove, verify, stage times, the prove's
     launches, tamper, one profiled and one sync-counted prove), and
     phase 5's slice over Gemini (setup, prove, verify, tamper, the same
     launches, profiled and sync-counted proves).
 13. the grumpkin half of the BN254 2-cycle: the nv = 3 vanilla plonk proof
     over BN254 Fq (seeds 3, 103, setup seed 0) under MultilinearIpaGrumpkin
     and MultilinearHyraxGrumpkin on the card and the CPU, hashing to the
     JAX package's proofs (PCS_PLONK_SHA256), then phase 7's circuit over
     BN254 Fq at nv = 14 (SECONDARY_NUM_VARS; nv = 16 before phase 16, for
     the smoke's time) under each (setup with grumpkin's hash_to_curve
     timed apart, preprocess, prove, verify, stage times, launches, tamper,
     one profiled and one sync-counted prove); each path must launch the
     Fq instances of sumcheck_round and fold_all and the grumpkin instances
     of ec_add and msm_level (native.counts counts them apart).
 14. Brakedown, the hash-based multilinear PCS: the nv = 3 vanilla plonk
     proof (seeds 3, 103, setup seed 0) over MultilinearBrakedown on the
     card and the CPU, hashing to the JAX package's proof
     (PCS_PLONK_SHA256; tests/test_torch_hyperplonk_brakedown.py holds the
     two packages to it); then phase 7's circuit over Brakedown at nv = 16
     (setup, preprocess, prove, verify, stage times, launches, tamper, one
     profiled and one sync-counted prove, and a summary line); then the
     nv = 16 code's encode of 8 random rows on the card (timed) against the
     same code's plain versions on the CPU, bit for bit on 2 of the rows.
     The environment phase builds the native Keccak sponge
     (halo2_lasso_tpu_torch/csrc/host/keccak.c, the host C compiler) and
     times it; the run fails on any other sponge.
 15. multi-GPU sharding (halo2_lasso_tpu_torch/parallel/): on a mesh of
     SHARDS virtual shards on the card (and on a mesh of the cards where
     there are two or more; the line says which meshes ran), a round
     message, a fold, a whole sumcheck, a coefficient sumcheck and an MSM
     at 2^16 bit for bit against one device; then the proofs of phases 9
     (nv = 16 Lasso-in-HyperPlonk, its pp), 5 (2^16 Lasso range) and 10
     (the ARX chain) proved again under the virtual mesh, each byte-equal
     to its unsharded proof, its launches counted as a path of its own
     ("sharded_*") and K1 and K2 required to launch once a shard a split
     round more than the unsharded prove (phase 9's also verified, and a
     profiled prove of it: busy share, device times); the full-feature circuit at nv = 6 over the mesh
     (dryrun_multichip), and in DRYRUN_PROCS processes of DRYRUN_SHARDS
     shards on the card over gloo (scripts/dryrun_multiprocess.py, each
     worker under its own time limit), its proof hashing to the JAX
     package's (FULL_FEATURE_SHA256) in every process and on one device.
 16. K1 past its compiled limits, parameter files and the comparison MSM
     engines (run_support_phase): a GKR batch of 100 grand products at
     nv = 16, whose round program (201 leaves) is cut into chunks of whole
     terms, K1 launched chunks x rounds, each chunk's program bit-exact
     against round_message_plain, its nv = 6 proof hashing to the JAX
     package's (SPLIT_SHA256); phase 7's pp/vp and phase 5's Lasso set-up
     saved, loaded back onto the card and proved again, byte-equal, and
     phase 6's golden circuit from reloaded params; one 2^16 MSM on
     bench.py:100's inputs through the production MSM, msm_affine and the
     scan MSM, and an nv = 16 open's quotient MSMs with and without the
     segmented grouping (SEG_LANES), the points equal, with their launches
     and device ms from the fresh process.
 17. sumchecks past the round kernel's degree 8, then the Pasta curves
     (run_degree_phase, run_pasta_phase): lt_table(64, 8) at 2^16 lookups
     (LT64, a primary sumcheck of degree 9, each round two launches of K1
     from t0 = 0 and 8) set up, proved, verified and a flipped byte
     rejected, and lt_table(56, 8) (degree 8), its prove's K1 launches the
     primary rounds fewer; the small twins on the card hashing to the JAX
     package's proofs (LT16_SHA256, DEGREE9_SHA256); for each of Pallas and
     Vesta a 2^16 MSM on bench.py:100's inputs (points from fixed_base_msm)
     through the production MSM equal to msm_affine's and on the curve, the
     IPA-shaped ladder (2^15 lanes) against curves.host_mul on 64 lanes;
     every Pasta instance of K4 (the six op codes, mont_pow, the scan,
     batch_inv) and K3 (ec_add, msm_level over every level, ec_ladder over
     every one of 2^15 lanes, plane_tree) bit-exact against its plain
     version on the card, K1 at degrees 9 and 17 (2 and 3 launches) and
     from t0 > 0 against its plain version, and K1, K2, K5, sum_reduce and
     eq_xy raising on a Pasta tensor (every entry point refusing an
     unknown field id); then the device times of phases 3, 16 and 17 from
     one fresh process, each Pasta instance's beside its BN254 twin's, its
     bound by Pasta's Montgomery product (imad_per_mont_mul: 176
     multiply-adds, against BN254's 256). Profiled once each: lt_table(64,
     8)'s prove, and each Pasta path's two MSMs and ladder.
 18. a term past the round kernel's limits (run_wide_phase): the product of
     WIDE["tables"] = 129 tables at nv = 16 (RandomState(18)), one term
     that no split of terms or points can cut, proved by sum_check.prove
     with the term evaluated in field ops (fold_all, K4's op codes,
     sum_reduce: the JAX package's chunked round evaluation), verified
     against the tables' own evaluations, a flipped byte rejected; the
     prove's launches of K1 (none), K2, K4 and sum_reduce equal to its
     plan's (evaluated_launches), printed with its ms; its nv = 3 twin on
     the card, alone and on SHARDS virtual shards, hashing to the JAX
     package's proof (WIDE_SHA256).
The kernel phase also holds ec_add bit-exact at the IPA ladder's shapes at
nv = 16 (2^15 lanes: the doubling of the accumulator, P + P, and the add of
the point, with identity lanes), and the field instances that phase 13 runs
at its shapes, each recorded under its own name: sumcheck_round.fq at the
grumpkin SNARK's zero check over Fq (23 leaves, degree 5; 2^14, 2 * 1037 and
2^16, timed there), fold_all.fq (1, 37, 64, 65 tables, both strides, both
challenge forms; timed at the zero check's 23 tables of 2^16),
ec_add.grumpkin (the five cases at 2^15 lanes, also against host
arithmetic, and six steps of the IPA ladder over 2^15 grumpkin points;
timed at its doubling step), msm_level.grumpkin (every level of a
64-point edge-case MSM and of a 2^16 grumpkin MSM, 17 launches of the
instance and one of plane_tree.grumpkin with no host sync; timed over
them), and ec_ladder.grumpkin and plane_tree.grumpkin at the shapes of
their BN254 twins (the 2^16 grumpkin MSM's and a grumpkin Hyrax row MSM's
buckets). The IPA-family paths (IPA_PCS) print their prove's K3 launches
and fail unless ec_add is the open's fold adds alone and ec_ladder twice
that and one (on MultilinearIpa's, ec_add is nv).
Kernel launch counts are reset just before each main path (phases 5, 7, 8,
the nv = 16 part of 9, the two full-width paths of 10, 11, the five
full-size paths of 12, the two of 13, the one of 14, the three sharded
proves of 15, the eight paths of 16, the four of 17 and the one of 18)
and read just after it; each path must
launch every kernel it names in PATH_KERNELS, the K4 family's launches (K4,
its row sum and the mont_chain entries) and K5's are printed by path, and a
proof path that runs the plain carry pass (ops/field.py's _norm) on a CUDA
tensor fails the run. A profiled prove fails the run unless the profiler
records each hand kernel's launches as the prove counted them (a session
that lost a record is repeated). The profiled proves (the full-size
HyperPlonk paths and Lasso over Gemini) also count their host syncs by the port function
that made them (a third prove, under torch.cuda.set_sync_debug_mode("warn")).

The last lines are a JSON object with every kernel's and instance's numbers, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
A plain version's time is one call, with no warm-up (``plain_once``; in
the kernel phase's records the call that the bit-exact check compares); a
kernel's is the mean of 20 calls after a warm-up.
Any failure exits non-zero; a watchdog turns a hang into a traceback and a
non-zero exit. Without a CUDA device, or without the package beside it, the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import faulthandler
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import time

WATCHDOG_S = 1000  # below the smoke's 1200 s limit, with a margin
FRESH_RESTARTS = 2  # more fresh device-time processes, where one failed after some jobs
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
ARX_SMALL_SHA256 = "5e13a062db9b3a9f7dba437342477fd28c7f02a69f9ec60711528d227263ed2e"
ARX_SMALL = {"circuit": "arx_chain_circuit", "num_vars": 4, "setup_seed": 0,
             "kwargs": {"word_bits": 8, "chunk_bits": 4, "rot": 3}}
TWO_PHASE_SHA256 = "a36e9f29744a6f6938cca92eb53bd1e7408899781a8c2c81499c1bbb21eccddb"
TWO_PHASE_SMALL = {"circuit": "rand_two_phase_circuit", "num_vars": 3, "seeds": (103,), "setup_seed": 0}
BUILDER_SHA256 = "5cb45859c055786dedda8a7d06b89282ec5ccd4632e73b3e58a03bed75bb4249"
BUILDER_SMALL = {"circuit": "builder_copy_circuit", "num_vars": 3, "setup_seed": 0}
# the ARX chain at BASELINE config 4's widths: 32-bit words, 8-bit XOR
# chunks, rot 7 (arx_chain_circuit's defaults), at 2^18 rows: config 4's 2^19
# cut by one for the smoke's time since phase 15 proves it twice (the
# kernel phase still holds the chain's programs and MSMs at 2^19)
ARX = {"circuit": "arx_chain_circuit", "num_vars": 18, "setup_seed": 0}
# HyperPlonk and Lasso over the secondary BN254 PCS: the nv = 3 vanilla
# plonk proofs of tests/test_hyperplonk_pcs.py's seeds under each PCS and
# the Lasso-over-Gemini proof of tests/test_lasso.py's shape, each hashing
# to the JAX package's proof on the CPU (tests/test_torch_hyperplonk_pcs.py,
# tests/test_torch_hyperplonk_ipa.py, tests/test_torch_lasso_gemini.py hold
# the two packages to them); then PLONK's circuit and the Lasso slice over them
SECONDARY_PCS = ("Gemini", "Zeromorph", "MultilinearIpa", "MultilinearHyrax")
# the smoke's time budget: phase 12's BN254 Hyrax path runs at a smaller nv
# since phase 13, and its BN254 IPA path (its set-up's hash_to_curve of
# 2^nv + 1 generators) since phase 14; their grumpkin twins of phase 13
# since phase 16, with the same launch pattern
SECONDARY_NUM_VARS = {"MultilinearHyrax": 14, "MultilinearIpa": 14, "MultilinearIpaGrumpkin": 14,
                      "MultilinearHyraxGrumpkin": 14}
PCS_PLONK_SMALL = {"circuit": "rand_vanilla_plonk_circuit", "num_vars": 3, "seeds": (3, 103), "setup_seed": 0}
PCS_PLONK_SHA256 = {
    "Gemini": "7cb8ccdce443cd36147e7c8b0eb2a151bc749bbd7b7851396ae5658daae7085e",
    "Zeromorph": "481129c602ce29493f70c20af9f1374a7c389f835136741afb270669dcb1a67f",
    "MultilinearIpa": "6ed95c494c683ae59985869aa2cc6aed428773f03ff2aa6ee83b895cb9c6ba6f",
    "MultilinearHyrax": "3777c0d2f4663ae16cef31c4ce779f51b564ec939177f9f74170009399617560",
    "MultilinearIpaGrumpkin": "8950de0c769dc8902064b75ab32120c3d45c4acb7220186207a4fc9831e50677",
    "MultilinearHyraxGrumpkin": "bd50367754dda639ad9a4c00b7d2bb03031c1e114a553f392cb361400dba0cf1",
    "MultilinearBrakedown": "8690c307bd655063f1a605dbb92fb17af3b995e6a3936b3b318db3d76028be3a",
}
# the grumpkin half of the BN254 2-cycle (hyperplonk.rs:422-423): the same
# circuits over BN254 Fq under the grumpkin-backed IPA and Hyrax, their nv = 3
# proofs hashing to the JAX package's (tests/test_torch_grumpkin_hyperplonk_ipa.py,
# tests/test_torch_grumpkin_hyperplonk_hyrax.py hold the two packages to them)
GRUMPKIN_PCS = ("MultilinearIpaGrumpkin", "MultilinearHyraxGrumpkin")
LASSO_GEMINI_SMALL = {"index_bits": 16, "chunk_bits": 8, "lookups": 8, "srs_seed": 3, "index_seed": 123, "pcs": "Gemini"}
LASSO_GEMINI_SHA256 = "ec43db505fd50634294dc7df94bdc4e5cad5a7ed08286a824b966e70d16e632b"
LASSO_GEMINI = {**SLICE, "pcs": "Gemini"}
ARX_SHAPE = {"selectors": 1, "advice": [8], "gates": 6, "lasso_tables": ["xor_32", "range_25", "range_7"]}
TWO_PHASE = {"circuit": "rand_two_phase_circuit", "num_vars": 16, "seeds": (116,), "setup_seed": 0}
PROOF_KERNELS = ("mont_mul", "fold_all", "sumcheck_round", "ec_add", "fix_var", "msm_level", "eq_xy", "sum_reduce",
                 "plane_tree")
# the HyperPlonk paths' batch inversions and permutation scan
HYPERPLONK_KERNELS = PROOF_KERNELS + ("mont_pow", "prefix_products")
# the kernels' field instances that the grumpkin SNARK runs (ops/native.py
# INSTANCES, counted apart from their kernel's first instance)
GRUMPKIN_INSTANCES = ("sumcheck_round.fq", "fold_all.fq", "ec_add.grumpkin", "msm_level.grumpkin", "ec_ladder.grumpkin",
                      "plane_tree.grumpkin")
# the IPA-family PCS: their opens scale points with the ladder
IPA_PCS = ("MultilinearIpa", "MultilinearHyrax", "MultilinearIpaGrumpkin", "MultilinearHyraxGrumpkin")
PATH_KERNELS = {
    "lasso": PROOF_KERNELS,
    "hyperplonk": HYPERPLONK_KERNELS,
    "lasso_and": PROOF_KERNELS,
    "lasso_hyperplonk": HYPERPLONK_KERNELS,
    # no copy constraint and no logup lookup: no batch inversion or scan
    "arx": PROOF_KERNELS,
    "two_phase": PROOF_KERNELS,
    "layout": ("mont_mul", "mont_mul_limbs_first", "mont_mul_tiled"),
    # phase 7's circuit under each secondary PCS (HyperPlonk's batch
    # inversions and scan, as there; the IPA family's ladders); Lasso over
    # Gemini adds the scan of the univariate evaluations' powers
    **{f"plonk_{name}": HYPERPLONK_KERNELS + (("ec_ladder",) if name in IPA_PCS else ()) for name in SECONDARY_PCS},
    # the grumpkin SNARK: the same kernels, and the Fq instances of K1 and K2
    # and the grumpkin instances of K3 among their launches
    **{f"plonk_{name}": HYPERPLONK_KERNELS + ("ec_ladder",) + GRUMPKIN_INSTANCES for name in GRUMPKIN_PCS},
    "lasso_gemini": PROOF_KERNELS + ("prefix_products",),
    # HyperPlonk over Brakedown: no MSM; the code's sparse products and the
    # opens' row combinations are K4 and its row sum
    "plonk_MultilinearBrakedown": ("mont_mul", "sum_reduce", "fold_all", "sumcheck_round", "fix_var", "eq_xy",
                                   "mont_pow", "prefix_products"),
    # phase 16: the split GKR batch (its layers' products, eq tables, K1 a
    # chunk and the chunks' sums); the proves from reloaded params (a prove
    # alone: no set-up window tree); the MSM engines and the quotient MSMs
    "split_gkr": ("sumcheck_round", "fold_all", "mont_mul", "eq_xy", "sum_reduce"),
    "files_plonk": tuple(k for k in HYPERPLONK_KERNELS if k != "ec_add"),
    "files_lasso": tuple(k for k in PROOF_KERNELS if k != "ec_add"),
    "msm_msm": ("msm_level", "plane_tree"),
    "msm_affine": ("mont_mul", "prefix_products", "mont_pow", "ec_add"),
    "msm_scan": ("ec_add", "mont_mul"),
    "msm_quotients": ("msm_level", "plane_tree"),
    "msm_quotients_grouped": ("msm_level", "plane_tree"),
    # phase 17: Lasso with a primary sumcheck of degree 9 and 8 (each Pasta
    # curve's path, "pasta_<curve>", is added by run_pasta_phase)
    "lasso_lt64": PROOF_KERNELS,
    "lasso_lt56": PROOF_KERNELS,
    # phase 18: the evaluated term's folds, field ops and row sums; no K1
    "wide_product": ("fold_all", "mont_mul", "sum_reduce"),
}
# phase 14: HyperPlonk over Brakedown, phase 7's circuit at nv = 16, and the
# rows of its code encoded on the card against the CPU
BRAKEDOWN = {**PLONK, "pcs": "MultilinearBrakedown"}
BRAKEDOWN_ENCODE_ROWS = 8  # a commit's rows at nv = 16; 2 of them are checked on the CPU
SPONGE_MB = 64  # bytes absorbed to time the native sponge
# K4 (csrc/mont_mul.cu: the elementwise kernel and its row sum) and the
# entries that replaced its caller loops (csrc/mont_chain.cu)
K4_FAMILY = ("mont_mul", "sum_reduce", "mont_pow", "prefix_products", "eq_xy")
# phase 15: the proofs of phases 9, 5 and 10 again under a mesh of SHARDS
# virtual shards on the card, each byte-equal to its unsharded proof, and the
# multi-process dryrun (DRYRUN_PROCS processes of DRYRUN_SHARDS shards each,
# gloo) of the full-feature circuit at FULL_FEATURE_NV, whose proof hashes to
# the JAX package's (FULL_FEATURE_SHA256[nv]: rand_full_feature_circuit(nv),
# seeds nv and 100 + nv, setup seed 0, on the CPU; tests/test_torch_distributed.py
# and tests/test_torch_sharding_full_feature.py hold the port to nv = 5's)
SHARDS = 4
SHARDED_PATHS = {"sharded_lasso_hyperplonk": "lasso_hyperplonk", "sharded_lasso": "lasso", "sharded_arx": "arx"}
DRYRUN_PROCS, DRYRUN_SHARDS, FULL_FEATURE_NV = 2, 2, 6
FULL_FEATURE_SHA256 = {5: "ff6b46bcb0655ae34b71f34fc30bb15358fe0b49e74d3cece9cba043c4644977",
                       6: "f14eb8172a76a4d9d809aa07d76b1c65b2e98d5359eb8fd7249b7d82cc7c65c9"}
DRYRUN_TIMEOUT_S = 240  # each worker's, from its start
# phase 16: a GKR batch of SPLIT_GKR["products"] pure grand products, whose
# round program (2 leaves a product and the eq table) passes the round
# kernel's limits and is split into chunks of whole terms; its proof at nv = 6
# hashes to the JAX package's (SPLIT_SHA256, tests/test_torch_round_split.py)
SPLIT_GKR = {"products": 100, "num_vars": 16, "seed": 11}
SPLIT_SHA256 = "6d8566f486c9b7146ce09500a6d02e95871b97705aca31e19e5df0aaab7ed4ec"
# phase 17: sumchecks past the round kernel's MAX_DEGREE (8), split into
# chunks of points: a 64-bit unsigned compare in 8-bit chunks (the
# primary sumcheck of degree 9) at 2^16 lookups against the same table in 7
# chunks (lt_table(56, 8), degree 8: one launch a round), and two small twins hashing
# to the JAX package's proofs (tests/test_torch_round_split.py): the nv = 3
# vanilla circuit with a gate of degree 8 (a zero check of degree 9) and
# lt_table(16, 2); then the Pasta curves' instances of K4 and K3
LT64 = {"table": ("lt_table", 64, 8), "lookups": 1 << 16, "srs_seed": 3, "index_seed": 1}
LT56 = {"table": ("lt_table", 56, 8), "lookups": 1 << 16, "srs_seed": 3, "index_seed": 1}
LT16_SMALL = {"table": ("lt_table", 16, 2), "lookups": 8, "srs_seed": 3, "index_seed": 171}
LT16_SHA256 = "95d0888c404993165852a6350e97af474edd9f84efbcfb968899f292bf3f2a70"
DEGREE9_SMALL = {"circuit": "raised_gate_circuit", "num_vars": 3, "seeds": (42, 43), "setup_seed": 0,
                 "gate_degree": 8}
DEGREE9_SHA256 = "6bdcbbab8b9bc7afe34b22041cbc46a057c06477103966de1e140dc8b44b70bc"
# phase 18: one term past the round kernel's limits, the product of
# MAX_LEAVES + 1 = 129 tables (degree 129), proved by sum_check.prove with
# the term evaluated in field ops as the JAX package's chunked round
# evaluation does (piop/sum_check.py ``evaluated_message``); tables from
# RandomState(seed), values below 2^62; its nv = 3 twin hashes to the JAX
# package's proof (WIDE_SHA256, tests/test_torch_round_split.py)
WIDE = {"tables": 129, "num_vars": 16, "seed": 18}
WIDE_SHA256 = "cb2c453b8a0baa3dd1a216a2a8fe0e9d8f6b7da9bc2df74b653ff3f051d75259"
# the lane budget of phase 16's grouped quotient MSMs
# (HALO2_LASSO_TPU_MSM_GROUP_LANES): the nv = 16 open's 16 MSMs in three
# segmented pipelines (2^15 and 2^14; 2^13 .. 2^5; the rest)
SEG_LANES = 1 << 21
# a sharded path is a prove alone: it launches what its unsharded path does
# but ec_add, which runs in set-up (the fixed-base MSM's window tree)
PATH_KERNELS.update({sharded: tuple(k for k in PATH_KERNELS[path] if k != "ec_add")
                     for sharded, path in SHARDED_PATHS.items()})


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
    sponge_line(np)

    # 2. build
    t0 = time.perf_counter()
    native.lib()
    stage("build", t0, f"parallel nvcc and link {native.build_seconds:.1f}s" if native.build_seconds else "cached")
    for line in ptxas_lines(native.ptxas_info):
        print("  ptxas " + line, flush=True)

    # 3. kernels (their device times come from one fresh process, with
    # phases 16's and 17's, at the end)
    t0 = time.perf_counter()
    fresh = FreshDeviceTimes()
    kernels = check_kernels(torch, np, dev, fresh)
    stage("kernels", t0, "bit-exact: " + ", ".join(k["name"] for k in kernels))
    by_name = {k["name"]: k for k in kernels}

    # 4. small proof against the JAX package's bytes
    proof_gate(np, lasso_proof, SMALL, SMALL_PROOF_SHA256, "small_proof", "range_table(8,4), 16 lookups")

    # 5. the Lasso slice
    launches = {}
    slice_path = {"cfg": SLICE}
    slice_path["proof"], _ = run_path(launches, "lasso", "slice", "2^16 lookups range_table(16,16)",
                                      lambda: lasso_proof(np, SLICE, "cuda", tamper=True, extra=slice_path))

    # 6. small HyperPlonk proof against the JAX package's golden bytes
    proof_gate(np, hyperplonk_proof, PLONK_SMALL, GOLDEN_SHA256, "plonk_small", "nv=3 vanilla")

    # 7. HyperPlonk at full size
    plonk_path = run_hyperplonk_path(torch, np, launches, "hyperplonk", "plonk", "nv=16 vanilla plonk with lookup",
                                     PLONK)
    sponge_ab(torch, plonk_path)

    # 8. two-operand Lasso at 2^16
    run_path(launches, "lasso_and", "lasso_and", "2^16 lookups and_table(32,8)",
             lambda: lasso_proof(np, AND_SLICE, "cuda", tamper=True))

    # 9. Lasso inside HyperPlonk: the small proof against the JAX package's
    # bytes, then the full-size circuit
    proof_gate(np, hyperplonk_proof, LASSO_PLONK_SMALL, LASSO_PLONK_SHA256, "lasso_plonk_small", "nv=3 Lasso lookups")
    lasso_plonk_path = run_hyperplonk_path(torch, np, launches, "lasso_hyperplonk", "lasso_plonk",
                                           "nv=16 32-bit AND + 16-bit range Lasso lookups", LASSO_PLONK)

    # 10. the circuit-builder frontend and multi-phase witnesses: the small
    # proofs against the JAX package's bytes, then the ARX chain and the
    # two-phase circuit at full width
    proof_gate(np, hyperplonk_proof, ARX_SMALL, ARX_SMALL_SHA256, "arx_small", "ARX chain k=4, 8-bit words")
    proof_gate(np, lambda np, cfg, device: hyperplonk_proof(np, cfg, device, cheat=True), TWO_PHASE_SMALL,
               TWO_PHASE_SHA256, "two_phase_small", "nv=3 two phases, cheating witness rejected")
    proof_gate(np, hyperplonk_proof, BUILDER_SMALL, BUILDER_SHA256, "builder_small", "builder copy circuit k=3")
    check_arx_shape(np, ARX)
    arx_path = run_hyperplonk_path(torch, np, launches, "arx", "arx",
                                   f"ARX chain k={ARX['num_vars']}, 32-bit words, 8-bit XOR chunks, rot 7", ARX)
    run_hyperplonk_path(torch, np, launches, "two_phase", "two_phase",
                        f"nv={TWO_PHASE['num_vars']} two phases", TWO_PHASE, cheat=True)

    # 11. the layout microbench
    from halo2_lasso_tpu_torch.scripts import layout_bench

    t0 = time.perf_counter()
    native.reset_counts()
    layouts = layout_bench.run()
    launches["layout"] = dict(native.counts)
    stage("layout", t0, "K4, K6, K7 and plain bit-exact at " + ", ".join(f"2^{r['n'].bit_length() - 1}" for r in layouts))
    for r in layouts:
        print("  " + json.dumps(r), flush=True)

    # 12. HyperPlonk and Lasso over the secondary BN254 PCS: the small proofs
    # against the JAX package's bytes, then phase 7's circuit under each PCS
    # and the Lasso slice over Gemini
    for name in SECONDARY_PCS:
        proof_gate(np, hyperplonk_proof, {**PCS_PLONK_SMALL, "pcs": name}, PCS_PLONK_SHA256[name],
                   f"plonk_small_{name}", f"nv=3 vanilla over {name}")
    proof_gate(np, lasso_proof, LASSO_GEMINI_SMALL, LASSO_GEMINI_SHA256, "lasso_gemini_small",
               "range_table(16,8), 8 lookups over Gemini")
    for name in SECONDARY_PCS:
        nv = SECONDARY_NUM_VARS.get(name, PLONK["num_vars"])
        run_hyperplonk_path(torch, np, launches, f"plonk_{name}", f"plonk_{name}",
                            f"nv={nv} vanilla plonk with lookup over {name}", {**PLONK, "pcs": name, "num_vars": nv})
    extra = {}
    run_path(launches, "lasso_gemini", "lasso_gemini", "2^16 lookups range_table(16,16) over Gemini",
             lambda: lasso_proof(np, LASSO_GEMINI, "cuda", tamper=True, extra=extra))
    profile_path(torch, extra)

    # 13. the grumpkin half of the BN254 2-cycle: the nv = 3 proofs over
    # BN254 Fq against the JAX package's bytes, then phase 7's circuit over
    # BN254 Fq under the grumpkin-backed IPA and Hyrax
    for name in GRUMPKIN_PCS:
        proof_gate(np, hyperplonk_proof, {**PCS_PLONK_SMALL, "pcs": name}, PCS_PLONK_SHA256[name],
                   f"plonk_small_{name}", f"nv=3 vanilla over BN254 Fq, {name}")
    for name in GRUMPKIN_PCS:
        nv = SECONDARY_NUM_VARS.get(name, PLONK["num_vars"])
        run_hyperplonk_path(torch, np, launches, f"plonk_{name}", f"plonk_{name}",
                            f"nv={nv} vanilla plonk with lookup over BN254 Fq, {name}",
                            {**PLONK, "pcs": name, "num_vars": nv})

    # 14. Brakedown: the nv = 3 proof against the JAX package's bytes, then
    # phase 7's circuit over Brakedown and its code's encode on the card
    # against the CPU
    name = BRAKEDOWN["pcs"]
    proof_gate(np, hyperplonk_proof, {**PCS_PLONK_SMALL, "pcs": name}, PCS_PLONK_SHA256[name],
               f"plonk_small_{name}", f"nv=3 vanilla over {name}")
    path = run_hyperplonk_path(torch, np, launches, f"plonk_{name}", f"plonk_{name}",
                               f"nv={BRAKEDOWN['num_vars']} vanilla plonk with lookup over {name}", BRAKEDOWN)
    ms = {}
    for k, v in path["records"]:  # the first of each (the tamper's verify comes second)
        ms.setdefault(k, v)
    print(f"brakedown summary: nv={BRAKEDOWN['num_vars']} setup {ms['setup']:.1f}ms preprocess "
          f"{ms['preprocess']:.1f}ms prove {ms['prove']:.1f}ms verify {ms['verify']:.1f}ms busy "
          f"{100 * path['profile']['busy_share']:.1f}% syncs {sum(path['sync_sites'].values())} bytes "
          f"{len(path['proof'])} | {smi}", flush=True)
    check_brakedown_encode(torch, np, path["pp"].pcs)

    # 15. multi-GPU sharding: the sharded functions against one device's,
    # then the proofs of phases 9, 5 and 10 under a mesh of SHARDS virtual
    # shards (and of the real cards, where there are two or more), and the
    # multi-process dryrun
    run_sharded_phase(torch, np, launches, {"sharded_lasso_hyperplonk": lasso_plonk_path, "sharded_lasso": slice_path,
                                            "sharded_arx": arx_path}, smi)

    # 16. K1 past its compiled limits (a GKR batch split into chunks), the
    # parameter files of phases 7, 5 and 6 reloaded onto the card, and the
    # comparison MSM engines at 2^16
    engines = run_support_phase(torch, np, launches, plonk_path, slice_path, smi, fresh)

    # 17. sumchecks past the round kernel's degree 8 (lt_table(64, 8) at 2^16
    # lookups and the small twins against the JAX package's bytes), then the
    # Pasta curves: MSMs and ladders over Pallas and Vesta and every Pasta
    # instance of K4 and K3 against its plain version
    run_degree_phase(torch, np, launches, smi)
    pasta, k1_points = run_pasta_phase(torch, np, launches, smi, fresh)

    # 18. a term past the round kernel's limits (the product of 129 tables
    # at nv = 16 and its nv = 3 twin against the JAX package's bytes),
    # evaluated with K2, K4 and the row sum
    run_wide_phase(torch, np, launches, smi)

    # the device times of phases 3, 16 and 17, in one fresh process
    t0 = time.perf_counter()
    fresh.run(torch)
    stage("device_times", t0, f"a fresh process, {len(fresh.jobs)} jobs")
    print_kernel_times(kernels)
    print_engines(engines, fresh, smi)
    print_pasta(pasta, k1_points, smi)
    kernels += list(pasta.values())
    by_name["sumcheck_round"]["timed"].update(k1_points)

    for path, counts in launches.items():
        missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
        if missing:
            raise SystemExit(f"the {path} path did not launch: {missing}")
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in launches.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    print("K4 family launches by path: " + json.dumps(
        {path: sum(counts[k] for k in K4_FAMILY) for path, counts in launches.items()}), flush=True)
    print("K5 (fix_var chain) launches by path: " + json.dumps(
        {path: counts["fix_var"] for path, counts in launches.items()}), flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def print_kernel_times(kernels):
    """The kernel phase's lines, once the fresh process has run: each
    kernel's events, device and plain times and bound at its shapes."""
    by_name = {k["name"]: k for k in kernels}
    print("kernels " + " ".join(f"{k['name']}={k['ms']:.4f}ms(plain {k['plain_ms']:.3f}ms)" for k in kernels), flush=True)
    for name in ("mont_mul", "sum_reduce", "fix_var", "sumcheck_round"):
        for shape, r in by_name[name]["timed"].items():
            print(f"{name}: {shape}: events {r['ms']:.4f}ms, device {r['device_ms']:.4f}ms (bound "
                  f"{r['bound_ms']:.5f}ms, {r['bound_by']}; plain {r['plain_ms']:.3f}ms)", flush=True)
    k1, k3, lv = by_name["sumcheck_round"], by_name["ec_add"], by_name["msm_level"]
    print(f"sumcheck_round: {k1['shape']}: {k1['ms']:.4f}ms, device {k1['device_ms']:.4f}ms "
          f"(bound {k1['bound_ms']:.4f}ms, {k1['bound_by']}); "
          f"Lasso primary 2^16: {k1['primary_ms']:.4f}ms (bound {k1['primary_bound_ms']:.4f}ms, "
          f"{k1['primary_bound_by']})", flush=True)
    print(f"ec_add: {k3['shape']}: {k3['ms']:.4f}ms (bound {k3['bound_ms']:.4f}ms); 878,592 lanes "
          f"of the five cases {k3['five_case_ms']:.4f}ms (bound {k3['five_case_bound_ms']:.4f}ms); "
          f"{k3['ladder_shape']}: {k3['ladder_ms']:.4f}ms (bound {k3['ladder_bound_ms']:.4f}ms, "
          f"{k3['ladder_bound_by']}; plain {k3['ladder_plain_ms']:.3f}ms)", flush=True)
    print(f"msm_level: {lv['shape']}: device {lv['ms']:.4f}ms, events {lv['event_ms']:.4f}ms (bound "
          f"{lv['bound_ms']:.4f}ms over {lv['adds']} adds; plain {lv['plain_ms']:.2f}ms)", flush=True)
    for shape, r in lv["timed"].items():
        print(f"msm_level: {shape}: device {r['device_ms']:.4f}ms, events {r['ms']:.4f}ms (bound "
              f"{r['bound_ms']:.4f}ms over {r['adds']} adds)", flush=True)
    for name in ("fold_all", "mont_pow", "prefix_products", "eq_xy"):
        k = by_name[name]
        print(f"{name}: {k['shape']}: events {k['ms']:.4f}ms, device {k['device_ms']:.4f}ms (bound "
              f"{k['bound_ms']:.5f}ms, {k['bound_by']}; plain {k['plain_ms']:.3f}ms)", flush=True)
    for name in ("sumcheck_round.fq", "fold_all.fq", "ec_add.grumpkin", "msm_level.grumpkin"):
        k = by_name[name]
        extra_ms = f", device {k['device_ms']:.4f}ms" if "device_ms" in k else ""
        if "event_ms" in k:
            extra_ms = f" (device), events {k['event_ms']:.4f}ms"
        print(f"{name}: {k['shape']}: {k['ms']:.4f}ms{extra_ms} (bound {k['bound_ms']:.5f}ms, {k['bound_by']}; "
              f"plain {k['plain_ms']:.3f}ms)", flush=True)
    print_ladder_and_tree(by_name)
    bi = by_name["prefix_products"]
    print(f"batch_inv: 2^17 Fr: events {bi['batch_inv_ms']:.4f}ms, device {bi['batch_inv_device_ms']:.4f}ms "
          f"(bound {bi['batch_inv_bound_ms']:.5f}ms, {bi['batch_inv_bound_by']}; plain "
          f"{bi['batch_inv_plain_ms']:.3f}ms)", flush=True)


def proof_gate(np, prove_fn, cfg, want_sha, name, label, cpu=True):
    """A small proof on the card and (with `cpu`) through the plain path on
    the CPU must both hash to `want_sha`, the SHA-256 of the JAX package's
    proof."""
    t0 = time.perf_counter()
    gpu_proof = prove_fn(np, cfg, "cuda")[0]
    cpu_proof = prove_fn(np, cfg, "cpu")[0] if cpu else gpu_proof
    sha = hashlib.sha256(gpu_proof).hexdigest()
    if sha != want_sha or cpu_proof != gpu_proof:
        raise SystemExit(f"{name} proof mismatch: gpu {sha}, cpu {hashlib.sha256(cpu_proof).hexdigest()}")
    stage(name, t0, f"{label}: {len(gpu_proof)} bytes sha256 {sha[:16]} == JAX" + (", == CPU plain path" if cpu else ""))


def run_path(launches, path, name, label, run):
    """One main path: launch counts and the plain carry passes run on the
    card reset just before `run` (which returns the proof and its stage
    records) and read just after: the counts kept in `launches[path]`, and
    any carry pass on the card a failure."""
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import native

    t0 = time.perf_counter()
    native.reset_counts()
    F.norm_on_card = 0
    proof, records = run()
    launches[path] = dict(native.counts)
    if F.norm_on_card:
        raise SystemExit(f"the {path} path ran the plain carry pass on the card {F.norm_on_card} times")
    stage(name, t0, f"{label}: {len(proof)} bytes, verified, tamper rejected, no plain carry pass on the card")
    print_stages(records)
    return proof, records


def run_hyperplonk_path(torch, np, launches, path, name, label, cfg, cheat=False):
    """A full-size HyperPlonk main path, with `cheat` a proof of the
    circuit's cheating witness rejected (after the path's launches are
    read), then ``profile_path``. Returns what the path left: its config,
    params (pp, vp), proof, stage records, profile and sync sites."""
    extra = {"cfg": cfg}
    extra["proof"], extra["records"] = run_path(
        launches, path, name, label, lambda: hyperplonk_proof(np, cfg, "cuda", tamper=True, extra=extra))
    if cfg.get("pcs") in IPA_PCS:
        # one IPA open a prove: a ladder for h', two a round (c_l h' and c_r
        # h' in one, xi b_r) and one ec_add a round (the fold); every MSM's
        # tree one plane_tree launch
        pl = extra["prove_launches"]
        print(f"  K3 in prove: ec_add {pl['ec_add']} (the open's fold adds), ec_ladder {pl['ec_ladder']}, "
              f"plane_tree {pl['plane_tree']}, msm_level {pl['msm_level']}", flush=True)
        rounds = cfg["num_vars"] if cfg["pcs"].startswith("MultilinearIpa") else None
        if pl["ec_ladder"] != 2 * pl["ec_add"] + 1 or pl["ec_add"] == 0 or rounds not in (None, pl["ec_add"]):
            raise SystemExit(f"the {path} prove launched ec_add {pl['ec_add']} and ec_ladder {pl['ec_ladder']} times")
    if cheat:
        rejects_cheat(np, cfg, extra["pp"], extra["vp"])
        print("  a proof of the cheating witness was rejected", flush=True)
    profile_path(torch, extra)
    return extra


def profile_path(torch, extra):
    """After a main path: the launches of its prove alone, then a second,
    profiled prove and a third with its host syncs counted by site (the
    prove `extra["prove"]` runs); their results kept in `extra` ("profile",
    "sync_sites")."""
    print("  launches in prove: " + json.dumps(extra["prove_launches"]), flush=True)
    prof = extra["profile"] = profile_prove(torch, extra["prove"])
    print("  second prove under torch.profiler: " + json.dumps(prof), flush=True)
    sites = extra["sync_sites"] = sync_sites(torch, extra["prove"])
    print(f"  third prove, host syncs by site ({sum(sites.values())}): " + json.dumps(sites), flush=True)


def run_sharded_phase(torch, np, launches, paths, smi):
    """Phase 15. On each mesh (SHARDS virtual shards on the card, and every
    card where there are two or more) the sharded functions against one
    device's; then each earlier proof of `paths` (sharded path -> what its
    unsharded path left) proved again under the virtual mesh, its launches
    counted apart and its bytes equal to the unsharded proof's; then the
    multi-process dryrun. Nothing is caught: a failing shard fails the run."""
    from halo2_lasso_tpu_torch.parallel import sharding as sh
    from halo2_lasso_tpu_torch.scripts import dryrun_multiprocess as dry

    t0 = time.perf_counter()
    meshes = [("%d virtual shards on cuda:0" % SHARDS, sh.Mesh([torch.device("cuda", 0)] * SHARDS))]
    if torch.cuda.device_count() >= 2:
        real = sh.make_mesh(1 << (torch.cuda.device_count().bit_length() - 1))  # a power of two of the cards
        meshes.append((f"{real.size} cards " + ",".join(str(d) for d in real.devices), real))
    for label, mesh in meshes:
        check_sharded_functions(torch, np, mesh, paths["sharded_lasso_hyperplonk"]["pp"].pcs)
    stage("sharded_functions", t0, "meshes: " + "; ".join(label for label, _ in meshes) + " | round, fold, "
          "coefficient round, sumcheck and MSM at 2^16 bit-exact against one device")

    mesh = meshes[0][1]
    for path, extra in paths.items():
        run_sharded_path(torch, launches, path, mesh, extra, full=path == "sharded_lasso_hyperplonk")

    t0 = time.perf_counter()
    dry.dryrun_multichip(SHARDS, mesh.devices, FULL_FEATURE_NV)
    stage("dryrun_multichip", t0, f"full-feature nv={FULL_FEATURE_NV} over {SHARDS} virtual shards")

    t0 = time.perf_counter()
    results = dry.run(DRYRUN_PROCS, DRYRUN_SHARDS, FULL_FEATURE_NV, "cuda", DRYRUN_TIMEOUT_S)
    pp, _, circuit = dry.full_feature(FULL_FEATURE_NV, torch.device("cuda", 0))
    single, want = hashlib.sha256(dry.prove(pp, circuit)).hexdigest(), FULL_FEATURE_SHA256[FULL_FEATURE_NV]
    if single != want or any(r["sha256"] != want for r in results):
        raise SystemExit(f"dryrun proofs {[r['sha256'] for r in results]}, one device {single}, want {want}")
    if any(r["msm"] != dry.msm_affine(*dry.msm_job(pp, FULL_FEATURE_NV)) for r in results):
        raise SystemExit("the dryrun's MSM split over the processes differs from one device's")
    stage("dryrun_multiprocess", t0, f"{DRYRUN_PROCS} processes x {DRYRUN_SHARDS} shards on one card (gloo), "
          f"full-feature nv={FULL_FEATURE_NV}: {results[0]['bytes']} bytes sha256 {single[:16]} == JAX == one "
          f"device, verified in each process, split MSM equal | {smi}")


class ShardedRounds:
    """While entered, counts the sumcheck rounds that ran split over a mesh
    (``piop/sum_check.py``'s ``_Tables``): round messages by kind ("message":
    one K1 launch a shard; "sums_of": the coefficient rounds) and, for each
    split fold, its K2 launches a shard (one a FOLD_MAX_TABLES tables)."""

    def __enter__(self):
        from halo2_lasso_tpu_torch.piop import sum_check as SC
        from halo2_lasso_tpu_torch.poly import multilinear as mle

        self.rounds, self.fold_launches = {"message": 0, "sums_of": 0}, 0
        self._tables = SC._Tables
        message, fold = SC._Tables.message, SC._Tables.fold
        counter = self

        def counted_message(tables, fn):
            if tables.mesh is not None:
                counter.rounds[fn.__name__] += 1
            return message(tables, fn)

        def counted_fold(tables, r):
            if tables.mesh is not None:
                counter.fold_launches += -(-len(tables.shards[0]) // mle.FOLD_MAX_TABLES)
            return fold(tables, r)

        self._saved = (message, fold)
        SC._Tables.message, SC._Tables.fold = counted_message, counted_fold
        return self

    def __exit__(self, *exc):
        self._tables.message, self._tables.fold = self._saved
        return False


def run_sharded_path(torch, launches, path, mesh, extra, full=False):
    """An earlier main path's prove under `mesh`: counts reset just before
    and read just after (kept in `launches[path]`), its proof equal to the
    unsharded one's, K1 and K2 once a shard a split round more than the
    unsharded prove; with `full`, the proof verified and one more prove
    profiled under the mesh (its busy share and device times)."""
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.parallel import sharding as sh

    t0 = time.perf_counter()
    native.reset_counts()
    F.norm_on_card = 0
    with sh.use_mesh(mesh), ShardedRounds() as split:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        proof = extra["prove"]()
        torch.cuda.synchronize()
        prove_ms = (time.perf_counter() - tp) * 1e3
    launches[path] = counts = dict(native.counts)
    if F.norm_on_card:
        raise SystemExit(f"the {path} path ran the plain carry pass on the card {F.norm_on_card} times")
    if proof != extra["proof"]:
        raise SystemExit(f"the {path} proof differs from its unsharded proof")
    if full:
        extra["verify"](proof)
    single = extra["prove_launches"]
    want = {"sumcheck_round": single["sumcheck_round"] + (mesh.size - 1) * split.rounds["message"],
            "fold_all": single["fold_all"] + (mesh.size - 1) * split.fold_launches}
    if any(counts[k] != v for k, v in want.items()) or not split.rounds["message"]:
        raise SystemExit(f"the {path} prove launched K1 {counts['sumcheck_round']} and K2 {counts['fold_all']} "
                         f"times, want {want} ({split.rounds} split rounds, {mesh.size} shards)")
    stage(path, t0, f"{len(proof)} bytes == unsharded{', verified' if full else ''}; prove {prove_ms:.1f}ms on "
          f"{mesh.size} shards; K1 {counts['sumcheck_round']} (unsharded {single['sumcheck_round']}, "
          f"{split.rounds['message']} split rounds x {mesh.size}), K2 {counts['fold_all']} (unsharded "
          f"{single['fold_all']}), {split.rounds['sums_of']} split coefficient rounds")
    print("  launches in sharded prove: " + json.dumps({k: v for k, v in counts.items() if v}), flush=True)
    print("  launches in unsharded prove: " + json.dumps({k: v for k, v in single.items() if v}), flush=True)
    if full:
        with sh.use_mesh(mesh):
            prof = profile_prove(torch, extra["prove"])
        print("  sharded prove under torch.profiler: " + json.dumps(prof), flush=True)


def check_sharded_functions(torch, np, mesh, kzg_pp, k=16):
    """At 2^k (2^16 on the card) on `mesh`, bit for bit against one device: a round message
    (K1 a shard, combined), a fold (K2 a shard), a whole sumcheck and a
    coefficient sumcheck under ``use_mesh``, and an MSM split over the mesh
    (``msm_planes`` a shard) of the SRS's 2^k points. A small k rehearses it
    on a mesh of CPU shards."""
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
    from halo2_lasso_tpu_torch.parallel import sharding as sh
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle
    from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

    dev = mesh.first
    rng = np.random.RandomState(15)

    def rand(n):
        return [int.from_bytes(rng.bytes(40), "little") % Fr.modulus for _ in range(n)]

    polys = [Fr.encode(rand(1 << k), dev) for _ in range(3)]
    y, chal, r = rand(k), rand(1), rand(1)[0]
    expr = ((Expression.poly(0) + Expression.challenge(0)) * Expression.poly(1) * Expression.poly(2)
            + Expression.challenge(0) * 3 + Expression.constant(5)) * Expression.eq_xy(0)
    keys = SC._leaf_keys(expr, 3)
    tables = polys + [mle.eq_xy(Fr, y, dev)]
    program = SC.lower_expression(expr, keys)
    chal_t = Fr.encode(chal, dev)
    shards = [list(t) for t in zip(*(mesh.split(t) for t in tables))]
    got = mesh.combine(Fr, [SC.round_message(Fr, t, program, chal_t.to(t[0].device), expr.degree) for t in shards])
    if got != Fr.decode_ints(SC.round_message(Fr, tables, program, chal_t, expr.degree)):
        raise SystemExit("the sharded round message differs from one device's")
    folded = [mle.fold_all(Fr, t, r) for t in shards]
    whole = mle.fold_all(Fr, tables, r)
    if not all(torch.equal(mesh.gather([f[i] for f in folded]), whole[i]) for i in range(len(tables))):
        raise SystemExit("the sharded fold differs from one device's")

    def proofs(run):
        out = []
        for m in (mesh, None):
            tw = Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, curve_b=3)
            if m is None:
                res = run(tw)
            else:
                with sh.use_mesh(m):
                    res = run(tw)
            out.append((tw.into_proof(), res))
        return out

    vp = SC.VirtualPolynomial(expr, polys, chal, [y])
    (p1, r1), (p2, r2) = proofs(lambda tw: SC.prove(Fr, k, vp, 0, tw))
    if p1 != p2 or r1 != r2:
        raise SystemExit("the sumcheck under the mesh differs from one device's")
    terms = [(s, mle.eq_xy(Fr, rand(k), dev), p) for s, p in zip(rand(3), polys)]
    (p1, r1), (p2, r2) = proofs(lambda tw: SC.prove_coeff_products(Fr, k, terms, 0, tw))
    if p1 != p2 or r1[0] != r2[0] or [Fr.decode_ints(f) for f in r1[1]] != [Fr.decode_ints(f) for f in r2[1]]:
        raise SystemExit("the coefficient sumcheck under the mesh differs from one device's")
    points = kzg_pp.eqs[k]
    scal = Fr.encode(rand(1 << k), dev)
    split = MJ.host_batch_affine([sh.sharded_msm(mesh, points, scal)], FQ_MODULUS)
    if split != MJ.host_batch_affine([MJ.msm(points, scal)], FQ_MODULUS):
        raise SystemExit("the MSM split over the mesh differs from one device's")
    torch.cuda.synchronize()


def sponge_line(np):
    """The Keccak sponge the transcript runs, which must be the native one,
    and its rates: SPONGE_MB absorbed in 1 MiB updates, and a commit's
    leaves at nv = 16 (14,091 columns of 8 elements) in one batch call."""
    from halo2_lasso_tpu_torch.ops import keccak

    t0 = time.perf_counter()
    sponge = keccak.sponge()
    if sponge != "native":
        raise SystemExit(f"the transcript runs the {sponge} Keccak sponge, not the native one")
    chunk = np.random.RandomState(0).bytes(1 << 20)
    h = keccak.Keccak256()
    t1 = time.perf_counter()
    for _ in range(SPONGE_MB):
        h.update(chunk)
    h.digest()
    absorb_s = time.perf_counter() - t1
    leaves = np.frombuffer(np.random.RandomState(1).bytes(14091 * 256), dtype=np.uint8).reshape(14091, 256)
    t1 = time.perf_counter()
    keccak.keccak256_rows(leaves)
    rows_s = time.perf_counter() - t1
    stage("sponge", t0, f"{sponge} ({os.path.relpath(keccak.SOURCE, os.path.dirname(os.path.abspath(__file__)))}): "
          f"absorb {SPONGE_MB / absorb_s:.1f} MB/s; 14091 leaves of 256 B in one call {1e3 * rows_s:.2f}ms "
          f"({leaves.nbytes / 2**20 / rows_s:.1f} MB/s)")


def sponge_ab(torch, path):
    """A main path's prove and verify with the native sponge and with the
    pure-Python one, in turns (native, python, python, native; the
    transcript module's sponge swapped, then restored), the proofs equal:
    what the native sponge did to a path that hashes kilobytes."""
    from halo2_lasso_tpu_torch import transcript
    from halo2_lasso_tpu_torch.ops import keccak

    t0 = time.perf_counter()
    times, proofs = {"native": [], "python": []}, set()
    try:
        for sponge in ("native", "python", "python", "native"):
            transcript.Keccak256 = keccak.NativeKeccak256 if sponge == "native" else keccak.PyKeccak256
            t1 = time.perf_counter()
            proof = path["prove"]()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            path["verify"](proof)
            times[sponge].append((1e3 * (t2 - t1), 1e3 * (time.perf_counter() - t2)))
            proofs.add(proof)
    finally:
        transcript.Keccak256 = keccak.Keccak256
    if len(proofs) != 1:
        raise SystemExit("the proofs differ between the native and the pure-Python sponge")
    stage("sponge_ab", t0, "prove / verify ms, native then python sponge, in turns: " + "; ".join(
        f"{k} " + ", ".join(f"{p:.1f} / {v:.1f}" for p, v in ts) for k, ts in times.items()) +
        f"; {len(next(iter(proofs)))} bytes, equal")


def check_brakedown_encode(torch, np, pp):
    """The nv = 16 code's encode of BRAKEDOWN_ENCODE_ROWS random rows on the
    card (one pass, timed by events) against the same code (its matrices
    copied to the host) on the CPU's plain versions, bit for bit on the
    first 2 rows; the card's launches a pass printed."""
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fr
    from halo2_lasso_tpu_torch.pcs.brakedown import BrakedownCode, SparseMatrix
    from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, bound_ms, cuda_ms

    t0 = time.perf_counter()
    code = pp.code

    def host(x):
        return SparseMatrix(x.n, x.m, x.d, x.rows_idx, x.cols_idx, x.coeffs.cpu())

    cpu_code = BrakedownCode(code.row_len, code.n_0, code.spec, [host(x) for x in code.a], [host(x) for x in code.b])
    n = BRAKEDOWN_ENCODE_ROWS
    rng = np.random.RandomState(14)
    vals = [int.from_bytes(rng.bytes(40), "little") % Fr.modulus for _ in range(code.row_len * n)]
    rows = F.from_numpy_u32(Fr.canonical_limbs(np.array(vals, dtype=object))).reshape(code.row_len, n, F.LIMBS)
    dev_rows = rows.cuda()
    before = dict(native.counts)
    got = code.encode(dev_rows)
    torch.cuda.synchronize()
    per_pass = {k: native.counts[k] - before[k] for k in before if native.counts[k] != before[k]}
    want = cpu_code.encode(rows[:, :2])
    if not torch.equal(got[:, :2].cpu(), want):
        raise SystemExit("the Brakedown encode on the card differs from the CPU's")
    ms = cuda_ms(lambda: code.encode(dev_rows), 10)
    mats = code.a + code.b
    nnz = sum(len(x.rows_idx) for x in mats)
    products = (nnz + code.vandermonde.shape[0] * code.vandermonde.shape[1]) * n
    moved = (code.row_len + code.codeword_len) * n * 32 + nnz * (32 + 8)
    bound, by = bound_ms(moved, products * IMAD_PER_MONT_MUL)
    stage("brakedown_encode", t0, f"nv={pp.num_vars} code ({code.row_len} -> {code.codeword_len}, {nnz} matrix entries): "
          f"{n} rows on the card == CPU plain on 2 rows; {ms:.4f}ms a pass of {n} rows by events (bound {bound:.5f}ms, "
          f"{by}); launches a pass {json.dumps(per_pass)}")


def pcs_class(cfg):
    """The port's PCS class a config names (multilinear KZG by default)."""
    from halo2_lasso_tpu_torch.pcs.brakedown import MultilinearBrakedown
    from halo2_lasso_tpu_torch.pcs.gemini import Gemini
    from halo2_lasso_tpu_torch.pcs.hyrax import MultilinearHyrax, MultilinearHyraxGrumpkin
    from halo2_lasso_tpu_torch.pcs.ipa import MultilinearIpa, MultilinearIpaGrumpkin
    from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
    from halo2_lasso_tpu_torch.pcs.zeromorph import Zeromorph

    classes = (MultilinearKzg, Gemini, Zeromorph, MultilinearIpa, MultilinearHyrax, MultilinearIpaGrumpkin,
               MultilinearHyraxGrumpkin, MultilinearBrakedown)
    return {c.__name__: c for c in classes}[cfg.get("pcs", "MultilinearKzg")]


def sync_sites(torch, prove):
    """One more prove with every host sync counted by the innermost port
    function outside ops/field.py that made it (the syncs' kinds: round
    messages, MSM results, witness reads)."""
    import collections
    import traceback
    import warnings

    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "halo2_lasso_tpu_torch", "")
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        frames = [fr for fr in traceback.extract_stack()[:-1] if fr.filename.startswith(pkg)]
        site = next((fr for fr in reversed(frames) if not fr.filename.endswith(os.path.join("ops", "field.py"))),
                    frames[-1] if frames else None)
        sites["outside the package" if site is None else f"{os.path.relpath(site.filename, pkg)}:{site.name}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            prove()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sites.most_common())


# kernels launched (torch's own, never counted) inside a profiler session
# before the profiled prove: late in the smoke's process the profiler
# dropped a few K4 launches of a prove (5 of 128 in phase 7, 6 of 444 in
# phase 9, the same in every session, whatever the idle margin around the
# prove), which a fresh process recorded whole
PROFILE_WARMUP_LAUNCHES = 256


def profile_prove(torch, prove):
    """One more prove under torch.profiler: its wall time, the card's busy
    time, each hand kernel's device time and launches, the device-to-host
    and host-to-device copies, and the heaviest other device rows. Each hand
    kernel's launches in the profiler's rows must equal the prove's own
    count (``native.counts``): a session that saw no device time or lost a
    launch record is repeated, as utils/bench.py's device_ms does, and the
    run fails if none of PROFILER_SESSIONS is whole. A failure of the prove
    or of the profiler fails the run."""
    from halo2_lasso_tpu_torch.ops import native

    from halo2_lasso_tpu_torch.utils.bench import PROFILER_SESSIONS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(PROFILER_SESSIONS):
        with torch.profiler.profile(activities=acts) as prof:
            pad = torch.zeros(1, device="cuda")
            for _ in range(PROFILE_WARMUP_LAUNCHES):
                pad.add_(1)
            torch.cuda.synchronize()
            before = dict(native.counts)
            t0 = time.perf_counter()
            prove()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counted = {k: native.counts[k] - before[k] for k in native.KERNELS}
        # device-side rows only (kernels, copies, memsets): one stream, so
        # their sum is the time the card was busy
        dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        hand, other = {k: [0.0, 0] for k in native.KERNELS}, []
        for e in dev:
            name = next((k for k, sym in native.SYMBOLS.items() if re.search(rf"(^|\W){sym}\s*[<(]", e.key)), None)
            if name is None:
                other.append(e)
            else:
                hand[name][0] += e.self_device_time_total / 1e3
                hand[name][1] += e.count
        lost = {k: (hand[k][1], n) for k, n in counted.items() if hand[k][1] != n}
        seen.append(lost)
        if busy_ms > 0 and not lost:
            break
    else:
        raise SystemExit(f"the profiler saw no device time, or other launch counts than the prove's "
                         f"(profiler, counted) by session: {seen}")
    copies = {d: [0.0, 0] for d in ("DtoH", "HtoD")}
    for e in dev:
        for d in copies:
            if e.key.startswith(f"Memcpy {d}"):
                copies[d][0] += e.self_device_time_total / 1e3
                copies[d][1] += e.count
    top = sorted(other, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms, "sessions": len(seen),
        "hand_kernels": {k: {"ms": v[0], "launches": v[1]} for k, v in hand.items()},
        "copies": {d: {"ms": v[0], "count": v[1]} for d, v in copies.items()},
        "top_other": [{"key": e.key[:64], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in top],
    }


def ptxas_lines(info):
    """Registers, shared memory and spills per kernel from -Xptxas -v."""
    out, fn = [], None
    for line in info.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("Used" in line or "spill" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


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


def make_circuit(np, cfg, **kwargs):
    """(circuit info, circuit) of a config: a fixture of
    backend/hyperplonk/fixtures.py with its seeds' RandomStates, the ARX
    chain of frontend/arx.py, the builder's copy circuit, or the vanilla
    fixture with its first gate raised to a degree (``raise_gate``)."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.frontend import arx, builder

    name = cfg["circuit"]
    if name == "builder_copy_circuit":
        return builder_copy_circuit(builder.CircuitBuilder, builder.P)
    if name == "raised_gate_circuit":
        ci, circuit = fixtures.rand_vanilla_plonk_circuit(
            cfg["num_vars"], *(np.random.RandomState(s) for s in cfg["seeds"]), **kwargs)
        return raise_gate(ci, Expression, cfg["gate_degree"]), circuit
    fn = arx.arx_chain_circuit if name == "arx_chain_circuit" else getattr(fixtures, name)
    return fn(cfg["num_vars"], *(np.random.RandomState(s) for s in cfg.get("seeds", ())),
              **cfg.get("kwargs", {}), **kwargs)


def raise_gate(ci, Expression, degree):
    """The circuit info `ci` with its first gate multiplied by poly(0) up to
    `degree` (the zero check's sumcheck one more): the witness still
    satisfies it. `Expression` is its package's class, so the JAX
    package's circuit is raised the same way in the tests."""
    q = ci.constraints[0]
    for _ in range(degree - q.degree):
        q = q * Expression.poly(0)
    ci.constraints = [q] + list(ci.constraints[1:])
    ci.max_degree = max(ci.max_degree, degree)
    return ci


def builder_copy_circuit(CircuitBuilder, P):
    """The copy circuit of tests/test_frontend.py::test_builder_e2e, through
    either package's CircuitBuilder: k = 3, an instance column with no
    values, a selector, advice columns a, b, c, the gate q * (a + b - c) on
    rows 0..4, and four copies c_i = a_(i+1)."""
    k, rows = 3, 5
    b = CircuitBuilder(k)
    b.instance_column()
    q = b.selector()
    a, bcol, c = (b.advice_column() for _ in range(3))
    b.max_degree = 4
    b.gate("add", lambda ctx: ctx.expr(q) * (ctx.expr(a) + ctx.expr(bcol) - ctx.expr(c)))
    a_vals, b_vals, c_vals = [3] + [0] * (rows - 1), [4, 5, 6, 7, 8], []
    for i in range(rows):
        c_vals.append((a_vals[i] + b_vals[i]) % P)
        if i + 1 < rows:
            a_vals[i + 1] = c_vals[i]
            b.copy(c, i, a, i + 1)
    pad = [0] * ((1 << k) - rows)
    fixed = {(q.index, r): 1 for r in range(rows)}
    return b.build(fixed, lambda phase, challenges: [a_vals + pad, b_vals + pad, c_vals + pad], [[]])


def arx_programs(np):
    """The round programs of the full-width ARX chain (built at k = 5, the
    same gates and tables): its zero check, and its largest GKR batch, which
    batches the read and write grand products of every memory of its Lasso
    layouts, one pure grand product each. Returns {name: (expression, leaf
    keys, program, challenges)}, with the number of challenges each round
    reads (beta, gamma, alpha; the batch's gamma)."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import preprocessor
    from halo2_lasso_tpu_torch.lasso.integration import LassoLayout
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.piop import sum_check as SC

    ci, _ = make_circuit(np, {**ARX, "num_vars": 5})
    nz, expr = preprocessor.compose(ci)
    n_polys = ci.num_poly() + preprocessor.num_lasso_polys(ci) + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz
    keys = SC._leaf_keys(expr, n_polys)
    nb = 2 * sum(len(LassoLayout(lk).mems) for lk in ci.lasso_lookups)
    gexpr = gkr.sum_check_expression_pure(nb)
    gkeys = SC._leaf_keys(gexpr, 2 * nb)
    return {"zero check": (expr, keys, SC.lower_expression(expr, keys), 3),
            "GKR batch": (gexpr, gkeys, SC.lower_expression(gexpr, gkeys), 1)}


def check_arx_shape(np, cfg):
    """The full-width ARX chain's circuit info (built at a small k, the same
    gates and tables) against ARX_SHAPE, and the round programs of its zero
    check and its largest GKR batch within K1's compiled limits."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import preprocessor
    from halo2_lasso_tpu_torch.piop import sum_check as SC

    t0 = time.perf_counter()
    ci, _ = make_circuit(np, {**cfg, "num_vars": 5})
    shape = {"selectors": len(ci.preprocess_polys), "advice": ci.num_witness_polys, "gates": len(ci.constraints),
             "lasso_tables": [lk.table.name for lk in ci.lasso_lookups]}
    if shape != ARX_SHAPE:
        raise SystemExit(f"the ARX chain's shape is {shape}, not {ARX_SHAPE}")
    progs = arx_programs(np)
    for what, (_, keys, prog, _) in progs.items():
        if len(keys) > SC.MAX_LEAVES or len(prog.ops) > SC.MAX_OPS or len(prog.consts) > SC.MAX_CONSTS:
            raise SystemExit(f"the ARX chain's {what} exceeds K1's compiled limits")
    expr, keys, prog, _ = progs["zero check"]
    _, gkeys, gprog, _ = progs["GKR batch"]
    mems = sum(len(lk.table.memories) for lk in ci.lasso_lookups)
    stage("arx_shape", t0, f"{json.dumps(shape)}, {mems} Lasso memories, {preprocessor.num_lasso_polys(ci)} Lasso "
          f"polys; zero check {len(keys)} leaves, {len(prog.ops)} ops, {len(prog.consts)} constants, stack "
          f"{prog.max_stack}, degree {expr.degree}; largest GKR batch {len(gkeys)} leaves, {len(gprog.ops)} ops")


def hyperplonk_proof(np, cfg, device, tamper=False, cheat=False, extra=None):
    """Setup, preprocess, prove and verify one HyperPlonk proof of a config's
    circuit under the PCS it names, over that PCS's field (the fixture's
    `field`, BN254 Fq for the grumpkin-backed PCS); returns (proof bytes,
    stage records).
    With `cheat`, a proof of the circuit's cheating witness (its
    `cheat=True`) must be rejected. `extra`, a dict, receives the prover's
    kernel launches and what a second prove needs."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import hyperplonk
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fr
    from halo2_lasso_tpu_torch.utils.timer import timed

    timed.clear()
    backend = hyperplonk(pcs_class(cfg))
    with timed.scope("fixture" if "seeds" in cfg else "build"):
        ci, circuit = make_circuit(np, cfg, **({} if backend.field is Fr else {"field": backend.field}))
    with timed.scope("setup"):
        param = backend.setup(ci, np.random.RandomState(cfg["setup_seed"]), device=device)
    pp, vp = backend.preprocess(param, ci)
    tw = backend.transcript()
    before = dict(native.counts)
    backend.prove(pp, circuit, tw)
    if extra is not None:
        def prove_again():
            t = backend.transcript()
            backend.prove(pp, circuit, t)
            return t.into_proof()

        extra.update(pp=pp, vp=vp, prove=prove_again,
                     verify=lambda p: backend.verify(vp, circuit.instances(), backend.transcript(p)),
                     prove_launches={k: native.counts[k] - before[k] for k in before})
    proof = tw.into_proof()
    backend.verify(vp, circuit.instances(), backend.transcript(proof))
    if tamper:
        rejects_flipped_byte(lambda bad: backend.verify(vp, circuit.instances(), backend.transcript(bad)), proof)
    records = timed.records()
    if cheat:
        rejects_cheat(np, cfg, pp, vp)
    return proof, records


def rejects_cheat(np, cfg, pp, vp):
    """A proof of the config's cheating witness (its circuit's `cheat=True`)
    must be rejected."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript
    from halo2_lasso_tpu_torch.errors import Halo2LassoError

    _, liar = make_circuit(np, cfg, cheat=True)
    tw = new_transcript()
    HyperPlonk.prove(pp, liar, tw)
    try:
        HyperPlonk.verify(vp, liar.instances(), new_transcript(tw.into_proof()))
    except Halo2LassoError:
        return
    raise SystemExit("a proof of the cheating witness was accepted")


def lasso_indices(np, cfg):
    """The lookup indices of a standalone Lasso config: uniform below
    2^index_bits, or for a two-operand table (x << bits) | y with the x
    operands drawn first, then the y operands."""
    rng = np.random.RandomState(cfg["index_seed"])
    m = cfg["lookups"]
    if "table" not in cfg:
        return [int(rng.randint(1 << cfg["index_bits"])) for _ in range(m)]
    bits = cfg["table"][1]
    x, y = (rng.randint(0, 1 << bits, size=m, dtype=np.uint64 if bits > 32 else np.int64) for _ in range(2))
    return [(int(a) << bits) | int(b) for a, b in zip(x, y)]


def lasso_table(cfg):
    from halo2_lasso_tpu_torch.lasso import tables

    if "table" in cfg:
        name, *args = cfg["table"]
        return getattr(tables, name)(*args)
    return tables.range_table(cfg["index_bits"], cfg["chunk_bits"])


def lasso_proof(np, cfg, device, tamper=False, extra=None):
    """Setup, prove and verify one standalone Lasso proof over the PCS the
    config names; returns (proof bytes, stage records). With `tamper`, a
    proof with one flipped byte must fail. `extra`, a dict, receives the
    prover's kernel launches, a second prove (returning its proof) and the
    verifier."""
    from halo2_lasso_tpu_torch.lasso import prove, verify
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import FQ_MODULUS, Fr
    from halo2_lasso_tpu_torch.transcript import Keccak256Transcript
    from halo2_lasso_tpu_torch.utils.timer import timed

    def transcript(proof=None):
        return Keccak256Transcript(Fr.modulus, base_modulus=FQ_MODULUS, proof=proof, curve_b=3)

    table = lasso_table(cfg)
    nv_m = cfg["lookups"].bit_length() - 1
    nv = max(nv_m, table.memories[0].subtable.index_bits)
    indices = lasso_indices(np, cfg)
    pcs = pcs_class(cfg)
    timed.clear()
    with timed.scope("lasso_setup"):
        param = pcs.setup(1 << nv, np.random.RandomState(cfg["srs_seed"]), device=device)
        pp, vp = pcs.trim(param, 1 << nv)
    tw = transcript()
    before = dict(native.counts)
    prove(pp, table, indices, tw, pcs=pcs, device=device)
    if extra is not None:
        def prove_again():
            t = transcript()
            prove(pp, table, indices, t, pcs=pcs, device=device)
            return t.into_proof()

        extra.update(prove=prove_again, verify=lambda p: verify(vp, table, nv_m, transcript(p), pcs=pcs),
                     prove_launches={k: native.counts[k] - before[k] for k in before}, param=param, table=table,
                     indices=indices, transcript=transcript)
    proof = tw.into_proof()
    verify(vp, table, nv_m, transcript(proof), pcs=pcs)
    if tamper:
        rejects_flipped_byte(lambda bad: verify(vp, table, nv_m, transcript(bad), pcs=pcs), proof)
    return proof, timed.records()


def run_support_phase(torch, np, launches, plonk_path, slice_path, smi, fresh, device="cuda", n=1 << 16,
                      split=None):
    """Phase 16: (1) a GKR batch past K1's compiled limits at nv = 16 on the
    card, cut into chunks of whole terms: K1 launched chunks x rounds, each
    chunk's program bit-exact against ``round_message_plain`` at the first
    round's shape, the nv = 6 proof the JAX package's; (2) phase 7's nv = 16 KZG params and phase 5's Lasso set-up saved
    and loaded back onto the card, their proves equal to those phases'
    proofs and verified under the reloaded params, and phase 6's golden
    circuit proved from reloaded params; (3) one 2^16 MSM on bench.py:100's
    inputs through the production MSM, ``msm_affine`` and the scan MSM, and
    an nv = 16 KZG open's quotient MSMs with and without the segmented
    grouping: the same points, with their launches; their device ms come
    from `fresh`, which the caller runs (``print_engines``). Returns the
    engines' report. A CPU rehearsal passes device "cpu", a small `n` and a
    small `split` config, and takes no device time."""
    import tempfile

    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript
    from halo2_lasso_tpu_torch.lasso import prove as lasso_prove
    from halo2_lasso_tpu_torch.lasso import verify as lasso_verify
    from halo2_lasso_tpu_torch.ops import ec, msm_affine, msm_scan, native
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops.bn254 import G1_GEN, Fq, Fr
    from halo2_lasso_tpu_torch.pcs.multilinear_kzg import MultilinearKzg
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.utils import serialize as ser

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (1) the split GKR batch: K1 once a chunk a round
    cfg = split or SPLIT_GKR
    expr = gkr.sum_check_expression_pure(cfg["products"])
    keys = SC._leaf_keys(expr, 2 * cfg["products"])
    plan = SC.plan_round(expr, keys, Fr.modulus, 1)
    if plan.program is not None:
        raise SystemExit("the split GKR batch fits the round kernel: nothing is split")
    rounds = []
    real_prove = SC.prove

    def counting_prove(spec, num_vars, *args):
        rounds.append(num_vars)
        return real_prove(spec, num_vars, *args)

    t0 = time.perf_counter()
    native.reset_counts()
    SC.prove = counting_prove
    try:
        proof, _ = split_gkr_proof(np, cfg, device)
    finally:
        SC.prove = real_prove
    sync()
    launches["split_gkr"] = counts = dict(native.counts)
    want = len(plan.chunks) * sum(rounds)
    if on_card and counts["sumcheck_round"] != want:
        raise SystemExit(f"the split GKR batch launched K1 {counts['sumcheck_round']} times, not {len(plan.chunks)} "
                         f"chunks x {sum(rounds)} rounds = {want}")
    stage("split_gkr", t0, f"{cfg['products']} grand products at nv={cfg['num_vars']}: {len(keys)} leaves a round "
          f"in {len(plan.chunks)} chunks ({', '.join(f'{len(c.leaves)} leaves {len(c.program.ops)} ops' for c in plan.chunks)}), "
          f"K1 {counts['sumcheck_round']} = chunks x {sum(rounds)} rounds, sum_reduce {counts['sum_reduce']}, "
          f"{len(proof)} bytes, verified")
    h = 1 << (cfg["num_vars"] - 2)  # the first round of the largest layer: 2^(nv-1) rows, 2^(nv-2) pairs
    rng = np.random.RandomState(16)
    chal = rand_field_rows(np, Fr, rng, len(plan.challenge_rows(Fr.modulus, [1])), dev)
    tables = [rand_field_rows(np, Fr, rng, 2 * h, dev) for _ in keys]
    for i, chunk in enumerate(plan.chunks):
        leaves = [tables[j] for j in chunk.leaves]
        got = SC.round_message(Fr, leaves, chunk.program, chal, expr.degree)
        if not torch.equal(got, SC.round_message_plain(Fr, leaves, chunk.program, chal, expr.degree)):
            raise SystemExit(f"K1 disagrees with its plain version on chunk {i} of the split GKR batch")
    del tables
    sha = hashlib.sha256(split_gkr_proof(np, cfg, device, 6)[0]).hexdigest()
    if sha != SPLIT_SHA256:  # tests/test_torch_round_split.py holds the CPU's to it
        raise SystemExit(f"split GKR nv=6 proof mismatch: {sha}")
    print(f"  each chunk's program bit-exact against round_message_plain at 2^{h.bit_length() - 1} pairs; nv=6 proof "
          f"sha256 {sha[:16]} == JAX", flush=True)

    # (2) parameter files, reloaded onto the card
    t_files = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "plonk")
        t0 = time.perf_counter()
        ser.save_hyperplonk_params(base, plonk_path["pp"], plonk_path["vp"])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pp, vp = ser.load_hyperplonk_params(base, device)
        sync()
        load_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(base + e) for e in (".npz", ".json"))
        _, circuit = make_circuit(np, plonk_path["cfg"])
        native.reset_counts()
        tw = new_transcript()
        HyperPlonk.prove(pp, circuit, tw)
        launches["files_plonk"] = dict(native.counts)
        if tw.into_proof() != plonk_path["proof"]:
            raise SystemExit("the prove from reloaded nv=16 params differs from phase 7's proof")
        HyperPlonk.verify(vp, circuit.instances(), new_transcript(plonk_path["proof"]))
        print(f"  files: phase 7's nv=16 pp/vp {nbytes} bytes, save {save_s:.2f}s, load onto the card "
              f"{load_s:.2f}s; the reloaded prove == phase 7's proof, verified under the reloaded vp", flush=True)

        base = os.path.join(tmp, "lasso")
        cfg5 = slice_path["cfg"]
        t0 = time.perf_counter()
        ser.save_lasso_setup(base, slice_path["table"], slice_path["param"])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        table, param = ser.load_lasso_setup(base, device)
        sync()
        load_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(base + e) for e in (".npz", ".json", ".lasso.json"))
        nv_m = cfg5["lookups"].bit_length() - 1
        nv = max(nv_m, table.memories[0].subtable.index_bits)
        lpp, lvp = MultilinearKzg.trim(param, 1 << nv)
        native.reset_counts()
        tw = slice_path["transcript"]()
        lasso_prove(lpp, table, slice_path["indices"], tw, pcs=MultilinearKzg, device=device)
        launches["files_lasso"] = dict(native.counts)
        if tw.into_proof() != slice_path["proof"]:
            raise SystemExit("the prove from the reloaded Lasso set-up differs from phase 5's proof")
        lasso_verify(lvp, table, nv_m, slice_path["transcript"](slice_path["proof"]), pcs=MultilinearKzg)
        print(f"  files: phase 5's Lasso set-up ({table.spec}) {nbytes} bytes, save {save_s:.2f}s, load "
              f"{load_s:.2f}s; the reloaded prove == phase 5's proof, verified under the reloaded params", flush=True)

        base = os.path.join(tmp, "golden")
        ci, circuit = make_circuit(np, PLONK_SMALL)
        gpp, gvp = HyperPlonk.preprocess(HyperPlonk.setup(ci, np.random.RandomState(PLONK_SMALL["setup_seed"]),
                                                          device=device), ci)
        ser.save_hyperplonk_params(base, gpp, gvp)
        gpp, gvp = ser.load_hyperplonk_params(base, device)
        tw = new_transcript()
        HyperPlonk.prove(gpp, circuit, tw)
        golden = tw.into_proof()
        HyperPlonk.verify(gvp, circuit.instances(), new_transcript(golden))
        if hashlib.sha256(golden).hexdigest() != GOLDEN_SHA256:
            raise SystemExit("the nv=3 golden circuit proved from reloaded params does not hash to GOLDEN_SHA256")
        print(f"  files: the nv=3 golden circuit from reloaded params: sha256 {GOLDEN_SHA256[:16]} == JAX", flush=True)
    stage("files", t_files, "phase 7's params, phase 5's set-up and phase 6's golden circuit through files")

    # (3) the MSM engines on bench.py:100's inputs
    t_engines = time.perf_counter()
    rng = np.random.RandomState(5)
    ms = [int(v) for v in rng.randint(1, 1 << 30, size=n)]
    points = ec.fixed_base_msm(G1_GEN, Fr.encode(ms, dev))
    scal = Fr.encode([int.from_bytes(rng.bytes(40), "little") % Fr.modulus for _ in range(n)], dev)
    engines = {"msm": lambda: MJ.msm_planes(points, scal, Fq, Fr),
               "affine": lambda: msm_affine.msm_affine(points, scal, Fq, Fr),
               "scan": lambda: msm_scan.msm_pallas(points, scal, Fq, Fr)}
    want = ec.msm_to_affine_int(points, scal)
    report = {}
    for name, call in engines.items():
        t0 = time.perf_counter()
        native.reset_counts()
        out = call()
        sync()
        launches[f"msm_{name}"] = counts = dict(native.counts)
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = want if name == "msm" else ec.jacobian_to_affine(out)[0]
        if got != want:
            raise SystemExit(f"the {name} MSM engine's point differs from the production MSM's")
        expect = {native.SYMBOLS[k]: counts[k] for k in native.KERNELS if counts[k]}
        fresh.add(name, name, {"points": points, "scal": scal, "base": Fq.kernel_id}, expect)
        report[name] = {"wall_ms": wall_ms, "launches": {k: counts[k] for k in native.KERNELS if counts[k]}}

    # the quotient MSMs of an nv = 16 KZG open, ungrouped and grouped
    kzg_pp = plonk_path["pp"].pcs
    rng = np.random.RandomState(17)
    kv = kzg_pp.num_vars
    quotients, _ = MultilinearKzg.quotient_polys(rand_field_rows(np, Fr, rng, 1 << kv, dev),
                                                 [int(v) for v in rng.randint(1, 1 << 62, size=kv)])
    jobs = [(kzg_pp.eqs[i], q) for i, q in quotients]
    for name, budget in (("quotients", 0), ("quotients_grouped", SEG_LANES)):
        os.environ["HALO2_LASSO_TPU_MSM_GROUP_LANES"] = str(budget)
        try:
            t0 = time.perf_counter()
            native.reset_counts()
            got = ec.msm_list_to_affine_int(jobs)
            launches[f"msm_{name}"] = counts = dict(native.counts)
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            os.environ.pop("HALO2_LASSO_TPU_MSM_GROUP_LANES")
        if name == "quotients":
            want_q = got
        elif got != want_q:
            raise SystemExit("the grouped quotient MSMs' points differ from the ungrouped ones'")
        expect = {native.SYMBOLS[k]: counts[k] for k in native.KERNELS if counts[k]}
        fresh.add(name, "msm_list", {"jobs": jobs, "budget": budget, "base": Fq.kernel_id}, expect)
        report[name] = {"wall_ms": wall_ms, "launches": {k: counts[k] for k in native.KERNELS if counts[k]}}
    stage("engines", t_engines, "three engines and the quotient MSMs run and compared")
    stage("support", t_phase, f"split GKR, files, engines: the production, affine and scan MSMs' 2^16 points "
          f"equal; {len(jobs)} quotient MSMs equal grouped (budget {SEG_LANES} lanes) and not")
    return report


def print_engines(report, fresh, smi):
    """Phase 16's engines, once `fresh` has run: wall and device ms and
    launches of each."""
    for name, r in report.items():
        r["device_ms"] = fresh.results.get(name, {})
        print(f"  engine {name}: wall {r['wall_ms']:.1f}ms, device (fresh process) "
              + ", ".join(f"{k} {v:.4f}ms" for k, v in r["device_ms"].items())
              + f"; launches {json.dumps(r['launches'])} | {smi}", flush=True)


def run_degree_phase(torch, np, launches, smi, device="cuda"):
    """Phase 17, part 1: sumchecks past the round kernel's MAX_DEGREE (8),
    each round in chunks of points (piop/sum_check.py ``plan_round``).
    (1) lt_table(64, 8) at 2^16 lookups (LT64: a 64-bit unsigned compare in
    8-bit chunks, a primary sumcheck of degree 9, two launches a round):
    set-up, prove, verify, a flipped byte rejected; and the same for
    lt_table(56, 8) at 2^16 (LT56: degree 8, one launch a round).
    LT64's prove must launch K1 exactly the primary sumcheck's rounds more
    than LT56's (the same subtables, one chunk fewer: the GKR batches launch
    alike). (2) The small twins on the card, hashing to the JAX package's
    proofs: lt_table(16, 2) at 8 lookups (LT16_SHA256) and the nv = 3
    vanilla circuit with a gate of degree 8 (DEGREE9_SHA256); the CPU
    parity is tests/test_torch_lasso_lt.py's and
    tests/test_torch_round_split.py's. A CPU rehearsal passes device "cpu"
    (and small configs) and skips the twins."""
    t_phase = time.perf_counter()
    paths = {}
    for path, cfg, label in (("lasso_lt64", LT64, "2^16 lookups lt_table(64,8): a primary sumcheck of degree 9"),
                             ("lasso_lt56", LT56, "2^16 lookups lt_table(56,8): a primary sumcheck of degree 8")):
        extra = paths[path] = {}
        run_path(launches, path, path, label, lambda: lasso_proof(np, cfg, device, tamper=True, extra=extra))
    k1 = {path: extra["prove_launches"]["sumcheck_round"] for path, extra in paths.items()}
    rounds = LT64["lookups"].bit_length() - 1
    if k1["lasso_lt64"] != k1["lasso_lt56"] + rounds:
        raise SystemExit(f"the lt_table(64,8) prove launched K1 {k1['lasso_lt64']} times, not lt_table(56,8)'s "
                         f"{k1['lasso_lt56']} and one more for each of the primary sumcheck's {rounds} rounds")
    print(f"  K1 in prove: lt_table(64,8) {k1['lasso_lt64']} (the primary sumcheck's {rounds} rounds in two chunks "
          f"of points each, t0 = 0 and 8), lt_table(56,8) {k1['lasso_lt56']} (one launch a round) | {smi}", flush=True)
    if device == "cuda":
        prof = profile_prove(torch, paths["lasso_lt64"]["prove"])
        print("  lt_table(64,8)'s second prove under torch.profiler: " + json.dumps(prof), flush=True)
    if device == "cuda":
        proof_gate(np, lasso_proof, LT16_SMALL, LT16_SHA256, "lt16_small", "lt_table(16,2), 8 lookups, degree 9",
                   cpu=False)
        proof_gate(np, hyperplonk_proof, DEGREE9_SMALL, DEGREE9_SHA256, "degree9_small",
                   "nv=3 vanilla with a gate of degree 8, a zero check of degree 9", cpu=False)
    stage("degree", t_phase, "lt_table(64,8) proved on the card in point chunks; the small twins == JAX")


def wide_product(Expression, tables):
    """poly(0) * poly(1) * ... * poly(tables - 1), left-deep: one term of
    `tables` leaf tables and degree `tables` (either package's class)."""
    expr = Expression.poly(0)
    for i in range(1, tables):
        expr = expr * Expression.poly(i)
    return expr


def wide_product_inputs(np, cfg, num_vars):
    """The wide product's tables: cfg["tables"] rows of 2^num_vars values
    below 2^62 from RandomState(cfg["seed"])."""
    rng = np.random.RandomState(cfg["seed"])
    return rng.randint(1, 1 << 62, size=(cfg["tables"], 1 << num_vars), dtype=np.int64)


def wide_product_proof(np, cfg, device, tamper=False, extra=None):
    """The wide product's sum over the hypercube at cfg["num_vars"] on
    `device`: the claim (``evaluate_torch`` over the whole tables and a row
    sum), ``sum_check.prove``, then ``sum_check.verify`` with its final
    evaluation held to the product of the tables' own evaluations at the
    challenges (``mle.evaluate_stacked_ints``; the prover's must equal
    them); with `tamper`, a proof with one flipped byte must fail. Returns
    (proof bytes, stage records); `extra`, a dict, receives the claim and
    the prove's launches and ms."""
    from halo2_lasso_tpu_torch.expression import Expression, Query, evaluate_torch, hypercube_leaves
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle
    from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

    nv, p = cfg["num_vars"], Fr.modulus
    records = []

    def stage_ms(name, t0):
        records.append((name, (time.perf_counter() - t0) * 1e3))

    t0 = time.perf_counter()
    polys = list(F.encode_dev(Fr, wide_product_inputs(np, cfg, nv), device).unbind(0))
    expr = wide_product(Expression, cfg["tables"])
    values = evaluate_torch(Fr, expr, hypercube_leaves(Fr, nv, polys), [], device)
    claim = Fr.decode_ints(F.sum_reduce(Fr, values)[None])[0]
    del values
    stage_ms("claim", t0)
    tw = Keccak256Transcript(p)
    before = dict(native.counts)
    t0 = time.perf_counter()
    x, evals = SC.prove(Fr, nv, SC.VirtualPolynomial(expr, polys, [], []), claim, tw)
    stage_ms("prove", t0)
    if extra is not None:
        extra.update(claim=claim, prove_ms=records[-1][1],
                     prove_launches={k: native.counts[k] - before[k] for k in before})
    proof = tw.into_proof()

    def verify(proof):
        final, xs = SC.verify(p, nv, expr.degree, claim, Keccak256Transcript(p, proof=proof))
        own = mle.evaluate_stacked_ints(Fr, polys, xs)
        if final != SC.evaluate_at_point(expr, p, nv, {Query(i): v for i, v in enumerate(own)}, [], [], xs):
            raise SC.SumcheckError("the final evaluation is not the product of the tables' evaluations")
        return xs, own

    t0 = time.perf_counter()
    if verify(proof) != (x, evals):
        raise SystemExit("the prover's challenges or final evaluations differ from the verifier's")
    stage_ms("verify", t0)
    if tamper:
        rejects_flipped_byte(verify, proof)
    return proof, records


def evaluated_launches(SC, plan, pairs, tables):
    """The launches by kernel of rounds of ``sum_check.prove`` over `tables`
    leaf tables under a split `plan`, one round for each of `pairs` (its
    tables' pairs): each chunk of points launches K1 once a term chunk, one
    row sum adding the parts and, for each evaluated term, K2 at each of its
    points once for each FOLD_MAX_TABLES of its tables, then a pass of
    ``point_batch`` points at a time (its ``field_ops`` of K4 and one row
    sum; a term that reads no table: one more K4, the product by half, and
    no row sum) and one K4 product by its coefficient; and each round folds
    every table."""
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    def groups(n):
        return -(-n // mle.FOLD_MAX_TABLES)

    r = {"sumcheck_round": 0, "fold_all": 0, "mont_mul": 0, "sum_reduce": 0}
    for h in pairs:
        r["fold_all"] += groups(tables)
        for _, d in plan.points:
            r["sumcheck_round"] += len(plan.chunks)
            r["sum_reduce"] += 1
            for e in plan.evaluated:
                passes = -(-d // SC.point_batch(e, h))
                r["fold_all"] += d * groups(len(e.leaves)) if e.leaves else 0
                r["mont_mul"] += passes * (e.field_ops + (0 if e.leaves else 1)) + 1
                r["sum_reduce"] += passes if e.leaves else 0
    return r


def run_wide_phase(torch, np, launches, smi, device="cuda", cfg=None):
    """Phase 18: one term past the round kernel's limits. (1) The product of
    WIDE["tables"] (MAX_LEAVES + 1) tables at WIDE["num_vars"] on the card
    (a main path, "wide_product"): claim, prove, verify, a flipped byte
    rejected. Its plan holds no chunk for K1, one evaluated term; the
    prove's launches of K1 (none), K2, K4 and the row sum must be the
    plan's (``evaluated_launches``), and are printed with its ms and the
    card's name and power limit. (2) The nv = 3 twin on the card, alone and
    on SHARDS virtual shards of it (its first round's message a shard at a
    time), hashing to the JAX package's proof (WIDE_SHA256;
    tests/test_torch_round_split.py holds the CPU's to it). A CPU rehearsal
    passes device "cpu" and a small `cfg`; it skips the launch gate and the
    twins."""
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.ops.bn254 import Fr
    from halo2_lasso_tpu_torch.parallel import sharding
    from halo2_lasso_tpu_torch.piop import sum_check as SC

    cfg = cfg or WIDE
    t_phase = time.perf_counter()
    expr = wide_product(Expression, cfg["tables"])
    plan = SC.plan_round(expr, SC._leaf_keys(expr, cfg["tables"]), Fr.modulus, 0)
    if plan.program is not None or plan.chunks or len(plan.evaluated) != 1:
        raise SystemExit(f"the product of {cfg['tables']} tables is not one evaluated term")
    extra = {}
    run_path(launches, "wide_product", "wide_product",
             f"the product of {cfg['tables']} tables at nv={cfg['num_vars']}, degree {expr.degree}: one term past "
             f"the round kernel's {SC.MAX_LEAVES} leaves",
             lambda: wide_product_proof(np, cfg, device, tamper=True, extra=extra))
    nv = cfg["num_vars"]
    want = evaluated_launches(SC, plan, [1 << (nv - 1 - r) for r in range(nv)], cfg["tables"])
    got = {k: extra["prove_launches"][k] for k in want}
    if device == "cuda" and got != want:
        raise SystemExit(f"the wide product's prove launched {got}, not its plan's {want}")
    ev = plan.evaluated[0]
    print(f"  prove {extra['prove_ms']:.1f}ms, launches {json.dumps(got)} == the plan's: no term chunk, one "
          f"evaluated term of {len(ev.leaves)} tables, {ev.field_ops} K4 a pass of up to "
          f"{SC.point_batch(ev, 1 << (nv - 1))} points, {len(plan.points)} chunks of points a round | {smi}",
          flush=True)
    if device == "cuda":
        proof_gate(np, wide_product_proof, {**cfg, "num_vars": 3}, WIDE_SHA256, "wide_small",
                   f"the product of {cfg['tables']} tables at nv=3", cpu=False)

        def on_mesh(np, cfg, device):
            with sharding.use_mesh(sharding.Mesh([torch.device(device, 0)] * SHARDS)):
                return wide_product_proof(np, cfg, device)

        proof_gate(np, on_mesh, {**cfg, "num_vars": 3}, WIDE_SHA256, "wide_small_sharded",
                   f"the same on {SHARDS} virtual shards of the card", cpu=False)
    stage("wide", t_phase, f"one term past the round kernel's limits proved, verified, tamper rejected | {smi}")


def run_pasta_phase(torch, np, launches, smi, fresh, device="cuda", n=1 << 16, lanes=1 << 15):
    """Phase 17, part 2: the Pasta curves' instances of K4 and K3. For each
    of Pallas and Vesta, a main path ("pasta_<curve>", counts reset just
    before, its kernels ``native.PASTA_KERNELS`` and their instances for the
    curve): 2^n points by ``fixed_base_msm`` over the generator and
    Montgomery scalars from RandomState(5) as bench.py:100 draws them
    (reduced mod the scalar field); the production variable_base_msm
    (msm_level and plane_tree) equal to ``msm_affine``'s point in affine and
    on the curve; the ladder at the IPA scaling shape (`lanes` lanes, every
    9th the identity, a shared scalar), 64 lanes of it against
    ``curves.host_mul``. Then ``check_pasta_instances`` holds every Pasta
    instance bit-exact against its plain version, and the kernels without a
    Pasta instance must raise. Device times go to `fresh`, each beside its
    BN254 twin's; the caller runs it. Returns the instances' records for
    the kernels line, and the point-chunk timings of K1. A CPU rehearsal
    passes device "cpu" and small sizes, with the timing helpers stubbed:
    it checks nothing that needs the card."""
    from halo2_lasso_tpu_torch.ops import curves, ec, msm_affine, native
    from halo2_lasso_tpu_torch.ops import field as F

    dev = torch.device(device)
    t_phase = time.perf_counter()
    results, k1_timed = {}, {}
    for curve in (curves.PALLAS, curves.VESTA):
        base, scalar = curve.base, curve.scalar
        path = f"pasta_{curve.name}"
        PATH_KERNELS[path] = native.PASTA_KERNELS + tuple(f"{k}.{curve.name}" for k in native.PASTA_KERNELS)
        t0 = time.perf_counter()
        native.reset_counts()
        F.norm_on_card = 0
        rng = np.random.RandomState(5)
        ms = [int(v) for v in rng.randint(1, 1 << 30, size=n)]
        points = ec.fixed_base_msm(curve.generator, scalar.encode(ms, dev), base=base, scalar=scalar)
        scal = scalar.encode([int.from_bytes(rng.bytes(40), "little") % scalar.modulus for _ in range(n)], dev)
        t_msm = time.perf_counter()
        got = ec.jacobian_to_affine(ec.variable_base_msm(points, scal, base, scalar), base)[0]
        msm_ms = (time.perf_counter() - t_msm) * 1e3
        t_aff = time.perf_counter()
        ref = ec.jacobian_to_affine(msm_affine.msm_affine(points, scal, base, scalar), base)[0]
        affine_ms = (time.perf_counter() - t_aff) * 1e3
        if got != ref or not curves.on_curve(curve, *got):
            raise SystemExit(f"the 2^{n.bit_length() - 1} {curve.name} MSM differs from msm_affine's or is off "
                             "the curve")
        lp = {k: v[:lanes].clone() for k, v in points.items()}
        lp["z"][::9] = 0
        k = int.from_bytes(rng.bytes(32), "little") % scalar.modulus
        lad = ec.ec_ladder(lp, k, scalar.num_bits, base)
        sample = torch.arange(0, lanes, max(1, lanes // 64), device=dev)
        bases = ec.jacobian_to_affine({c: v[sample] for c, v in lp.items()}, base)
        want = [curves.host_mul(curve, p, k) for p in bases]
        if ec.jacobian_to_affine({c: v[sample] for c, v in lad.items()}, base) != want:
            raise SystemExit(f"the {curve.name} ladder disagrees with curves.host_mul")
        launches[path] = dict(native.counts)
        if F.norm_on_card:
            raise SystemExit(f"the {path} path ran the plain carry pass on the card {F.norm_on_card} times")
        stage(path, t0, f"2^{n.bit_length() - 1} points: the production MSM ({msm_ms:.1f}ms wall) == msm_affine "
              f"({affine_ms:.1f}ms wall), on the curve; a {lanes}-lane ladder, 64 lanes == host_mul | {smi}")
        if dev.type == "cuda":
            prof = profile_prove(torch, lambda: (ec.variable_base_msm(points, scal, base, scalar),
                                                 msm_affine.msm_affine(points, scal, base, scalar),
                                                 ec.ec_ladder(lp, k, scalar.num_bits, base)))
            print(f"  {path}'s two MSMs and ladder again under torch.profiler: " + json.dumps(prof), flush=True)
        t0 = time.perf_counter()
        check_pasta_instances(torch, np, dev, rng, curve, points, lp, fresh, results)
        stage(f"{path}_instances", t0, f"every {curve.name} instance of K4 and K3 bit-exact against its plain "
              "version")
    check_point_chunks(torch, np, dev, fresh, k1_timed, n)
    if dev.type == "cuda":
        check_no_pasta_instance(torch, dev)
    stage("pasta", t_phase, "Pallas and Vesta: the MSMs, the ladder and every instance of K4 and K3 bit-exact; K1, "
          "K2, K5, sum_reduce and eq_xy raise on a Pasta field")
    return results, k1_timed


def print_pasta(results, k1_timed, smi):
    """The Pasta instances' and K1's point-chunk lines, once `fresh` has
    run: each shape's events and device time beside its BN254 twin's."""
    for name, r in [*results.items(), *k1_timed.items()]:
        for shape, t in [(r["shape"], r), *r.get("timed", {}).items()]:
            print_record(name, shape, t, smi)
        if "batch_inv_device_ms" in r:
            print_record(name.replace("prefix_products", "batch_inv"), r["batch_inv_shape"],
                         {k[len("batch_inv_"):]: v for k, v in r.items() if k.startswith("batch_inv_")}, smi)


def check_pasta_instances(torch, np, dev, rng, curve, points, lp, fresh, results):
    """The instances of `curve`'s coordinate field (its kernel_id: 2 for
    Pallas, 3 for Vesta) against their plain versions on the card, bit for
    bit, at the shapes of the curve's paths: K4's six op codes at 257 and
    2^16 rows over ew_cases' operands (strided, broadcast, by value) with 0,
    1, p - 1, p - 2 and R mod p among the rows; mont_pow at 2^16 rows (0, 1,
    2, p - 2 and a random exponent); the scan both ways at 2^16 and
    batch_inv at 2^17 with zero rows; ec_add at the ladder's lanes `lp` of
    the five cases (also against host arithmetic) and of P + P with
    identity lanes; every level of a 64-point edge-case MSM and of an MSM
    of the 2^16 `points` (``check_msm_levels``); the ladder over every lane
    and the plane tree of that MSM's buckets (``check_ladder_and_tree``).
    Each is recorded as "<kernel>.<instance>" with its events time, plain
    time and bound at its timed shape (Pasta's Montgomery product:
    ``imad_per_mont_mul``), and a fresh-process device time beside its
    BN254 twin's (the same shape over BN254 Fq, G1 for K3; mont_pow on the
    same exponent)."""
    from halo2_lasso_tpu_torch.ops import ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
    from halo2_lasso_tpu_torch.utils.bench import bound_ms, cuda_ms, imad_per_mont_mul

    base, scalar = curve.base, curve.scalar
    p, inst, mm = base.modulus, native.PASTA[base.kernel_id], imad_per_mont_mul(base)
    n, lanes = points["x"].shape[0], lp["x"].shape[0]
    edges = [0, 1, p - 1, p - 2, base.R]
    via = f" ({curve.name}: halo2_lasso_tpu/ops/msm_jacobian.py:90 over halo2_lasso_tpu/ops/pallas_field.py:225)"

    def rand(spec, m, edge_rows=()):
        limbs = rng.randint(0, 1 << 32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
        limbs[:, 7] = rng.randint(0, spec.modulus >> 224, size=m)
        t = F.from_numpy_u32(limbs, dev)
        if edge_rows:
            t[: len(edge_rows)] = F.from_numpy_u32(F.ints_to_u32(edge_rows), dev)
        return t

    def same(name, got, want):
        got, want = [t.reshape(-1) for t in got], [t.reshape(-1) for t in want]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"kernel {name} disagrees with its plain version")

    def record(kernel, src, replaces, shape, fn, plain_fn, bytes_moved, imads, symbol, job, twin_job):
        """Events and plain time of fn at its shape, its bound, and the
        device time of kernel `symbol` in a fresh process's run of `job`
        (call, args, expected launches) beside its BN254 twin's."""
        name = f"{kernel}.{inst}"
        b_ms, b_by = bound_ms(bytes_moved, imads)
        r = results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": 0, "max_abs_err": 0,
            "ms": cuda_ms(fn, 20), "plain_ms": plain_once(torch, plain_fn)[1], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape}
        # the BN254 twin's job is one for both curves (the second's inputs)
        for key, (call, args, expect), field in ((name, job, "device_ms"),
                                                 (f"{kernel}.twin", twin_job, "twin_device_ms")):
            fresh.add(key, call, args, expect)
            fresh.into(key, symbol, r, field)

    # K4's elementwise op: every op code over ew_cases' operands
    for size in (257, n):
        t = rand(base, 4 * size, edges)
        for a, b, c in ew_cases(t, base.decode_ints(rand(base, 1))[0], p - 1):
            for op in range(6):
                args = [a, b, c][: F._EW_ARGS[op]]
                vals = [v if isinstance(v, torch.Tensor) else base.encode([v], dev)[0] for v in args]
                same(f"mont_mul.{inst}", [no_sync(torch, lambda: F._ew(base, op, *args))],
                     [F._ew_plain(base, op, *vals).expand(a.shape)])
    a, b = rand(base, n, edges), rand(base, n)
    ta, tb = rand(Fq, n), rand(Fq, n)
    record("mont_mul", "halo2_lasso_tpu_torch/csrc/mont_pasta.cu (csrc/mont_mul.cu's kernel)",
           "halo2_lasso_tpu/ops/pallas_field.py:225", f"op a*b, 2^{n.bit_length() - 1} rows",
           lambda: F.mont_mul(base, a, b), lambda: F.mont_mul_plain(base, a, b), 96 * n, n * mm,
           "mont_mul_kernel", ("ew", {"op": F.EW_MUL, "args": [a, b], "base": base.kernel_id}, {"mont_mul_kernel": 1}),
           ("ew", {"op": F.EW_MUL, "args": [ta, tb], "base": Fq.kernel_id}, {"mont_mul_kernel": 1}))

    # mont_pow at 2^16 rows; timed where the proofs run it, on one row with
    # exponent p - 2 (batch_inv's total), its BN254 twin on the same
    # exponent (the same squarings and products)
    rows = rand(base, n, edges)
    for e in (0, 1, 2, p - 2, int.from_bytes(rng.bytes(32), "little") % (1 << 254) | 1 << 253):
        same(f"mont_pow.{inst}", [F.pow_fixed(base, rows, e)], [F.pow_fixed_plain(base, rows, e)])
    tot, ftot = rand(base, 1), rand(Fq, 1)
    e = p - 2
    record("mont_pow", "halo2_lasso_tpu_torch/csrc/mont_pasta.cu (csrc/mont_chain.cu's kernel)",
           "halo2_lasso_tpu/ops/field.py:387 over halo2_lasso_tpu/ops/pallas_field.py:225",
           f"one row, exponent p - 2 (batch_inv's total: {e.bit_length()} bits, {bin(e).count('1')} set; the twin "
           "on the same exponent)", lambda: F.pow_fixed(base, tot, e),
           lambda: F.pow_fixed_plain(base, tot, e), 64, (e.bit_length() - 2 + bin(e).count("1")) * mm,
           "mont_pow_kernel", ("pow", {"a": tot, "e": e, "base": base.kernel_id}, {"mont_pow_kernel": 1}),
           ("pow", {"a": ftot, "e": e, "base": Fq.kernel_id}, {"mont_pow_kernel": 1}))

    # the scan both ways at 2^16, batch_inv at 2^17 with zero rows; timed at
    # 2^17, the BN254 twin's shape (batch_inv's twin inverts with its own
    # p - 2, of another popcount: both are in its shape)
    xs = rand(base, n, edges)
    for rev in (False, True):
        same(f"prefix_products.{inst}", [no_sync(torch, lambda: F.prefix_products(base, xs, rev))],
             [F.prefix_products_plain(base, xs, rev)])
    zs = rand(base, 2 * n, edges)
    zs[5::7] = 0
    same(f"prefix_products.{inst}", [no_sync(torch, lambda: F.batch_inv(base, zs))], [F.batch_inv_plain(base, zs)])
    big, fbig = rand(base, 2 * n), rand(Fq, 2 * n)
    record("prefix_products", "halo2_lasso_tpu_torch/csrc/mont_pasta.cu (csrc/mont_chain.cu's scan)",
           "halo2_lasso_tpu/ops/field.py:416 over halo2_lasso_tpu/ops/pallas_field.py:225", f"2^{n.bit_length()} rows",
           lambda: F.prefix_products(base, big), lambda: F.prefix_products_plain(base, big), 64 * 2 * n,
           2 * n * mm, "scan_kernel", ("prefix", {"a": big, "base": base.kernel_id}, {"scan_kernel": 3}),
           ("prefix", {"a": fbig, "base": Fq.kernel_id}, {"scan_kernel": 3}))
    r = results[f"prefix_products.{inst}"]
    fe = Fq.modulus - 2
    r["batch_inv_shape"] = (f"2^{n.bit_length()} rows (the inverse of the total: p - 2, {e.bit_length()} bits, "
                            f"{bin(e).count('1')} set; the twin's BN254 Fq p - 2, {fe.bit_length()} bits, "
                            f"{bin(fe).count('1')} set)")
    r["batch_inv_ms"] = cuda_ms(lambda: F.batch_inv(base, big), 20)
    r["batch_inv_plain_ms"] = plain_once(torch, lambda: F.batch_inv_plain(base, big))[1]
    r["batch_inv_bound_ms"], r["batch_inv_bound_by"] = bound_ms(
        64 * 2 * n, (4 * 2 * n + e.bit_length() - 2 + bin(e).count("1")) * mm)
    for key, a_, spec in ((f"batch_inv.{inst}", big, base), ("batch_inv.twin", fbig, Fq)):
        fresh.add(key, "batch_inv", {"a": a_, "base": spec.kernel_id}, {"scan_kernel": 3, "mont_pow_kernel": 1})
        fresh.into(key, "scan_kernel+mont_pow_kernel", r,
                   "batch_inv_device_ms" if spec is base else "batch_inv_twin_device_ms")

    # K3's add: the five cases at `lanes` lanes (and host arithmetic), then
    # P + P over the ladder's points (identity lanes, every 9th); timed at
    # P + P, its bound the doubling lanes' 15 products
    ps, qs = ec_cases(np, rng, MJ, p, lanes, curve.generator)
    P = {c: base.encode([pt[i] for pt in ps], dev) for i, c in enumerate(ec.COORDS)}
    Q = {c: base.encode([pt[i] for pt in qs], dev) for i, c in enumerate(ec.COORDS)}
    got = ec.ec_add(P, Q, base)
    same(f"ec_add.{inst}", list(got.values()), list(ec.ec_add_plain(P, Q, base).values()))
    if ec.jacobian_to_affine(got, base) != MJ.host_batch_affine([MJ.host_jac_add(x, y, p) for x, y in zip(ps, qs)], p):
        raise SystemExit(f"ec_add over {curve.name} disagrees with host arithmetic")
    del P, Q, got
    same(f"ec_add.{inst}", list(ec.ec_add(lp, lp, base).values()), list(ec.ec_add_plain(lp, lp, base).values()))
    live = int((~F.is_zero(lp["z"])).sum())
    gpts = ec.fixed_base_msm((1, 2), rand(Fr, lanes))
    gpts["z"][::9] = 0
    record("ec_add", "halo2_lasso_tpu_torch/csrc/ec_pasta.cu (csrc/ec_add.cu's kernel)",
           "halo2_lasso_tpu/ops/pallas_ec.py:144" + via, f"P + P, {lanes} lanes ({live} not the identity)",
           lambda: ec.ec_add(lp, lp, base), lambda: ec.ec_add_plain(lp, lp, base), lanes * 9 * 32,
           live * 15 * mm, "ec_add_kernel",
           ("ec_add", {"p": lp, "base": base.kernel_id}, {"ec_add_kernel": 1}),
           ("ec_add", {"p": gpts, "base": Fq.kernel_id}, {"ec_add_kernel": 1}))

    # the MSM's levels: every level of a 64-point edge-case MSM and of an
    # MSM of the 2^16 points against the plain level; timed over the 2^16
    # MSM's 17 level launches and its tree launch
    check_msm_levels(torch, np, rng, dev, msm_edge_points(np, rng, MJ, p, dev, curve=curve), 64, scalar, base)
    check_msm_levels(torch, np, rng, dev, points, n, scalar, base)
    scal = rand(scalar, n)
    c = MJ.best_c(n)
    B, W = 1 << c, -(-scalar.num_bits // c)
    digits = MJ.digits_all(F.from_mont(scalar, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)

    def levels(level_fn):
        def run():
            bucket = ec.identity_point(W * B + 1, dev, base)
            pts, dig = level_fn(points, digits, bucket, W, B, order=order, base=base)
            while dig.shape[0]:
                pts, dig = level_fn(pts, dig, bucket, W, B, base=base)
            return bucket
        return run

    adds = msm_level_adds(torch, torch.gather(digits, 1, order), B)
    g_points = ec.fixed_base_msm((1, 2), rand(Fr, n))
    g_scal = rand(Fr, n)
    record("msm_level", "halo2_lasso_tpu_torch/csrc/msm_level_pasta.cu (csrc/msm_level.cu's kernel)",
           "halo2_lasso_tpu/ops/pallas_ec.py:144 with halo2_lasso_tpu/ops/msm_jacobian.py:168" + via,
           f"a 2^{n.bit_length() - 1} MSM's {n.bit_length()} launches (c = {c}, W = {W})",
           lambda: list(levels(MJ.msm_level)().values()), lambda: list(levels(MJ.msm_level_plain)().values()),
           n * 96 + W * n * 12 + W * B * 96, adds * 16 * mm, "msm_level_kernel",
           ("msm", {"points": points, "scal": scal, "base": base.kernel_id},
            {"msm_level_kernel": n.bit_length(), "plane_tree_kernel": 1}),
           ("msm", {"points": g_points, "scal": g_scal, "base": Fq.kernel_id},
            {"msm_level_kernel": n.bit_length(), "plane_tree_kernel": 1}))

    # the ladder over every lane and the plane tree of that MSM's buckets,
    # as BN254 G1's and grumpkin's; their BN254 twins: G1's ladder at the
    # same lanes, and the plane tree of the twin MSM
    trees = [(f"a 2^{n.bit_length() - 1} MSM's buckets (c = {c}, W = {W})", levels(MJ.msm_level)(), c, W,
              f"msm_level.{inst}")]
    check_ladder_and_tree(torch, np, dev, rng, rand, results, fresh, curve, trees, f".{inst}", lanes)
    fresh.into("msm_level.twin", "plane_tree_kernel", results[f"plane_tree.{inst}"], "twin_device_ms")
    fresh.add("ec_ladder.twin", "ladder", {"pts": gpts, "k": int.from_bytes(rng.bytes(32), "little") % Fr.modulus,
                                           "nbits": Fr.num_bits, "base": Fq.kernel_id}, {"ec_ladder_kernel": 1})
    fresh.into("ec_ladder.twin", "ec_ladder_kernel", results[f"ec_ladder.{inst}"], "twin_device_ms")


def check_point_chunks(torch, np, dev, fresh, k1_timed, n=1 << 16):
    """K1 past MAX_DEGREE: the lt_table(64, 8) primary sumcheck's round
    (degree 9, 16 leaf tables) and a product of degree 17 over four tables
    and the eq table, at 2^16 rows, split into chunks of points by
    plan_round (2 and 3 launches), against round_message_plain's degree
    points in one pass, with no host sync; and each chunk from t0 > 0
    alone against the plain version at that offset. Timed (events, fresh
    device time) beside the degree-8 product of the same tables (one
    launch), K1's BN254 twin at the largest degree one launch takes."""
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, bound_ms, cuda_ms

    rng = np.random.RandomState(17)

    def product(degree):
        acc = Expression.eq_xy(0)
        for i in range(degree - 1):
            acc = acc * Expression.poly(i % 4)
        return acc

    lt = lasso_table(LT64)
    cases = [("lt_table(64,8)'s primary sumcheck", Expression.eq_xy(0) * lt.g, len(lt.memories)),
             ("a product of degree 17", product(17), 4), ("a product of degree 8", product(8), 4)]
    for label, expr, n_polys in cases:
        keys = SC._leaf_keys(expr, n_polys)
        plan = SC.plan_round(expr, keys, Fr.modulus, 0)
        tables = [rand_field_rows(np, Fr, rng, n, dev) for _ in keys]
        tables[0][:4] = Fr.encode([0, 1, Fr.modulus - 1, Fr.R], dev)
        before = native.counts["sumcheck_round"]
        got = no_sync(torch, lambda: SC.round_message_planned(Fr, tables, plan, None))
        launched = native.counts["sumcheck_round"] - before if dev.type == "cuda" else len(plan.points)
        if launched != len(plan.points) or plan.program is None:
            raise SystemExit(f"K1 over {label} launched {native.counts['sumcheck_round'] - before} times, not "
                             f"{len(plan.points)}")
        want, plain_ms = plain_once(torch, lambda: SC.round_message_plain(Fr, tables, plan.program, None, expr.degree))
        if not torch.equal(got, want):
            raise SystemExit(f"kernel sumcheck_round disagrees with its plain version over {label}")
        for t0, d in plan.points[1:]:
            if not torch.equal(SC.round_message(Fr, tables, plan.program, None, d, t0),
                               SC.round_message_plain(Fr, tables, plan.program, None, d, t0)):
                raise SystemExit(f"kernel sumcheck_round disagrees with its plain version from t0 = {t0}")
        muls = program_muls(SC, plan.program)
        b_ms, b_by = bound_ms(len(keys) * n * 32, expr.degree * muls * (n // 2) * IMAD_PER_MONT_MUL)
        key = f"sumcheck_round degree {expr.degree}"
        r = k1_timed[key] = {
            "shape": f"{label}: {len(keys)} leaves, degree {expr.degree}, {len(plan.points)} launch(es) "
                     f"{plan.points}, 2^{n.bit_length() - 1} rows", "ms": cuda_ms(
                         lambda: SC.round_message_planned(Fr, tables, plan, None), 20),
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "launches_a_round": len(plan.points)}
        fresh.add(key, "round", {"tables": tables, "plan": plan, "base": Fr.kernel_id},
                  {"round_kernel": len(plan.points)})
        fresh.into(key, "round_kernel", r, "device_ms")


def check_no_pasta_instance(torch, dev):
    """The kernels without a Pasta instance (K1, K2, K5, the row sum and the
    eq table) raise on a CUDA tensor of either Pasta field, before any
    launch; and every C entry point returns cudaErrorInvalidValue for a
    field id it was not built for (so none runs a BN254 instance in its
    place)."""
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.ops import curves, native
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    refused = []
    for spec in (curves.Fp_pallas, curves.Fq_vesta):
        t = [spec.encode([1, 2, 3, 4], dev) for _ in range(2)]
        prog = SC.lower_expression(Expression.poly(0) * Expression.poly(1), [("poly", 0, 0), ("poly", 1, 0)])
        before = dict(native.counts)
        for name, fn in (("sumcheck_round", lambda: SC.round_message(spec, t, prog, None, 2)),
                         ("fold_all", lambda: mle.fold_all(spec, t, 5)),
                         ("fix_var", lambda: mle.fix_var_chain(spec, t[0], [5, 6], False)),
                         ("sum_reduce", lambda: F.sum_reduce(spec, t[0])),
                         ("eq_xy", lambda: mle.eq_xy(spec, [1, 2], dev))):
            try:
                fn()
            except ValueError:
                refused.append(f"{name}/{spec.name}")
                continue
            raise SystemExit(f"{name} ran on a CUDA tensor of {spec.name}, a field it has no instance for")
        if native.counts != before:
            raise SystemExit(f"a kernel launched on a CUDA tensor of {spec.name} it has no instance for")
    lib = native.lib()
    for name, argtypes in native._SIGNATURES.items():
        entry = name[len("h2l_"):]
        for field in [4, -1] + [i for i in (2, 3) if i not in native.FIELD_IDS.get(entry, (2, 3))]:
            if entry in native.FIELD_IDS and getattr(lib, name)(field, *[None if a is native._P else 0
                                                                         for a in argtypes[1:]]) != 1:
                raise SystemExit(f"h2l_{entry} took the field id {field}, which it was not built for")
    torch.cuda.synchronize()
    print(f"  no Pasta instance, refused before a launch: {', '.join(refused)}; every entry point refuses "
          "an unknown field id", flush=True)


def rand_field_rows(np, spec, rng, n, device):
    """n random field elements below 2^62 from `rng`, Montgomery form on
    `device` (``F.encode_dev``)."""
    from halo2_lasso_tpu_torch.ops import field as F

    return F.encode_dev(spec, rng.randint(1, 1 << 62, size=n, dtype=np.int64), device)


def split_gkr_inputs(np, cfg, num_vars):
    """The q polys of a split GKR batch: cfg["products"] rows of 2^num_vars
    values below 2^62 from RandomState(cfg["seed"])."""
    rng = np.random.RandomState(cfg["seed"])
    return rng.randint(1, 1 << 62, size=(cfg["products"], 1 << num_vars), dtype=np.int64)


def split_gkr_proof(np, cfg, device, num_vars=None):
    """Prove and verify the pure grand products of a split GKR batch
    (``gkr.prove_fractional_sum_check``, every p None) on `device`; returns
    (proof bytes, the q tables)."""
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops.bn254 import Fr
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.transcript import Keccak256Transcript

    nv = cfg["num_vars"] if num_vars is None else num_vars
    b = cfg["products"]
    qs = list(F.encode_dev(Fr, split_gkr_inputs(np, cfg, nv), device).unbind(0))
    tw = Keccak256Transcript(Fr.modulus)
    gkr.prove_fractional_sum_check([0] * b, [None] * b, [None] * b, qs, tw)
    proof = tw.into_proof()
    gkr.verify_fractional_sum_check(nv, [0] * b, [None] * b, Keccak256Transcript(Fr.modulus, proof=proof))
    return proof, qs


def check_kernels(torch, np, dev, fresh):
    """Each kernel against its plain version on the same card inputs; the
    device times that a fresh process takes go to `fresh`, which the caller
    runs."""
    from halo2_lasso_tpu_torch.expression import Expression
    from halo2_lasso_tpu_torch.lasso.tables import range_table
    from halo2_lasso_tpu_torch.ops import curves, ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
    from halo2_lasso_tpu_torch.piop import gkr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle
    from halo2_lasso_tpu_torch.scripts import layout_bench as LB
    from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, bound_ms, cuda_ms, device_ms

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
        """Check and time one kernel at a shape of the main path (the plain
        version's one call, compared and timed)."""
        want, plain_ms = plain_once(torch, plain_fn)
        err = max(err, same(name, kernel_fn, lambda: want))
        b_ms, b_by = bound_ms(bytes_moved, imads)
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": 0, "max_abs_err": err,
            "ms": cuda_ms(kernel_fn, 20), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }

    def timing(fn, plain_fn, symbols, bytes_moved, imads):
        """Events, device time, bound and plain time of fn at one shape; fn
        must make no host sync."""
        no_sync(torch, fn)
        b_ms, b_by = bound_ms(bytes_moved, imads)
        dev_ms = device_ms(fn, 20, symbols)
        return {"ms": cuda_ms(fn, 20), "device_ms": sum(dev_ms[s] for s in symbols), "bound_ms": b_ms,
                "bound_by": b_by, "plain_ms": plain_once(torch, plain_fn)[1]}

    # K4, csrc/mont_mul.cu's elementwise kernel: every op code in Fr and Fq
    # at n = 1, 257, 1037 and 2^16 over the operands of ew_cases (full,
    # strided, broadcast, by value), with 0, 1, p - 1 and R mod p among the
    # rows, against the plain versions (their carry pass on the card), each
    # launch with no host sync; timed at 2^16 in Fr: the product (the
    # witness encodes) and mul_add (b by value), add, sub and neg as the
    # rewired sites run them
    n = 1 << 16
    err = 0
    for spec in (Fq, Fr):
        p = spec.modulus
        for size in (1, 257, 1037, n):
            t = rand_field(spec, 4 * size, [0, 1, p - 1, spec.R][: 4 * size])
            for a, b, c in ew_cases(t, spec.decode_ints(rand_field(spec, 1))[0], p - 1):
                for op in range(6):
                    args = [a, b, c][: F._EW_ARGS[op]]
                    vals = [v if isinstance(v, torch.Tensor) else spec.encode([v], dev)[0] for v in args]
                    err = max(err, same("mont_mul", lambda: [no_sync(torch, lambda: F._ew(spec, op, *args))],
                                        lambda: [F._ew_plain(spec, op, *vals).expand(a.shape)]))
    a, b, c = (rand_field(Fr, n) for _ in range(3))
    xv = Fr.decode_ints(rand_field(Fr, 1))[0]
    xe = Fr.encode([xv], dev)[0]
    record("mont_mul", "halo2_lasso_tpu_torch/csrc/mont_mul.cu", "halo2_lasso_tpu/ops/pallas_field.py:225",
           lambda: [F.mont_mul(Fr, a, b)], lambda: [F.mont_mul_plain(Fr, a, b)], 96 * n, n * IMAD_PER_MONT_MUL, err)
    sym = ["mont_mul_kernel"]
    results["mont_mul"]["timed"] = {
        "mul 2^16": timing(lambda: F.mont_mul(Fr, a, b), lambda: F.mont_mul_plain(Fr, a, b), sym, 96 * n,
                           n * IMAD_PER_MONT_MUL),
        "mul_add 2^16, b by value": timing(lambda: F.mul_add(Fr, a, xv, c),
                                           lambda: F.add_plain(Fr, F.mont_mul_plain(Fr, a, xe), c), sym, 96 * n,
                                           n * IMAD_PER_MONT_MUL),
        "add 2^16": timing(lambda: F.add(Fr, a, b), lambda: F.add_plain(Fr, a, b), sym, 96 * n, 0),
        "sub 2^16": timing(lambda: F.sub(Fr, a, b), lambda: F.sub_plain(Fr, a, b), sym, 96 * n, 0),
        "neg 2^16": timing(lambda: F.neg(Fr, a), lambda: F.neg_plain(Fr, a), sym, 64 * n, 0),
    }

    # K4's row sum: n = 1, 257 and 2^15 + 3 rows, a batch of 2 x 6 columns
    # and the coefficient prover's transposed (h, 2T) view, Fr and Fq, one
    # launch with no host sync; timed at 2^16 rows and at the batch open's
    # first round (6 columns of 2^15, transposed)
    err = 0
    for spec in (Fr, Fq):
        for size in (1, 257, (1 << 15) + 3):
            t = rand_field(spec, 12 * size, [spec.modulus - 1] * 3)
            for x in (t[:size], t.view(size, 2, 6, 8), t.view(12, size, 8).transpose(0, 1)):
                err = max(err, same("sum_reduce", lambda: [no_sync(torch, lambda: F.sum_reduce(spec, x))],
                                    lambda: [F.sum_reduce_plain(spec, x)]))
    record("sum_reduce", "halo2_lasso_tpu_torch/csrc/mont_mul.cu",
           "halo2_lasso_tpu/ops/field.py:477 over halo2_lasso_tpu/ops/pallas_field.py:225",
           lambda: [F.sum_reduce(Fr, a)], lambda: [F.sum_reduce_plain(Fr, a)], 32 * n + 32, 0, err)
    cols = rand_field(Fr, 6 * (n // 2)).view(6, n // 2, 8).transpose(0, 1)
    sym = ["sum_reduce_kernel"]
    results["sum_reduce"]["timed"] = {
        "2^16 rows": timing(lambda: F.sum_reduce(Fr, a), lambda: F.sum_reduce_plain(Fr, a), sym, 32 * n + 32, 0),
        "6 columns of 2^15, transposed": timing(lambda: F.sum_reduce(Fr, cols), lambda: F.sum_reduce_plain(Fr, cols),
                                                sym, 6 * 32 * (n // 2) + 6 * 32, 0),
    }
    print("K4's op codes and row sum: bit-exact in Fr and Fq, one launch each, no host sync", flush=True)

    # K2 fold_all: 1, 37, 64 and 65 tables of 2^10 (two launches beyond
    # 64), both strides, the challenge as a host int and as a card tensor;
    # timed at the batch open's first fold (3 eq tables + 3 polys of 2^16)
    # with the challenge as a host int, as the sumchecks pass it
    p = Fr.modulus
    xv = Fr.decode_ints(rand_field(Fr, 1))[0]
    x = Fr.encode([xv], dev)[0]
    err = 0
    for ntables in (1, 37, 64, 65):
        tabs = [rand_field(Fr, 1 << 10, [0, 1, p - 1, Fr.R]) for _ in range(ntables)]
        for last in (False, True):
            for xc in (xv, x):
                err = max(err, same("fold_all", lambda: mle.fold_all(Fr, tabs, xc, last),
                                    lambda: mle.fold_all_plain(Fr, tabs, x, last)))
    tabs = [rand_field(Fr, n) for _ in range(6)]
    no_sync(torch, lambda: mle.fold_all(Fr, tabs, xv))
    record("fold_all", "halo2_lasso_tpu_torch/csrc/fold.cu", "halo2_lasso_tpu/ops/pallas_field.py:293",
           lambda: mle.fold_all(Fr, tabs, xv), lambda: mle.fold_all_plain(Fr, tabs, x),
           6 * n * 48, 6 * (n // 2) * IMAD_PER_MONT_MUL, err)
    results["fold_all"].update(
        shape="6 tables of 2^16, the challenge by value",
        device_ms=device_ms(lambda: mle.fold_all(Fr, tabs, xv), 20, ["fold_all_kernel"])["fold_all_kernel"])

    # mont_pow: exponents 0, 1, 2, p - 2 and a random 254-bit one, in both
    # fields, on 2^10 rows with 0, 1, p - 1 and R mod p; timed where the
    # proofs run it, on batch_inv's one total (a single row, exponent
    # p - 2): one thread's chain of products, bound by their latency, not by
    # the bound below, which counts its products at the card's full rate
    err = 0
    for spec in (Fr, Fq):
        q = spec.modulus
        rows = rand_field(spec, 1 << 10, [0, 1, q - 1, spec.R])
        for e in (0, 1, 2, q - 2, int.from_bytes(rng.bytes(32), "little") % (1 << 254) | 1 << 253):
            err = max(err, same("mont_pow", lambda: [F.pow_fixed(spec, rows, e)],
                                lambda: [F.pow_fixed_plain(spec, rows, e)]))
    e = p - 2
    tot = rand_field(Fr, 1)
    record("mont_pow", "halo2_lasso_tpu_torch/csrc/mont_chain.cu",
           "halo2_lasso_tpu/ops/field.py:387 over halo2_lasso_tpu/ops/pallas_field.py:225",
           lambda: [F.pow_fixed(Fr, tot, e)], lambda: [F.pow_fixed_plain(Fr, tot, e)],
           64, (e.bit_length() - 2 + bin(e).count("1")) * IMAD_PER_MONT_MUL, err)
    results["mont_pow"].update(
        shape="one row, exponent p - 2 (batch_inv's total)",
        device_ms=device_ms(lambda: F.pow_fixed(Fr, tot, e), 20, ["mont_pow_kernel"])["mont_pow_kernel"])

    # the scan, forward and reverse, and batch_inv with zero rows in both
    # fields, at n = 1, 255, 256, 257 and 2^17 + 3; both timed at 2^17 (the
    # vanilla circuit's lookup batch_inv), the scan's bound n products and
    # its rows read and written once, batch_inv's 4 products a row (the two
    # scans, then prefix * suffix * inverse) and the power's
    err = 0
    for size in (1, 255, 256, 257, (1 << 17) + 3):
        xs = rand_field(Fr, size, [0, 1, p - 1, Fr.R][:size])
        for rev in (False, True):
            err = max(err, same("prefix_products", lambda: [F.prefix_products(Fr, xs, rev)],
                                lambda: [F.prefix_products_plain(Fr, xs, rev)]))
        for spec in (Fr, Fq):
            zs = rand_field(spec, size, [0, 1, spec.modulus - 1, spec.R][:size])
            zs[5::7] = 0
            err = max(err, same("batch_inv", lambda: [F.batch_inv(spec, zs)], lambda: [F.batch_inv_plain(spec, zs)]))
    big = rand_field(Fr, 1 << 17)
    no_sync(torch, lambda: F.prefix_products(Fr, big))
    no_sync(torch, lambda: F.batch_inv(Fr, big))
    record("prefix_products", "halo2_lasso_tpu_torch/csrc/mont_chain.cu",
           "halo2_lasso_tpu/ops/field.py:416 over halo2_lasso_tpu/ops/pallas_field.py:225",
           lambda: [F.prefix_products(Fr, big)], lambda: [F.prefix_products_plain(Fr, big)],
           64 << 17, (1 << 17) * IMAD_PER_MONT_MUL, err)
    pp = results["prefix_products"]
    pp["shape"] = "2^17 rows, Fr"
    pp["device_ms"] = device_ms(lambda: F.prefix_products(Fr, big), 20, ["scan_kernel"])["scan_kernel"]
    bi_dev = device_ms(lambda: F.batch_inv(Fr, big), 20, ["scan_kernel", "mont_pow_kernel"])
    pp.update(batch_inv_ms=cuda_ms(lambda: F.batch_inv(Fr, big), 20),
              batch_inv_plain_ms=plain_once(torch, lambda: F.batch_inv_plain(Fr, big))[1],
              batch_inv_device_ms=bi_dev["scan_kernel"] + bi_dev["mont_pow_kernel"])
    pp["batch_inv_bound_ms"], pp["batch_inv_bound_by"] = bound_ms(
        64 << 17, (4 * (1 << 17) + e.bit_length() - 2 + bin(e).count("1")) * IMAD_PER_MONT_MUL)

    # eq_xy: k = 0, 1, 5 and 16, the point as host ints and on the card,
    # with 0, 1 and p - 1 among its coordinates; timed at k = 16 from host
    # ints (the nv = 16 sumchecks' eq tables), bound 2^k products and the
    # table written once
    err = 0
    for k in (0, 1, 5, 16):
        y = ([0, 1, p - 1] + Fr.decode_ints(rand_field(Fr, k)))[:k]
        ty = Fr.encode(y, dev) if k else Fr.zeros(0, dev)
        for point in (y, ty):
            err = max(err, same("eq_xy", lambda: [mle.eq_xy(Fr, point, dev)], lambda: [mle.eq_xy_plain(Fr, ty)]))
    no_sync(torch, lambda: mle.eq_xy(Fr, y, dev))
    record("eq_xy", "halo2_lasso_tpu_torch/csrc/mont_chain.cu",
           "halo2_lasso_tpu/poly/multilinear.py:55 over halo2_lasso_tpu/ops/pallas_field.py:225",
           lambda: [mle.eq_xy(Fr, y, dev)], lambda: [mle.eq_xy_plain(Fr, ty)],
           32 << 16, (1 << 16) * IMAD_PER_MONT_MUL, err)
    results["eq_xy"].update(
        shape="k = 16, the point as host ints",
        device_ms=device_ms(lambda: mle.eq_xy(Fr, y, dev), 20, ["eq_xy_kernel"])["eq_xy_kernel"])
    print("fold_all (int challenge), prefix_products, batch_inv and eq_xy (host ints) ran with no host "
          "sync or copy", flush=True)

    # K1 round message: the Lasso primary expression and a GKR degree-3
    # layer at 2^14, and the primary sumcheck's first round (2^16), timed
    # beside the zero check's below
    k1_err = 0
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
        k1_err = max(k1_err, same("sumcheck_round", kernel_fn, plain_fn))
    primary = {"primary_ms": cuda_ms(kernel_fn, 20), "primary_plain_ms": plain_once(torch, plain_fn)[1]}
    primary["primary_bound_ms"], primary["primary_bound_by"] = bound_ms(
        len(leaves) * n * 32, expr.degree * program_muls(SC, prog) * (n // 2) * IMAD_PER_MONT_MUL)

    # K3 ec_add: 2^12 lanes over the five cases (generic, P = Q, P = -Q,
    # P = O, Q = O), also against host arithmetic; recorded below at the
    # first level of a 2^16 MSM's bit-plane tree, and timed here over the
    # five cases at 878,592 lanes (PR 6's shape: the first level of a 2^16
    # MSM before msm_level, which no path runs any more) for comparison.
    # Products the inputs need: 16 a generic lane, 15 where P = Q (the 8
    # that give h and r, then the doubling's 7), 8 where P = -Q, none where
    # an input is the identity.
    pts_p, pts_q = ec_cases(np, rng, MJ, Fq.modulus, 1 << 12)
    P = {k: Fq.encode([pt[i] for pt in pts_p], dev) for i, k in enumerate(ec.COORDS)}
    Q = {k: Fq.encode([pt[i] for pt in pts_q], dev) for i, k in enumerate(ec.COORDS)}
    k3_err = same("ec_add", lambda: list(ec.ec_add(P, Q).values()), lambda: list(ec.ec_add_plain(P, Q).values()))
    want = MJ.host_batch_affine([MJ.host_jac_add(a, b, Fq.modulus) for a, b in zip(pts_p, pts_q)], Fq.modulus)
    if ec.jacobian_to_affine(ec.ec_add(P, Q)) != want:
        raise SystemExit("ec_add disagrees with host arithmetic")
    lanes = 878_592
    reps = -(-lanes // (1 << 12))
    P = {k: v.repeat(reps, 1)[:lanes] for k, v in P.items()}
    Q = {k: v.repeat(reps, 1)[:lanes] for k, v in Q.items()}
    case = torch.arange(lanes) % (1 << 12) % 5  # ec_cases: lane i is case i % 5
    products = int(16 * (case == 0).sum() + 15 * (case == 1).sum() + 8 * (case == 2).sum())
    five = {"five_case_lanes": lanes, "five_case_ms": cuda_ms(lambda: ec.ec_add(P, Q), 20)}
    five["five_case_bound_ms"], five["five_case_bound_by"] = bound_ms(lanes * 9 * 32, products * IMAD_PER_MONT_MUL)
    del P, Q

    # msm_level: every level of a 64-point MSM (c = 3; P = Q, P = -Q,
    # digit-0 and identity lanes) against the plain level, then a 2^16 MSM:
    # bit-exact at every level, 16 level launches and a final flush, no
    # host sync in its device part; timed over its 17 launches, the bound
    # counting the adds this data needs (16 products where both inputs are
    # not the identity; its points are distinct and random, so no lane meets
    # P = Q or P = -Q)
    err = check_msm_levels(torch, np, rng, dev, msm_edge_points(np, rng, MJ, Fq.modulus, dev), 64, Fr)
    from halo2_lasso_tpu_torch.ops.bn254 import G1_GEN

    points = ec.fixed_base_msm(G1_GEN, rand_field(Fr, n))
    scal = rand_field(Fr, n)
    err = max(err, check_msm_levels(torch, np, rng, dev, points, n, Fr))
    MJ.msm_planes(points, scal)  # the cached constants exist before the sync check
    native.reset_counts()
    planes = no_sync(torch, lambda: MJ.msm_planes(points, scal))[0]
    if native.counts["msm_level"] != 17 or native.counts["plane_tree"] != 1 or native.counts["ec_add"]:
        raise SystemExit(f"a 2^16 MSM launched msm_level {native.counts['msm_level']} times, not 17, and "
                         f"plane_tree {native.counts['plane_tree']} times, not 1, and ec_add {native.counts['ec_add']}")
    print("msm_level: a 2^16 MSM launches it 17 times (16 levels + the final flush) and plane_tree once, no "
          "ec_add, with no host sync", flush=True)
    c = MJ.best_c(n)
    B, W = 1 << c, -(-Fr.num_bits // c)
    digits = MJ.digits_all(F.from_mont(Fr, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)

    def levels(level_fn):
        def run():
            bucket = ec.identity_point(W * B + 1, dev)
            pts, dig = level_fn(points, digits, bucket, W, B, order=order)
            while dig.shape[0]:
                pts, dig = level_fn(pts, dig, bucket, W, B)
            return [bucket[k][: W * B] for k in ec.COORDS]
        return run

    adds = msm_level_adds(torch, torch.gather(digits, 1, order), B)
    record("msm_level", "halo2_lasso_tpu_torch/csrc/msm_level.cu",
           "halo2_lasso_tpu/ops/pallas_ec.py:144 with halo2_lasso_tpu/ops/msm_jacobian.py:168",
           levels(MJ.msm_level), levels(MJ.msm_level_plain),
           n * 96 + W * n * 12 + W * B * 96, adds * 16 * IMAD_PER_MONT_MUL, err)
    # its ms is the kernel's own device time over the 17 launches (the
    # profiler's rows, in a fresh process: FreshDeviceTimes), not the
    # events' wall time, which holds the host's enqueue gaps between the
    # launches
    lv = results["msm_level"]
    lv["event_ms"] = lv["ms"]
    fresh.add("msm", "msm", {"points": points, "scal": scal, "base": Fq.kernel_id},
              {"msm_level_kernel": 17, "plane_tree_kernel": 1})
    fresh.into("msm", "msm_level_kernel", lv, "ms")
    lv.update(shape="a 2^16 MSM's 17 launches (c = 10, W = 26)", adds=adds)

    # msm_level over one 2^19 MSM (the ARX chain's commits): bit-exact at
    # every level; its device time over the MSM's launches and its events'
    # time, the bound counting the adds its data needs
    big = 1 << 19
    points19 = ec.fixed_base_msm(G1_GEN, rand_field(Fr, big))
    lv["max_abs_err"] = max(lv["max_abs_err"], check_msm_levels(torch, np, rng, dev, points19, big, Fr))
    scal19 = rand_field(Fr, big)
    no_sync(torch, lambda: MJ.msm_planes(points19, scal19))
    c19 = MJ.best_c(big)
    B19, W19 = 1 << c19, -(-Fr.num_bits // c19)
    dig19 = MJ.digits_all(F.from_mont(Fr, scal19), c19, W19).to(torch.int32)
    adds19 = msm_level_adds(torch, torch.sort(dig19, dim=1, descending=True, stable=True).values, B19)
    b_ms, b_by = bound_ms(big * 96 + W19 * big * 12 + W19 * B19 * 96, adds19 * 16 * IMAD_PER_MONT_MUL)
    lv["timed"] = {f"a 2^19 MSM (c = {c19}, W = {W19})": {
        "ms": cuda_ms(lambda: MJ.msm_planes(points19, scal19), 3), "bound_ms": b_ms, "bound_by": b_by,
        "adds": adds19}}
    fresh.add("msm19", "msm", {"points": points19, "scal": scal19, "base": Fq.kernel_id},
              {"msm_level_kernel": big.bit_length(), "plane_tree_kernel": 1})
    fresh.into("msm19", "msm_level_kernel", lv["timed"][f"a 2^19 MSM (c = {c19}, W = {W19})"], "device_ms")
    bucket19 = MJ.msm_buckets(points19, scal19, Fq, Fr)[0]
    del points19, scal19, dig19

    # K3's add at the IPA open's first fold at nv = 16 (b_l + xi b_r over
    # 2^15 lanes; random points, so no lane meets P = Q or P = -Q), where the
    # bit-plane tree no longer takes it
    lanes = n // 2
    fold_l, fold_r = (ec.fixed_base_msm(G1_GEN, rand_field(Fr, lanes)) for _ in range(2))
    live = int((~F.is_zero(fold_l["z"]) & ~F.is_zero(fold_r["z"])).sum())
    record("ec_add", "halo2_lasso_tpu_torch/csrc/ec_add.cu", "halo2_lasso_tpu/ops/pallas_ec.py:144",
           lambda: list(ec.ec_add(fold_l, fold_r).values()), lambda: list(ec.ec_add_plain(fold_l, fold_r).values()),
           lanes * 9 * 32, live * 16 * IMAD_PER_MONT_MUL, k3_err)
    results["ec_add"].update(five, shape=f"the IPA open's first fold add, {lanes} lanes")
    results["ec_add"]["device_ms"] = device_ms(lambda: ec.ec_add(fold_l, fold_r), 20, ["ec_add_kernel"])["ec_add_kernel"]
    del fold_l, fold_r

    # K3 at the IPA ladder's shapes at nv = 16 (MultilinearIpa._scale_points
    # over the first round's 2^15 right-hand bases), every 9th lane the
    # identity: six steps of a per-lane random scalar's top bits, each the
    # doubling of the accumulator (O + O while it is the identity, then
    # P + P) and the add of the point (O + P, O + O, generic), and the point
    # added to itself, each against the plain version; the doubling step
    # timed, its bound counting the doubling lanes' 15 products
    lanes = n // 2
    base = ec.fixed_base_msm(G1_GEN, rand_field(Fr, lanes))
    base["z"][::9] = 0
    acc = ec.identity_point(lanes, dev)
    k3_err = same("ec_add", lambda: list(ec.ec_add(base, base).values()),
                  lambda: list(ec.ec_add_plain(base, base).values()))
    for _ in range(6):
        k3_err = max(k3_err, same("ec_add", lambda: list(ec.ec_add(acc, acc).values()),
                                  lambda: list(ec.ec_add_plain(acc, acc).values())))
        dbl = ec.ec_add(acc, acc)
        k3_err = max(k3_err, same("ec_add", lambda: list(ec.ec_add(dbl, base).values()),
                                  lambda: list(ec.ec_add_plain(dbl, base).values())))
        bit = torch.from_numpy(rng.randint(0, 2, size=lanes).astype(bool)).to(dev)
        acc = ec.ec_select(bit, ec.ec_add(dbl, base), dbl)
    live = int((~F.is_zero(acc["z"])).sum())
    b_ms, b_by = bound_ms(lanes * 9 * 32, live * 15 * IMAD_PER_MONT_MUL)
    results["ec_add"].update(
        max_abs_err=max(results["ec_add"]["max_abs_err"], k3_err),
        ladder_shape=f"IPA ladder doubling step, {lanes} lanes ({live} not the identity)",
        ladder_ms=cuda_ms(lambda: ec.ec_add(acc, acc), 20),
        ladder_plain_ms=plain_once(torch, lambda: ec.ec_add_plain(acc, acc))[1],
        ladder_bound_ms=b_ms, ladder_bound_by=b_by)
    del base, acc, dbl
    if planes["x"].shape[0] != c * W:
        raise SystemExit("msm_planes returned the wrong number of plane sums")

    # K3's ladder and plane tree: the IPA ladders, and the trees of the
    # 2^16 and 2^19 MSMs and of a Hyrax row MSM (256 points)
    trees = [(f"a 2^16 MSM's buckets (c = {c}, W = {W})", dict(zip(ec.COORDS, levels(MJ.msm_level)())), c, W, "msm"),
             ("a 2^19 MSM's buckets (c = 10, W = 26)", bucket19, 10, 26, "msm19")]
    row = ec.fixed_base_msm(G1_GEN, rand_field(Fr, 256))
    row_scal = rand_field(Fr, 256)
    bucket, c_row, w_row = MJ.msm_buckets(row, row_scal, Fq, Fr)
    trees.append((f"a Hyrax row MSM's buckets (256 points, c = {c_row}, W = {w_row})", bucket, c_row, w_row, "row"))
    fresh.add("row", "msm", {"points": row, "scal": row_scal, "base": Fq.kernel_id},
              {"msm_level_kernel": 9, "plane_tree_kernel": 1})
    check_ladder_and_tree(torch, np, dev, rng, rand_field, results, fresh, curves.BN254_G1, trees, "", lanes)
    del trees, bucket19, bucket

    # K5, csrc/fix_var.cu's chain: k = 0, 1, 5, 12, 13 and 16, both
    # directions, with and without quotients, Fr and Fq, the point as host
    # ints and on the card, with 0, 1 and p - 1 among its coordinates and 0,
    # 1, p - 1, R mod p among the rows; each one launch with no host sync;
    # the one-variable chain against fix_var_plain at 2^16 and 2 * 1037
    # rows with the challenge's edge values. Timed at k = 16: a KZG open's
    # quotient chain (highest first, the quotients written) and an
    # evaluation (lowest first); the bound counts 2^k - 1 products and the
    # rows read and written once
    p = Fr.modulus
    err = 0
    for spec in (Fr, Fq):
        q = spec.modulus
        for k in (0, 1, 5, 12, 13, 16):
            tab = rand_field(spec, 1 << k, [0, 1, q - 1, spec.R][: 1 << k])
            y = ([0, 1, q - 1] + spec.decode_ints(rand_field(spec, k)))[:k]
            ty = spec.encode(y, dev) if k else spec.zeros(0, dev)
            for last in (False, True):
                for quot in (False, True):
                    for point in (y, ty):
                        err = max(err, same("fix_var", lambda: no_sync(torch, lambda: [
                            t for t in mle.fix_var_chain(spec, tab, point, last, quot) if t is not None]),
                            lambda: [t for t in mle.fix_var_chain_plain(spec, tab, ty, last, quot) if t is not None]))
    for size in (n, 2 * 1037):
        tab = rand_field(Fr, size, [0, 1, p - 1, Fr.R, p - 1, 0, 1, p - 1])
        for xv in ([0], [1], [p - 1], [Fr.R], []):
            x = rand_field(Fr, 1, xv)[0]
            for last in (False, True):
                err = max(err, same("fix_var", lambda: [mle.fix_var_chain(Fr, tab, x[None], last)[0]],
                                    lambda: [mle.fix_var_plain(Fr, tab, x, last)]))
    # and at k = 19 in Fr (the ARX chain's opens and evaluations), both
    # directions, with and without quotients, the point as host ints
    k19 = 1 << 19
    tab19 = rand_field(Fr, k19, [0, 1, p - 1, Fr.R])
    y19 = [0, 1, p - 1] + Fr.decode_ints(rand_field(Fr, 16))
    ty19 = Fr.encode(y19, dev)
    for last in (False, True):
        for quot in (False, True):
            err = max(err, same("fix_var", lambda: no_sync(torch, lambda: [
                t for t in mle.fix_var_chain(Fr, tab19, y19, last, quot) if t is not None]),
                lambda: [t for t in mle.fix_var_chain_plain(Fr, tab19, ty19, last, quot) if t is not None]))
    tab = rand_field(Fr, n)
    y = Fr.decode_ints(rand_field(Fr, 16))
    ty = Fr.encode(y, dev)
    record("fix_var", "halo2_lasso_tpu_torch/csrc/fix_var.cu", "halo2_lasso_tpu/ops/pallas_field.py:250",
           lambda: list(mle.fix_var_chain(Fr, tab, y, True, True)),
           lambda: list(mle.fix_var_chain_plain(Fr, tab, ty, True, True)),
           32 * (2 * n), (n - 1) * IMAD_PER_MONT_MUL, err)
    sym = ["fix_var_kernel"]
    results["fix_var"]["timed"] = {
        "k = 16 KZG quotient chain": timing(lambda: mle.fix_var_chain(Fr, tab, y, True, True),
                                            lambda: mle.fix_var_chain_plain(Fr, tab, ty, True, True), sym,
                                            32 * (2 * n), (n - 1) * IMAD_PER_MONT_MUL),
        "k = 16 evaluation": timing(lambda: mle.evaluate(Fr, tab, y), lambda: mle.fix_var_chain_plain(Fr, tab, ty, False),
                                    sym, 32 * (n + 1), (n - 1) * IMAD_PER_MONT_MUL),
        "k = 19 KZG quotient chain": timing(lambda: mle.fix_var_chain(Fr, tab19, y19, True, True),
                                            lambda: mle.fix_var_chain_plain(Fr, tab19, ty19, True, True), sym,
                                            32 * (2 * k19), (k19 - 1) * IMAD_PER_MONT_MUL),
        "k = 19 evaluation": timing(lambda: mle.evaluate(Fr, tab19, y19),
                                    lambda: mle.fix_var_chain_plain(Fr, tab19, ty19, False), sym,
                                    32 * (k19 + 1), (k19 - 1) * IMAD_PER_MONT_MUL),
    }
    print("K5's chain: bit-exact in Fr and Fq (and at k = 19 in Fr), both directions, with quotients, one launch, "
          "no host sync", flush=True)

    # K1 on the HyperPlonk zero check: the composed expression of the
    # nv = 16 with-lookup circuit (23 leaf tables, degree 5) at 2^14
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor

    ci = fixtures.vanilla_plonk_with_lookup_circuit_info(16, 16, [[0]] * 9, [[(10, 1), (11, 1), (12, 1)]])
    nz, expr = preprocessor.compose(ci)
    keys = SC._leaf_keys(expr, ci.num_poly() + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz)
    prog = SC.lower_expression(expr, keys)
    leaves = [rand_field(Fr, 1 << 14) for _ in keys]
    chal = rand_field(Fr, 3)
    k1_err = max(k1_err, same("sumcheck_round", lambda: [SC.round_message(Fr, leaves, prog, chal, expr.degree)],
                              lambda: [SC.round_message_plain(Fr, leaves, prog, chal, expr.degree)]))

    # K1 on the Lasso-in-HyperPlonk zero check: the composed expression of
    # the nv = 16 circuit of phase 9 (5 witness + 26 Lasso polys) at 2^14
    ci, _ = fixtures.rand_lasso_circuit(16, np.random.RandomState(16), np.random.RandomState(516),
                                        **LASSO_PLONK["kwargs"])
    nz, expr = preprocessor.compose(ci)
    n_polys = ci.num_poly() + preprocessor.num_lasso_polys(ci) + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz
    keys = SC._leaf_keys(expr, n_polys)
    prog = SC.lower_expression(expr, keys)
    chal = rand_field(Fr, 3)
    for size in (1 << 14, 2 * 1037):
        leaves = [rand_field(Fr, size) for _ in keys]
        k1_err = max(k1_err, same("sumcheck_round", lambda: [SC.round_message(Fr, leaves, prog, chal, expr.degree)],
                                  lambda: [SC.round_message_plain(Fr, leaves, prog, chal, expr.degree)]))
    # K1 at the ARX chain's shapes: its zero check (48 leaves, three
    # challenges) at 2^14, 2 * 1037 and its first round (2^19), and the GKR
    # layer batching the read and write grand products of its memories (73
    # leaves, one challenge) at 2^14, 2 * 1037 and its largest layer (2^18);
    # timed at the two large shapes, with no host sync or copy in the call
    arx_timed = {}
    progs = arx_programs(np)
    for what, big in (("zero check", 1 << 19), ("GKR batch", 1 << 18)):
        aexpr, akeys, aprog, nchal = progs[what]
        achal = rand_field(Fr, nchal)
        for size in (1 << 14, 2 * 1037, big):
            aleaves = [rand_field(Fr, size) for _ in akeys]
            k1_err = max(k1_err, same("sumcheck_round",
                                      lambda: [SC.round_message(Fr, aleaves, aprog, achal, aexpr.degree)],
                                      lambda: [SC.round_message_plain(Fr, aleaves, aprog, achal, aexpr.degree)]))
        muls = program_muls(SC, aprog)
        arx_timed[f"ARX {what}: {len(akeys)} leaves, degree {aexpr.degree}, {muls} products a point, "
                  f"2^{big.bit_length() - 1}"] = timing(
            lambda: SC.round_message(Fr, aleaves, aprog, achal, aexpr.degree),
            lambda: SC.round_message_plain(Fr, aleaves, aprog, achal, aexpr.degree), ["round_kernel"],
            len(aleaves) * big * 32, aexpr.degree * muls * (big // 2) * IMAD_PER_MONT_MUL)
        del aleaves
    print("K1 at the ARX chain's zero check (2^14, 2 * 1037, 2^19) and GKR batch (2^14, 2 * 1037, 2^18): "
          "bit-exact, no host sync", flush=True)

    # timed at its first round (2^16), with no host sync or copy in the call
    leaves = [rand_field(Fr, n) for _ in keys]
    no_sync(torch, lambda: SC.round_message(Fr, leaves, prog, chal, expr.degree))
    muls = program_muls(SC, prog)
    record("sumcheck_round", "halo2_lasso_tpu_torch/csrc/sumcheck_round.cu",
           "halo2_lasso_tpu/ops/pallas_field.py:376",
           lambda: [SC.round_message(Fr, leaves, prog, chal, expr.degree)],
           lambda: [SC.round_message_plain(Fr, leaves, prog, chal, expr.degree)],
           len(leaves) * n * 32, expr.degree * muls * (n // 2) * IMAD_PER_MONT_MUL, k1_err)
    results["sumcheck_round"].update(primary, shape=f"zero check: {len(keys)} leaves, degree {expr.degree}, "
                                     f"stack {prog.max_stack}, {muls} products a point, 2^16")
    results["sumcheck_round"]["device_ms"] = device_ms(
        lambda: SC.round_message(Fr, leaves, prog, chal, expr.degree), 20, ["round_kernel"])["round_kernel"]
    results["sumcheck_round"]["timed"] = arx_timed
    print(f"K1 on the Lasso-in-HyperPlonk zero check: {len(keys)} leaves, degree {expr.degree}, "
          f"stack {prog.max_stack}, bit-exact at 2^14 and 2 * 1037, no host sync", flush=True)

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
    check_grumpkin_instances(torch, np, dev, rng, rand_field, same, record, results, fresh)
    # the Pasta instances are phase 17's (run_pasta_phase)
    return [results[k] for k in native.KERNELS + native.INSTANCES if k.split(".")[-1] not in native.PASTA.values()]


def check_grumpkin_instances(torch, np, dev, rng, rand_field, same, record, results, fresh, n=1 << 16):
    """The field instances of the grumpkin-backed SNARK (phase 13), each
    against its plain version at that path's nv = 16 shapes (n = 2^16),
    recorded under its own name (``native.INSTANCES``): K1 and K2 over BN254
    Fq, K3's add and MSM level over grumpkin (coordinates in BN254 Fr,
    scalars in Fq)."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures, preprocessor
    from halo2_lasso_tpu_torch.ops import curves, ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
    from halo2_lasso_tpu_torch.piop import sum_check as SC
    from halo2_lasso_tpu_torch.poly import multilinear as mle
    from halo2_lasso_tpu_torch.utils.bench import IMAD_PER_MONT_MUL, device_ms

    G = curves.GRUMPKIN

    # K1 over Fq: the zero check of the grumpkin SNARK's nv = 16 circuit
    # (vanilla plonk with lookup: 23 leaf tables, degree 5, three
    # challenges) at 2^14, 2 * 1037 and its first round, 2^16, timed there
    ci = fixtures.vanilla_plonk_with_lookup_circuit_info(16, 16, [[0]] * 9, [[(10, 1), (11, 1), (12, 1)]])
    nz, expr = preprocessor.compose(ci)
    keys = SC._leaf_keys(expr, ci.num_poly() + len(ci.permutation_polys()) + 2 * len(ci.lookups) + nz)
    prog = SC.lower_expression(expr, keys)
    chal = rand_field(Fq, 3)
    err = 0
    for size in (min(1 << 14, n), 2 * 1037, n):
        leaves = [rand_field(Fq, size, [0, 1, Fq.modulus - 1, Fq.R]) for _ in keys]
        err = max(err, same("sumcheck_round.fq",
                            lambda: [no_sync(torch, lambda: SC.round_message(Fq, leaves, prog, chal, expr.degree))],
                            lambda: [SC.round_message_plain(Fq, leaves, prog, chal, expr.degree)]))
    muls = program_muls(SC, prog)
    record("sumcheck_round.fq", "halo2_lasso_tpu_torch/csrc/sumcheck_round.cu",
           "halo2_lasso_tpu/ops/pallas_field.py:376",
           lambda: [SC.round_message(Fq, leaves, prog, chal, expr.degree)],
           lambda: [SC.round_message_plain(Fq, leaves, prog, chal, expr.degree)],
           len(leaves) * n * 32, expr.degree * muls * (n // 2) * IMAD_PER_MONT_MUL, err)
    results["sumcheck_round.fq"].update(
        shape=f"grumpkin SNARK zero check over Fq: {len(keys)} leaves, degree {expr.degree}, stack "
              f"{prog.max_stack}, {muls} products a point, 2^{n.bit_length() - 1}",
        device_ms=device_ms(lambda: SC.round_message(Fq, leaves, prog, chal, expr.degree), 20,
                            ["round_kernel"])["round_kernel"])

    # K2 over Fq: 1, 37, 64 and 65 tables of 2^10, both strides, the
    # challenge as a host int and on the card; then the zero check's first
    # fold (its 23 tables of 2^16, the challenge by value), timed there
    xv = Fq.decode_ints(rand_field(Fq, 1))[0]
    x = Fq.encode([xv], dev)[0]
    err = 0
    for ntables in (1, 37, 64, 65):
        tabs = [rand_field(Fq, 1 << 10, [0, 1, Fq.modulus - 1, Fq.R]) for _ in range(ntables)]
        for last in (False, True):
            for xc in (xv, x):
                err = max(err, same("fold_all.fq", lambda: mle.fold_all(Fq, tabs, xc, last),
                                    lambda: mle.fold_all_plain(Fq, tabs, x, last)))
    tabs = leaves
    err = max(err, same("fold_all.fq", lambda: no_sync(torch, lambda: mle.fold_all(Fq, tabs, xv)),
                        lambda: mle.fold_all_plain(Fq, tabs, x)))
    record("fold_all.fq", "halo2_lasso_tpu_torch/csrc/fold.cu", "halo2_lasso_tpu/ops/pallas_field.py:293",
           lambda: mle.fold_all(Fq, tabs, xv), lambda: mle.fold_all_plain(Fq, tabs, x),
           len(tabs) * n * 48, len(tabs) * (n // 2) * IMAD_PER_MONT_MUL, err)
    results["fold_all.fq"].update(
        shape=f"the zero check's first fold over Fq: {len(tabs)} tables of 2^{n.bit_length() - 1}, the challenge "
              "by value",
        device_ms=device_ms(lambda: mle.fold_all(Fq, tabs, xv), 20, ["fold_all_kernel"])["fold_all_kernel"])
    del leaves, tabs

    # K3's add over grumpkin at the IPA ladder's nv = 16 shapes (2^15
    # lanes): the five cases of ec_cases (generic, P = Q, P = -Q, P = O,
    # Q = O), also against host arithmetic; then six ladder steps over
    # 2^15 grumpkin points, every 9th the identity (the doubling of the
    # accumulator, the add of the point), and the point added to itself;
    # the doubling step timed, its bound counting the doubling lanes' 15
    # products
    lanes = n // 2
    pts_p, pts_q = ec_cases(np, rng, MJ, Fr.modulus, lanes, G.generator)
    P = {k: Fr.encode([pt[i] for pt in pts_p], dev) for i, k in enumerate(ec.COORDS)}
    Q = {k: Fr.encode([pt[i] for pt in pts_q], dev) for i, k in enumerate(ec.COORDS)}
    err = same("ec_add.grumpkin", lambda: list(ec.ec_add(P, Q, Fr).values()),
               lambda: list(ec.ec_add_plain(P, Q, Fr).values()))
    want = MJ.host_batch_affine([MJ.host_jac_add(a, b, Fr.modulus) for a, b in zip(pts_p, pts_q)], Fr.modulus)
    if ec.jacobian_to_affine(ec.ec_add(P, Q, Fr), Fr) != want:
        raise SystemExit("ec_add over grumpkin disagrees with host arithmetic")
    del P, Q
    base = ec.fixed_base_msm(G.generator, rand_field(Fq, lanes), base=Fr, scalar=Fq)
    base["z"][::9] = 0
    acc = ec.identity_point(lanes, dev, Fr)
    err = max(err, same("ec_add.grumpkin", lambda: list(ec.ec_add(base, base, Fr).values()),
                        lambda: list(ec.ec_add_plain(base, base, Fr).values())))
    for _ in range(6):
        err = max(err, same("ec_add.grumpkin", lambda: list(ec.ec_add(acc, acc, Fr).values()),
                            lambda: list(ec.ec_add_plain(acc, acc, Fr).values())))
        dbl = ec.ec_add(acc, acc, Fr)
        err = max(err, same("ec_add.grumpkin", lambda: list(ec.ec_add(dbl, base, Fr).values()),
                            lambda: list(ec.ec_add_plain(dbl, base, Fr).values())))
        bit = torch.from_numpy(rng.randint(0, 2, size=lanes).astype(bool)).to(dev)
        acc = ec.ec_select(bit, ec.ec_add(dbl, base, Fr), dbl)
    live = int((~F.is_zero(acc["z"])).sum())
    record("ec_add.grumpkin", "halo2_lasso_tpu_torch/csrc/ec_add.cu",
           "halo2_lasso_tpu/ops/pallas_ec.py:144 (grumpkin: halo2_lasso_tpu/ops/msm_jacobian.py:90 over "
           "halo2_lasso_tpu/ops/pallas_field.py:225)",
           lambda: list(ec.ec_add(acc, acc, Fr).values()), lambda: list(ec.ec_add_plain(acc, acc, Fr).values()),
           lanes * 9 * 32, live * 15 * IMAD_PER_MONT_MUL, err)
    results["ec_add.grumpkin"]["shape"] = f"grumpkin IPA ladder doubling step, {lanes} lanes ({live} not the identity)"
    del base, acc, dbl

    # msm_level over grumpkin: every level of a 64-point MSM (c = 3; P = Q,
    # P = -Q, digit-0 and identity lanes) and of a 2^16 MSM (the SNARK's
    # commits) against the plain level; the 2^16 MSM's device part 17
    # launches of the grumpkin instance with no host sync, timed over them,
    # the bound counting the adds its data needs
    err = check_msm_levels(torch, np, rng, dev, msm_edge_points(np, rng, MJ, Fr.modulus, dev, curve=G), 64, Fq, Fr)
    points = ec.fixed_base_msm(G.generator, rand_field(Fq, n), base=Fr, scalar=Fq)
    scal = rand_field(Fq, n)
    err = max(err, check_msm_levels(torch, np, rng, dev, points, n, Fq, Fr))
    MJ.msm_planes(points, scal, Fr, Fq)
    native.reset_counts()
    no_sync(torch, lambda: MJ.msm_planes(points, scal, Fr, Fq))
    if native.counts["msm_level.grumpkin"] != n.bit_length() or native.counts["plane_tree.grumpkin"] != 1:
        raise SystemExit(f"a {n}-point grumpkin MSM launched msm_level's grumpkin instance "
                         f"{native.counts['msm_level.grumpkin']} times, not {n.bit_length()}, and plane_tree's "
                         f"{native.counts['plane_tree.grumpkin']} times, not 1")
    c = MJ.best_c(n)
    B, W = 1 << c, -(-Fq.num_bits // c)
    digits = MJ.digits_all(F.from_mont(Fq, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)

    def levels(level_fn):
        def run():
            bucket = ec.identity_point(W * B + 1, dev, Fr)
            pts, dig = level_fn(points, digits, bucket, W, B, order=order, base=Fr)
            while dig.shape[0]:
                pts, dig = level_fn(pts, dig, bucket, W, B, base=Fr)
            return [bucket[k][: W * B] for k in ec.COORDS]
        return run

    adds = msm_level_adds(torch, torch.gather(digits, 1, order), B)
    record("msm_level.grumpkin", "halo2_lasso_tpu_torch/csrc/msm_level.cu",
           "halo2_lasso_tpu/ops/pallas_ec.py:144 with halo2_lasso_tpu/ops/msm_jacobian.py:168 (grumpkin: "
           "jac_add_lf, :90, over halo2_lasso_tpu/ops/pallas_field.py:225)",
           levels(MJ.msm_level), levels(MJ.msm_level_plain),
           n * 96 + W * n * 12 + W * B * 96, adds * 16 * IMAD_PER_MONT_MUL, err)
    lv = results["msm_level.grumpkin"]
    lv["event_ms"] = lv["ms"]
    fresh.add("msm.grumpkin", "msm", {"points": points, "scal": scal, "base": Fr.kernel_id},
              {"msm_level_kernel": n.bit_length(), "plane_tree_kernel": 1})
    fresh.into("msm.grumpkin", "msm_level_kernel", lv, "ms")
    lv.update(shape=f"a 2^{n.bit_length() - 1} grumpkin MSM's {n.bit_length()} launches (c = {c}, W = {W})",
              adds=adds)
    # K3's ladder and plane tree over grumpkin: the IPA ladders, and the
    # trees of that MSM and of a Hyrax row MSM (256 points)
    trees = [(f"a 2^{n.bit_length() - 1} grumpkin MSM's buckets (c = {c}, W = {W})",
              dict(zip(ec.COORDS, levels(MJ.msm_level)())), c, W, "msm.grumpkin")]
    row = ec.fixed_base_msm(G.generator, rand_field(Fq, 256), base=Fr, scalar=Fq)
    row_scal = rand_field(Fq, 256)
    bucket, c_row, w_row = MJ.msm_buckets(row, row_scal, Fr, Fq)
    trees.append((f"a Hyrax row grumpkin MSM's buckets (256 points, c = {c_row}, W = {w_row})", bucket, c_row, w_row,
                  "row.grumpkin"))
    fresh.add("row.grumpkin", "msm", {"points": row, "scal": row_scal, "base": Fr.kernel_id},
              {"msm_level_kernel": 9, "plane_tree_kernel": 1})
    check_ladder_and_tree(torch, np, dev, rng, rand_field, results, fresh, G, trees, ".grumpkin", lanes)
    del trees, bucket
    print("the grumpkin SNARK's instances: K1 and K2 over Fq, K3's add, level, ladder and plane tree over grumpkin, "
          "bit-exact at the nv = 16 shapes; a 2^16 grumpkin MSM launches the level 17 times and the plane tree once, "
          "with no host sync", flush=True)


def check_ladder_and_tree(torch, np, dev, rng, rand_field, results, fresh, curve, trees, suffix, lanes):
    """K3's scalar ladder and plane tree (csrc/ec_add.cu; the Pasta
    instances in csrc/ec_pasta.cu) over `curve` (BN254 G1; grumpkin, Pallas
    or Vesta with `suffix` ".grumpkin", ".pallas" or ".vesta"), bit-exact
    against their plain versions at the main paths' shapes, recorded as
    ec_ladder<suffix> and plane_tree<suffix>:

      - the ladder at the IPA open's first scaling of b_r (`lanes` bases,
        every 9th the identity, a shared random scalar below the scalar
        field's modulus, its bits): against scalar_mul_bits_plain over every
        lane on the card, whose one call is the plain time; timed by events; the same
        scalar as per-lane limbs and through scalar_mul_bits (shared bits)
        give the same bits, each one ec_ladder launch and no ec_add launch;
      - the 2-lane ladder of c_l h' and c_r h' (per-lane scalars: random
        ones, then 0 and q - 1, then 1 and q - 1) against the plain version
        on CPU copies (host ints), timed by events;
      - the plane tree over each of `trees` [(label, bucket, c, W, key)]
        against bucket_planes_plain on the card (one call, its plain time),
        with no host sync, timed by events; the first is the recorded shape.

    Their device times come from `fresh` (FreshDeviceTimes): the two
    ladders' here, and each tree's from the job `key` (the MSM whose
    buckets it is), which the caller adds.

    Bounds: the ladder's products where P is not the identity (7 a step
    past the scalar's top bit, 16 a further set bit) against each point
    read and written once; the tree's adds whose operands are both not the
    identity (16 products each) against the buckets read and the planes
    written once; a product's multiply-adds by the coordinate field
    (``imad_per_mont_mul``)."""
    from halo2_lasso_tpu_torch.ops import ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops import native
    from halo2_lasso_tpu_torch.utils.bench import bound_ms, cuda_ms, imad_per_mont_mul

    base, scal = curve.base, curve.scalar
    q, nbits, mm = scal.modulus, scal.num_bits, imad_per_mont_mul(base)
    src = "halo2_lasso_tpu_torch/csrc/ec_add.cu"
    if base.kernel_id in native.PASTA:
        src = "halo2_lasso_tpu_torch/csrc/ec_pasta.cu (csrc/ec_add.cu's kernel)"
    via = "halo2_lasso_tpu/ops/pallas_ec.py:144" + (
        f" ({curve.name}: halo2_lasso_tpu/ops/msm_jacobian.py:90 over halo2_lasso_tpu/ops/pallas_field.py:225)"
        if suffix else "")

    def check(name, got, want):
        if not all(torch.equal(got[k], want[k].to(got[k].device)) for k in ec.COORDS):
            raise SystemExit(f"kernel {name} disagrees with its plain version")

    def ladder_products(ks, live):
        return sum(7 * (k.bit_length() - 1) + 16 * (bin(k).count("1") - 1) for k, on in zip(ks, live) if on and k)

    def launched(fn, *names):
        before = {k: native.counts[k] for k in names}
        out = fn()
        return out, [native.counts[k] - before[k] for k in names]

    lname, tname = "ec_ladder" + suffix, "plane_tree" + suffix

    # the ladder at the IPA open's first scaling of b_r
    pts = ec.fixed_base_msm(curve.generator, rand_field(scal, lanes), base=base, scalar=scal)
    pts["z"][::9] = 0
    k = int.from_bytes(rng.bytes(32), "little") % q
    bits = [(k >> i) & 1 for i in range(nbits)]
    got = no_sync(torch, lambda: ec.ec_ladder(pts, k, nbits, base))
    want, plain_ms = plain_once(torch, lambda: ec.scalar_mul_bits_plain(pts, bits, base))
    check(lname, got, want)
    del want
    limbs = F.from_numpy_u32(F.ints_to_u32([k] * lanes), dev)
    for fn in (lambda: ec.ec_ladder(pts, limbs, nbits, base), lambda: ec.scalar_mul_bits(pts, bits, base)):
        same_bits, n_launch = launched(fn, "ec_ladder", lname, "ec_add")
        if n_launch != [1, 1, 0] and dev.type == "cuda":
            raise SystemExit(f"a ladder launched ec_ladder, {lname} and ec_add {n_launch} times, not 1, 1 and 0")
        check(lname, same_bits, got)
    live = (~F.is_zero(pts["z"])).tolist()
    b_ms, b_by = bound_ms(lanes * 192, ladder_products([k] * lanes, live) * mm)
    results[lname] = {
        "name": lname, "route": "cuda", "source": src, "replaces": f"halo2_lasso_tpu/ops/ec.py:216 over {via}",
        "launches": 0, "max_abs_err": 0, "ms": cuda_ms(lambda: ec.ec_ladder(pts, k, nbits, base), 5),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"the IPA open's first scaling of b_r: {lanes} lanes ({sum(live)} not the identity), a shared "
                 f"{nbits}-bit scalar",
    }
    fresh.add(f"ladder{suffix}", "ladder", {"pts": pts, "k": k, "nbits": nbits, "base": base.kernel_id},
              {"ec_ladder_kernel": 1})
    fresh.into(f"ladder{suffix}", "ec_ladder_kernel", results[lname], "device_ms")
    del limbs, got

    # the 2-lane ladder of c_l h' and c_r h', per-lane scalars
    h = ec.fixed_base_msm(curve.generator, rand_field(scal, 1), base=base, scalar=scal)
    h = {kk: v.expand(2, F.LIMBS).contiguous() for kk, v in h.items()}
    host = {kk: v.cpu() for kk, v in h.items()}
    pairs = ([int.from_bytes(rng.bytes(32), "little") % q for _ in range(2)], [0, q - 1], [1, q - 1])
    for pair in pairs:
        ks = F.from_numpy_u32(F.ints_to_u32(pair), dev)
        check(lname, ec.ec_ladder(h, ks, nbits, base), ec.ec_ladder(host, ks.cpu(), nbits, base))
    ks = F.from_numpy_u32(F.ints_to_u32(pairs[0]), dev)
    t0 = time.perf_counter()
    ec.ec_ladder(host, ks.cpu(), nbits, base)
    b2_ms, b2_by = bound_ms(2 * 192 + 2 * 32, ladder_products(pairs[0], [True, True]) * mm)
    r = {"ms": cuda_ms(lambda: ec.ec_ladder(h, ks, nbits, base), 5), "plain_cpu_ms": (time.perf_counter() - t0) * 1e3,
         "bound_ms": b2_ms, "bound_by": b2_by}
    results[lname]["timed"] = {"the 2-lane ladder of c_l h' and c_r h', per-lane scalars": r}
    fresh.add(f"ladder2{suffix}", "ladder", {"pts": h, "k": ks, "nbits": nbits, "base": base.kernel_id},
              {"ec_ladder_kernel": 1})
    fresh.into(f"ladder2{suffix}", "ec_ladder_kernel", r, "device_ms")

    # the plane tree
    for i, (label, bucket, c, W, key) in enumerate(trees):
        got = no_sync(torch, lambda: MJ.bucket_planes(bucket, c, W, base))
        want, p_ms = plain_once(torch, lambda: MJ.bucket_planes_plain(bucket, c, W, base))
        check(tname, got, want)
        live = ~F.is_zero(bucket["z"][: W << c])[MJ._tree_rows(c, W, str(dev))]
        adds = 0
        while live.shape[1] > 1:
            half = live.shape[1] // 2
            adds += int((live[:, :half] & live[:, half:]).sum())
            live = live[:, :half] | live[:, half:]
        b_ms, b_by = bound_ms((W << c) * 96 + c * W * 96, adds * 16 * mm)
        r = {"ms": cuda_ms(lambda: MJ.bucket_planes(bucket, c, W, base), 10), "plain_ms": p_ms, "bound_ms": b_ms,
             "bound_by": b_by, "adds": adds}
        if i == 0:
            r = results[tname] = {
                "name": tname, "route": "cuda", "source": src,
                "replaces": f"halo2_lasso_tpu/ops/msm_jacobian.py:299 with :318 over {via}", "launches": 0,
                "max_abs_err": 0, "library_ms": None, "shape": label, "timed": {}, **r}
        else:
            results[tname]["timed"][label] = r
        fresh.into(key, "plane_tree_kernel", r, "device_ms")


def print_record(name, shape, r, smi=""):
    """One timed shape of a kernel: events and device time (and its BN254
    twin's, where it has one), bound and plain time."""
    twin = f", BN254 twin {r['twin_device_ms']:.4f}ms" if "twin_device_ms" in r else ""
    plain = f"plain {r['plain_ms']:.3f}ms" if "plain_ms" in r else f"plain on the CPU {r['plain_cpu_ms']:.1f}ms"
    print(f"{name}: {shape}: events {r['ms']:.4f}ms, device {r.get('device_ms', float('nan')):.4f}ms{twin} (bound "
          f"{r['bound_ms']:.5f}ms, {r['bound_by']}; {plain})" + (f" | {smi}" if smi else ""), flush=True)


def print_ladder_and_tree(by_name):
    """The ladder's and the plane tree's lines, in both instances: each
    shape's events and device time, bound and plain time."""
    for name in ("ec_ladder", "plane_tree", "ec_ladder.grumpkin", "plane_tree.grumpkin"):
        k = by_name[name]
        for shape, r in [(k["shape"], k), *k["timed"].items()]:
            print_record(name, shape, r)


class FreshDeviceTimes:
    """Device times taken in one fresh process (``chip_smoke.py
    --device-times``) at the end of the kernel phase: late in a long
    process a profiler session now and then loses the records of some
    launches, where a fresh process recorded every one. A job is one call,
    ``ec.ec_ladder`` ("ladder"), ``msm_jacobian.msm_planes`` ("msm"),
    ``msm_affine.msm_affine`` ("affine"), ``msm_scan.msm_pallas`` ("scan"),
    ``ec.msm_list_to_affine_int`` under a lane budget ("msm_list"), K4's
    elementwise op ("ew"), ``F.pow_fixed`` ("pow"), ``F.prefix_products``
    ("prefix"), ``F.batch_inv`` ("batch_inv"), ``ec.ec_add`` of a batch to
    itself ("ec_add") or ``sum_check.round_message_planned`` ("round"), on
    card inputs saved for it under build/, with the launches a call makes
    of each kernel whose time is read; the phase fails unless a profiler
    session records every one of them. ``results`` keeps each job's device
    ms a call, by kernel symbol and in all ("all")."""

    def __init__(self):
        self.jobs, self.sinks, self.results = {}, [], {}

    def add(self, key, call, args, expect):
        """Job `key`: `call` on `args` (the coordinate field as "base", its
        kernel_id), launching each kernel of `expect` {symbol: n} n times."""
        self.jobs[key] = {"call": call, "args": args, "expect": expect}

    def into(self, key, symbol, record, field):
        """Job `key`'s device ms a call in kernel `symbol` (several joined
        by "+": their sum) goes to record[field]."""
        self.sinks.append((key, symbol, record, field))

    def run(self, torch):
        """Every job in one fresh process. Its jobs' results come one line
        each; where the process fails on a job after others (a session
        there lost a launch record: late in a long process the profiler
        now and then does), the rest, that job first, go to one more fresh
        process, up to FRESH_RESTARTS; a job that fails first in a fresh
        process fails the run."""
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "device_times.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pending, got = dict(self.jobs), {}
        for restart in range(FRESH_RESTARTS + 1):
            torch.save(pending, path)
            try:
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--device-times", path],
                                      capture_output=True, text=True, timeout=300, check=False)
            finally:
                os.remove(path)
            done = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
            for d in done:
                got.update(d)
            pending = {k: v for k, v in pending.items() if k not in got}
            if proc.returncode == 0 and not pending:
                break
            if not done or restart == FRESH_RESTARTS:
                raise SystemExit(f"the device times' process failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            print(f"  the device times' process failed after {len(done)} jobs "
                  f"({(proc.stderr.strip().splitlines() or [''])[-1][-300:]}); "
                  f"the {len(pending)} left in a fresh one", flush=True)
        self.results = got
        for key, symbol, record, field in self.sinks:  # "a+b": the two kernels' times added
            record[field] = sum(got[key][s] for s in symbol.split("+"))


def device_times(path) -> int:
    """``--device-times PATH``: each job of FreshDeviceTimes's file, its
    device ms a call in each kernel it expects (3 calls a session, up to
    three tries of three sessions), printed as one JSON line a job."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from halo2_lasso_tpu_torch.ops import ec, msm_affine, msm_scan
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops.bn254 import Fq, Fr
    from halo2_lasso_tpu_torch.utils.bench import device_ms

    from halo2_lasso_tpu_torch.ops import curves
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.piop import sum_check as SC

    # a curve's coordinate and scalar fields, by the coordinate field's kernel_id
    fields = {spec.kernel_id: (spec, other) for spec, other in (
        (Fq, Fr), (Fr, Fq), (curves.Fp_pallas, curves.Fq_vesta), (curves.Fq_vesta, curves.Fp_pallas))}
    for key, job in torch.load(path, weights_only=False).items():
        a, expect = job["args"], job["expect"]
        base, scalar = fields[a["base"]]
        if job["call"] == "ladder":
            fn = functools.partial(ec.ec_ladder, a["pts"], a["k"], a["nbits"], base)
        elif job["call"] == "affine":
            fn = functools.partial(msm_affine.msm_affine, a["points"], a["scal"], base, scalar)
        elif job["call"] == "scan":
            fn = functools.partial(msm_scan.msm_pallas, a["points"], a["scal"], base, scalar)
        elif job["call"] == "msm_list":
            os.environ["HALO2_LASSO_TPU_MSM_GROUP_LANES"] = str(a["budget"])
            fn = functools.partial(ec.msm_list_to_affine_int, a["jobs"], base, scalar)
        elif job["call"] == "ew":
            fn = functools.partial(F._ew, base, a["op"], *a["args"])
        elif job["call"] == "pow":
            fn = functools.partial(F.pow_fixed, base, a["a"], a["e"])
        elif job["call"] == "prefix":
            fn = functools.partial(F.prefix_products, base, a["a"])
        elif job["call"] == "batch_inv":
            fn = functools.partial(F.batch_inv, base, a["a"])
        elif job["call"] == "ec_add":
            fn = functools.partial(ec.ec_add, a["p"], a["p"], base)
        elif job["call"] == "round":
            fn = functools.partial(SC.round_message_planned, base, a["tables"], a["plan"], None)
        else:
            fn = functools.partial(MJ.msm_planes, a["points"], a["scal"], base, scalar)
        for attempt in range(3):
            try:
                ms = device_ms(fn, 3, list(expect), expect=expect)
                break
            except RuntimeError as e:
                if attempt == 2:
                    raise RuntimeError(f"job {key}: {e}") from e
        print(json.dumps({key: {"all": ms["all"], **{sym: ms[sym] for sym in expect}}}), flush=True)
        os.environ.pop("HALO2_LASSO_TPU_MSM_GROUP_LANES", None)
    return 0


def ew_cases(t, x, y):
    """(a, b, c) operand triples for csrc/mont_mul.cu over t, 4n rows on the
    card, and host ints x and y: full rows, a table's odd and even rows
    (pair stride 2) with one broadcast row, b or c by value, and a 2-D grid
    of halves of two stacked tables."""
    n = t.shape[0] // 4
    one = t[5 % (4 * n)]
    st = t.view(2, 2 * n, 8)
    return [
        (t[:n], t[n : 2 * n], t[2 * n : 3 * n]),
        (t[1 : 2 * n : 2], t[0 : 2 * n : 2], one),
        (t[:n], x, t[3 * n :]),
        (t[n : 2 * n], one, y),
        (st[:, 1::2], st[:, 0::2], st[:, :n]),
    ]


def plain_once(torch, fn):
    """(fn(), its ms by CUDA events over one call): a plain version's output
    and time. A plain version takes milliseconds to seconds a call and has
    nothing to warm up, so one call, where possible the one that a bit-exact
    check compares, is its time (a kernel's is the mean of many calls,
    ``cuda_ms``)."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def no_sync(torch, fn):
    """fn() with any host sync, a blocking copy included, raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def ec_cases(np, rng, MJ, mod, n, gen=(1, 2)):
    """Jacobian lane pairs over the five cases of the complete add, on the
    curve of generator `gen` over the modulus `mod` (BN254 G1 by default)."""
    def mul(k):
        acc, base = (0, 0, 0), (gen[0], gen[1], 1)
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


def program_muls(SC, prog):
    """Montgomery products of one pass of a round program at one point."""
    return sum(op in (SC.OP_MUL, SC.OP_SCALED) for op, _ in prog.ops)


def msm_edge_points(np, rng, MJ, mod, dev, n=64, curve=None):
    """n points over two base points, rescaled and every other block of four
    negated (P = Q and P = -Q lanes), point 5 the identity; on `curve`
    (ops/curves.py), BN254 G1 by default."""
    from halo2_lasso_tpu_torch.ops import curves, ec

    curve = curve or curves.BN254_G1
    base = [ec_cases(np, rng, MJ, mod, 1, curve.generator)[0][0] for _ in range(2)]
    pts = []
    for i in range(n):
        x, y, z = base[i % 2]
        lam = int(rng.randint(2, 1 << 40))
        pts.append((x * lam * lam % mod, (-1) ** (i // 4) * y * lam**3 % mod, z * lam % mod))
    pts[5] = (1, 1, 0)
    return {k: curve.base.encode([pt[i] for pt in pts], dev) for i, k in enumerate(ec.COORDS)}


def check_msm_levels(torch, np, rng, dev, points, n, Fr, base=None):
    """Every level of one MSM of the n points (coordinates over `base`,
    BN254 Fq by default; scalars over `Fr`, the scalar field), msm_level
    against msm_level_plain on the same inputs (survivors, digits, buckets);
    a third of the scalars are 0 (digit-0 slots). Returns the largest
    difference."""
    from halo2_lasso_tpu_torch.ops import ec
    from halo2_lasso_tpu_torch.ops import field as F
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops.bn254 import Fq

    base = base or Fq
    scal = Fr.encode([int(rng.randint(0, 1 << 62)) * (i % 3 != 0) for i in range(n)], dev)
    c = MJ.best_c(n)
    B, W = 1 << c, -(-Fr.num_bits // c)
    digits = MJ.digits_all(F.from_mont(Fr, scal), c, W).to(torch.int32)
    order = torch.argsort(-digits, dim=1, stable=True)
    bk, bp = ec.identity_point(W * B + 1, dev, base), ec.identity_point(W * B + 1, dev, base)
    kp, kd, pp, pd, first = points, digits, points, digits, True
    while True:
        kp, kd = MJ.msm_level(kp, kd, bk, W, B, order=order if first else None, base=base)
        pp, pd = MJ.msm_level_plain(pp, pd, bp, W, B, order=order if first else None, base=base)
        got = [kd, *kp.values(), *(bk[k][: W * B] for k in ec.COORDS)]
        want = [pd, *pp.values(), *(bp[k][: W * B] for k in ec.COORDS)]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"kernel msm_level disagrees with its plain version at {kd.shape[0]} survivors")
        if kd.shape[0] == 0:
            return 0
        first = False


def msm_level_adds(torch, dig, B):
    """Adds with two non-identity inputs over an MSM's levels and final
    flush, from the sorted (W, n) digits of distinct random points: a slot
    is the identity where its digit is 0 (or both halves of its pair were),
    a bucket until its first flush."""
    W, m = dig.shape
    live = dig != 0
    filled = torch.zeros((W, B), dtype=torch.bool, device=dig.device)
    rows = torch.arange(W, device=dig.device)[:, None]
    adds = 0
    while True:
        if m == 1:
            da, la = dig, live
            adds += int((filled[rows, da] & la).sum())
            return adds
        da, db, la, lb = dig[:, 0::2], dig[:, 1::2], live[:, 0::2], live[:, 1::2]
        same = da == db
        flush = ~same & la
        adds += int((same & la & lb).sum() + (flush & filled[rows, da]).sum())
        filled[rows.expand_as(da)[flush], da[flush]] = True
        dig, live, m = db, torch.where(same, la | lb, lb), m // 2


if __name__ == "__main__":
    sys.exit(device_times(sys.argv[2]) if sys.argv[1:2] == ["--device-times"] else main())
