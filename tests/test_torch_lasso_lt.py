"""A Lasso lookup whose primary sumcheck passes the round kernel's
MAX_DEGREE (8) against the JAX package on the CPU: lt_table(16, 2), eight
2-bit chunks, so LT = sum_j LT_j prod_{k > j} EQ_k has degree 8 and the
primary sumcheck degree 9, its rounds two chunks of points
(piop/sum_check.py ``plan_round``). The JAX package proves it, and the
port's proof is the same bytes; chip_smoke.py's phase 17 proves the same
table at 64 bits (lt_table(64, 8)) on the card."""

import hashlib

import numpy as np
import torch

import chip_smoke
from halo2_lasso_tpu import lasso as jlasso
from halo2_lasso_tpu.lasso import tables as jtables
from halo2_lasso_tpu.ops.bn254 import FQ_MODULUS
from halo2_lasso_tpu.pcs.multilinear_kzg import MultilinearKzg as JKzg
from halo2_lasso_tpu.transcript import Keccak256Transcript as JTranscript
from halo2_lasso_tpu_torch.ops.bn254 import Fr
from halo2_lasso_tpu_torch.piop import sum_check as sc

P = Fr.modulus
torch.set_num_threads(1)  # small tensors; the suite's workers share the cores


def test_lt_table_lasso_proof_matches_jax():
    """lt_table(16, 2): eight 2-bit chunks, g of degree 8, a primary
    sumcheck of degree 9 (chip_smoke.LT16_SMALL, 8 lookups): the port's
    proof on the CPU is the JAX package's, whose hash is
    chip_smoke.LT16_SHA256."""
    cfg = chip_smoke.LT16_SMALL
    table = chip_smoke.lasso_table(cfg)
    assert 1 + table.g.degree == 9 and sc.point_chunks(9) == ((0, 8), (8, 1))
    indices = chip_smoke.lasso_indices(np, cfg)
    nv = max(cfg["lookups"].bit_length() - 1, table.memories[0].subtable.index_bits)
    jparam = JKzg.setup(1 << nv, np.random.RandomState(cfg["srs_seed"]))
    jpp, _ = JKzg.trim(jparam, 1 << nv)
    jt = JTranscript(P, base_modulus=FQ_MODULUS, curve_b=3)
    jlasso.prove(jpp, jtables.lt_table(*cfg["table"][1:]), indices, jt)
    proof, _ = chip_smoke.lasso_proof(np, cfg, "cpu")
    assert proof == jt.into_proof()
    assert hashlib.sha256(proof).hexdigest() == chip_smoke.LT16_SHA256
