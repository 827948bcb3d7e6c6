"""Port Lasso-in-HyperPlonk end to end on the CPU, port only: the port's own
setup, preprocess, prove and verify of the circuits that
tests/test_lasso_hyperplonk.py runs for the JAX package (the byte parity
with the JAX package is in tests/test_torch_lasso_hyperplonk.py):

* a range subtable (2^10) larger than the circuit (2^3): the PCS must cover
  the final_cts size, and the 2^10 final counters are committed and opened
  at their own size beside the 2^3 ones;
* rand_full_feature_circuit at nv = 3: gate, copy constraint, a logup
  lookup and two Lasso lookups in one proof.
"""

import numpy as np
import pytest
import torch

from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript
from halo2_lasso_tpu_torch.backend.hyperplonk import fixtures

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores


def prove_and_verify(name, num_vars, **kw):
    ci, circuit = getattr(fixtures, name)(
        num_vars, np.random.RandomState(num_vars), np.random.RandomState(500 + num_vars), **kw
    )
    param = HyperPlonk.setup(ci, np.random.RandomState(0), device="cpu")
    pp, vp = HyperPlonk.preprocess(param, ci)
    t = new_transcript()
    HyperPlonk.prove(pp, circuit, t)
    HyperPlonk.verify(vp, circuit.instances(), new_transcript(t.into_proof()))


@pytest.mark.parametrize(
    "name,num_vars,kw",
    [
        ("rand_lasso_circuit", 3, {"range_bits": 10}),
        ("rand_full_feature_circuit", 3, {}),
    ],
    ids=["big_subtable", "full_feature"],
)
def test_lasso_hyperplonk_proves_and_verifies(name, num_vars, kw):
    prove_and_verify(name, num_vars, **kw)
