"""Port MultilinearIpa and MultilinearHyrax (halo2_lasso_tpu_torch.pcs.ipa,
.hyrax) against the JAX package on the CPU: the tests of
tests/test_torch_pcs_secondary.py (a single open at nv = 4 and an additive
batch open at nv = 3, byte-equal, verified across packages, a tampered
evaluation rejected) over the two IPA-based PCS, each package with its own
transparent setup (hash_to_curve generators). A file of its own so that
each stays within the suite's time a file."""

import pytest
import torch

from test_torch_pcs_secondary import (  # noqa: F401  (collected here over this file's PCS)
    make_case,
    test_batch_open_bytes_match_jax,
    test_batch_open_verifies_across_packages,
    test_single_open_bytes_match_jax,
    test_single_open_verifies_across_packages,
)

torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores


@pytest.fixture(scope="module", params=["MultilinearIpa", "MultilinearHyrax"])
def case(request):
    return make_case(request.param)
