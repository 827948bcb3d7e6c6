"""The port's multi-process mesh (halo2_lasso_tpu_torch.parallel.distributed)
on the CPU: 2 processes of 2 CPU shards each join a gloo group on
127.0.0.1 (halo2_lasso_tpu_torch/scripts/dryrun_multiprocess.py's workers)
and prove the full-feature circuit at nv = 5 under the global mesh of 4
shards. Their round messages, coefficient sums and MSM totals cross
processes as host limbs, GKR's halves and the gathered tables through the
group's all_gather. The proof's bytes must equal the single-device proof's
made here, which is the JAX package's (``chip_smoke.FULL_FEATURE_SHA256[5]``),
and each worker's MSM split
over the global mesh the single-device MSM. Every worker runs under its own
time limit, and the test fails rather than hangs.
"""

import hashlib

import pytest
import torch

import chip_smoke
from halo2_lasso_tpu_torch.scripts import dryrun_multiprocess as dry

NV = 5
WORKER_TIMEOUT_S = 120
torch.set_num_threads(1)  # the suite's workers share the cores


def test_two_processes_of_two_shards_give_the_single_device_proof():
    results = dry.run(nproc=2, shards=2, nv=NV, device="cpu", timeout=WORKER_TIMEOUT_S)
    pp, vp, circuit = dry.full_feature(NV, "cpu")
    single = dry.prove(pp, circuit)
    assert len(results) == 2
    assert all(r["sha256"] == hashlib.sha256(single).hexdigest() and r["bytes"] == len(single) for r in results)
    assert all(r["msm"] == dry.msm_affine(*dry.msm_job(pp, NV)) for r in results)
    assert hashlib.sha256(single).hexdigest() == chip_smoke.FULL_FEATURE_SHA256[NV]


def test_a_worker_that_fails_fails_the_run():
    """A worker that cannot prove (nv = 2 is below the fixture's minimum)
    fails the launcher with its output."""
    with pytest.raises(RuntimeError, match="failed"):
        dry.run(nproc=2, shards=1, nv=2, device="cpu", timeout=WORKER_TIMEOUT_S)


def test_a_worker_that_runs_over_is_killed():
    """Past its time limit a worker is killed and the run fails."""
    with pytest.raises(RuntimeError, match="ran over"):
        dry.run(nproc=2, shards=2, nv=NV, device="cpu", timeout=1)
