"""Framework configuration flags (the port's copy of halo2_lasso_tpu/config.py).

The Rust reference's config surface is Cargo features (`sanity-check` among
them, plonkish_backend/Cargo.toml:34-44). Here it is an environment
variable with the JAX package's name, so one setting drives both packages:

  HALO2_LASSO_TPU_SANITY=1   — prover-internal debug assertions (the
                               `sanity-check` feature: sum(h) = 0, the
                               permutation grand product closes)
"""

import os

SANITY_CHECK = os.environ.get("HALO2_LASSO_TPU_SANITY", "0") == "1"


def sanity_enabled() -> bool:
    return SANITY_CHECK
