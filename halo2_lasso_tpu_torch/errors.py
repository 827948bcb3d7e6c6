"""Common base of the port's error types (mirrors halo2_lasso_tpu/errors.py)."""


class Halo2LassoError(Exception):
    pass
