"""halo2-lasso on PyTorch and CUDA: the port of the JAX package
``halo2_lasso_tpu`` (which stays the reference) to an NVIDIA H100.

Field layout: a field element is a row of 8 little-endian 32-bit limbs in
``torch.int32`` storage (the bit pattern of ``uint32``), shape ``(..., 8)``,
in Montgomery form with R = 2^256 and fully reduced into [0, p). The JAX
package holds the same 256-bit numbers as 16 limbs of 16 bits, so
``ops.field.from_jax_limbs`` / ``to_jax_limbs`` are a repack. The plain
versions of the kernels compute on 16-bit limbs in ``int64``.

Kernels (``csrc/*.cu``, one ``nvcc`` build, loaded with ``ctypes`` by
``ops/native.py``): ``mont_mul`` (ops/field.py), ``fold_all`` and
``fix_var`` (poly/multilinear.py), ``sumcheck_round`` (piop/sum_check.py),
``ec_add`` (ops/ec.py), and the layout microbench's
``mont_mul_limbs_first`` and ``mont_mul_tiled`` (scripts/layout_bench.py).
Each wrapper launches its kernel for a CUDA tensor or raises; a CPU tensor
takes the plain PyTorch version beside it.

Entry points (``lasso.prove``, ``MultilinearKzg.setup``,
``backend.hyperplonk.HyperPlonk.setup``, ``from_jax_kzg_params``,
``from_jax_hyperplonk_params``) take an explicit ``device`` that defaults to
``"cuda"``; ``preprocess`` and ``prove`` run where their parameters live.
Random draws take an explicit ``np.random.RandomState`` as the reference's
do, so both packages build the same SRS from the same seed.
"""
