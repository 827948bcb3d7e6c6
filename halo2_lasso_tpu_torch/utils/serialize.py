"""Parameter serialization (the port of halo2_lasso_tpu/utils/serialize.py).

The Rust reference serializes its params with serde + bincode
(backend.rs:18-19, pcs.rs:23-25); the JAX package stores them as an npz
archive of limb arrays and a JSON side-car for host values (G2 points,
sizes, expressions), and proofs are bytes already. The port writes and
reads the same files: the same npz keys and JSON keys and ``kind``s, and
the arrays in the JAX package's layout, uint32[..., 16] 16-bit Montgomery
limbs (``F.to_jax_limbs`` / ``F.from_jax_limbs``, a repack of the same
256-bit numbers), so a file written by either package loads in the other
and proves the same bytes. Loaders put the tensors on `device`, the card
unless the caller asks for the CPU. Only ``json`` and ``numpy`` touch the
files.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from halo2_lasso_tpu_torch.ops import ec
from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.pcs.multilinear_kzg import KzgParams, KzgProverParams, KzgVerifierParams


def _base(path: str) -> str:
    if path.endswith(".npz"):  # not assert: survives python -O
        raise ValueError("pass a base path without extension")
    return path


def _eq_arrays(eqs) -> Dict[str, np.ndarray]:
    return {f"eq{j}_{c}": F.to_jax_limbs(table[c]) for j, table in enumerate(eqs) for c in ec.COORDS}


def _eq_tables(data, num_tables: int, device) -> List[dict]:
    return [{c: F.from_jax_limbs(data[f"eq{j}_{c}"], device) for c in ec.COORDS} for j in range(num_tables)]


def _g1(meta):
    return tuple(int(v) for v in meta["g1"])


def _g2(meta):
    return tuple(tuple(int(c) for c in pair) for pair in meta["g2"])


def _ss(meta):
    return [tuple(tuple(int(c) for c in pair) for pair in pt) for pt in meta["ss"]]


def _g2_meta(g2, ss) -> dict:
    return {
        "g2": [[str(c) for c in pair] for pair in g2],
        "ss": [[[str(c) for c in pair] for pair in pt] for pt in ss],
    }


def _write(path: str, arrays: Dict[str, np.ndarray], meta: dict) -> None:
    # uncompressed: np.load reads it as it reads the JAX package's compressed
    # files, and the writes of an nv = 16 set-up take a second, not 18
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _read(path: str, kind: str):
    data = np.load(path + ".npz")
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("kind") != kind:
        raise ValueError(f"params at {path} are {meta.get('kind')!r}, not {kind}")
    return data, meta


def save_kzg_params(path: str, params: KzgParams) -> None:
    """Store multilinear KZG params (``MultilinearKzg.setup``'s). `path` is
    a base path, without extension."""
    meta = {
        "kind": "multilinear_kzg",
        "num_tables": len(params.eqs),
        "g1": [str(v) for v in params.g1],
        **_g2_meta(params.g2, params.ss),
    }
    _write(_base(path), _eq_arrays(params.eqs), meta)


def load_kzg_params(path: str, device="cuda") -> KzgParams:
    """The params stored at the base path `path`, their tables on `device`."""
    data, meta = _read(path, "multilinear_kzg")
    return KzgParams(g1=_g1(meta), eqs=_eq_tables(data, meta["num_tables"], device), g2=_g2(meta), ss=_ss(meta))


# ---------------------------------------------------------------------------
# HyperPlonk prover/verifier params over MultilinearKzg (the Rust
# HyperPlonkProverParam / HyperPlonkVerifierParam are serde + bincode,
# backend/hyperplonk.rs:39-74)
# ---------------------------------------------------------------------------


def save_hyperplonk_params(path: str, pp, vp) -> None:
    """Store a (pp, vp) pair from ``HyperPlonk.preprocess`` over
    MultilinearKzg. `path` is a base path, without extension. As in the JAX
    package the Lasso lookups are not stored."""
    from halo2_lasso_tpu_torch.expression import expression_to_obj

    path = _base(path)
    arrays = _eq_arrays(pp.pcs.eqs)
    for i, poly in enumerate(pp.preprocess_polys):
        arrays[f"pre{i}"] = F.to_jax_limbs(poly)
    for i, (_, poly) in enumerate(pp.permutation_polys):
        arrays[f"perm{i}"] = F.to_jax_limbs(poly)
    meta = {
        "kind": "hyperplonk_kzg",
        "num_tables": len(pp.pcs.eqs),
        "g1": [str(v) for v in pp.pcs.g1],
        **_g2_meta(vp.pcs.g2, vp.pcs.ss),
        "num_instances": pp.num_instances,
        "num_witness_polys": pp.num_witness_polys,
        "num_challenges": pp.num_challenges,
        "lookups": [[[expression_to_obj(i), expression_to_obj(t)] for i, t in lookup] for lookup in pp.lookups],
        "num_permutation_z_polys": pp.num_permutation_z_polys,
        "num_vars": pp.num_vars,
        "expression": expression_to_obj(pp.expression),
        "preprocess_comms": [[str(x), str(y)] for x, y in pp.preprocess_comms],
        "permutation_idx": [i for i, _ in pp.permutation_polys],
        "permutation_comms": [[str(x), str(y)] for x, y in pp.permutation_comms],
    }
    _write(path, arrays, meta)


def load_hyperplonk_params(path: str, device="cuda"):
    """The (pp, vp) pair stored at the base path `path`, the prover's
    tensors on `device`."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonkProverParam, HyperPlonkVerifierParam
    from halo2_lasso_tpu_torch.expression import expression_from_obj

    data, meta = _read(path, "hyperplonk_kzg")
    g1 = _g1(meta)
    pcs_pp = KzgProverParams(g1=g1, eqs=_eq_tables(data, meta["num_tables"], device))
    pcs_vp = KzgVerifierParams(g1=g1, g2=_g2(meta), ss=_ss(meta))
    preprocess_polys = []
    while f"pre{len(preprocess_polys)}" in data:
        preprocess_polys.append(F.from_jax_limbs(data[f"pre{len(preprocess_polys)}"], device))
    perm_idx = meta["permutation_idx"]
    permutation_polys = [(idx, F.from_jax_limbs(data[f"perm{i}"], device)) for i, idx in enumerate(perm_idx)]
    preprocess_comms = [(int(x), int(y)) for x, y in meta["preprocess_comms"]]
    permutation_comms = [(int(x), int(y)) for x, y in meta["permutation_comms"]]
    lookups = [[(expression_from_obj(i), expression_from_obj(t)) for i, t in lookup] for lookup in meta["lookups"]]
    common = dict(
        num_instances=list(meta["num_instances"]),
        num_witness_polys=list(meta["num_witness_polys"]),
        num_challenges=list(meta["num_challenges"]),
        num_permutation_z_polys=meta["num_permutation_z_polys"],
        num_vars=meta["num_vars"],
        expression=expression_from_obj(meta["expression"]),
    )
    pp = HyperPlonkProverParam(
        pcs=pcs_pp, lookups=lookups, preprocess_polys=preprocess_polys, preprocess_comms=preprocess_comms,
        permutation_polys=permutation_polys, permutation_comms=permutation_comms, **common,
    )
    vp = HyperPlonkVerifierParam(
        pcs=pcs_vp, num_lookups=len(lookups), preprocess_comms=preprocess_comms,
        permutation_comms=list(zip(perm_idx, permutation_comms)), **common,
    )
    return pp, vp


# ---------------------------------------------------------------------------
# Lasso set-up: the structured table's factory spec and the KZG params.
# Tables are closed-form (Surge subtables materialize from their factory),
# so the spec (factory name and bound kwargs) is the table's whole
# serialization.
# ---------------------------------------------------------------------------


def save_lasso_setup(path: str, table, params: KzgParams) -> None:
    """Store a Lasso set-up: `table`'s factory spec (lasso/tables.py's
    ``_serializable``) and the KZG params. `path` is a base path."""
    spec = getattr(table, "spec", None)
    if spec is None:
        raise ValueError(f"table {table.name!r} has no factory spec; only factory-built structured tables are "
                         "serializable")
    save_kzg_params(path, params)
    with open(path + ".lasso.json", "w") as f:
        json.dump({"kind": "lasso_setup", "table": spec}, f)


def load_lasso_setup(path: str, device="cuda"):
    """(table, params) of the set-up stored at the base path `path`, the
    params' tables on `device`."""
    from halo2_lasso_tpu_torch.lasso import tables as T

    with open(path + ".lasso.json") as f:
        meta = json.load(f)
    if meta.get("kind") != "lasso_setup":
        raise ValueError(f"the set-up at {path} is {meta.get('kind')!r}, not lasso_setup")
    table = getattr(T, meta["table"]["factory"])(**meta["table"]["kwargs"])
    return table, load_kzg_params(path, device)
