"""Hypercube sharding over a mesh of devices (the port of
halo2_lasso_tpu/parallel/sharding.py).

A ``Mesh`` is an explicit list of devices, one a shard, driven by one
process, as ``shard_map`` is: the host loop (transcript, challenges) runs
once and each shard launches the port's kernels on its own rows. A table of
n rows is split by its high index bits: shard i holds rows
[i n / D, (i + 1) n / D). Sumcheck binds X_0 (adjacent rows 2j, 2j + 1)
first, so every fold stays inside a shard and no round exchanges rows until
a shard would hold a single one. A device may appear several times:
``["cuda:0"] * 4`` gives four virtual shards on one card, ``["cpu"] * 4``
the same for the CPU tests. Across processes (parallel/distributed.py) the
mesh is global: each process owns a contiguous block of shards, its
``devices``, in process order.

Round messages, coefficient sums and MSM totals are per-shard partials added
exactly mod p: gathered to the mesh's first device and added there
(``sum_reduce``, K4), read once, then added across processes on the host
(the JAX package's psum carries the same O(D) words). Proof bytes equal the
single-device proof's: every transcript write is a canonical field element
or an affine point, and a mod-p sum does not depend on its order.

``with use_mesh(mesh): HyperPlonk.prove(...)`` (or ``lasso.prove``) makes
the mesh-aware layers (piop/sum_check.py's rounds and coefficient rounds,
piop/gkr.py's layers, ops/msm_jacobian.py's MSMs) shard over it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from halo2_lasso_tpu_torch.ops import field as F
from halo2_lasso_tpu_torch.ops.field import FieldSpec


class Mesh:
    """A 1-D mesh of D shards (a power of two). ``devices`` are this
    process's shards, in order; with a ``group`` (a torch.distributed group
    of every process of the mesh, each holding as many shards) the mesh has
    D = len(devices) * world shards and this process owns shards
    [rank L, (rank + 1) L), L = len(devices). ``host_group``, gloo, carries
    the host partials across processes (the group itself by default)."""

    def __init__(self, devices: Sequence, group=None, host_group=None):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("Mesh: no devices")
        self.group = group
        self.host_group = group if host_group is None else host_group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.size = len(self.devices) * self.world
        if self.size & (self.size - 1):
            raise ValueError(f"Mesh: {self.size} shards, not a power of two")
        if self.world > 1 and any(n != len(self.devices) for n in self.gather_ints([len(self.devices)])[0]):
            raise ValueError("Mesh: every process must hold as many shards")

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def holds(self, rows: int) -> bool:
        """Whether a table of `rows` rows stays split: every shard holds at
        least one pair of rows."""
        return rows >= 2 * self.size

    def split(self, t: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """This process's shards of a whole table, split on `dim` by its high
        index bits, each on its shard's device (a view where the device is
        the table's own)."""
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"Mesh.split: {n} rows do not split into {self.size} shards")
        rows = n // self.size
        base = self.rank * len(self.devices)
        return [t.narrow(dim, (base + j) * rows, rows).to(d) for j, d in enumerate(self.devices)]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """The whole table on the first device from this process's shards
        (every process's, through the group's all_gather)."""
        local = torch.cat([p.to(self.first) for p in parts], dim)
        if self.world == 1:
            return local
        return torch.cat(self._all_gather(local), dim)

    def halves(self, parts: Sequence[torch.Tensor], dim: int = 1):
        """(low, high) halves of a split table on its highest variable, each
        split over the mesh again. The low half lies on shards [0, D / 2) and
        the high on [D / 2, D), so shard j of a half is half of shard j // 2
        of the half's own: a copy between shards in one process. Across
        processes the whole table comes through the group's all_gather and
        is split again."""
        if self.world > 1:
            whole = self.gather(parts, dim)
            mid = whole.shape[dim] // 2
            return self.split(whole.narrow(dim, 0, mid), dim), self.split(whole.narrow(dim, mid, mid), dim)
        rows = parts[0].shape[dim] // 2
        half = self.size // 2

        def part(src: int, j: int) -> torch.Tensor:
            return parts[src].narrow(dim, (j % 2) * rows, rows).to(self.devices[j])

        return [part(j // 2, j) for j in range(self.size)], [part(half + j // 2, j) for j in range(self.size)]

    def combine(self, spec: FieldSpec, partials: Sequence[torch.Tensor]) -> List[int]:
        """The exact mod-p sum of this process's per-shard partials (each
        (m, 8) Montgomery rows on its shard's device) and every other
        process's, as m canonical ints: added on the first device, read
        once, then added across processes on the host."""
        total = spec.decode_ints(F.sum_reduce(spec, torch.stack([p.to(self.first) for p in partials])))
        if self.world == 1:
            return total
        return [sum(v) % spec.modulus for v in zip(*self.gather_ints(total))]

    def gather_ints(self, values: Sequence[int]) -> List[List[int]]:
        """Every process's list of ints in [0, 2^256), the same length in
        each, in process order (as limbs through the host group)."""
        if self.world == 1:
            return [list(values)]
        local = F.from_numpy_u32(F.ints_to_u32(values))
        outs = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(outs, local, group=self.host_group)
        return [F.u32_to_ints(F.to_numpy_u32(o)) for o in outs]

    def _all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every process's `t` (one shape), on the first device: through the
        group on the card for NCCL, through host buffers for gloo."""
        nccl = dist.get_backend(self.group) == "nccl"
        src = t.contiguous() if nccl else t.cpu().contiguous()
        outs = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(outs, src, group=self.group)
        return [o.to(self.first) for o in outs]


class Shards(list):
    """One table already split over the active mesh: this process's shards
    of it, in mesh order (piop/gkr.py's layers hand them to the sumcheck)."""


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices`, or the first `n_devices` CUDA devices (all of
    them by default); raises where there are fewer. It never places a shard
    on the CPU unless `devices` says so."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, {count} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices)


# ---------------------------------------------------------------------------
# the active mesh: how a mesh is threaded through the prover
# ---------------------------------------------------------------------------

_ACTIVE_MESH: List[Mesh] = []


class use_mesh:
    """Context in which the prover's mesh-aware layers shard over `mesh`."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self) -> Mesh:
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def active_mesh() -> Optional[Mesh]:
    """The innermost mesh of ``use_mesh``, or None (one device, or a mesh of
    one shard)."""
    if _ACTIVE_MESH and _ACTIVE_MESH[-1].size > 1:
        return _ACTIVE_MESH[-1]
    return None


# ---------------------------------------------------------------------------
# the JAX package's sharded helpers (sharding.py:80-137)
# ---------------------------------------------------------------------------


def replicate(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """A split table gathered whole, on the mesh's first device."""
    return mesh.gather(parts, dim)


def shard_evals(mesh: Mesh, evals: torch.Tensor) -> List[torch.Tensor]:
    """An MLE table (n, 8) split by its high index bits (axis 0)."""
    return mesh.split(evals, 0)


def shard_evals_axis1(mesh: Mesh, stacked: torch.Tensor) -> List[torch.Tensor]:
    """A stacked (T, n, 8) batch of tables split on axis 1."""
    return mesh.split(stacked, 1)


def sharded_sum_reduce(spec: FieldSpec, mesh: Mesh, parts: Sequence[torch.Tensor]) -> int:
    """The field sum of a split table: ``sum_reduce`` on each shard, the
    partials combined exactly."""
    return mesh.combine(spec, [F.sum_reduce(spec, p)[None] for p in parts])[0]


def sharded_fix_var(spec: FieldSpec, mesh: Mesh, parts: Sequence[torch.Tensor], x) -> List[torch.Tensor]:
    """X_0 of a split table bound to x (a host int): ``fold_all`` on each
    shard, no exchange."""
    from halo2_lasso_tpu_torch.poly import multilinear as mle

    return [mle.fold_all(spec, [p], x)[0] for p in parts]


def sharded_msm(mesh: Mesh, points, scalars_mont: torch.Tensor):
    """A BN254 G1 MSM split over the mesh: ``msm_planes`` on each shard's
    points and scalars, the per-shard Jacobian totals added on the host.
    Returns the Jacobian total (X, Y, Z) as canonical ints."""
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ

    return MJ.msm_many([(points, scalars_mont)], mesh=mesh)[0]
