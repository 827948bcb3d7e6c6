"""A mesh across processes over torch.distributed (the port of
halo2_lasso_tpu/parallel/distributed.py).

Every process runs the same host program: the transcript is deterministic,
so the Fiat-Shamir challenges agree everywhere without communication, and
each process builds the whole witness. The global mesh (``global_mesh``)
gives each process a contiguous block of its shards, in process order; a
process launches the kernels on its own shards only. What crosses
processes:

  * a round message, a coefficient round's sums, an MSM's Jacobian total:
    after the process's own shards are combined, a few field elements
    through the host group (gloo), as the JAX package's psum and all_gather
    carry O(D) words;
  * a GKR layer's halves, which span shards of other processes, and the
    tables of a sumcheck when a shard would hold a single row: through the
    group's all_gather (on the card for NCCL, through host buffers for
    gloo).

NCCL refuses two ranks on one card: ranks that share a card, and the CPU
tests, use gloo. Nothing on the machine tells a process of its peers: the
caller gives the coordinator's address, the number of processes and this
process's rank.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from halo2_lasso_tpu_torch.parallel.sharding import Mesh

TIMEOUT = datetime.timedelta(minutes=10)  # a collective waits this long for a peer that lags


def init_process(coordinator_address: str, num_processes: int, process_id: int, backend: str = "gloo") -> None:
    """Join the process group: `coordinator_address` is host:port of rank
    0's store (``127.0.0.1:<free port>`` on one machine)."""
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
        timeout=TIMEOUT,
    )


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh over every process of the group. This process's shards are
    `devices` (as many in each process), by default its CUDA card (its rank
    modulo the card count); host partials go through a gloo group. Every
    process must call it, in the same order as its other collectives."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("global_mesh: no CUDA device; give this process's devices")
        devices = [torch.device("cuda", dist.get_rank() % count)]
    world = dist.group.WORLD
    host = world if dist.get_backend(world) == "gloo" else dist.new_group(backend="gloo")
    return Mesh(devices, group=world, host_group=host)
