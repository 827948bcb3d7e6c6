"""A sharded prove across processes: N processes of L shards each over
torch.distributed (the port of scripts/dryrun_multiprocess.py), and
``dryrun_multichip``, the same prove over a mesh of one process (the port of
__graft_entry__.dryrun_multichip).

Each worker joins a process group on 127.0.0.1 (NCCL where every worker
has a card of its own, else gloo: NCCL refuses two ranks on one card, and
the CPU has only gloo), builds the global mesh of N L shards and proves the
full-feature circuit (``rand_full_feature_circuit(nv)``: gates, a copy
constraint, a logup lookup and two Lasso lookups with their GKR memory
checks; fixture seeds nv and 100 + nv, setup seed 0) under it, verifies the
proof, runs one MSM split over the mesh, and prints the proof's SHA-256 and
the MSM's affine point. The launcher gives every worker its own time limit,
kills them all when one fails or runs over, and checks that the workers
agree; ``main`` also proves the circuit on one device in its own process
and requires the same bytes.

    python -m halo2_lasso_tpu_torch.scripts.dryrun_multiprocess [--device cuda|cpu] [--procs 2] [--shards 2] [--nv 6]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MSM_SEED = 7  # the scalars of the workers' split MSM


def full_feature(nv: int, device):
    """(pp, vp, circuit) of the full-feature circuit at nv on `device`."""
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk
    from halo2_lasso_tpu_torch.backend.hyperplonk.fixtures import rand_full_feature_circuit

    info, circuit = rand_full_feature_circuit(nv, np.random.RandomState(nv), np.random.RandomState(100 + nv))
    pp, vp = HyperPlonk.preprocess(HyperPlonk.setup(info, np.random.RandomState(0), device=device), info)
    return pp, vp, circuit


def prove(pp, circuit) -> bytes:
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript

    t = new_transcript()
    HyperPlonk.prove(pp, circuit, t)
    return t.into_proof()


def verify(vp, circuit, proof: bytes) -> None:
    from halo2_lasso_tpu_torch.backend.hyperplonk import HyperPlonk, new_transcript

    HyperPlonk.verify(vp, circuit.instances(), new_transcript(proof))


def msm_job(pp, nv: int):
    """The points of the workers' MSM (the SRS's 2^nv Lagrange points) and
    scalars from MSM_SEED."""
    from halo2_lasso_tpu_torch.ops.bn254 import Fr

    points = pp.pcs.eqs[nv]
    rng = np.random.RandomState(MSM_SEED)
    scalars = [int.from_bytes(rng.bytes(40), "little") % Fr.modulus for _ in range(1 << nv)]
    return points, Fr.encode(scalars, points["x"].device)


def msm_affine(points, scalars, mesh=None):
    from halo2_lasso_tpu_torch.ops import msm_jacobian as MJ
    from halo2_lasso_tpu_torch.ops.bn254 import Fq

    return MJ.host_batch_affine(MJ.msm_many([(points, scalars)], mesh=mesh), Fq.modulus)[0]


def worker(pid: int, nproc: int, port: str, shards: int, nv: int, device: str) -> None:
    import torch.distributed as dist

    from halo2_lasso_tpu_torch.parallel import distributed
    from halo2_lasso_tpu_torch.parallel import sharding as sh

    if device == "cpu":
        torch.set_num_threads(1)
        dev, backend = torch.device("cpu"), "gloo"
    else:
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", pid % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if nproc <= cards else "gloo"  # NCCL refuses two ranks on one card
    distributed.init_process(f"127.0.0.1:{port}", nproc, pid, backend=backend)
    try:
        mesh = distributed.global_mesh([dev] * shards)
        pp, vp, circuit = full_feature(nv, dev)
        with sh.use_mesh(mesh):
            proof = prove(pp, circuit)
        verify(vp, circuit, proof)
        x, y = msm_affine(*msm_job(pp, nv), mesh=mesh)
    finally:
        dist.destroy_process_group()
    print(f"[p{pid}/{nproc}] {mesh.size} shards nv={nv} sha256 {hashlib.sha256(proof).hexdigest()} "
          f"bytes {len(proof)} verified msm {x:x} {y:x}", flush=True)


def run(nproc: int = 2, shards: int = 2, nv: int = 6, device: str = "cuda", timeout: float = 120.0):
    """Start `nproc` workers of `shards` shards each and wait for them, each
    within `timeout` seconds of its start; returns what each printed (its
    SHA-256, proof length and MSM point), and raises if one failed, ran
    over or disagreed with the others."""
    with socket.socket() as s:  # a free port for rank 0's store
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []
    try:
        for i in range(nproc):
            cmd = [sys.executable, "-m", "halo2_lasso_tpu_torch.scripts.dryrun_multiprocess", "--worker", str(i),
                   str(nproc), port, str(shards), str(nv), device]
            procs.append((time.monotonic(), subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                                             stderr=subprocess.STDOUT, text=True)))
        outs = []
        for i, (start, p) in enumerate(procs):
            try:
                out = p.communicate(timeout=max(1.0, start + timeout - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"dryrun worker {i} ran over {timeout:.0f}s") from None
            if p.returncode != 0:
                raise RuntimeError(f"dryrun worker {i} failed ({p.returncode}):\n{out[-4000:]}")
            outs.append(out)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        words = [ln for ln in out.splitlines() if ln.startswith("[p")][-1].split()
        at = {w: i for i, w in enumerate(words)}
        results.append({"sha256": words[at["sha256"] + 1], "bytes": int(words[at["bytes"] + 1]),
                        "msm": (int(words[at["msm"] + 1], 16), int(words[at["msm"] + 2], 16))})
    if any(r != results[0] for r in results):
        raise RuntimeError(f"dryrun workers disagree: {results}")
    return results


def dryrun_multichip(n: int, devices=None, nv: int = None) -> bytes:
    """The full-feature prove under a mesh of `n` shards in this process
    (``devices``, or the first n CUDA devices): byte-equal to the
    single-device proof and verified. Returns the proof."""
    from halo2_lasso_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh(n, devices)
    nv = nv or max(6, (mesh.size - 1).bit_length() + 1)
    pp, vp, circuit = full_feature(nv, mesh.first)
    single = prove(pp, circuit)
    with sh.use_mesh(mesh):
        sharded = prove(pp, circuit)
    if sharded != single:
        raise RuntimeError("the sharded proof differs from the single-device proof")
    verify(vp, circuit, sharded)
    print(f"dryrun_multichip({n}): full-feature proof (nv={nv}) over {mesh.size} shards byte-equal to one "
          "device's, verified", flush=True)
    return sharded


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        pid, nproc, port, shards, nv, device = sys.argv[2:8]
        worker(int(pid), int(nproc), port, int(shards), int(nv), device)
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--nv", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    results = run(args.procs, args.shards, args.nv, args.device, args.timeout)
    pp, _, circuit = full_feature(args.nv, args.device)
    single = prove(pp, circuit)
    if hashlib.sha256(single).hexdigest() != results[0]["sha256"]:
        raise SystemExit("the multi-process sharded proof differs from the single-device proof")
    if msm_affine(*msm_job(pp, args.nv)) != results[0]["msm"]:
        raise SystemExit("the multi-process MSM differs from the single-device MSM")
    print(f"dryrun_multiprocess: {args.procs} processes x {args.shards} shards, proof sha256 "
          f"{results[0]['sha256']} == single device, MSM equal", flush=True)


if __name__ == "__main__":
    main()
