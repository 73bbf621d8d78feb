"""Multi-process launch recipe: `torch.distributed` and the rank mesh (port
of `scheduler_plugins_tpu.parallel.launch`).

The reference scales one Go process with goroutines; the JAX package runs
N identical processes under `jax.distributed`, each jitting the same
sharded solve over one global mesh. Here the N processes are the ranks of
one `torch.distributed` process group:

    from scheduler_plugins_tpu_torch.parallel import launch
    launch.initialize(backend="nccl")  # from torchrun's environment, or
                                       # pass init_method/world_size/rank;
                                       # False (a no-op) when alone
    mesh = launch.make_multihost_mesh()

    # rank 0 runs the cluster store and the event feed; every cycle:
    snap = launch.broadcast_snapshot(snap_or_none, device=...)
    assignment = launch.distributed_solve(snap, mesh, weights)
    # `assignment` is the whole (P,) on every rank: rank 0 binds

The environment is PyTorch's own, the one `torchrun` sets, in place of
JAX's: `MASTER_ADDR` and `MASTER_PORT` (JAX_COORDINATOR), `WORLD_SIZE`
(JAX_NUM_PROCESSES) and `RANK` (JAX_PROCESS_ID); `LOCAL_RANK` and
`LOCAL_WORLD_SIZE` place the ranks of one host.

The backend is the caller's choice, never guessed: "nccl" when each rank
has a card of its own, "gloo" otherwise (several ranks sharing one card, or
the CPU). Under gloo the rank-split solves stage their CUDA tensors through
the host (`parallel.mesh.all_gather`).

`run_ranks` starts a gloo process group of `world_size` spawned
processes on this host (a `file://` store) and runs one function in each: the tests'
and `chip_smoke.py`'s way to drive the ranks. Each run has a deadline: a
rank that raises or hangs fails the whole run, and every rank still alive
is killed.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Optional

import torch

from scheduler_plugins_tpu_torch.parallel.mesh import (
    NODES_AXIS,
    PODS_AXIS,
    Mesh,
    make_mesh,
)

#: collective timeout of a process group started here, seconds
DEFAULT_TIMEOUT_S = 600


def _dist():
    import torch.distributed as dist

    return dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Start the default process group from the arguments or PyTorch's
    environment (`WORLD_SIZE`, `RANK`, and `MASTER_ADDR` / `MASTER_PORT`
    for the "env://" rendezvous). Returns True when a group of more than
    one rank is running (started here or before), False when the process
    is alone. `backend` ("nccl" or "gloo") must be named to start one;
    under "nccl" the rank takes the card `LOCAL_RANK` names (else its rank
    modulo the cards)."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or world_size <= 1:
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(
            f"backend={backend!r}: name it, 'nccl' (a card a rank) or "
            "'gloo' (ranks sharing a card, or the CPU)")
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "no rendezvous: pass init_method or set MASTER_ADDR and "
                "MASTER_PORT")
        init_method = "env://"
    if rank is None:
        raise ValueError("no rank: pass rank or set RANK")
    if backend == "nccl":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(
            int(local) if local is not None
            else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))
    return True


def make_multihost_mesh() -> Mesh:
    """The ("pods", "nodes") mesh with "pods" across hosts and "nodes"
    within a host (ranks of one host share the node axis's frequent small
    exchanges), hosts of `LOCAL_WORLD_SIZE` ranks (else the whole group is
    one host). A single process gets `make_mesh()`'s 1 x 1 mesh."""
    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return make_mesh()
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not fill hosts of {per_host}")
    return Mesh((PODS_AXIS, NODES_AXIS), (world // per_host, per_host))


def broadcast_snapshot(snap, meta=None, *, device=None):
    """Rank 0's snapshot (its tensors and, when given, its host
    `SnapshotMeta`) on every rank: rank 0 owns the store and the feed, the
    others only compute, and whatever they pass is ignored. It lands on
    `device` (None = the device of this rank's `snap`, or the card when
    it passes None). Returns the snapshot, or (snapshot, meta) on every
    rank when rank 0 passes a meta. Alone, the arguments come back as they
    are."""
    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return snap if meta is None else (snap, meta)
    if device is None:
        if snap is None:
            from scheduler_plugins_tpu_torch.device import resolve_device

            device = resolve_device(None)
        else:
            device = snap.device
    box = [None, None]
    if dist.get_rank() == 0:
        box = [snap.to("cpu"), meta]
    dist.broadcast_object_list(box, src=0)
    out = box[0].to(device)
    return out if box[1] is None else (out, box[1])


def distributed_solve(snap, mesh: Mesh, weights, max_waves: int = 8):
    """The rank-split batched solve on `mesh`; returns the (P,) int32
    assignment as a numpy array on every rank (rank 0 binds)."""
    from scheduler_plugins_tpu_torch.parallel.solver import (
        sharded_batch_solve,
    )

    assignment, _, _ = sharded_batch_solve(snap, mesh, weights,
                                           max_waves=max_waves)
    return assignment.to("cpu", copy=True).numpy()


# ---------------------------------------------------------------------------
# spawned ranks on one host
# ---------------------------------------------------------------------------


def _rank_entry(rank: int, world_size: int, store: str, out_dir: str,
                timeout_s: float, fn, args) -> None:
    """One spawned rank: join the gloo group, run `fn(rank, world_size,
    *args)`, write its result (or its traceback) to `out_dir`. One
    intra-op thread a rank: the ranks share the host's cores."""
    torch.set_num_threads(1)
    out = Path(out_dir) / f"rank{rank}.pkl"
    dist = _dist()
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world_size,
            rank=rank, timeout=timedelta(seconds=timeout_s))
        result = ("ok", fn(rank, world_size, *args))
    except BaseException:  # noqa: BLE001 - the parent reports it
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        os._exit(1)
    with open(out, "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), *, workdir,
              timeout_s: float = 300) -> list:
    """`fn(rank, world_size, *args)` in each of `world_size` spawned
    processes joined in one gloo process group (a `file://` store in
    `workdir`: ranks on one host, sharing its card or its CPU); returns
    the ranks' results in rank order. `fn` and `args` must pickle (a
    module-level function). A rank that raises, or a run past `timeout_s`
    seconds, raises here after every rank still alive is killed."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / f"store-{os.getpid()}-{time.monotonic_ns()}"
    out_dir = workdir / store.name.replace("store", "out")
    out_dir.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        rank, world_size, str(store), str(out_dir), timeout_s, fn,
        tuple(args))) for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = (f"ranks {[r for r, c in enumerate(codes) if c is None]}"
                          f" still running after {timeout_s} s")
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    results, errors = [], []
    for rank in range(world_size):
        path = out_dir / f"rank{rank}.pkl"
        if not path.exists():
            results.append(None)
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            errors.append(f"rank {rank}:\n{value}")
        results.append(value)
    if failed or errors:
        raise RuntimeError("; ".join(filter(None, [failed] + errors)))
    return results

