"""The rank-split path's cases, run inside spawned ranks
(`scheduler_plugins_tpu_torch.parallel.launch.run_ranks`): each function
here is one rank's body, `fn(rank, world_size, ...)`, returning numpy
results the caller holds against the one-card solves and the JAX package.

Shared by `tests/test_torch_ranks.py` (gloo ranks on the CPU) and
`chip_smoke.py` (gloo ranks sharing the card). Imports neither package at
its top level: a spawned rank loads only the port, inside the functions.

Inputs travel as numpy: a snapshot as the port's `snap.numpy()` tree
(`convert.snapshot_from_numpy` rebuilds it on the rank), a gang problem as
its `RankGangState` fields. A profile solve builds its cluster on the rank
from a seeded scenario (`ROSTERS`), since the plugins prepare from the
store as well as the snapshot."""

from __future__ import annotations

import time

import numpy as np

#: the rosters of `dryrun_multichip` (`__graft_entry__.py`) and
#: `tests/test_parallel.py`'s sharded cases: (scenario, plugin names)
ROSTERS = {
    "mixed": ("mixed_scenario", ("NodeResourcesAllocatable",
                                 "NodeResourceTopologyMatch",
                                 "NetworkOverhead", "PodTopologySpread")),
    "metric": ("metric_affinity_scenario", ("TargetLoadPacking",
                                            "LoadVariationRiskBalancing",
                                            "InterPodAffinity", "SySched")),
}


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def roster_problem(pkg, name: str, n_nodes: int, n_pods: int,
                   pad: bool = True, device="cpu"):
    """(scheduler, snapshot, meta) of roster `name` on `n_nodes` x
    `n_pods`, built from `pkg` (`.models`, `.plugins`, `.Profile`,
    `.Scheduler`): each plugin's `configure_cluster`, QueueSort, the
    snapshot (padded to the given sizes when `pad`; on `device` unless it
    is None, JAX's snapshot taking none), `prepare`."""
    scenario, plugin_names = ROSTERS[name]
    cluster = getattr(pkg.models, scenario)(n_nodes=n_nodes, n_pods=n_pods)
    plugins = [getattr(pkg.plugins, p)() for p in plugin_names]
    sched = pkg.Scheduler(pkg.Profile(plugins=plugins))
    for p in plugins:
        p.configure_cluster(cluster)
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    kw = dict(pad_nodes=n_nodes, pad_pods=n_pods) if pad else {}
    if device is not None:
        kw["device"] = device
    snap, meta = cluster.snapshot(pending, now_ms=0, **kw)
    sched.prepare(meta, cluster)
    return sched, snap, meta


def port_namespace():
    """The port's modules a roster build reads, as `roster_problem`'s
    `pkg`."""
    from types import SimpleNamespace

    import scheduler_plugins_tpu_torch.models as models
    import scheduler_plugins_tpu_torch.plugins as plugins
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler

    return SimpleNamespace(models=models, plugins=plugins, Profile=Profile,
                           Scheduler=Scheduler)


def wave_rank(rank, world, cases, device="cpu", sanitized=()):
    """`sharded_wave_solve(snap, make_node_mesh(), weights, **kw)` for each
    (label, tree, weights, kw) case: {label: (assignment, admitted, wait,
    waves, this rank's block of node ids, the sanitizer's reports)}. The
    cases labelled in `sanitized` run under `SPT_SANITIZE=1` (the checked
    program "sharded_wave_solve")."""
    import os

    import torch

    from scheduler_plugins_tpu_torch.convert import snapshot_from_numpy
    from scheduler_plugins_tpu_torch.parallel.mesh import make_node_mesh
    from scheduler_plugins_tpu_torch.parallel.solver import (
        sharded_wave_solve,
    )
    from scheduler_plugins_tpu_torch.utils import sanitize

    mesh = make_node_mesh()
    out = {}
    for label, tree, weights, kw in cases:
        snap = snapshot_from_numpy(tree, device)
        sanitize.drain()
        os.environ["SPT_SANITIZE"] = "1" if label in sanitized else ""
        try:
            a, adm, wait, stats = sharded_wave_solve(
                snap, mesh, torch.as_tensor(weights), collect_stats=True,
                **kw)
        finally:
            os.environ.pop("SPT_SANITIZE")
        out[label] = (_np(a), _np(adm), _np(wait), stats["waves"],
                      _np(stats["node_ids"]), sanitize.drain())
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def flagship_weights(meta):
    return meta.index.encode({"cpu": 1 << 20, "memory": 1})


def batch_rank(rank, world, cases, rosters, views=(), device="cpu",
               pad=True, reference=False):
    """On the ("pods", "nodes") mesh of the whole group:
    `sharded_batch_solve` for each (label, tree, weights) of `cases`, and
    for each (name, n_nodes, n_pods) of `rosters` `sharded_profile_batch_
    solve` and `sharded_batch_solve` (the flagship weights) of its
    snapshot, with this rank's `shard_snapshot` view (as numpy tables) of
    each roster named in `views`. With `reference`, rank 0 also solves
    each roster in one process (`profile_batch_solve`, `batch_solve`).
    Returns {"batch": {label: (assignment, admitted, wait)}, "roster":
    {name: ...}, "roster_batch": {name: ...}, "one_card": {name:
    (profile outputs, batch outputs)}, "views": {name: tree}, "seconds":
    {solve: wall seconds}, "coords": (pods, nodes)}."""
    import torch

    from scheduler_plugins_tpu_torch.convert import snapshot_from_numpy
    from scheduler_plugins_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_snapshot,
    )
    from scheduler_plugins_tpu_torch.parallel.solver import (
        batch_solve,
        profile_batch_solve,
        sharded_batch_solve,
        sharded_profile_batch_solve,
    )

    mesh = make_mesh()
    out = {"batch": {}, "roster": {}, "roster_batch": {}, "one_card": {},
           "views": {}, "seconds": {},
           "coords": (mesh.coordinate("pods"), mesh.coordinate("nodes"))}

    def timed(key, fn):
        _sync(device)
        t0 = time.perf_counter()
        result = tuple(_np(x) for x in fn())
        out["seconds"][key] = time.perf_counter() - t0
        return result

    for label, tree, weights in cases:
        snap = snapshot_from_numpy(tree, device)
        out["batch"][label] = timed(f"batch_{label}", lambda: (
            sharded_batch_solve(snap, mesh, torch.as_tensor(weights))))
    pkg = port_namespace()
    for name, n_nodes, n_pods in rosters:
        sched, snap, meta = roster_problem(pkg, name, n_nodes, n_pods,
                                           pad=pad, device=device)
        w = flagship_weights(meta)
        out["roster"][name] = timed(f"roster_{name}", lambda: (
            sharded_profile_batch_solve(sched, snap, mesh, device=device)))
        out["roster_batch"][name] = timed(f"roster_batch_{name}", lambda: (
            sharded_batch_solve(snap, mesh, w)))
        if reference and rank == 0:
            out["one_card"][name] = (
                timed(f"one_card_roster_{name}", lambda: (
                    profile_batch_solve(sched, snap, device=device))),
                timed(f"one_card_batch_{name}", lambda: (
                    batch_solve(snap, w))))
        if name in views:
            out["views"][name] = shard_snapshot(snap, mesh).numpy()
    return out


def gang_rank(rank, world, cases, device="cpu"):
    """`wave_gang_solve(..., mesh=<("gangs",) mesh>)` for each (label,
    RankGangState fields, free0, eq_used0, node_mask, wave) case: {label:
    (rank_nodes, admitted, placed_new, free, eq_used, stats, seconds)}."""
    from scheduler_plugins_tpu_torch.gangs.topology import RankGangState
    from scheduler_plugins_tpu_torch.gangs.waves import wave_gang_solve
    from scheduler_plugins_tpu_torch.parallel.mesh import (
        GANGS_AXIS,
        make_axis_mesh,
    )

    mesh = make_axis_mesh(GANGS_AXIS)
    out = {}
    for label, fields, free0, eq_used0, node_mask, wave in cases:
        stats = {}
        t0 = time.perf_counter()
        got = wave_gang_solve(RankGangState(**fields), free0, eq_used0,
                              node_mask, wave=wave, mesh=mesh, stats=stats,
                              device=device)
        out[label] = tuple(np.asarray(x) for x in got) + (
            stats, time.perf_counter() - t0)
    return out


def launch_rank(rank, world, tree, meta_weights, device="cpu"):
    """The multi-host recipe (`tests/multihost_child.py`): rank 0 owns the
    snapshot, every other rank CORRUPTS its copy first, and the broadcast
    must win. Returns (distributed_solve's assignment, the mesh's shape)."""
    import torch

    from scheduler_plugins_tpu_torch.convert import snapshot_from_numpy
    from scheduler_plugins_tpu_torch.parallel import launch

    assert launch.initialize() is True  # the group the spawn started
    snap = snapshot_from_numpy(tree, device)
    if rank != 0:
        snap = snap.replace(pods=snap.pods.replace(req=snap.pods.req * 0 + 1))
    snap = launch.broadcast_snapshot(snap)
    mesh = launch.make_multihost_mesh()
    assignment = launch.distributed_solve(
        snap, mesh, torch.as_tensor(meta_weights))
    return assignment, dict(mesh.shape)


def broadcast_wave_rank(rank, world, n_nodes, n_pods, chunk,
                        rescue_window, device="cpu"):
    """The flagship wave solve across the ranks as a deployment runs it:
    rank 0 builds `allocatable_scenario(n_nodes, n_pods)` and its snapshot
    (queue in creation order, pods padded to a multiple of `chunk`, as
    `chip_smoke.drive` does) and `broadcast_snapshot`s it with its meta;
    every rank then runs `sharded_wave_solve` over the ("nodes",) mesh of
    the group, its kernel launches and exchanges counted from just before
    to just after. Returns {assignment, admitted, wait, waves, launches,
    exchanges, solve_s, broadcast_s}."""
    import torch

    from scheduler_plugins_tpu_torch.models import allocatable_scenario
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel import launch
    from scheduler_plugins_tpu_torch.parallel import mesh as rank_mesh
    from scheduler_plugins_tpu_torch.parallel.solver import (
        sharded_wave_solve,
    )

    device = torch.device(device)
    snap = meta = None
    if rank == 0:
        cluster = allocatable_scenario(n_nodes, n_pods)
        pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
        snap, meta = cluster.snapshot(
            pending, now_ms=0, device=device,
            pad_pods=-(-len(pending) // chunk) * chunk)
    t0 = time.perf_counter()
    snap, meta = launch.broadcast_snapshot(snap, meta, device=device)
    _sync(device)
    broadcast_s = time.perf_counter() - t0
    mesh = rank_mesh.make_node_mesh()
    pk.reset_launches()
    rank_mesh.reset_exchanges()
    t0 = time.perf_counter()
    a, adm, wait, stats = sharded_wave_solve(
        snap, mesh, flagship_weights(meta), chunk=chunk,
        rescue_window=rescue_window, collect_stats=True)
    _sync(device)
    solve_s = time.perf_counter() - t0
    return {"assignment": _np(a), "admitted": _np(adm), "wait": _np(wait),
            "waves": stats["waves"], "launches": pk.launches(),
            "exchanges": rank_mesh.exchanges(), "solve_s": solve_s,
            "broadcast_s": broadcast_s}


def jax_modules(rank, world):
    """The JAX modules this rank has loaded (none, for a rank of the
    port)."""
    import sys

    return sorted(m for m in sys.modules
                  if m in ("jax", "scheduler_plugins_tpu")
                  or m.startswith(("jax.", "scheduler_plugins_tpu.")))


def run_all(rank, world, calls):
    """Several bodies in one spawn: [(function name, args)] run in order,
    their results in a list."""
    return [globals()[name](rank, world, *args) for name, args in calls]
