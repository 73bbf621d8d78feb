"""Rank meshes over `torch.distributed` process groups, the snapshot's row
split and the collectives of the rank-split path (port of
`scheduler_plugins_tpu.parallel.mesh`).

The JAX package lays its devices out on a `jax.sharding.Mesh` with
("pods", "nodes") axes and lets XLA or `shard_map` move rows between them.
Here a mesh is a grid of the process group's RANKS, one process each, with
the same axis names and the same factorisation rule (`mesh_shape`). The
ranks are laid out row-major (rank = pods coordinate * nodes size + nodes
coordinate), and each axis gets one process group per line of the grid
(`torch.distributed.new_group`), so a collective "over the nodes axis"
runs among the ranks that share a pods coordinate. An axis of size 1 has no
group: its collectives are the identity, which is how a single process
(no process group at all) runs the rank-split code on a 1 x 1 mesh.

The groups are built with `new_group`, not `init_device_mesh`: a mesh here
names ranks, not devices, and its tensors may sit on the CPU (gloo) or on
the card (gloo staged through the host, or NCCL with a card a rank).

`all_gather` is the one collective of the rank-split solves. Gloo reduces
CUDA tensors by copying them through the host itself; here the choice is
made once, by the group's backend: under gloo a CUDA tensor is staged
through a pinned host buffer explicitly, under NCCL it is gathered on the
card. Each call adds one to `EXCHANGES`.

`shard_snapshot` is the row split of JAX's `snapshot_shardings`: the view
of a snapshot that one rank holds.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Optional, Sequence

import torch

PODS_AXIS = "pods"
NODES_AXIS = "nodes"
#: the wave-gang solve's lane axis (`gangs.waves.wave_gang_solve(mesh=)`)
GANGS_AXIS = "gangs"

#: collectives since the last `reset_exchanges()`: calls, bytes sent by
#: this rank, and host seconds inside them (staging included)
EXCHANGES = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_exchanges() -> None:
    EXCHANGES.update(calls=0, bytes=0, seconds=0.0)


def exchanges() -> dict:
    return dict(EXCHANGES)


def mesh_shape(n: int) -> tuple:
    """(pods, nodes) of an n-rank mesh: the largest divisor of n that is at
    most sqrt(n) goes to "pods", the rest to "nodes" (JAX `make_mesh`'s
    rule: clusters have more nodes than a wave has pods per shard)."""
    pods = 1
    for cand in range(int(math.isqrt(n)), 0, -1):
        if n % cand == 0:
            pods = cand
            break
    return pods, n // pods


def pad_to_shards(n: int, n_shards: int) -> int:
    """Smallest multiple of `n_shards` >= n: the node axis padding of the
    rank-ordered carry (padded rows carry zero capacity and node id -1, so
    they never win an election)."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def block_bounds(n: int, n_blocks: int, block: int) -> tuple:
    """[lo, hi) of block `block` when n rows split into `n_blocks` blocks
    of ceil(n / n_blocks) rows (the last ones shorter or empty)."""
    size = pad_to_shards(n, n_blocks) // n_blocks
    lo = min(block * size, n)
    return lo, min(lo + size, n)


def _dist():
    import torch.distributed as dist

    return dist


class Mesh:
    """A grid of process-group ranks with named axes.

    `shape` maps each axis name to its size, in order (JAX's
    `Mesh.shape`); `coords` maps it to this rank's coordinate; `group(axis)`
    is the process group of this rank's line along `axis` (None for a
    size-1 axis); `group(None)` spans the whole mesh. `backend` is the
    default group's ("gloo", "nccl"), None for a single process."""

    def __init__(self, axis_names: Sequence[str], dims: Sequence[int]):
        self.axis_names = tuple(axis_names)
        dims = tuple(int(d) for d in dims)
        if len(dims) != len(self.axis_names) or min(dims) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and dims {dims}")
        self.shape = dict(zip(self.axis_names, dims))
        self.size = math.prod(dims)
        dist = _dist()
        if dist.is_available() and dist.is_initialized():
            world, self.rank = dist.get_world_size(), dist.get_rank()
            self.backend = dist.get_backend()
        else:
            world, self.rank, self.backend = 1, 0, None
        if world != self.size:
            raise ValueError(
                f"a {dict(self.shape)} mesh needs a process group of "
                f"{self.size} ranks, not {world}")
        self.coords = {}
        rest = self.rank
        for name, d in reversed(list(self.shape.items())):
            self.coords[name] = rest % d
            rest //= d
        self._groups = {None: None if self.size == 1 else dist.group.WORLD}
        for axis in self.axis_names:
            self._groups[axis] = self._line_group(axis)

    def _line_group(self, axis: str):
        """The group of this rank's line along `axis`. Every rank creates
        every line's group, in one order: `new_group` is collective."""
        d = self.shape[axis]
        if d == 1:
            return None
        if d == self.size:
            return _dist().group.WORLD
        dist = _dist()
        others = [a for a in self.axis_names if a != axis]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            at = dict(zip(others, fixed))
            ranks = []
            for k in range(d):
                at[axis] = k
                ranks.append(self._rank_of(at))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def _rank_of(self, coords: dict) -> int:
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords[name]
        return rank

    def group(self, axis: Optional[str]):
        """The process group along `axis` (None for an axis the mesh lacks
        or of size 1, whose collectives are the identity)."""
        return self._groups.get(axis)

    def axis_size(self, axis: Optional[str]) -> int:
        """Ranks along `axis` (1 for an axis the mesh lacks; the whole mesh
        for None)."""
        if axis is None:
            return self.size
        return self.shape.get(axis, 1)

    def coordinate(self, axis: Optional[str]) -> int:
        """This rank's index along `axis` (0 for an axis the mesh lacks;
        the rank for None)."""
        if axis is None:
            return self.rank
        return self.coords.get(axis, 0)


def _world(n_ranks: Optional[int]) -> int:
    dist = _dist()
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return world if n_ranks is None else int(n_ranks)


def make_mesh(n_ranks: Optional[int] = None) -> Mesh:
    """("pods", "nodes") mesh over the whole process group (`mesh_shape`'s
    factorisation); `n_ranks`, when given, must be the group's size. A
    single process gets the 1 x 1 mesh."""
    return Mesh((PODS_AXIS, NODES_AXIS), mesh_shape(_world(n_ranks)))


def make_axis_mesh(axis: str, n_ranks: Optional[int] = None) -> Mesh:
    """1-D mesh named `axis` over the whole process group."""
    return Mesh((axis,), (_world(n_ranks),))


def make_node_mesh(n_ranks: Optional[int] = None) -> Mesh:
    """1-D ("nodes",) mesh for the rank-split wave solve: every rank on the
    node axis (the wave loop's only split dimension)."""
    return make_axis_mesh(NODES_AXIS, n_ranks)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    """Gloo takes host tensors: a CUDA tensor goes through a pinned host
    buffer, chosen by the backend once, never by trying."""
    return t.is_cuda and mesh.backend == "gloo"


def all_gather(t: torch.Tensor, mesh: Mesh, axis: Optional[str]):
    """(S, *t.shape): `t` of every rank along `axis` (None = the whole
    mesh), in coordinate order, on `t`'s device. Every rank of the line
    must call it with a tensor of the same shape and dtype."""
    group = mesh.group(axis)
    if group is None:
        return t.unsqueeze(0)
    dist = _dist()
    start = time.perf_counter()
    S = mesh.axis_size(axis)
    t = t.contiguous()
    staged = _staged(t, mesh)
    src = t
    if staged:
        src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        src.copy_(t)
    out = torch.empty((S,) + tuple(t.shape), dtype=t.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    if staged:
        out = out.to(t.device)
    EXCHANGES["calls"] += 1
    EXCHANGES["bytes"] += t.numel() * t.element_size()
    EXCHANGES["seconds"] += time.perf_counter() - start
    return out


def gather_blocks(block: torch.Tensor, n: int, mesh: Mesh,
                  axis: Optional[str]) -> torch.Tensor:
    """The (n, ...) tensor whose rows `block_bounds(n, S, coordinate)` this
    rank holds as `block`: the blocks of every rank along `axis`,
    concatenated (each padded to the block size for the exchange)."""
    S = mesh.axis_size(axis)
    size = pad_to_shards(n, S) // S
    if block.shape[0] != size:
        pad = block.new_zeros((size - block.shape[0],) + tuple(block.shape[1:]))
        block = torch.cat([block, pad])
    return all_gather(block, mesh, axis).flatten(0, 1)[:n]


# ---------------------------------------------------------------------------
# the snapshot's row split
# ---------------------------------------------------------------------------

#: node-major tables: every tensor splits its leading axis over "nodes"
_NODE_TABLES = ("nodes", "numa", "metrics")
#: the syscall table's node-major fields (the rest are pod-major)
_SYSCALL_NODE_FIELDS = ("host_sets", "counts", "host_pod_count")


def _split(x: torch.Tensor, dim: int, mesh: Mesh, axis: str):
    lo, hi = block_bounds(x.shape[dim], mesh.axis_size(axis),
                          mesh.coordinate(axis))
    return x.narrow(dim, lo, hi - lo)


def _row_axis(table: str, field: str, x) -> Optional[tuple]:
    """(dim, mesh axis) a snapshot leaf splits on, None to replicate: JAX
    `snapshot_shardings`'s rule (scheduler_plugins_tpu/parallel/mesh.py)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return None
    if table in _NODE_TABLES:
        return 0, NODES_AXIS
    if table == "pods":
        return 0, PODS_AXIS
    if table == "network" and field == "placed_node" and x.dim() == 2:
        return 1, NODES_AXIS
    if table == "syscalls":
        return 0, NODES_AXIS if field in _SYSCALL_NODE_FIELDS else PODS_AXIS
    return None


def shard_snapshot(snap, mesh: Mesh):
    """This rank's view of `snap`: node-major tables (`nodes`, `numa`,
    `metrics`) hold its block of rows along "nodes", pod-major tables
    (`pods`) its block along "pods", `network.placed_node` its block of
    columns, the syscall table's node rows along "nodes" and pod rows along
    "pods"; every side table (gangs, quota, nominees, the rest of network,
    scheduling) is replicated. A block is `block_bounds`'s, so an axis that
    does not divide evenly leaves the last ranks shorter. Views, no
    copies."""
    parts = {}
    for f in dataclasses.fields(snap):
        table = getattr(snap, f.name)
        if table is None or not dataclasses.is_dataclass(table):
            parts[f.name] = table
            continue
        changes = {}
        for g in dataclasses.fields(table):
            x = getattr(table, g.name)
            where = _row_axis(f.name, g.name, x)
            if where is not None:
                changes[g.name] = _split(x, where[0], mesh, where[1])
        parts[f.name] = dataclasses.replace(table, **changes)
    return dataclasses.replace(snap, **parts)
