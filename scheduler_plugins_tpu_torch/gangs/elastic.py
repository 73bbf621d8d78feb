"""Elastic jobs: gangs with (min, desired, max) replica bounds (port of
`scheduler_plugins_tpu.gangs.elastic`).

An elastic gang is a `PodGroup` with `rank_aware=True` and
`desired_replicas` / `max_replicas` set (`min_member` stays the hard
quorum). The transitions:

- **shrink** (live members > desired): release the HIGHEST-COST ranks
  first. A rank's cost is its max inter-rank pair cost against the live
  set, so topology outliers leave before well-packed ranks; ties release
  the highest rank index (the launcher, rank 0, leaves last).
  `shrink_select` is the tensor selection and `shrink_select_np` its
  bit-identical host twin, which `GangPhase.reconcile` applies through
  the store (the deletes emit Pod/Delete like any other removal).
- **grow** (live + pending members < desired): clone member pods from
  the gang's rank template; the clones join the batch, and the topology
  solve anchors them on the block holding the gang's residents.

`elastic_satisfaction` scores the fleet: the mean over elastic gangs of
min(live / desired, 1).
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.ops.network import MAX_COST

I32 = np.int32
I64 = np.int64


def rank_release_keys(rank_nodes, live, node_block, block_cost):
    """(G, M) int64 release-priority keys: `max-pair-cost * M + rank
    index` for live ranks (unique: the highest key releases first), -1
    for dead slots. Tensors in, tensors out."""
    G, M = rank_nodes.shape
    device = rank_nodes.device
    nb = torch.where(live, node_block[torch.clamp(rank_nodes, min=0).long()],
                     -1)
    known = nb >= 0
    nb0 = torch.clamp(nb, min=0).long()
    bc = block_cost[nb0[:, :, None], nb0[:, None, :]].to(torch.int64)
    cost = torch.where(known[:, :, None] & known[:, None, :], bc, MAX_COST)
    same_node = rank_nodes[:, :, None] == rank_nodes[:, None, :]
    cost = torch.where(same_node, 0, cost)
    eye = torch.eye(M, dtype=torch.bool, device=device)
    valid = live[:, :, None] & live[:, None, :] & ~eye[None]
    per_rank = torch.where(valid, cost, 0).amax(dim=2)  # (G, M)
    keys = per_rank * M + torch.arange(M, device=device)
    return torch.where(live, keys, -1)


def shrink_select(rank_nodes, live, node_block, block_cost, n_release):
    """(G, M) bool release mask: for each gang, the `n_release[g]` live
    ranks with the highest release keys (highest max inter-rank cost
    first, highest index on a tie). Tensors; `rank_nodes` is the resident
    rank assignment."""
    keys = rank_release_keys(rank_nodes, live, node_block, block_cost)
    G, M = rank_nodes.shape
    # each slot's rank in descending key order (0 = released first); the
    # keys are unique among live slots, so any sort agrees
    order = torch.argsort(-keys, dim=1)
    pos = torch.zeros_like(order).scatter(
        1, order, torch.arange(M, device=keys.device).expand(G, M)
        .contiguous())
    return live & (pos < n_release[:, None])


def shrink_select_np(rank_nodes, live, node_block, block_cost, n_release):
    """Bit-identical host twin of `shrink_select` (the one `GangPhase`
    applies: deletions are host mutations)."""
    rank_nodes = np.asarray(rank_nodes)
    live = np.asarray(live)
    node_block = np.asarray(node_block)
    block_cost = np.asarray(block_cost)
    n_release = np.asarray(n_release)
    G, M = rank_nodes.shape
    nb = np.where(live, node_block[np.maximum(rank_nodes, 0)], -1)
    known = nb >= 0
    nb0 = np.maximum(nb, 0)
    bc = block_cost[nb0[:, :, None], nb0[:, None, :]].astype(I64)
    cost = np.where(known[:, :, None] & known[:, None, :], bc, MAX_COST)
    same_node = rank_nodes[:, :, None] == rank_nodes[:, None, :]
    cost = np.where(same_node, 0, cost)
    valid = live[:, :, None] & live[:, None, :]
    valid &= ~np.eye(M, dtype=bool)[None]
    per_rank = np.max(np.where(valid, cost, 0), axis=2)
    keys = np.where(live, per_rank * M + np.arange(M), -1)
    order = np.argsort(-keys, axis=1, kind="stable")
    pos = np.zeros_like(order)
    np.put_along_axis(
        pos, order, np.broadcast_to(np.arange(M), (G, M)).copy(), axis=1
    )
    return live & (pos < n_release[:, None])


def elastic_bounds(pg):
    """(min, desired, max) replica bounds of a PodGroup: `min_member` is
    the quorum floor; `desired_replicas` defaults to min (a rigid gang);
    `max_replicas` caps desired, and a `max_replicas` below the quorum
    saturates at it (shrinking below quorum would make the partial-rank
    state the solve exists to prevent)."""
    lo = int(pg.min_member)
    desired = pg.desired_replicas if pg.desired_replicas is not None else lo
    hi = pg.max_replicas if pg.max_replicas is not None else max(desired, lo)
    hi = max(int(hi), lo)
    return lo, int(min(max(desired, lo), hi)), hi


def elastic_satisfaction(live_counts, desired_counts) -> float:
    """Mean over elastic gangs of min(live / desired, 1): 1.0 when every
    elastic gang runs at its desired width. Gangs with desired 0 are
    skipped; an empty input gives 1.0."""
    live_counts = np.asarray(live_counts, np.float64)
    desired_counts = np.asarray(desired_counts, np.float64)
    mask = desired_counts > 0
    if not mask.any():
        return 1.0
    frac = np.minimum(live_counts[mask] / desired_counts[mask], 1.0)
    return float(frac.mean())
