"""Per-cycle placement-quality objectives (port of
`scheduler_plugins_tpu.tuning.quality`).

Each objective is a float64 scalar of a solved cycle (snapshot,
assignment, admitted, wait):

- fragmentation: 1 - largest node free / total free, averaged over cpu
  and memory, after this cycle's placements;
- util_imbalance: population stddev of per-node cpu/memory utilization;
- packed_utilization: 1 - free / allocatable over nodes holding a pod;
- gang_wait_frac: placed pods that wait on quorum, over placed pods;
- unplaced_frac: real batch pods not placed, over real batch pods.

Two forms, each with the JAX package's float64 arithmetic in its order:
the tensor gauges (`placed_demand`, `fragmentation`, `packed_utilization`,
`util_imbalance`, `cycle_quality`) on torch tensors on the snapshot's
device, and `cycle_quality_np`, host numpy on one copy of the snapshot's
columns, which `run_cycle` stamps on every report.
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import CANONICAL, CPU, MEMORY
from scheduler_plugins_tpu_torch.ops import PODS_I
from scheduler_plugins_tpu_torch.ops.fit import free_capacity, pod_fit_demand
from scheduler_plugins_tpu_torch.tuning.gates import pod_fit_demand_np

CPU_I = CANONICAL.index(CPU)
MEM_I = CANONICAL.index(MEMORY)

F64 = torch.float64

#: the objectives `cycle_quality` / `cycle_quality_np` emit per cycle
CYCLE_OBJECTIVES = (
    "fragmentation", "util_imbalance", "packed_utilization",
    "gang_wait_frac", "unplaced_frac",
)


def _core(x):
    """(N, 2) the cpu and memory columns of an (N, R) tensor (stacked
    slices: an index list would be a host copy)."""
    return torch.stack((x[:, CPU_I], x[:, MEM_I]), dim=1)


def placed_demand(req, assignment, n_nodes: int):
    """(N, R) demand committed by the placements: each placed pod's fit
    demand scatter-added onto its node."""
    demand = pod_fit_demand(req)
    placed = assignment >= 0
    add = torch.where(placed[:, None], demand, 0)
    out = torch.zeros((n_nodes, req.shape[1]), dtype=req.dtype,
                      device=req.device)
    return out.index_add_(0, torch.clamp(assignment, min=0).long(), add)


def fragmentation(free, node_mask):
    """Scalar float64 free-capacity fragmentation (module docstring)."""
    core = _core(torch.where(node_mask[:, None], free, 0).to(F64))
    total = core.sum(dim=0)
    largest = core.amax(dim=0)
    frag = torch.where(total > 0,
                       1.0 - largest / torch.clamp(total, min=1.0), 0.0)
    return frag.mean()


def packed_utilization(alloc, free, node_mask):
    """Scalar float64: 1 - the free over the allocatable of the nodes
    holding a pod (pods-slot usage > 0), per core resource, averaged over
    cpu and memory; 0.0 when no node holds a pod."""
    allocf = alloc.to(F64)
    freef = free.to(F64)
    occ = node_mask & (allocf[:, PODS_I] - freef[:, PODS_I] > 0)
    num = _core(torch.where(occ[:, None], freef, 0.0)).sum(dim=0)
    den = _core(torch.where(occ[:, None], allocf, 0.0)).sum(dim=0)
    frac = torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)
    return torch.where(occ.any(), (1.0 - frac).mean(), 0.0)


def util_imbalance(alloc, free, node_mask):
    """Scalar float64 population stddev of per-node cpu/memory
    utilization over schedulable nodes."""
    allocf = _core(alloc.to(F64))
    usedf = allocf - _core(free.to(F64))
    util = torch.where(allocf > 0, usedf / torch.clamp(allocf, min=1.0),
                       0.0)
    node_util = util.mean(dim=1)
    n = torch.clamp(node_mask.sum(), min=1)
    mean = torch.where(node_mask, node_util, 0.0).sum() / n
    var = torch.where(node_mask, (node_util - mean) ** 2, 0.0).sum() / n
    return torch.sqrt(var)


def _quality_terms(snap, assignment, wait):
    free0 = free_capacity(snap.nodes.alloc, snap.nodes.requested)
    free0 = torch.where(snap.nodes.mask[:, None], free0, 0)
    free = free0 - placed_demand(snap.pods.req, assignment, snap.num_nodes)
    placed = (assignment >= 0) & snap.pods.mask
    n_real = torch.clamp(snap.pods.mask.sum(), min=1)
    return {
        "fragmentation": fragmentation(free, snap.nodes.mask),
        "util_imbalance": util_imbalance(snap.nodes.alloc, free,
                                         snap.nodes.mask),
        "packed_utilization": packed_utilization(snap.nodes.alloc, free,
                                                 snap.nodes.mask),
        "gang_wait_frac": (
            torch.where(placed, wait, False).sum().to(F64)
            / torch.clamp(placed.sum(), min=1)
        ),
        "unplaced_frac": 1.0 - placed.sum().to(F64) / n_real,
    }


def cycle_quality(snap, assignment, admitted, wait) -> dict:
    """{objective: float} of one solved cycle, computed on the snapshot's
    device with one host read. `assignment` and `wait` may be tensors or
    numpy arrays; `admitted` is part of the JAX signature and is not
    read."""
    terms = _quality_terms(
        snap, torch.as_tensor(assignment, device=snap.device),
        torch.as_tensor(wait, device=snap.device).to(torch.bool))
    names = tuple(terms)
    values = torch.stack([terms[k] for k in names]).tolist()
    return dict(zip(names, values))


def cycle_quality_np(snap, assignment, admitted, wait) -> dict:
    """The cycle objectives from host arrays: `snap` holds numpy
    `nodes.alloc/requested/mask` and `pods.req/mask`; `admitted` is part
    of the signature the JAX function has and is not read."""
    alloc = np.asarray(snap.nodes.alloc)
    requested = np.asarray(snap.nodes.requested)
    node_mask = np.asarray(snap.nodes.mask)
    req = np.asarray(snap.pods.req)
    pods_mask = np.asarray(snap.pods.mask)
    assignment = np.asarray(assignment)
    wait = np.asarray(wait).astype(bool)

    free = np.where(node_mask[:, None], alloc - requested, 0)
    demand = pod_fit_demand_np(req)
    placed = (assignment >= 0) & pods_mask
    free = free.copy()
    np.add.at(free, assignment[placed], -demand[placed])

    core = np.where(node_mask[:, None], free, 0).astype(np.float64)[
        :, (CPU_I, MEM_I)
    ]
    total = core.sum(axis=0)
    largest = core.max(axis=0, initial=0.0)
    frag = np.where(total > 0, 1.0 - largest / np.maximum(total, 1.0), 0.0)

    allocf = alloc.astype(np.float64)[:, (CPU_I, MEM_I)]
    usedf = allocf - free.astype(np.float64)[:, (CPU_I, MEM_I)]
    util = np.where(allocf > 0, usedf / np.maximum(allocf, 1.0), 0.0)
    node_util = util.mean(axis=1)
    n = max(int(node_mask.sum()), 1)
    mean = float(np.where(node_mask, node_util, 0.0).sum()) / n
    var = float(np.where(node_mask, (node_util - mean) ** 2, 0.0).sum()) / n

    allocf2 = alloc.astype(np.float64)
    freef2 = free.astype(np.float64)
    occ = node_mask & (allocf2[:, PODS_I] - freef2[:, PODS_I] > 0)
    num = np.where(occ[:, None], freef2, 0.0)[:, (CPU_I, MEM_I)].sum(axis=0)
    den = np.where(occ[:, None], allocf2, 0.0)[:, (CPU_I, MEM_I)].sum(axis=0)
    pfrac = np.where(den > 0, num / np.maximum(den, 1.0), 0.0)
    packed = float((1.0 - pfrac).mean()) if occ.any() else 0.0

    n_real = max(int(pods_mask.sum()), 1)
    return {
        "fragmentation": float(frag.mean()),
        "util_imbalance": float(np.sqrt(var)),
        "packed_utilization": packed,
        "gang_wait_frac": float((placed & wait).sum())
        / max(int(placed.sum()), 1),
        "unplaced_frac": 1.0 - float(placed.sum()) / n_real,
    }


# ---------------------------------------------------------------------------
# rank-aware gang placement objectives (gangs.topology)
# ---------------------------------------------------------------------------


def rank_gang_quality(rank_nodes, rank_mask, node_block, block_cost) -> dict:
    """Placement-quality objectives of a rank-gang solve: host float64
    reductions over `gangs.topology.pair_costs`.

    - ``gang_spread_cost``: the mean over solved gangs of the SUM of
      inter-rank pair costs (each unordered pair once);
    - ``rank_cost_max``: the max inter-rank pair cost across every gang
      (one slow link paces a whole collective);
    - ``rank_cost_p99``: the 99th percentile over ALL valid rank-pair
      costs.

    Gangs with fewer than 2 placed ranks contribute no pairs; with no
    pairs at all every objective is 0.0."""
    from scheduler_plugins_tpu_torch.gangs.topology import pair_costs

    pc = np.asarray(
        pair_costs(rank_nodes, rank_mask, node_block, block_cost)
    )
    valid = pc >= 0
    if not valid.any():
        return {
            "gang_spread_cost": 0.0, "rank_cost_max": 0.0,
            "rank_cost_p99": 0.0,
        }
    per_gang_sum = np.sum(np.where(valid, pc, 0), axis=(1, 2)) / 2.0
    gang_has = valid.any(axis=(1, 2))
    flat = pc[valid].astype(np.float64)
    return {
        "gang_spread_cost": float(per_gang_sum[gang_has].mean()),
        "rank_cost_max": float(flat.max()),
        "rank_cost_p99": float(np.percentile(flat, 99)),
    }


def elastic_satisfaction_quality(reports_or_counts) -> float:
    """The fleet's elastic-satisfaction fraction (`gangs.elastic`): from
    (live_counts, desired_counts) arrays, or from an iterable of
    `CycleReport.rank_gangs` dicts (the LAST observation of each gang
    wins: satisfaction is a state, not a flow)."""
    from scheduler_plugins_tpu_torch.gangs.elastic import (
        elastic_satisfaction,
    )

    if isinstance(reports_or_counts, tuple):
        return elastic_satisfaction(*reports_or_counts)
    latest: dict = {}
    for stats in reports_or_counts:
        for gang, row in stats.items():
            latest[gang] = (
                row.get("resident", 0) + row.get("placed_new", 0),
                row.get("desired", 0),
            )
    if not latest:
        return 1.0
    live = [v[0] for v in latest.values()]
    desired = [v[1] for v in latest.values()]
    return elastic_satisfaction(live, desired)
