"""Per-cycle placement-quality objectives (port of
`scheduler_plugins_tpu.tuning.quality.cycle_quality_np`).

Host numpy on one copy of the snapshot's columns, with the JAX package's
float64 arithmetic in the same order, so both packages stamp the same
numbers bit for bit:

- fragmentation: 1 - largest node free / total free, averaged over cpu
  and memory, after this cycle's placements;
- util_imbalance: population stddev of per-node cpu/memory utilization;
- packed_utilization: 1 - free / allocatable over nodes holding a pod;
- gang_wait_frac: placed pods that wait on quorum, over placed pods;
- unplaced_frac: real batch pods not placed, over real batch pods.
"""

from __future__ import annotations

import numpy as np

from scheduler_plugins_tpu_torch.api.resources import CANONICAL, CPU, MEMORY
from scheduler_plugins_tpu_torch.ops import PODS_I

CPU_I = CANONICAL.index(CPU)
MEM_I = CANONICAL.index(MEMORY)

#: the objectives `cycle_quality_np` emits per cycle
CYCLE_OBJECTIVES = (
    "fragmentation", "util_imbalance", "packed_utilization",
    "gang_wait_frac", "unplaced_frac",
)


def pod_fit_demand_np(req) -> np.ndarray:
    """Numpy twin of `ops.fit.pod_fit_demand`: the effective request with
    the pod-count slot charged 1 per pod."""
    demand = np.asarray(req).copy()
    demand[:, PODS_I] = 1
    return demand


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
