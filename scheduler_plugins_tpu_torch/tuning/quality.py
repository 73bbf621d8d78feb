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
`util_imbalance`, `cycle_quality`, `batch_quality` over K candidate
placements of one cycle in one `torch.func.vmap`, `state_quality` of an
accumulated cluster state) on torch tensors on the snapshot's device, and
`cycle_quality_np`, host numpy on one copy of the snapshot's columns,
which `run_cycle` stamps on every report.

`SENSE` gives each objective's improvement direction; `score_drift` is
the relative score-sum drift against an anchor's placements on a (P, N)
cycle-initial score matrix. Objectives that need memory across cycles
(gang admission latency, the preemption totals) live in
`QualityAccumulator` and `gang_admission_latency`.
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import CANONICAL, CPU, MEMORY
from scheduler_plugins_tpu_torch.ops import PODS_I
from scheduler_plugins_tpu_torch.ops.fit import free_capacity, pod_fit_demand
from scheduler_plugins_tpu_torch.tuning.gates import pod_fit_demand_np
from scheduler_plugins_tpu_torch.utils.intmath import add_rows

CPU_I = CANONICAL.index(CPU)
MEM_I = CANONICAL.index(MEMORY)

F64 = torch.float64

#: objective -> +1 (higher is better) / -1 (lower is better)
SENSE = {
    "fragmentation": -1,
    "util_imbalance": -1,
    "packed_utilization": +1,
    "gang_wait_frac": -1,
    "unplaced_frac": -1,
    "drift": +1,
    "preemptions": -1,
    "nominations": -1,
    "gang_latency_cycles": -1,
    # rank-aware gang placement (gangs.topology)
    "gang_spread_cost": -1,
    "rank_cost_max": -1,
    "rank_cost_p99": -1,
    "elastic_satisfaction": +1,
}

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
    demand scatter-added onto its node, out of place (so `batch_quality`
    can map it over K candidate placements). A node index past the rows
    adds nothing, as JAX drops an out-of-bounds scatter: the chaos
    harness's garbage sweep lanes are scored, then failed by the gates."""
    demand = pod_fit_demand(req)
    placed = (assignment >= 0) & (assignment < n_nodes)
    add = torch.where(placed[:, None], demand, 0)
    out = torch.zeros((n_nodes, req.shape[1]), dtype=req.dtype,
                      device=req.device)
    return add_rows(out, torch.where(placed, assignment, 0).long(), add)


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


def batch_quality(snap, assignments, waits) -> dict:
    """{objective: (K,) float64} for K candidate placements of ONE cycle
    (`assignments` and `waits` (K, P), tensors or numpy) in one
    `torch.func.vmap` of the cycle objectives on the snapshot's device, one
    host copy: how the weight sweep scores every candidate at once."""
    terms = torch.func.vmap(lambda a, w: _quality_terms(snap, a, w))(
        torch.as_tensor(np.asarray(assignments), device=snap.device),
        torch.as_tensor(np.asarray(waits), device=snap.device).to(
            torch.bool))
    names = tuple(terms)
    values = torch.stack([terms[k] for k in names]).cpu().numpy()
    return {name: values[i] for i, name in enumerate(names)}


def state_quality(alloc, used, node_mask=None) -> dict:
    """{fragmentation, util_imbalance, packed_utilization} of a CLUSTER
    STATE (allocatable and used (N, R) matrices on the CANONICAL axis,
    tensors or numpy): the multi-cycle benches score their accumulated end
    state with this instead of one cycle's placements."""
    alloc = torch.as_tensor(alloc)
    used = torch.as_tensor(used, device=alloc.device)
    node_mask = (torch.ones(alloc.shape[0], dtype=torch.bool,
                            device=alloc.device) if node_mask is None
                 else torch.as_tensor(node_mask, device=alloc.device))
    free = torch.where(node_mask[:, None], alloc - used, 0)
    values = torch.stack([
        fragmentation(free, node_mask),
        util_imbalance(alloc, free, node_mask),
        packed_utilization(alloc, free, node_mask),
    ]).tolist()
    return dict(zip(("fragmentation", "util_imbalance",
                     "packed_utilization"), values))


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


def score_drift(scores, assignment, anchor) -> float:
    """Relative score-sum drift of `assignment` against `anchor`'s
    placements on a (P, N) cycle-initial score matrix, host numpy.
    Out-of-range node indices (garbage placements, the chaos harness's
    corrupted sweep output) contribute nothing instead of crashing the
    scorer: the hard-constraint oracles are the gate that counts them."""
    scores = np.asarray(scores)
    a = np.asarray(assignment)
    ref = np.asarray(anchor)

    def ssum(x):
        placed = (x >= 0) & (x < scores.shape[1])
        return int(scores[np.nonzero(placed)[0], x[placed]].sum())

    s_ref = ssum(ref)
    return (ssum(a) - s_ref) / max(abs(s_ref), 1)


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


# ---------------------------------------------------------------------------
# multi-cycle: gang admission latency
# ---------------------------------------------------------------------------


class QualityAccumulator:
    """Host accumulator for objectives that need memory across cycles:
    gang admission latency (cycles from a gang's first pending appearance
    to its first member binding; 0 = admitted the cycle it arrived) and
    the preemption / nomination totals. Feed one `(cycle_no, report,
    gang_of)` a cycle; `gang_of` maps a pod uid to its gang name (or
    None)."""

    def __init__(self):
        self._first_pending: dict = {}
        self.latencies: dict = {}  # gang -> cycles waited
        self.preemptions = 0
        self.nominations = 0

    def observe(self, cycle_no: int, report, gang_of) -> None:
        self.nominations += len(report.preempted)
        self.preemptions += sum(
            len(victims) for _, victims in report.preempted.values()
        )
        pending = set()
        for uid in list(report.failed) + list(report.reserved):
            g = gang_of(uid)
            if g is not None:
                pending.add(g)
        admitted = set()
        for uid in report.bound:
            g = gang_of(uid)
            if g is not None:
                admitted.add(g)
        for g in pending | admitted:
            self._first_pending.setdefault(g, cycle_no)
        for g in admitted:
            if g not in self.latencies:
                self.latencies[g] = cycle_no - self._first_pending[g]

    def summary(self) -> dict:
        lat = list(self.latencies.values())
        return {
            "gang_latency_cycles": (
                float(np.mean(lat)) if lat else None
            ),
            "gangs_admitted": len(lat),
            "gangs_still_waiting": len(self._first_pending)
            - len(self.latencies),
            "preemptions": self.preemptions,
            "nominations": self.nominations,
        }


def gang_admission_latency(cycles) -> dict:
    """Gang admission latency over a recorded-corpus replay: `cycles` is
    an iterable of (gang_names, gang (P,), assignment (P,), wait (P,)) in
    cycle order. A gang is pending while a member sits in the batch, and
    admitted the first cycle a member places with quorum met (wait
    False). Returns {gang: cycles waited} for the admitted gangs."""
    first: dict = {}
    admitted: dict = {}
    for cycle_no, (gang_names, gang, assignment, wait) in enumerate(cycles):
        gang = np.asarray(gang)
        assignment = np.asarray(assignment)
        wait = np.asarray(wait).astype(bool)
        for g, name in enumerate(gang_names):
            members = gang == g
            if not members.any():
                continue
            first.setdefault(name, cycle_no)
            if name not in admitted and (
                members & (assignment >= 0) & ~wait
            ).any():
                admitted[name] = cycle_no - first[name]
    return admitted
