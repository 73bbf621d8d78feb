"""Hard-constraint replay oracles (port of
`scheduler_plugins_tpu.tuning.gates`).

Numpy re-statements, independent of the solvers, of the hard-constraint
families every solve enforces: resource fit, placements on schedulable
nodes only, queue-order elastic quota (Max and aggregate Min) and gang
quorum Permit, replayed against a snapshot and a candidate assignment.
Each oracle returns a violation count (0 = clean). The snapshot's fields
and the assignment may be torch tensors on any device or numpy arrays:
each is copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.ops import PODS_I


def _host(x) -> np.ndarray:
    """`x` as a host numpy array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pod_fit_demand_np(req) -> np.ndarray:
    """Numpy twin of `ops.fit.pod_fit_demand`: the effective request with
    the pod-count slot charged 1 per pod; the one host copy of the
    fit-demand rule, shared by these oracles and the quality stamp
    (`tuning.quality.cycle_quality_np`)."""
    demand = _host(req).copy()
    demand[:, PODS_I] = 1
    return demand


def fit_violations(snap, assignment) -> int:
    """(node, resource) cells over allocatable after committing the
    placements (pods slot charged 1 per pod). Out-of-range node indices are
    `mask_violations`' count; this oracle skips them."""
    alloc = _host(snap.nodes.alloc)
    requested = _host(snap.nodes.requested)
    assignment = _host(assignment)
    used = requested.copy()
    demand = pod_fit_demand_np(snap.pods.req)
    placed = (assignment >= 0) & (assignment < alloc.shape[0])
    np.add.at(used, assignment[placed], demand[placed])
    return int((used > alloc).sum())


def mask_violations(snap, assignment) -> int:
    """Placements on unschedulable (masked) or padded node rows."""
    node_mask = _host(snap.nodes.mask)
    assignment = _host(assignment)
    placed = assignment[assignment >= 0]
    n = node_mask.shape[0]
    return int((placed >= n).sum() + (~node_mask[np.minimum(placed, n - 1)]
                                      & (placed < n)).sum())


def quota_violations(snap, assignment) -> int:
    """Placed quota-namespace pods past their Max or the aggregate-Min
    pool at their own queue-order admission step
    (capacity_scheduling.go:208-282)."""
    if snap.quota is None:
        return 0
    req = _host(snap.pods.req).astype(np.int64)
    ns = _host(snap.pods.ns)
    has_q = _host(snap.quota.has_quota)
    qmax = _host(snap.quota.max).astype(np.int64)
    qmin = _host(snap.quota.min).astype(np.int64)
    used = _host(snap.quota.used).astype(np.int64).copy()
    assignment = _host(assignment)
    agg_min = (qmin * has_q[:, None]).sum(axis=0)
    agg_used = (used * has_q[:, None]).sum(axis=0)
    violations = 0
    for p in range(len(assignment)):
        if assignment[p] < 0 or not has_q[ns[p]]:
            continue
        if (used[ns[p]] + req[p] > qmax[ns[p]]).any() or (
            agg_used + req[p] > agg_min
        ).any():
            violations += 1
            continue  # a violating pod holds no capacity it was denied
        used[ns[p]] += req[p]
        agg_used += req[p]
    return violations


def gang_quorum_violations(snap, assignment, wait) -> int:
    """Gangs with a member bound (placed, not Permit-Wait) below quorum
    (assigned before + placed this cycle < MinMember)."""
    if snap.gangs is None:
        return 0
    gang = _host(snap.pods.gang)
    min_member = _host(snap.gangs.min_member)
    assigned = _host(snap.gangs.assigned)
    assignment = _host(assignment)
    wait = _host(wait).astype(bool)
    placed = assignment >= 0
    violations = 0
    for g in range(len(min_member)):
        members = gang == g
        bound = int((members & placed & ~wait).sum())
        total = int((members & placed).sum()) + int(assigned[g])
        if bound > 0 and total < int(min_member[g]):
            violations += 1
    return violations


def hard_violations(snap, assignment, wait) -> dict:
    """{family: count} and "total"."""
    out = {
        "fit": fit_violations(snap, assignment),
        "mask": mask_violations(snap, assignment),
        "quota": quota_violations(snap, assignment),
        "gang_quorum": gang_quorum_violations(snap, assignment, wait),
    }
    out["total"] = sum(out.values())
    return out
