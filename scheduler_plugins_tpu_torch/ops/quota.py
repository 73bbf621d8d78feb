"""ElasticQuota admission (port of `scheduler_plugins_tpu.ops.quota`).

Reference PreFilter (upstream pkg/capacityscheduling/
capacity_scheduling.go:208-282) rejects a pod when its namespace's used +
request exceeds Max in any resource, or when the sum of used over all
quotas + request exceeds the sum of Min. Nominated pods join those
aggregates through per-pod vectors the snapshot builder precomputes.
"""

from __future__ import annotations

import torch


def quota_admit(eq_used, eq_min, eq_max, has_quota, ns, req,
                nominated_in_eq=None, nominated_total=None):
    """Admission verdicts for pods with namespace codes `ns` (any shape,
    0-d for one pod) and requests `req` (ns's shape + (R,)); the JAX package
    vmaps a scalar version over the pods. Pods in namespaces without a
    quota pass."""
    ns = ns.long()
    in_eq = req if nominated_in_eq is None else req + nominated_in_eq
    total = req if nominated_total is None else req + nominated_total
    over_max = torch.any(eq_used[ns] + in_eq > eq_max[ns], dim=-1)
    agg_used = torch.where(has_quota[:, None], eq_used, 0).sum(dim=0)
    agg_min = torch.where(has_quota[:, None], eq_min, 0).sum(dim=0)
    over_min = torch.any(agg_used + total > agg_min, dim=-1)
    return torch.where(has_quota[ns], ~(over_max | over_min), True)


def nominee_sums(mask, nom_req):
    """(K, R) int64 sums of the nominees' (M, R) requests selected by each
    column of the (M, K) bool `mask`: a float64 product (int64 has no
    CUDA matmul), exact while every sum stays below 2^53."""
    return (mask.to(torch.float64).T @ nom_req.to(torch.float64)).to(
        torch.int64
    )


def quota_commit(eq_used, has_quota, ns, req, placed):
    """Reserve: add `req` to each placed pod's namespace usage when the
    namespace has a quota (capacity_scheduling.go:350-368). `ns` and
    `placed` of one shape, `req` that shape + (R,); returns a new tensor."""
    ns = ns.long()
    add = torch.where((placed & has_quota[ns])[..., None], req, 0)
    return torch.index_add(
        eq_used, 0, ns.reshape(-1), add.reshape(-1, eq_used.shape[1])
    )


def nominee_contribution(same_namespace: bool, nominee_priority: int,
                         pod_priority: int, nominee_eq_over_min: bool):
    """Which aggregates a nominated pod's request joins for one pending
    pod (capacity_scheduling.go:247-257): (counts_in_eq, counts_in_total)."""
    if same_namespace and nominee_priority >= pod_priority:
        return True, True
    if not same_namespace and not nominee_eq_over_min:
        return False, True
    return False, False
