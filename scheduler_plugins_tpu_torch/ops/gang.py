"""PodGroup (gang) admission (port of `scheduler_plugins_tpu.ops.gang`).

Reference PreFilter (upstream pkg/coscheduling/core/core.go:243-305):
reject a member when the group is backed off, has fewer siblings than
MinMember, has too many gated siblings to reach quorum, or its MinResources
exceed the whole-cluster free capacity (raw, unclamped per-node leftovers
plus the gang's own assigned members added back).
"""

from __future__ import annotations

import torch


def cluster_free_total(free: torch.Tensor) -> torch.Tensor:
    """(R,) whole-cluster leftover: raw per-node sums, negatives included."""
    return free.sum(dim=0)


def gang_admit(gangs, state_free: torch.Tensor,
               gang_id: torch.Tensor) -> torch.Tensor:
    """Admission verdicts for gang codes `gang_id` (any shape; -1 = not in
    a gang -> pass). The JAX package vmaps a scalar version over the pods;
    here the pod axis is a batch dimension."""
    in_gang = gang_id >= 0
    g = torch.clamp(gang_id, min=0).long()
    enough_members = gangs.total_members[g] >= gangs.min_member[g]
    not_backed_off = ~gangs.backed_off[g]
    # gated siblings can never reach quorum (core.go:268-277)
    reachable = gangs.total_members[g] - gangs.gated[g] >= gangs.min_member[g]
    capacity = cluster_free_total(state_free) + gangs.cluster_slack[g]
    fits_cluster = torch.all(gangs.min_resources[g] <= capacity, dim=-1)
    minres_ok = ~gangs.has_min_resources[g] | fits_cluster
    verdict = enough_members & not_backed_off & reachable & minres_ok
    return torch.where(in_gang, verdict, True)
