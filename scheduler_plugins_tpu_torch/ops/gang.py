"""PodGroup (gang) admission (port of `scheduler_plugins_tpu.ops.gang`).

Reference PreFilter (upstream pkg/coscheduling/core/core.go:243-305):
reject a member when the group is backed off, has fewer siblings than
MinMember, has too many gated siblings to reach quorum, or its MinResources
exceed the whole-cluster free capacity (raw, unclamped per-node leftovers
plus the gang's own assigned members added back, and, in the sequential
solve, its own in-cycle placements: `SolverState.gang_inflight`).
"""

from __future__ import annotations

import torch


def cluster_free_total(free: torch.Tensor) -> torch.Tensor:
    """(R,) whole-cluster leftover: raw per-node sums, negatives included."""
    return free.sum(dim=0)


def gang_admit(gangs, state_free: torch.Tensor, gang_id: torch.Tensor,
               inflight=None) -> torch.Tensor:
    """Admission verdicts for gang codes `gang_id` (any shape; -1 = not in
    a gang -> pass). The JAX package vmaps a scalar version over the pods;
    here the pod axis is a batch dimension. `inflight` (G, R) is the demand
    each gang placed earlier in this solve, added back like
    `cluster_slack`."""
    in_gang = gang_id >= 0
    g = torch.clamp(gang_id, min=0).long()
    enough_members = gangs.total_members[g] >= gangs.min_member[g]
    not_backed_off = ~gangs.backed_off[g]
    # gated siblings can never reach quorum (core.go:268-277)
    reachable = gangs.total_members[g] - gangs.gated[g] >= gangs.min_member[g]
    capacity = cluster_free_total(state_free) + gangs.cluster_slack[g]
    if inflight is not None:
        capacity = capacity + inflight[g]
    fits_cluster = torch.all(gangs.min_resources[g] <= capacity, dim=-1)
    minres_ok = ~gangs.has_min_resources[g] | fits_cluster
    verdict = enough_members & not_backed_off & reachable & minres_ok
    return torch.where(in_gang, verdict, True)


def gang_commit(gang_scheduled: torch.Tensor, gang_id: torch.Tensor,
                placed: torch.Tensor) -> torch.Tensor:
    """Count in-cycle placements toward their gangs' quorum (`gang_id` and
    `placed` of one shape; a new tensor is returned)."""
    add = (placed & (gang_id >= 0)).to(gang_scheduled.dtype)
    return torch.index_add(
        gang_scheduled, 0, torch.clamp(gang_id, min=0).long().reshape(-1),
        add.reshape(-1),
    )


def gang_inflight_commit(gang_inflight: torch.Tensor, gang_id: torch.Tensor,
                         demand: torch.Tensor,
                         placed: torch.Tensor) -> torch.Tensor:
    """Fold placed members' demand (`demand` (..., R) beside `gang_id`
    (...)) into their gangs' in-cycle add-back."""
    add = torch.where((placed & (gang_id >= 0))[..., None], demand, 0)
    return torch.index_add(
        gang_inflight, 0, torch.clamp(gang_id, min=0).long().reshape(-1),
        add.reshape(-1, gang_inflight.shape[1]),
    )
