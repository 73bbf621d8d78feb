"""CapacityScheduling (port of `scheduler_plugins_tpu.plugins.capacityscheduling`).

Per-namespace elastic quota (upstream pkg/capacityscheduling: PreFilter
with AddPod/RemovePod extensions, quota-aware preemption PostFilter,
Reserve/Unreserve — capacity_scheduling.go:101-105). The (Q, R) `eq_used`
usage is carried through the solve; PreFilter's two rejects (over own Max,
aggregate over cluster Min) are `ops.quota.quota_admit`, Reserve is
`quota_commit`; PostFilter is the quota-aware preemption engine
(`framework.preemption`, CAPACITY mode).
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.framework.preemption import (
    PreemptionEngine,
    PreemptionMode,
)
from scheduler_plugins_tpu_torch.ops.quota import (
    nominee_sums,
    quota_admit,
    quota_commit,
)


class CapacityScheduling(Plugin):
    name = "CapacityScheduling"

    def __init__(self, min_candidate_nodes_percentage: int = None,
                 min_candidate_nodes_absolute: int = None):
        # the candidate-sampling knobs of the upstream evaluator the
        # reference wraps; checked at load time
        PreemptionEngine.validate_sampling_args(
            min_candidate_nodes_percentage, min_candidate_nodes_absolute
        )
        self.min_candidate_nodes_percentage = min_candidate_nodes_percentage
        self.min_candidate_nodes_absolute = min_candidate_nodes_absolute

    def events_to_register(self):
        # freed capacity or quota growth (capacity_scheduling.go:194-203;
        # the EQ event is ActionType All)
        return (ev.POD_DELETE, ev.ELASTIC_QUOTA_ADD, ev.ELASTIC_QUOTA_UPDATE,
                ev.ELASTIC_QUOTA_DELETE)

    def preemption_engine(self):
        """PostFilter = quota-aware preemption (capacity_scheduling.go:
        331-348 wraps the upstream evaluator with the EQ borrow rules)."""
        return PreemptionEngine(
            PreemptionMode.CAPACITY,
            min_candidate_nodes_percentage=self.min_candidate_nodes_percentage,
            min_candidate_nodes_absolute=self.min_candidate_nodes_absolute,
        )

    def prepare_solve(self, snap):
        """(M,) batch rows of the nominees inside the batch (clamped) and
        which nominees are inside it: pod-invariant."""
        if snap.quota is None:
            return None
        idx = snap.quota.nom_batch_idx
        return torch.clamp(idx, min=0).long(), idx >= 0

    def admit(self, state, snap, p):
        if snap.quota is None or state.eq_used is None:
            return None
        quota = snap.quota
        row, in_batch = self._presolve or self.prepare_solve(snap)
        # live nominee aggregates: a nominee that already placed in this
        # solve is usage (the eq_used carry), not a nomination anymore
        if state.placed_mask is not None:
            live = ~(state.placed_mask[row] & in_batch)
        else:
            live = torch.ones_like(in_batch)
        in_eq = torch.where(
            (quota.nom_in_eq_mask[:, p] & live)[:, None], quota.nom_req, 0
        ).sum(dim=0)
        total = torch.where(
            (quota.nom_total_mask[:, p] & live)[:, None], quota.nom_req, 0
        ).sum(dim=0)
        return quota_admit(
            state.eq_used, quota.min, quota.max, quota.has_quota,
            snap.pods.ns[p:p + 1], snap.pods.req[p:p + 1], in_eq, total,
        )

    def admit_rows(self, state, snap, rows):
        if snap.quota is None or state.eq_used is None:
            return None
        quota = snap.quota
        row, in_batch = self._presolve or self.prepare_solve(snap)
        if state.placed_mask is not None:
            live = ~(state.placed_mask[row] & in_batch)
        else:
            live = torch.ones_like(in_batch)
        in_eq = nominee_sums(quota.nom_in_eq_mask[:, rows] & live[:, None],
                             quota.nom_req)
        total = nominee_sums(quota.nom_total_mask[:, rows] & live[:, None],
                             quota.nom_req)
        return quota_admit(
            state.eq_used, quota.min, quota.max, quota.has_quota,
            snap.pods.ns[rows], snap.pods.req[rows], in_eq, total,
        )

    def commit(self, state, snap, p, choice):
        if snap.quota is None or state.eq_used is None:
            return state
        return state.replace(
            eq_used=quota_commit(
                state.eq_used, snap.quota.has_quota,
                snap.pods.ns[p:p + 1], snap.pods.req[p:p + 1], choice >= 0,
            )
        )
