"""Coscheduling (port of `scheduler_plugins_tpu.plugins.coscheduling`).

Gang scheduling over PodGroups (upstream pkg/coscheduling: QueueSort,
PreFilter, PostFilter, Permit, Unreserve — coscheduling.go:49-55, core
engine core/core.go):

- QueueSort -> `queue_key`: a gang's members sort together, by the gang's
  creation (or last failure) time.
- PreFilter -> `ops.gang.gang_admit` against the carried free capacity,
  with the gang's in-cycle placements added back.
- Reserve -> the gang's in-cycle member count and demand carries.
- Permit quorum -> the runtime's tail after the per-pod loop.

Defaults (apis/config/v1/defaults.go:29-47): PermitWaitingTimeSeconds=60,
PodGroupBackoffSeconds=0, PodGroupRejectPercentage=10.
"""

from __future__ import annotations

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops.fit import pod_fit_demand
from scheduler_plugins_tpu_torch.ops.gang import (
    gang_admit,
    gang_commit,
    gang_inflight_commit,
)

DEFAULT_PERMIT_WAITING_SECONDS = 60
DEFAULT_POD_GROUP_BACKOFF_SECONDS = 0
DEFAULT_REJECT_PERCENTAGE = 10


class Coscheduling(Plugin):
    name = "Coscheduling"

    def __init__(
        self,
        permit_waiting_seconds: int = DEFAULT_PERMIT_WAITING_SECONDS,
        pod_group_backoff_seconds: int = DEFAULT_POD_GROUP_BACKOFF_SECONDS,
        reject_percentage: int = DEFAULT_REJECT_PERCENTAGE,
    ):
        # validation_pluginargs.go:48-58
        if permit_waiting_seconds < 0 or pod_group_backoff_seconds < 0:
            raise ValueError("timeouts must be non-negative")
        if not 0 <= reject_percentage <= 100:
            raise ValueError("reject percentage must be in [0, 100]")
        self.permit_waiting_seconds = permit_waiting_seconds
        self.pod_group_backoff_seconds = pod_group_backoff_seconds
        self.reject_percentage = reject_percentage

    def events_to_register(self):
        # a new sibling or PodGroup change can complete the quorum
        # (coscheduling.go:113-122)
        return (ev.POD_ADD, ev.POD_GROUP_ADD, ev.POD_GROUP_UPDATE)

    # QueueSort (coscheduling.go:133-145): priority desc -> group/pod
    # creation time (failure-time override kept by the cluster store) ->
    # name
    def queue_key(self, pod, cluster):
        created = pod.creation_ms
        tiebreak = f"{pod.namespace}/{pod.name}"
        if cluster is not None:
            pg = cluster.pod_group_of(pod)
            if pg is not None:
                created = cluster.gang_sort_time(pg)
                tiebreak = pg.full_name
        return (-pod.priority, created, tiebreak)

    def admit(self, state, snap, p):
        return self.admit_rows(state, snap, slice(p, p + 1))

    def admit_rows(self, state, snap, rows):
        if snap.gangs is None:
            return None
        return gang_admit(snap.gangs, state.free, snap.pods.gang[rows],
                          state.gang_inflight)

    def commit(self, state, snap, p, choice):
        if snap.gangs is None or state.gang_scheduled is None:
            return state
        placed = choice >= 0
        gang = snap.pods.gang[p:p + 1]
        state = state.replace(
            gang_scheduled=gang_commit(state.gang_scheduled, gang, placed)
        )
        if state.gang_inflight is not None:
            state = state.replace(
                gang_inflight=gang_inflight_commit(
                    state.gang_inflight, gang,
                    pod_fit_demand(snap.pods.req[p:p + 1]), placed,
                )
            )
        return state
