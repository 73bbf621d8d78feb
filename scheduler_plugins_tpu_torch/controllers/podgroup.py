"""PodGroup status reconciler.

Mirror of pkg/controllers/podgroup_controller.go:66-139 — the
phase machine driven by member pod phases:

    "" -> Pending
    Pending -> Scheduling once MinMember siblings exist (records OccupiedBy)
    Scheduling/Running: recount running/succeeded/failed;
        fewer siblings than MinMember  -> back to Pending
        succeeded+running < MinMember  -> Scheduling
        succeeded+running >= MinMember -> Running
        failed > 0 and failed+running+succeeded >= MinMember -> Failed (final)
        succeeded >= MinMember -> Finished (final)

Terminal phases and the 48h stale-schedule timeout stop reconciliation
(the reference emits a Timeout warning event).
"""

from __future__ import annotations

from scheduler_plugins_tpu_torch.api.objects import PodGroup, PodGroupPhase, PodPhase
from scheduler_plugins_tpu_torch.state.cluster import Cluster

STALE_SCHEDULE_MS = 48 * 3600 * 1000


def reconcile_pod_groups(cluster: Cluster, now_ms: int = 0) -> list[str]:
    """One reconcile pass over every PodGroup; returns emitted event strings
    (the recorder boundary)."""
    events = []
    for pg in cluster.pod_groups.values():
        events.extend(_reconcile_one(cluster, pg, now_ms))
    return events


def _pod_stats(pods) -> tuple[int, int, int]:
    running = sum(1 for p in pods if p.phase == PodPhase.RUNNING)
    succeeded = sum(1 for p in pods if p.phase == PodPhase.SUCCEEDED)
    failed = sum(1 for p in pods if p.phase == PodPhase.FAILED)
    return running, succeeded, failed


def _transition_event(pg: PodGroup, old_phase) -> list[str]:
    """Recorder boundary: one event per phase transition — the
    observability the reference gets from its status patches + manager
    logs (podgroup_controller.go:104-139 phase switch; the recorder itself
    upstream only carries the Timeout warning, line 87). Failure
    transitions record as Warning like the Timeout event, so event-type
    filters see gang failures."""
    if pg.phase == old_phase:
        return []
    etype = "Warning" if pg.phase == PodGroupPhase.FAILED else "Normal"
    return [
        f"{etype} {str(pg.phase)} {pg.full_name}: "
        f"phase transitioned from {str(old_phase) or 'unset'} to {str(pg.phase)}"
    ]


def _reconcile_one(cluster: Cluster, pg: PodGroup, now_ms: int) -> list[str]:
    if pg.phase in (PodGroupPhase.FINISHED, PodGroupPhase.FAILED):
        return []
    if (
        pg.phase in (PodGroupPhase.SCHEDULING, PodGroupPhase.PENDING)
        and pg.running == 0
        and pg.schedule_start_ms - pg.creation_ms > STALE_SCHEDULE_MS
    ):
        return [f"Warning Timeout {pg.full_name}: schedule time longer than 48 hours"]

    old_phase = pg.phase
    pods = cluster.gang_members(pg)
    if pg.phase == PodGroupPhase.PENDING or pg.phase == "":
        pg.phase = PodGroupPhase.PENDING
        if len(pods) >= pg.min_member:
            pg.phase = PodGroupPhase.SCHEDULING
            pg.schedule_start_ms = now_ms
            if pods:
                pg.occupied_by = pods[0].uid
        return _transition_event(pg, old_phase)

    pg.running, pg.succeeded, pg.failed = _pod_stats(pods)
    if len(pods) < pg.min_member:
        pg.phase = PodGroupPhase.PENDING
        return _transition_event(pg, old_phase)
    if pg.succeeded + pg.running < pg.min_member:
        pg.phase = PodGroupPhase.SCHEDULING
    if pg.succeeded + pg.running >= pg.min_member:
        pg.phase = PodGroupPhase.RUNNING
    if pg.failed != 0 and pg.failed + pg.running + pg.succeeded >= pg.min_member:
        pg.phase = PodGroupPhase.FAILED
    if pg.succeeded >= pg.min_member:
        pg.phase = PodGroupPhase.FINISHED
    return _transition_event(pg, old_phase)
