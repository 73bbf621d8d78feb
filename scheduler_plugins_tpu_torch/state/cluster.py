"""Mutable host-side cluster store (port of `scheduler_plugins_tpu.state.cluster`).

Object upserts come in, snapshots go out. This slice keeps the store and
its queue predicate; the JAX store's event ledger, delta feeds, native
mirror and permit bookkeeping wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from scheduler_plugins_tpu_torch.api.objects import (
    DEFAULT_SCHEDULER_NAME,
    ElasticQuota,
    Node,
    Pod,
    PodGroup,
    PodPhase,
)
from scheduler_plugins_tpu_torch.state.snapshot import build_snapshot


@dataclass
class Cluster:
    nodes: dict[str, Node] = field(default_factory=dict)
    pods: dict[str, Pod] = field(default_factory=dict)  # keyed by uid
    pod_groups: dict[str, PodGroup] = field(default_factory=dict)  # ns/name
    quotas: dict[str, ElasticQuota] = field(default_factory=dict)  # namespace
    #: profile names this scheduler owns: only their pods enter the queue
    scheduler_names: set = field(
        default_factory=lambda: {DEFAULT_SCHEDULER_NAME}
    )
    #: gang name -> wall-clock ms until which the gang stays backed off
    gang_backoff_until_ms: dict[str, int] = field(default_factory=dict)
    #: gang name -> wall-clock ms of its last scheduling failure: the
    #: gang's queue-sort time once set
    gang_last_failure_ms: dict[str, int] = field(default_factory=dict)

    def add_node(self, node: Node):
        self.nodes[node.name] = node

    def add_pod(self, pod: Pod):
        self.pods[pod.uid] = pod

    def add_pod_group(self, pg: PodGroup):
        self.pod_groups[pg.full_name] = pg

    def add_quota(self, eq: ElasticQuota):
        self.quotas[eq.namespace] = eq

    def pod_group_of(self, pod: Pod) -> Optional[PodGroup]:
        name = pod.pod_group()
        if not name:
            return None
        return self.pod_groups.get(f"{pod.namespace}/{name}")

    def gang_sort_time(self, pg: PodGroup) -> int:
        """Queue-sort timestamp for a gang: last schedule-failure time when
        set (defeats head-of-line blocking, core.go:365-384), else
        creation."""
        return self.gang_last_failure_ms.get(pg.full_name, pg.creation_ms)

    def _pending_eligible(self, pod: Pod) -> bool:
        return (
            pod.node_name is None
            and pod.phase == PodPhase.PENDING
            and not pod.terminating
            and not pod.scheduling_gated
            and pod.scheduler_name in self.scheduler_names
        )

    def pending_pods(self) -> list[Pod]:
        """The schedulable queue in insertion order: gated pods stay out,
        and only pods addressed to one of `scheduler_names` enter."""
        return [p for p in self.pods.values() if self._pending_eligible(p)]

    def gated_pods(self) -> list[Pod]:
        return [
            p for p in self.pods.values()
            if p.node_name is None and p.scheduling_gated and not p.terminating
        ]

    def snapshot(self, pending: list[Pod], now_ms: int = 0, device=None,
                 **kwargs):
        """Lower the current state for the solver onto `device` (None =
        the CUDA card)."""
        assigned = [p for p in self.pods.values() if p.node_name is not None]
        backed_off = [
            name for name, until in self.gang_backoff_until_ms.items()
            if until > now_ms
        ]
        return build_snapshot(
            list(self.nodes.values()),
            pending,
            assigned_pods=assigned,
            pod_groups=list(self.pod_groups.values()),
            quotas=list(self.quotas.values()),
            backed_off_gangs=backed_off,
            extra_pods=self.gated_pods(),
            device=device,
            **kwargs,
        )
