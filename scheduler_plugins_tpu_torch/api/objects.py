"""Host-side cluster object model (port of `scheduler_plugins_tpu.api.objects`).

The types the ported slices need: `Node`, `Pod` with its `Container`s
and its QoS class, the two CRDs the admission reads, `PodGroup` (gang)
and `ElasticQuota`, the `PodDisruptionBudget` that preemption reads, and
the `NodeResourceTopology` CR with its `NUMAZone`s that the NUMA plugin
reads, and the network-aware CRs (`AppGroup`, `NetworkTopology`) that
NetworkOverhead and TopologicalSort read, and the core/v1 scheduling-spec
fragments the in-tree plugins read (taints and tolerations, label and
node selectors, topology spread constraints, pod (anti-)affinity terms,
the `Namespace` a namespaceSelector targets), the `SeccompProfile` CR
SySched reads and the `PriorityClass` PreemptionToleration reads.
Derived-request
semantics follow the reference: the effective request is max(sum of app
containers, max over init containers) plus overhead (upstream
pkg/util/resource.go:45-85). The Trimaran plugins add the pod's effective
limits and TargetLoadPacking's CPU prediction.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Mapping, Optional

from scheduler_plugins_tpu_torch.api.resources import (
    CPU,
    MEMORY,
    add_quantities,
    max_quantities,
)

#: label that joins a pod to its PodGroup
POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"
#: well-known topology labels the network-aware plugins read
REGION_LABEL = "topology.kubernetes.io/region"
ZONE_LABEL = "topology.kubernetes.io/zone"
#: AppGroup membership labels (diktyo appgroup-api)
APP_GROUP_LABEL = "app-group.scheduling.x-k8s.io"
WORKLOAD_SELECTOR_LABEL = "app"

DEFAULT_SCHEDULER_NAME = "tpu-scheduler"


class QOSClass(enum.IntEnum):
    """Ordered so that a comparator can compare numerically: Guaranteed >
    Burstable > BestEffort (upstream pkg/qos/queue_sort.go:46-81)."""

    BEST_EFFORT = 0
    BURSTABLE = 1
    GUARANTEED = 2


class PodPhase(enum.StrEnum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


# -- in-tree scheduling-spec fragments (upstream core/v1 types) -------------

@dataclass
class Taint:
    """core/v1 Taint. Effects: NoSchedule | PreferNoSchedule | NoExecute."""

    key: str
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class Toleration:
    """core/v1 Toleration, with upstream v1helper.TolerationsTolerateTaint's
    rules: an empty effect matches every effect; an empty key with Exists
    matches every taint; Exists ignores the value."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" | NoSchedule | PreferNoSchedule | NoExecute

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key:
            if self.key != taint.key:
                return False
        elif self.operator != "Exists":
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class LabelSelectorRequirement:
    """metav1.LabelSelectorRequirement (In | NotIn | Exists | DoesNotExist)."""

    key: str
    operator: str
    values: tuple = ()


@dataclass
class LabelSelector:
    """metav1.LabelSelector: the AND of `match_labels` and
    `match_expressions`. A None selector matches nothing; an empty one
    matches everything (metav1 semantics)."""

    match_labels: Mapping[str, str] = field(default_factory=dict)
    match_expressions: list[LabelSelectorRequirement] = field(
        default_factory=list
    )

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for r in self.match_expressions:
            has = r.key in labels
            if r.operator == "In":
                if not has or labels[r.key] not in r.values:
                    return False
            elif r.operator == "NotIn":
                if has and labels[r.key] in r.values:
                    return False
            elif r.operator == "Exists":
                if not has:
                    return False
            elif r.operator == "DoesNotExist":
                if has:
                    return False
            else:
                raise ValueError(f"unknown selector operator {r.operator!r}")
        return True

    def _key(self):
        return (
            tuple(sorted(self.match_labels.items())),
            tuple(
                (r.key, r.operator, tuple(r.values))
                for r in self.match_expressions
            ),
        )


@dataclass
class NodeSelectorRequirement:
    """core/v1 NodeSelectorRequirement (In | NotIn | Exists | DoesNotExist
    | Gt | Lt); NotIn and DoesNotExist match an absent label (apimachinery
    labels.Requirement semantics)."""

    key: str
    operator: str
    values: tuple = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        val = labels.get(self.key)
        if self.operator == "In":
            return has and val in self.values
        if self.operator == "NotIn":
            return not has or val not in self.values
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator in ("Gt", "Lt"):
            if not has or len(self.values) != 1:
                return False
            try:
                lhs, rhs = int(val), int(self.values[0])
            except ValueError:
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        raise ValueError(f"unknown node selector operator {self.operator!r}")


@dataclass
class NodeSelectorTerm:
    """The AND of `match_expressions` (node labels) and `match_fields`
    (metadata.name only, as upstream supports)."""

    match_expressions: list[NodeSelectorRequirement] = field(
        default_factory=list
    )
    match_fields: list[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, node: "Node") -> bool:
        return all(
            r.matches(node.labels) for r in self.match_expressions
        ) and all(
            r.matches({"metadata.name": node.name}) for r in self.match_fields
        )

    @classmethod
    def from_wire(cls, spec: Mapping) -> "NodeSelectorTerm":
        """Parse the wire shape ({"match_expressions": [{"key",
        "operator", "values"}], "match_fields": [...]}); JSON nulls read
        as empty."""

        def req(r):
            return NodeSelectorRequirement(
                key=r["key"], operator=r["operator"],
                values=tuple(r.get("values") or ()),
            )

        return cls(
            match_expressions=[
                req(r) for r in spec.get("match_expressions") or []
            ],
            match_fields=[req(r) for r in spec.get("match_fields") or []],
        )


@dataclass
class PreferredSchedulingTerm:
    weight: int  # 1..100
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class TopologySpreadConstraint:
    """core/v1 TopologySpreadConstraint: DoNotSchedule filters,
    ScheduleAnyway scores.

    - `min_domains` (DoNotSchedule only): with fewer eligible domains than
      this, the global minimum counts as 0 (upstream minMatchNum).
    - `match_label_keys`: keys whose values are copied from the incoming
      pod into the selector as exact-match requirements (keys the pod
      lacks are ignored).
    - `node_affinity_policy` / `node_taints_policy`: which nodes count
      toward the domains and the minimum. Honor (the default for
      affinity) keeps the nodes matching the pod's nodeSelector and
      required affinity; Ignore (the default for taints) keeps all.
    """

    max_skew: int
    topology_key: str
    when_unsatisfiable: str = "DoNotSchedule"  # | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    match_label_keys: tuple = ()
    node_affinity_policy: str = "Honor"  # | Ignore
    node_taints_policy: str = "Ignore"  # | Honor


@dataclass
class PodAffinityTerm:
    """core/v1 PodAffinityTerm: a selector over pod labels, scoped to
    `namespaces` plus every namespace `namespace_selector` matches (a nil
    selector adds none, an EMPTY one matches all); both empty means the
    incoming pod's own namespace. Co-location is judged by the
    `topology_key` domains."""

    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: tuple = ()
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class Namespace:
    """core/v1 Namespace (labels only): what a namespaceSelector targets."""

    name: str
    labels: Mapping[str, str] = field(default_factory=dict)


@dataclass
class WeightedPodAffinityTerm:
    weight: int  # 1..100
    term: PodAffinityTerm


@dataclass
class Container:
    name: str = "c"
    requests: Mapping[str, int] = field(default_factory=dict)
    limits: Mapping[str, int] = field(default_factory=dict)
    #: a restartable (sidecar) init container: the NRT cache counts its
    #: requests toward exclusive-resource use (exclusive.go:47-95)
    restart_policy_always: bool = False
    #: the SeccompProfile CR this container references, for SySched: a
    #: bare name, "namespace/name" or a localhost path; None = unconfined
    seccomp_profile: Optional[str] = None


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    uid: str = ""
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: Mapping[str, int] = field(default_factory=dict)
    priority: int = 0
    labels: Mapping[str, str] = field(default_factory=dict)
    #: metadata.annotations: SySched reads the Security Profiles Operator's
    #: seccomp annotation
    annotations: Mapping[str, str] = field(default_factory=dict)
    node_name: Optional[str] = None
    #: node the scheduler nominated this pod for after preemption
    nominated_node_name: Optional[str] = None
    phase: PodPhase = PodPhase.PENDING
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    creation_ms: int = 0
    #: non-None marks a terminating pod (deletionTimestamp set)
    deletion_ms: Optional[int] = None
    scheduling_gated: bool = False
    #: spec.priorityClassName: PreemptionToleration looks its policy up
    priority_class_name: str = ""
    #: spec.preemptionPolicy: "Never" disqualifies the pod from preempting
    #: (capacity_scheduling.go:412-416)
    preemption_policy: Optional[str] = None
    #: spec.nodeSelector: every key=value pair must match the node's labels
    node_selector: Mapping[str, str] = field(default_factory=dict)
    #: required node affinity: OR over the terms (empty = unconstrained)
    node_affinity_required: list[NodeSelectorTerm] = field(
        default_factory=list
    )
    #: preferred node affinity terms (a weighted score)
    node_affinity_preferred: list[PreferredSchedulingTerm] = field(
        default_factory=list
    )
    tolerations: list[Toleration] = field(default_factory=list)
    topology_spread: list[TopologySpreadConstraint] = field(
        default_factory=list
    )
    pod_affinity_required: list[PodAffinityTerm] = field(default_factory=list)
    pod_affinity_preferred: list[WeightedPodAffinityTerm] = field(
        default_factory=list
    )
    pod_anti_affinity_required: list[PodAffinityTerm] = field(
        default_factory=list
    )
    pod_anti_affinity_preferred: list[WeightedPodAffinityTerm] = field(
        default_factory=list
    )
    #: memoized `effective_limits`: a pod's container spec is immutable
    #: after creation; init=False keeps the cache out of constructors and
    #: dataclasses.replace
    _lim_cache: Optional[dict] = field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"

    def pod_group(self) -> str:
        return self.labels.get(POD_GROUP_LABEL, "")

    def app_group(self) -> str:
        return self.labels.get(APP_GROUP_LABEL, "")

    def workload_selector(self) -> str:
        return self.labels.get(WORKLOAD_SELECTOR_LABEL, "")

    @property
    def terminating(self) -> bool:
        return self.deletion_ms is not None

    def effective_request(self) -> dict[str, int]:
        return effective_request(self)

    def qos_class(self) -> QOSClass:
        """Upstream `v1qos.GetPodQOS` over cpu and memory: BestEffort when
        no container names a cpu or memory request or limit; Guaranteed
        when every container has cpu and memory limits and the summed
        requests equal the summed limits per resource (absent requests
        are fine); Burstable otherwise."""
        all_containers = list(self.containers) + list(self.init_containers)
        requests: dict[str, int] = {}
        limits: dict[str, int] = {}
        guaranteed = bool(all_containers)
        for c in all_containers:
            limits_found = set()
            for res in (CPU, MEMORY):
                if c.requests.get(res, 0):
                    requests[res] = requests.get(res, 0) + c.requests[res]
                if c.limits.get(res, 0):
                    limits_found.add(res)
                    limits[res] = limits.get(res, 0) + c.limits[res]
            if limits_found != {CPU, MEMORY}:
                guaranteed = False
        if not requests and not limits:
            return QOSClass.BEST_EFFORT
        for res, req_sum in requests.items():
            if limits.get(res) != req_sum:
                guaranteed = False
        return QOSClass.GUARANTEED if guaranteed else QOSClass.BURSTABLE

    def effective_limits(self) -> dict[str, int]:
        """Trimaran-style effective limits: per resource, the sum over app
        containers, then the max against each init container on its own,
        plus overhead (upstream trimaran resourcestats.go:121-145
        GetEffectiveResource over container limits)."""
        if self._lim_cache is not None:
            return dict(self._lim_cache)
        resources: dict[str, int] = {}
        for c in self.containers:
            resources = add_quantities(resources, c.limits)
        for ic in self.init_containers:
            resources = max_quantities(resources, ic.limits)
        self._lim_cache = add_quantities(resources, self.overhead)
        return dict(self._lim_cache)

    def tlp_predicted_cpu_millis(
        self, multiplier: float = 1.5, default_millis: int = 1000
    ) -> int:
        """TargetLoadPacking's per-pod CPU prediction: per app container,
        its CPU limit if set, else round(request * multiplier), else the
        default 1000m; plus the pod overhead's CPU
        (targetloadpacking.go:123-129, 198-205). Init containers do not
        count."""
        total = 0
        for c in self.containers:
            if c.limits.get(CPU):
                total += c.limits[CPU]
            elif c.requests.get(CPU):
                # Go math.Round; requests are non-negative by construction
                total += int(c.requests[CPU] * multiplier + 0.5)
            else:
                total += default_millis
        total += self.overhead.get(CPU, 0)
        return total


def effective_request(pod: Pod) -> dict[str, int]:
    """Per resource: max(sum of app containers, max over init containers)
    plus overhead — GetPodEffectiveRequest (resource.go:45-85)."""
    resources: dict[str, int] = {}
    for c in pod.containers:
        resources = add_quantities(resources, c.requests)
    init_max: dict[str, int] = {}
    for ic in pod.init_containers:
        init_max = max_quantities(init_max, ic.requests)
    resources = max_quantities(resources, init_max)
    return add_quantities(resources, pod.overhead)


@dataclass
class Node:
    name: str
    allocatable: Mapping[str, int] = field(default_factory=dict)
    capacity: Mapping[str, int] = field(default_factory=dict)
    labels: Mapping[str, str] = field(default_factory=dict)
    unschedulable: bool = False
    taints: list[Taint] = field(default_factory=list)

    def __post_init__(self):
        if not self.capacity:
            self.capacity = dict(self.allocatable)

    @property
    def region(self) -> str:
        return self.labels.get(REGION_LABEL, "")

    @property
    def zone(self) -> str:
        return self.labels.get(ZONE_LABEL, "")


class PodGroupPhase(enum.StrEnum):
    """PodGroup status phase machine (apis/scheduling/v1alpha1/types.go
    :120-150), driven by `controllers.podgroup`."""

    PENDING = "Pending"
    PRE_SCHEDULING = "PreScheduling"
    SCHEDULING = "Scheduling"
    SCHEDULED = "Scheduled"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    FINISHED = "Finished"
    FAILED = "Failed"


@dataclass
class PodGroup:
    name: str
    namespace: str = "default"
    min_member: int = 1
    #: guaranteed whole-gang demand; enables the cluster-capacity pre-check
    #: (upstream pkg/coscheduling/core/core.go:286-305)
    min_resources: Mapping[str, int] = field(default_factory=dict)
    #: Permit wait per member; None falls back to Coscheduling's
    #: PermitWaitingTimeSeconds (GetWaitTimeDuration)
    schedule_timeout_seconds: Optional[int] = None
    creation_ms: int = 0
    #: rank-aware workload family (beyond the upstream reference): members
    #: are RANKS, placed as a whole gang by the topology-block waterfill
    #: (`gangs.topology`) ahead of the per-pod solve, minimizing the
    #: inter-rank network cost under the same hard constraints;
    #: min_member stays the quorum
    rank_aware: bool = False
    #: elastic job bounds: the replica width this gang should run at
    #: (clamped into [min_member, max_replicas]); None = a rigid gang
    #: (desired == min). The gang phase's reconcile grows or shrinks the
    #: members between cycles (`gangs.elastic`)
    desired_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    # status, written by `controllers.podgroup`
    phase: PodGroupPhase = PodGroupPhase.PENDING
    occupied_by: str = ""
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    schedule_start_ms: int = 0

    @property
    def full_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ElasticQuota:
    """Per-namespace elastic quota: `min` is guaranteed, `max` is the cap."""

    name: str
    namespace: str = "default"
    min: Mapping[str, int] = field(default_factory=dict)
    max: Mapping[str, int] = field(default_factory=dict)
    # status, written by `controllers.elasticquota`
    used: Mapping[str, int] = field(default_factory=dict)


@dataclass
class PodDisruptionBudget:
    """The PDB surface preemption reads when it partitions victims
    (upstream capacity_scheduling.go:889-934): a match-labels selector and
    the API server's DisruptionsAllowed budget."""

    name: str
    namespace: str = "default"
    #: match-labels selector; an empty one matches NOTHING (upstream)
    selector: Mapping[str, str] = field(default_factory=dict)
    disruptions_allowed: int = 0
    #: pod NAMES (not uids) already being disrupted: not counted again
    disrupted_pods: frozenset[str] = frozenset()

    def matches(self, pod: Pod) -> bool:
        if (not self.selector or pod.namespace != self.namespace
                or not pod.labels):
            return False
        return all(pod.labels.get(k) == v for k, v in self.selector.items())


class TopologyManagerPolicy(enum.IntEnum):
    """The kubelet topology-manager policy an NRT CR mirrors (upstream
    pkg/noderesourcetopology/nodeconfig/topologymanager.go)."""

    NONE = 0
    BEST_EFFORT = 1
    RESTRICTED = 2
    SINGLE_NUMA_NODE = 3


class TopologyManagerScope(enum.IntEnum):
    CONTAINER = 0
    POD = 1


@dataclass
class NUMAZone:
    numa_id: int
    #: available = allocatable minus used, as the node agent publishes it
    available: Mapping[str, int] = field(default_factory=dict)
    #: allocatable per zone (the available quantities when the agent
    #: omits it)
    allocatable: Mapping[str, int] = field(default_factory=dict)
    #: SLIT-style distance to the other zones, keyed by numa_id
    costs: Mapping[int, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.allocatable:
            self.allocatable = dict(self.available)


@dataclass
class NodeResourceTopology:
    node_name: str
    zones: list[NUMAZone] = field(default_factory=list)
    policy: TopologyManagerPolicy = TopologyManagerPolicy.NONE
    scope: TopologyManagerScope = TopologyManagerScope.CONTAINER
    max_numa_nodes: int = 8
    #: the node agent's pod fingerprint and its method attribute, which
    #: the over-reserve cache's resync validates (upstream
    #: cache/overreserve.go:276-348, `state.nrt_cache`)
    pod_fingerprint: str = ""
    pod_fingerprint_method: str = ""


# -- network-aware CRs (diktyo appgroup-api / networktopology-api) ----------

@dataclass
class AppGroupDependency:
    workload_selector: str
    max_network_cost: int = 0


@dataclass
class AppGroupWorkload:
    selector: str
    dependencies: list[AppGroupDependency] = field(default_factory=list)


@dataclass
class AppGroup:
    name: str
    namespace: str = "default"
    workloads: list[AppGroupWorkload] = field(default_factory=list)
    #: status.TopologyOrder: workload selector -> topological index, read
    #: by the TopologicalSort queue comparator (topologicalsort.go:102-132)
    topology_order: Mapping[str, int] = field(default_factory=dict)


@dataclass
class NetworkTopology:
    """Origin -> destination costs per topology key (region / zone) per
    weights profile (networkoverhead.go:448-638)."""

    name: str = "nt-default"
    namespace: str = "default"
    #: weightsName -> topology key ("region" | "zone") -> (origin, dest)
    #: -> cost
    weights: Mapping[str, Mapping[str, Mapping[tuple[str, str], int]]] = (
        field(default_factory=dict)
    )


@dataclass
class SeccompProfile:
    """The syscall allow-list a pod's containers or its Security Profiles
    Operator annotation reference, for SySched (sysched.go:124-210)."""

    name: str
    namespace: str = "default"
    syscalls: frozenset[str] = frozenset()

    @property
    def full_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class PriorityClass:
    """A PriorityClass with the preemption-toleration annotations
    PreemptionToleration reads (preemption_toleration_policy.go)."""

    name: str
    value: int = 0
    annotations: Mapping[str, str] = field(default_factory=dict)
