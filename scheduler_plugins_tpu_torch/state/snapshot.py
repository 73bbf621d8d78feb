"""Dense-tensor cluster snapshot (port of `scheduler_plugins_tpu.state.snapshot`).

The whole scheduling problem is lowered once per cycle into dataclasses of
int64 tensors with bucketed static shapes:

- nodes: (N, R) allocatable / requested, schedulable mask.
- pods:  (P, R) effective requests of the pending batch, namespace and gang
         codes, queue-sort keys.
- gangs: (G,) PodGroup member counts, (G, R) MinResources.
- quota: (Q, R) ElasticQuota min/max/used by namespace code, plus the
         nominated-pod tables.
- nominees: (M,) unbound pods nominated to a node, whose demand holds
         that node's capacity in the sequential solve.
- metrics: (N,) load-watcher utilisation percentages and the
         missing-utilization compensation the Trimaran plugins read.
- numa:  (N, Z, R) NUMA zone availability from the NodeResourceTopology
         CRs (or the NRT cache tier's adjusted view, its stale nodes not
         fresh), with the topology-manager policy and scope codes the
         NUMA plugin reads.
- network: AppGroup dependency rows per pod and per workload class, the
         (W, N) placed pods per workload and node, and the region of each
         zone code, which NetworkOverhead reads with the nodes'
         region / zone codes.
- scheduling: the in-tree plugins' lookup tables
         (`state.scheduling.SchedulingState`: node-affinity and toleration
         rows, selector groups, topology-domain codes and the counts the
         spread and inter-pod affinity carries start from).

This slice lowers what the ported plugins read; the JAX snapshot's
syscall tables wait for a later slice, and
node/pod fields nothing here reads are left out. The lowering runs in numpy (the
same arithmetic as the JAX builder, so both packages produce the same
tensors) and moves the result to the requested device once.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field, fields
from typing import Optional, Sequence

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.objects import (
    AppGroup,
    ElasticQuota,
    Node,
    NodeResourceTopology,
    Pod,
    PodGroup,
)
from scheduler_plugins_tpu_torch.api.resources import PODS, ResourceIndex
from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.ops.quota import nominee_contribution
from scheduler_plugins_tpu_torch.utils.intmath import bucket_size

I64 = np.int64
I32 = np.int32
F64 = np.float64


class _Tensors:
    """Shared helpers for the snapshot's dataclasses of tensors."""

    def to(self, device):
        return type(self)(**{
            f.name: _to(getattr(self, f.name), device) for f in fields(self)
        })

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def numpy(self) -> dict:
        return {
            f.name: _numpy(getattr(self, f.name)) for f in fields(self)
            if getattr(self, f.name) is not None
        }


def _to(value, device):
    if value is None or isinstance(value, (tuple, bool)):
        # absent, or a host static (`NumaState.pack_scales`,
        # `SchedulingState.spread_needs_node_counts`)
        return value
    if isinstance(value, _Tensors):
        return value.to(device)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.tensor(np.asarray(value), device=device)  # a copy


def _numpy(value):
    if isinstance(value, (tuple, bool)):
        return value
    if isinstance(value, _Tensors):
        return value.numpy()
    return value.cpu().numpy()


@dataclass
class NodeState(_Tensors):
    alloc: torch.Tensor  # (N, R) int64 allocatable
    capacity: torch.Tensor  # (N, R) int64
    requested: torch.Tensor  # (N, R) int64 sum of assigned pods' requests
    #: (N, R) int64 sum of assigned pods' effective limits, each pod's
    #: clamped to >= its requests (trimaran SetMaxLimits,
    #: resourcestats.go:225-231)
    limits: torch.Tensor
    mask: torch.Tensor  # (N,) bool — real, schedulable node
    region: torch.Tensor  # (N,) int32 region code (-1 unset)
    zone: torch.Tensor  # (N,) int32 zone code (-1 unset)
    pod_count: torch.Tensor  # (N,) int32 assigned pods


@dataclass
class PodState(_Tensors):
    req: torch.Tensor  # (P, R) int64 effective request (pods slot = 0)
    limits: torch.Tensor  # (P, R) int64 trimaran effective limits (unclamped)
    #: (P,) int64 TargetLoadPacking per-pod CPU prediction
    predicted_cpu_millis: torch.Tensor
    #: (P, C, R) int64 per-container requests, init containers first: the
    #: NUMA container-scope Filter and Score take containers one at a
    #: time (filter.go:39-78, score.go:152-165)
    container_req: torch.Tensor
    container_is_init: torch.Tensor  # (P, C) bool
    container_mask: torch.Tensor  # (P, C) bool
    priority: torch.Tensor  # (P,) int64
    ns: torch.Tensor  # (P,) int32 namespace code
    gang: torch.Tensor  # (P,) int32 gang code (-1 = not in a PodGroup)
    qos: torch.Tensor  # (P,) int32 QOSClass
    mask: torch.Tensor  # (P,) bool
    creation_ms: torch.Tensor  # (P,) int64 queue-sort timestamp
    gated: torch.Tensor  # (P,) bool SchedulingGated


@dataclass
class GangState(_Tensors):
    """PodGroup bookkeeping (upstream pkg/coscheduling/core/core.go)."""

    min_member: torch.Tensor  # (G,) int32
    total_members: torch.Tensor  # (G,) int32 siblings known cluster-wide
    assigned: torch.Tensor  # (G,) int32 already bound members
    gated: torch.Tensor  # (G,) int32 SchedulingGated siblings
    min_resources: torch.Tensor  # (G, R) int64 whole-gang demand
    has_min_resources: torch.Tensor  # (G,) bool
    creation_ms: torch.Tensor  # (G,) int64
    backed_off: torch.Tensor  # (G,) bool
    #: (G, R) capacity the gang's own assigned members add back in the
    #: CheckClusterResource sweep (core.go:433-467)
    cluster_slack: torch.Tensor
    mask: torch.Tensor  # (G,) bool


@dataclass
class QuotaState(_Tensors):
    """ElasticQuota tensors by namespace code, with the nominated-pod
    tables of capacity_scheduling.go:226-263."""

    min: torch.Tensor  # (Q, R) int64
    max: torch.Tensor  # (Q, R) int64
    used: torch.Tensor  # (Q, R) int64
    has_quota: torch.Tensor  # (Q,) bool
    nom_req: torch.Tensor  # (M, R) int64
    nom_in_eq_mask: torch.Tensor  # (M, P) bool
    nom_total_mask: torch.Tensor  # (M, P) bool
    nom_batch_idx: torch.Tensor  # (M,) int32


@dataclass
class NomineeState(_Tensors):
    """Unbound pods nominated to a node after preemption: their demand
    HOLDS node capacity against lower-or-equal-priority pods in the
    sequential solve (the upstream nominator's AddNominatedPods). A
    nominee inside the pending batch stops holding once it places
    (`SolverState.placed_mask`)."""

    node: torch.Tensor  # (M,) int32 nominated node index
    demand: torch.Tensor  # (M, R) int64 fit demand (pods slot = 1)
    priority: torch.Tensor  # (M,) int64
    batch_idx: torch.Tensor  # (M,) int32 index in the pending batch, -1 outside
    mask: torch.Tensor  # (M,) bool


@dataclass
class MetricsState(_Tensors):
    """Load-watcher node metrics in percent of capacity (upstream
    trimaran collector.go, resourcestats.go:33-107)."""

    cpu_avg: torch.Tensor  # (N,) float64 %
    #: (N,) the CPU value TargetLoadPacking reads: its selection loop lets
    #: a later Latest override Average (targetloadpacking.go:130-139);
    #: defaults to cpu_avg
    cpu_tlp: torch.Tensor
    #: (N,) the CPU value Peaks reads: the FIRST Average-or-Latest sample
    #: in report order (peaks.go:118-131); defaults to cpu_tlp, then cpu_avg
    cpu_peaks: torch.Tensor
    cpu_std: torch.Tensor  # (N,) float64 %
    mem_avg: torch.Tensor  # (N,) float64 %
    mem_std: torch.Tensor  # (N,) float64 %
    cpu_valid: torch.Tensor  # (N,) bool
    #: (N,) whether an Average/Latest CPU sample was seen: TLP needs one
    #: (targetloadpacking.go:130-146) and must not score a std-only node
    cpu_tlp_valid: torch.Tensor
    mem_valid: torch.Tensor  # (N,) bool
    #: (N,) int64 predicted-but-unreported CPU millis per node (the
    #: ScheduledPodsCache compensation, trimaran handler.go:47-171)
    missing_cpu_millis: torch.Tensor


@dataclass
class NumaState(_Tensors):
    """Per-node NUMA zones from the NodeResourceTopology CRs (upstream
    noderesourcetopology/numaresources.go:32-103), the zone axis indexed
    by NUMA id."""

    available: torch.Tensor  # (N, Z, R) int64
    allocatable: torch.Tensor  # (N, Z, R) int64
    zone_mask: torch.Tensor  # (N, Z) bool
    #: which zone reports which resource: NUMA affinity applies only to
    #: reported resources (numaresources.go:105-135)
    reported: torch.Tensor  # (N, Z, R) bool
    policy: torch.Tensor  # (N,) int32 TopologyManagerPolicy
    scope: torch.Tensor  # (N,) int32 TopologyManagerScope
    distances: torch.Tensor  # (N, Z, Z) int32 SLIT costs (default 10)
    has_nrt: torch.Tensor  # (N,) bool
    #: (N,) cache freshness: a stale node (the NRT cache tier's
    #: `stale_nrt_nodes`) is Unschedulable for any non-best-effort pod
    #: (filter.go:194-197) and scores 0
    fresh: torch.Tensor
    #: (N,) int32 topology-manager MaxNUMANodes (LeastNUMANodes
    #: normalization, least_numa.go:88-102; default 8)
    max_numa: torch.Tensor
    #: static per-resource power-of-2 scales of the float32 NUMA path
    #: (`_numa_pack_scales`), or None: the solve then carries float64
    pack_scales: Optional[tuple] = None


@dataclass
class NetworkState(_Tensors):
    """AppGroup dependency and placement tensors (networkoverhead.go:
    448-638). The cost between a candidate node and a placed dependency
    pod depends only on (region, zone) codes, so placed pods aggregate
    into per-zone / per-region counts and a cost lookup is a small dense
    gather. The cost matrices come from the NetworkTopology CR through
    the plugin (`NetworkOverhead.prepare_cluster`)."""

    dep_workload: torch.Tensor  # (P, D) int32 workload code (-1 pad)
    dep_max_cost: torch.Tensor  # (P, D) int64
    dep_mask: torch.Tensor  # (P, D) bool
    pod_workload: torch.Tensor  # (P,) int32 the pod's workload (-1 none)
    #: (W, N) int32 placed pods per workload per node; the solve carries
    #: its live copy (`SolverState.net_placed`), so in-cycle placements
    #: count for later pods
    placed_node: torch.Tensor
    zone_region: torch.Tensor  # (ZC,) int32 region code of each zone
    #: the dependency rows of each workload class: every pod of a
    #: workload shares its row, so the batched tallies run once a class
    cls_dep_workload: torch.Tensor  # (W, D) int32
    cls_dep_max_cost: torch.Tensor  # (W, D) int64
    cls_dep_mask: torch.Tensor  # (W, D) bool


@dataclass
class ClusterSnapshot(_Tensors):
    nodes: NodeState
    pods: PodState
    gangs: Optional[GangState] = None
    quota: Optional[QuotaState] = None
    nominees: Optional[NomineeState] = None
    metrics: Optional[MetricsState] = None
    numa: Optional[NumaState] = None
    network: Optional[NetworkState] = None
    #: `state.scheduling.SchedulingState`, None when no node has a taint
    #: and no pod an in-tree spec
    scheduling: Optional[object] = None

    @property
    def num_nodes(self) -> int:
        return self.nodes.alloc.shape[0]

    @property
    def num_pods(self) -> int:
        return self.pods.req.shape[0]

    @property
    def num_resources(self) -> int:
        return self.nodes.alloc.shape[1]

    @property
    def device(self) -> torch.device:
        return self.nodes.alloc.device


@dataclass
class SnapshotMeta:
    """Host-only name <-> code mappings for one snapshot."""

    index: ResourceIndex
    node_names: list[str] = field(default_factory=list)
    pod_names: list[str] = field(default_factory=list)
    namespaces: list[str] = field(default_factory=list)
    gang_names: list[str] = field(default_factory=list)
    regions: list[str] = field(default_factory=list)
    zones: list[str] = field(default_factory=list)
    #: "namespace/selector" of each workload code
    workloads: list[str] = field(default_factory=list)
    #: where the snapshot's tensors live; plugins put theirs there too
    device: torch.device = torch.device("cpu")
    #: host seconds `state.scheduling.build_scheduling` took for this
    #: snapshot (its relevance test alone when it built no table)
    scheduling_s: float = 0.0


class _Interner:
    """O(1) name -> stable code interning over a shared list."""

    def __init__(self, table: list[str]):
        self.table = table
        self.pos = {name: i for i, name in enumerate(table)}

    def code(self, name: str) -> int:
        i = self.pos.get(name)
        if i is None:
            i = len(self.table)
            self.table.append(name)
            self.pos[name] = i
        return i

    def get(self, name: str) -> int:
        return self.pos.get(name, -1)


def build_snapshot(
    nodes: Sequence[Node],
    pending_pods: Sequence[Pod],
    assigned_pods: Sequence[Pod] = (),
    pod_groups: Sequence[PodGroup] = (),
    quotas: Sequence[ElasticQuota] = (),
    pad_nodes: Optional[int] = None,
    pad_pods: Optional[int] = None,
    backed_off_gangs: Sequence[str] = (),
    extra_pods: Sequence[Pod] = (),
    device=None,
    node_metrics: Optional[dict] = None,
    tlp_prediction: tuple = (1.5, 1000),
    nrts: Sequence[NodeResourceTopology] = (),
    stale_nrt_nodes: Sequence[str] = (),
    app_groups: Sequence[AppGroup] = (),
    namespaces: Sequence = (),
) -> tuple[ClusterSnapshot, SnapshotMeta]:
    """Lower host objects into a `ClusterSnapshot` on `device`.

    `pending_pods` become the pod batch in the given (queue) order;
    `assigned_pods` contribute node usage and gang/quota accounting;
    `extra_pods` (scheduling-gated pods) count toward gang membership
    only. `node_metrics` (node name -> metric dict, `Cluster.node_metrics`
    with the missing-CPU compensation merged in) becomes the metrics
    table, None leaves it out; `tlp_prediction` (multiplier, default
    millis) parameterizes each pod's `predicted_cpu_millis`. `nrts` become
    the zone tables (None without any), `stale_nrt_nodes` not fresh there;
    `app_groups` the network table (None without any); `namespaces` (the
    store's Namespace objects, the namespaceSelector targets) feed the
    in-tree scheduling tables, None when nothing makes them relevant. Codes and
    padding follow the JAX builder (`build_snapshot`,
    scheduler_plugins_tpu/state/snapshot.py:552) line for line."""
    device = resolve_device(device)
    requests = {p.uid: p.effective_request() for p in
                list(pending_pods) + list(assigned_pods) + list(extra_pods)}
    index = ResourceIndex.union(
        *[n.allocatable for n in nodes],
        *[pg.min_resources for pg in pod_groups],
        *[q.min for q in quotas],
        *[q.max for q in quotas],
        *[requests[p.uid] for p in list(pending_pods) + list(assigned_pods)],
        *[z.available for t in nrts for z in t.zones],
        *[z.allocatable for t in nrts for z in t.zones],
    )
    R = len(index)
    N = pad_nodes or bucket_size(max(len(nodes), 1))
    P = pad_pods or bucket_size(max(len(pending_pods), 1))
    pods_i = index.position(PODS)

    meta = SnapshotMeta(index=index, device=device)
    meta.node_names = [n.name for n in nodes]
    meta.pod_names = [p.uid for p in pending_pods]
    regions_in = _Interner(meta.regions)
    zones_in = _Interner(meta.zones)
    ns_in = _Interner(meta.namespaces)
    gangs_in = _Interner(meta.gang_names)

    # --- nodes ---------------------------------------------------------
    alloc = np.zeros((N, R), I64)
    capacity = np.zeros((N, R), I64)
    requested = np.zeros((N, R), I64)
    node_limits = np.zeros((N, R), I64)
    node_mask = np.zeros(N, bool)
    region = np.full(N, -1, I32)
    zone = np.full(N, -1, I32)
    pod_count = np.zeros(N, I32)
    node_pos = {}
    for i, node in enumerate(nodes):
        node_pos[node.name] = i
        alloc[i] = index.encode(node.allocatable)
        capacity[i] = index.encode(node.capacity)
        node_mask[i] = not node.unschedulable
        if node.region:
            region[i] = regions_in.code(node.region)
        if node.zone:
            zone[i] = zones_in.code(node.zone)
    for pod in assigned_pods:
        if pod.node_name not in node_pos:
            continue
        i = node_pos[pod.node_name]
        req = index.encode(requests[pod.uid])
        requested[i] += req
        # limits clamped to >= requests per pod (SetMaxLimits)
        node_limits[i] += np.maximum(index.encode(pod.effective_limits()),
                                     req)
        pod_count[i] += 1
    # the "pods" resource is accounted as a count, not a request sum
    requested[:, pods_i] = pod_count

    # nominee capacity holds: every unbound pod nominated to a known node,
    # wherever it lives (upstream's nominator keeps a popped pod's own
    # nomination until assume, so the batch is included)
    nominee_pods = []
    seen_nominated = set()
    for pod in list(pending_pods) + list(assigned_pods) + list(extra_pods):
        if (pod.node_name is None and pod.nominated_node_name in node_pos
                and pod.uid not in seen_nominated):
            seen_nominated.add(pod.uid)
            nominee_pods.append(pod)
    node_state = NodeState(
        alloc=alloc, capacity=capacity, requested=requested,
        limits=node_limits, mask=node_mask, region=region, zone=zone,
        pod_count=pod_count,
    )

    # --- gangs ---------------------------------------------------------
    gang_pos = {pg.full_name: gangs_in.code(pg.full_name) for pg in pod_groups}
    G = max(len(gang_pos), 1)
    backed_off = set(backed_off_gangs)
    gang_min = np.ones(G, I32)
    gang_minres = np.zeros((G, R), I64)
    gang_has_minres = np.zeros(G, bool)
    gang_created = np.zeros(G, I64)
    gang_backoff = np.zeros(G, bool)
    gang_mask = np.zeros(G, bool)
    for pg in pod_groups:
        g = gang_pos[pg.full_name]
        gang_mask[g] = True
        gang_min[g] = pg.min_member
        gang_created[g] = pg.creation_ms
        gang_backoff[g] = pg.full_name in backed_off
        if pg.min_resources:
            gang_minres[g] = index.encode(pg.min_resources)
            gang_has_minres[g] = True
            # MinResources demand includes a pods slot of MinMember
            # (core.go:295-297)
            gang_minres[g, pods_i] = pg.min_member

    def gang_of(pod: Pod) -> int:
        name = pod.pod_group()
        if not name:
            return -1
        return gang_pos.get(f"{pod.namespace}/{name}", -1)

    gang_total = np.zeros(G, I32)
    gang_assigned = np.zeros(G, I32)
    gang_gated = np.zeros(G, I32)
    gang_slack = np.zeros((G, R), I64)
    for pod in list(pending_pods) + list(assigned_pods) + list(extra_pods):
        g = gang_of(pod)
        if g < 0:
            continue
        gang_total[g] += 1
        if pod.node_name is not None:
            gang_assigned[g] += 1
            if pod.node_name in node_pos:
                vec = index.encode(requests[pod.uid])
                vec[pods_i] = 1
                gang_slack[g] += vec
        elif pod.scheduling_gated:
            gang_gated[g] += 1
    gang_state = GangState(
        min_member=gang_min, total_members=gang_total,
        assigned=gang_assigned, gated=gang_gated,
        min_resources=gang_minres, has_min_resources=gang_has_minres,
        creation_ms=gang_created, backed_off=gang_backoff,
        cluster_slack=gang_slack, mask=gang_mask,
    ) if pod_groups else None

    # --- pods (pending batch) -----------------------------------------
    preq = np.zeros((P, R), I64)
    plimits = np.zeros((P, R), I64)
    ppredicted = np.zeros(P, I64)
    C = max(max((len(p.init_containers) + len(p.containers)
                 for p in pending_pods), default=1), 1)
    pcreq = np.zeros((P, C, R), I64)
    pcinit = np.zeros((P, C), bool)
    pcmask = np.zeros((P, C), bool)
    ppriority = np.zeros(P, I64)
    pns = np.zeros(P, I32)
    pgang = np.full(P, -1, I32)
    pqos = np.zeros(P, I32)
    pmask = np.zeros(P, bool)
    pcreated = np.zeros(P, I64)
    pgated = np.zeros(P, bool)
    for i, pod in enumerate(pending_pods):
        preq[i] = index.encode(requests[pod.uid])
        plimits[i] = index.encode(pod.effective_limits())
        ppredicted[i] = pod.tlp_predicted_cpu_millis(*tlp_prediction)
        for c, cont in enumerate(list(pod.init_containers)
                                 + list(pod.containers)):
            pcreq[i, c] = index.encode(cont.requests)
            pcinit[i, c] = c < len(pod.init_containers)
            pcmask[i, c] = True
        pqos[i] = int(pod.qos_class())
        ppriority[i] = pod.priority
        pns[i] = ns_in.code(pod.namespace)
        pgang[i] = gang_of(pod)
        pmask[i] = True
        pcreated[i] = pod.creation_ms
        pgated[i] = pod.scheduling_gated
    pod_state = PodState(
        req=preq, limits=plimits, predicted_cpu_millis=ppredicted,
        container_req=pcreq, container_is_init=pcinit,
        container_mask=pcmask, priority=ppriority, ns=pns, gang=pgang,
        qos=pqos, mask=pmask, creation_ms=pcreated, gated=pgated,
    )

    # --- quota ---------------------------------------------------------
    quota_state = None
    if quotas:
        for q in quotas:
            ns_in.code(q.namespace)
        for pod in assigned_pods:
            ns_in.code(pod.namespace)
        Q = max(len(meta.namespaces), 1)
        qmin = np.zeros((Q, R), I64)
        # absent resources in Max are unbounded (UpperBound semantics,
        # elasticquota.go:96-120)
        qmax = np.full((Q, R), np.iinfo(I64).max, I64)
        qhas = np.zeros(Q, bool)
        for q in quotas:
            nsi = ns_in.get(q.namespace)
            qhas[nsi] = True
            qmin[nsi] = index.encode(q.min)
            qmax[nsi] = index.encode(q.max, default=np.iinfo(I64).max)
        qused = np.zeros((Q, R), I64)
        for pod in assigned_pods:
            if pod.node_name is None:
                continue
            nsi = ns_in.get(pod.namespace)
            if qhas[nsi]:
                qused[nsi] += index.encode(requests[pod.uid])
        nominated = [
            p for p in list(pending_pods) + list(extra_pods)
            if p.nominated_node_name is not None and p.node_name is None
        ]
        batch_pos = {p.uid: i for i, p in enumerate(pending_pods)}
        M = max(len(nominated), 1)
        nom_req = np.zeros((M, R), I64)
        nom_in_eq = np.zeros((M, P), bool)
        nom_total = np.zeros((M, P), bool)
        nom_batch_idx = np.full(M, -1, I32)
        over_min = np.any(qused > qmin, axis=1)  # (Q,) usedOverMin
        for j, m in enumerate(nominated):
            m_ns = ns_in.get(m.namespace)
            if m_ns < 0 or not qhas[m_ns]:
                continue
            nom_req[j] = index.encode(requests[m.uid])
            nom_batch_idx[j] = batch_pos.get(m.uid, -1)
            for i, pod in enumerate(pending_pods):
                if m.uid == pod.uid:
                    continue
                nom_in_eq[j, i], nom_total[j, i] = nominee_contribution(
                    m.namespace == pod.namespace, m.priority, pod.priority,
                    bool(over_min[m_ns]),
                )
        quota_state = QuotaState(
            min=qmin, max=qmax, used=qused, has_quota=qhas,
            nom_req=nom_req, nom_in_eq_mask=nom_in_eq,
            nom_total_mask=nom_total, nom_batch_idx=nom_batch_idx,
        )

    nominee_state = None
    if nominee_pods:
        M = len(nominee_pods)
        batch_pos_nom = {p.uid: i for i, p in enumerate(pending_pods)}
        nom_node = np.zeros(M, I32)
        nom_demand = np.zeros((M, R), I64)
        nom_pri = np.zeros(M, I64)
        nom_batch = np.full(M, -1, I32)
        for j, p in enumerate(nominee_pods):
            nom_node[j] = node_pos[p.nominated_node_name]
            nom_demand[j] = index.encode(requests[p.uid])
            nom_demand[j, pods_i] = 1
            nom_pri[j] = p.priority
            nom_batch[j] = batch_pos_nom.get(p.uid, -1)
        nominee_state = NomineeState(
            node=nom_node, demand=nom_demand, priority=nom_pri,
            batch_idx=nom_batch, mask=np.ones(M, bool),
        )

    metrics_state = None
    if node_metrics is not None:
        metrics_state = _metrics_state(node_metrics, node_pos, N)

    numa_state = None
    if nrts:
        numa_state = _numa_state(nrts, node_pos, index, N, pod_state,
                                 stale_nrt_nodes)

    network_state = None
    if app_groups:
        network_state = _network_state(app_groups, pending_pods,
                                       assigned_pods, node_pos, region, zone,
                                       meta, P)

    # imported here: `state.scheduling` imports this module's `_Tensors`
    from scheduler_plugins_tpu_torch.state.scheduling import (
        build_scheduling,
    )

    t0 = time.perf_counter()
    scheduling_state = build_scheduling(
        nodes, pending_pods, N, P, assigned=assigned_pods,
        namespaces=namespaces,
    )
    meta.scheduling_s = time.perf_counter() - t0

    snapshot = ClusterSnapshot(
        nodes=node_state, pods=pod_state, gangs=gang_state,
        quota=quota_state, nominees=nominee_state, metrics=metrics_state,
        numa=numa_state, network=network_state, scheduling=scheduling_state,
    )
    return snapshot.to(device), meta


def _numa_state(nrts, node_pos: dict, index, N: int, pod_state: PodState,
                stale_nrt_nodes=()) -> NumaState:
    """The zone tables (host numpy), as the JAX `build_snapshot` lowers them
    (snapshot.py:848-900): the zone axis is indexed by NUMA id (zone lists
    may arrive unordered, and costs are keyed by id), distances default
    to 10, MaxNUMANodes to 8; CRs of unknown nodes are skipped. The
    known nodes among `stale_nrt_nodes` are not fresh. The row reaches
    the device with the other zone tables, in the snapshot's one copy."""
    R = len(index)
    Z = max(max((z.numa_id + 1 for t in nrts for z in t.zones), default=1),
            1)
    z_avail = np.zeros((N, Z, R), I64)
    z_alloc = np.zeros((N, Z, R), I64)
    z_mask = np.zeros((N, Z), bool)
    z_reported = np.zeros((N, Z, R), bool)
    policy = np.zeros(N, I32)
    scope = np.zeros(N, I32)
    distances = np.full((N, Z, Z), 10, I32)
    has_nrt = np.zeros(N, bool)
    fresh = np.ones(N, bool)
    max_numa = np.full(N, 8, I32)
    for name in stale_nrt_nodes:
        if name in node_pos:
            fresh[node_pos[name]] = False
    for t in nrts:
        if t.node_name not in node_pos:
            continue
        i = node_pos[t.node_name]
        has_nrt[i] = True
        policy[i] = int(t.policy)
        scope[i] = int(t.scope)
        max_numa[i] = t.max_numa_nodes
        for zinfo in t.zones:
            z = zinfo.numa_id
            z_mask[i, z] = True
            z_avail[i, z] = index.encode(zinfo.available)
            z_alloc[i, z] = index.encode(zinfo.allocatable)
            for rname in zinfo.available:
                z_reported[i, z, index.position(rname)] = True
            for other, cost in zinfo.costs.items():
                if other < Z:
                    distances[i, z, other] = cost
    return NumaState(
        available=z_avail, allocatable=z_alloc, zone_mask=z_mask,
        reported=z_reported, policy=policy, scope=scope,
        distances=distances, has_nrt=has_nrt, fresh=fresh,
        max_numa=max_numa,
        pack_scales=_numa_pack_scales(z_avail, z_alloc, pod_state.req,
                                      pod_state.container_req, R),
    )


#: rescaled quantities must keep value * MAX_NODE_SCORE (100) exactly
#: representable in float32
_F32_PACK_LIMIT = (1 << 24) // 128


def _numa_pack_scales(z_avail, z_alloc, preq, pcreq, R: int):
    """Per-resource power-of-2 scales for the float32 NUMA path, or None.

    A resource packs when every zone quantity and every pending (container)
    request is divisible by 2^k and the rescaled maximum stays below
    2^24/128, so `value * 100` is exact in float32. The trunc-division
    strategy scores are floors of an unchanged rational, so packed
    placements equal the int64 semantics."""
    scales = []
    for r in range(R):
        vals = np.concatenate([
            z_avail[:, :, r].ravel(), z_alloc[:, :, r].ravel(),
            preq[:, r].ravel(), pcreq[:, :, r].ravel(),
        ])
        vals = vals[vals > 0]
        if vals.size == 0:
            scales.append(1)
            continue
        # the largest power of two dividing every value: the least of
        # their lowest set bits
        scale = int(np.min(vals & -vals))
        if int(vals.max()) // scale >= _F32_PACK_LIMIT:
            return None
        scales.append(scale)
    return tuple(scales)


def _metrics_state(node_metrics: dict, node_pos: dict, N: int) -> MetricsState:
    """The metrics table (host numpy), each field defaulted as the JAX
    builder does (snapshot.py:801-846): `cpu_tlp` falls back to `cpu_avg`,
    `cpu_peaks` to `cpu_tlp` and then `cpu_avg`; a node with only a std
    sample is valid with a 0 average (GetResourceData, resourcestats.go:
    88-106), but TLP and Peaks need an Average or Latest sample
    (`cpu_tlp_valid`). Nodes the store does not know are skipped."""
    cpu_avg = np.zeros(N, F64)
    cpu_tlp = np.zeros(N, F64)
    cpu_peaks = np.zeros(N, F64)
    cpu_std = np.zeros(N, F64)
    mem_avg = np.zeros(N, F64)
    mem_std = np.zeros(N, F64)
    cpu_valid = np.zeros(N, bool)
    cpu_tlp_valid = np.zeros(N, bool)
    mem_valid = np.zeros(N, bool)
    missing = np.zeros(N, I64)
    for name, m in node_metrics.items():
        if name not in node_pos:
            continue
        i = node_pos[name]
        if "cpu_avg" in m:
            cpu_avg[i] = m["cpu_avg"]
        cpu_tlp[i] = m.get("cpu_tlp", m.get("cpu_avg", 0.0))
        cpu_peaks[i] = m.get(
            "cpu_peaks", m.get("cpu_tlp", m.get("cpu_avg", 0.0))
        )
        cpu_std[i] = m.get("cpu_std", 0.0)
        cpu_valid[i] = "cpu_avg" in m or "cpu_std" in m
        cpu_tlp_valid[i] = "cpu_tlp" in m or "cpu_avg" in m
        if "mem_avg" in m:
            mem_avg[i] = m["mem_avg"]
        mem_valid[i] = "mem_avg" in m or "mem_std" in m
        mem_std[i] = m.get("mem_std", 0.0)
        missing[i] = m.get("missing_cpu_millis", 0)
    return MetricsState(
        cpu_avg=cpu_avg, cpu_tlp=cpu_tlp, cpu_peaks=cpu_peaks,
        cpu_std=cpu_std, mem_avg=mem_avg, mem_std=mem_std,
        cpu_valid=cpu_valid, cpu_tlp_valid=cpu_tlp_valid,
        mem_valid=mem_valid, missing_cpu_millis=missing,
    )


def _network_state(app_groups, pending_pods, assigned_pods, node_pos: dict,
                   region, zone, meta: SnapshotMeta, P: int) -> NetworkState:
    """The network table (host numpy), as the JAX builder lowers it
    (`_build_network`, snapshot.py:988-1060): workload selectors interned
    as "namespace/selector" in AppGroup order, each pending pod's
    dependency row, each class's row, the placed pods of the assigned
    (bound and reserved) pods per workload and node, and the region of
    each zone code."""
    workloads_in = _Interner(meta.workloads)
    dep_lists = {}  # workload code -> [(dependency code, max cost)]
    for ag in app_groups:
        for w in ag.workloads:
            wc = workloads_in.code(f"{ag.namespace}/{w.selector}")
            dep_lists[wc] = [
                (workloads_in.code(f"{ag.namespace}/{d.workload_selector}"),
                 d.max_network_cost)
                for d in w.dependencies
            ]
    W = max(len(meta.workloads), 1)
    D = max(max((len(v) for v in dep_lists.values()), default=1), 1)
    ZC = max(len(meta.zones), 1)
    N = region.shape[0]

    dep_workload = np.full((P, D), -1, I32)
    dep_max_cost = np.zeros((P, D), I64)
    dep_mask = np.zeros((P, D), bool)
    pod_workload = np.full(P, -1, I32)
    for i, pod in enumerate(pending_pods):
        sel = pod.workload_selector()
        wc = workloads_in.get(f"{pod.namespace}/{sel}") if sel else -1
        if wc < 0:
            continue
        pod_workload[i] = wc
        for d, (dw, mc) in enumerate(dep_lists.get(wc, [])):
            dep_workload[i, d] = dw
            dep_max_cost[i, d] = mc
            dep_mask[i, d] = True

    placed_node = np.zeros((W, N), I32)
    zone_region = np.full(ZC, -1, I32)
    for ni in range(N):
        if zone[ni] >= 0 and region[ni] >= 0:
            zone_region[zone[ni]] = region[ni]
    for pod in assigned_pods:
        sel = pod.workload_selector()
        if not sel or pod.node_name not in node_pos:
            continue
        wc = workloads_in.get(f"{pod.namespace}/{sel}")
        if wc >= 0:
            placed_node[wc, node_pos[pod.node_name]] += 1

    cls_dep_workload = np.full((W, D), -1, I32)
    cls_dep_max_cost = np.zeros((W, D), I64)
    cls_dep_mask = np.zeros((W, D), bool)
    for wc, deps in dep_lists.items():
        for d, (dw, mc) in enumerate(deps):
            cls_dep_workload[wc, d] = dw
            cls_dep_max_cost[wc, d] = mc
            cls_dep_mask[wc, d] = True
    return NetworkState(
        dep_workload=dep_workload, dep_max_cost=dep_max_cost,
        dep_mask=dep_mask, pod_workload=pod_workload,
        placed_node=placed_node, zone_region=zone_region,
        cls_dep_workload=cls_dep_workload,
        cls_dep_max_cost=cls_dep_max_cost, cls_dep_mask=cls_dep_mask,
    )
