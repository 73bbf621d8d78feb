"""Mutable host-side cluster store (port of `scheduler_plugins_tpu.state.cluster`).

Object upserts and deletes come in, snapshots go out. The store also owns
the scheduling-runtime bookkeeping that stays on the host: Permit
reservations (waiting pods) and their per-pod deadlines, gang backoff and
failure times (upstream core.go:134-192), the event ledger that gates
requeues (EnqueueExtensions) and the per-pod requeue backoff.

Every mutator notes its event (`note_event`) in the JAX store's order:
a parked pod's stamp is compared against these counters, so the order is
part of the semantics. For the Trimaran plugins the store holds the
load-watcher metrics, the TargetLoadPacking prediction parameters and the
recently bound pods whose load the metrics do not show yet. For the NUMA
plugin it holds the NodeResourceTopology CRs and, when the plugin's
cache arguments install one, the NRT cache tier (`state.nrt_cache`): the
store's pod, bind, reserve and NRT mutators drive its lifecycle hooks,
and the snapshot then reads the cache's adjusted view with its stale
nodes. For the network-aware plugins it holds the AppGroup and
NetworkTopology CRs. For the in-tree plugins it holds the Namespace
objects a PodAffinityTerm's namespaceSelector matches. The JAX store's
native mirror, delta sink, pending index and ledger hooks come with their
slices.
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.api.objects import (
    DEFAULT_SCHEDULER_NAME,
    AppGroup,
    ElasticQuota,
    Namespace,
    NetworkTopology,
    Node,
    NodeResourceTopology,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    PodPhase,
)
from scheduler_plugins_tpu_torch.state.snapshot import build_snapshot

#: upstream podMaxInUnschedulablePodsDuration: a parked pod re-enters the
#: batch after this long even with no event
REQUEUE_FLUSH_MS = 5 * 60 * 1000
#: requeue backoff (upstream calculateBackoffDuration: 1 s doubling to 10 s
#: per attempt), scaled by a deterministic jitter in [0.5, 1.0] drawn from
#: blake2b(BACKOFF_SEED:uid:attempt)
BACKOFF_INITIAL_MS = 1000
BACKOFF_MAX_MS = 10_000
BACKOFF_SEED = 0

@dataclass
class Cluster:
    nodes: dict[str, Node] = field(default_factory=dict)
    pods: dict[str, Pod] = field(default_factory=dict)  # keyed by uid
    pod_groups: dict[str, PodGroup] = field(default_factory=dict)  # ns/name
    quotas: dict[str, ElasticQuota] = field(default_factory=dict)  # namespace
    #: node name -> NodeResourceTopology CR
    nrts: dict[str, NodeResourceTopology] = field(default_factory=dict)
    #: ns/name -> AppGroup / NetworkTopology CR (the network-aware plugins)
    app_groups: dict[str, AppGroup] = field(default_factory=dict)
    network_topologies: dict[str, NetworkTopology] = field(
        default_factory=dict
    )
    #: ns/name -> PodDisruptionBudget, read by preemption's victim ranking
    pdbs: dict[str, PodDisruptionBudget] = field(default_factory=dict)
    #: name -> Namespace (labels): PodAffinityTerm.namespaceSelector targets
    namespaces: dict[str, Namespace] = field(default_factory=dict)
    #: profile names this scheduler owns: only their pods enter the queue
    scheduler_names: set = field(
        default_factory=lambda: {DEFAULT_SCHEDULER_NAME}
    )
    #: node name -> load-watcher metrics in percent of capacity
    #: (`state.collector`), or None when no metrics source is configured
    node_metrics: Optional[dict] = None
    #: TargetLoadPacking pod CPU-prediction parameters (multiplier,
    #: default-request millis), installed by the plugin's
    #: `configure_cluster` from DefaultRequests/DefaultRequestsMultiplier
    #: (apis/config/v1/defaults.go:76-90)
    tlp_prediction: tuple = (1.5, 1000)
    #: recently bound pods whose load the metrics provider has not
    #: reported yet (the trimaran PodAssignEventHandler's
    #: ScheduledPodsCache, handler.go:47-171): uid -> (bind ms, node)
    recent_bindings: dict[str, tuple[int, str]] = field(default_factory=dict)
    #: the NRT cache tier (`state.nrt_cache`: OverReserve / Passthrough /
    #: DiscardReserved), installed by the NUMA plugin's
    #: `configure_cluster` when its cache arguments are given; when set,
    #: snapshots read the cache's adjusted zone view instead of `nrts`
    nrt_cache: Optional[object] = None

    # scheduling-runtime bookkeeping (host-only)
    reserved: dict[str, str] = field(default_factory=dict)  # uid -> node
    #: per-POD permit deadlines (the upstream waitingPods timers,
    #: coscheduling.go:227-235): uid -> wall-clock ms at which this waiting
    #: pod's Permit times out
    pod_deadline_ms: dict[str, int] = field(default_factory=dict)
    #: gang name -> wall-clock ms until which the gang stays backed off
    gang_backoff_until_ms: dict[str, int] = field(default_factory=dict)
    #: gang name -> wall-clock ms of its last scheduling failure: the
    #: gang's queue-sort time once set
    gang_last_failure_ms: dict[str, int] = field(default_factory=dict)
    #: EnqueueExtensions ledger: a monotonic event counter, the last
    #: counter value per kind, and per parked pod (counter at failure,
    #: flush deadline)
    event_seq: int = 0
    event_last: dict[str, int] = field(default_factory=dict)
    unschedulable_since: dict[str, tuple[int, int]] = field(
        default_factory=dict
    )
    #: requeue backoff per pod (`BACKOFF_*`)
    pod_attempts: dict[str, int] = field(default_factory=dict)
    pod_backoff_until_ms: dict[str, int] = field(default_factory=dict)
    #: last failure stamp per pod: one cycle can mark a pod twice (bind
    #: failure, then whole-gang rejection); only the first is an attempt
    _pod_last_failure_ms: dict[str, int] = field(default_factory=dict)

    def note_event(self, kind: str) -> None:
        """Record a cluster event ("Resource/Action", `api.events`) for
        requeue gating."""
        self.event_seq += 1
        self.event_last[kind] = self.event_seq

    def mark_unschedulable(self, uid: str, now_ms: int) -> None:
        """Park a pod and charge one backoff attempt: min(initial *
        2^(attempts-1), max) scaled by the jitter. A bind or a delete
        clears the attempts."""
        if self._pod_last_failure_ms.get(uid) != now_ms:
            self._pod_last_failure_ms[uid] = now_ms
            attempts = self.pod_attempts.get(uid, 0) + 1
            self.pod_attempts[uid] = attempts
            base = min(
                BACKOFF_INITIAL_MS * (1 << min(attempts - 1, 30)),
                BACKOFF_MAX_MS,
            )
            self.pod_backoff_until_ms[uid] = now_ms + int(
                base * (0.5 + 0.5 * self._backoff_jitter(uid, attempts))
            )
        self.unschedulable_since[uid] = (
            self.event_seq, now_ms + REQUEUE_FLUSH_MS,
        )

    def _backoff_jitter(self, uid: str, attempt: int) -> float:
        """[0, 1) from blake2b(seed:uid:attempt): stable across runs and
        processes, and independent of the order of failures."""
        h = hashlib.blake2b(
            f"{BACKOFF_SEED}:{uid}:{attempt}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def _clear_backoff(self, uid: str) -> None:
        self.pod_attempts.pop(uid, None)
        self.pod_backoff_until_ms.pop(uid, None)
        self._pod_last_failure_ms.pop(uid, None)

    # -- upserts and deletes -------------------------------------------------
    def add_node(self, node: Node):
        self.note_event(
            ev.NODE_UPDATE if node.name in self.nodes else ev.NODE_ADD
        )
        self.nodes[node.name] = node

    def remove_node(self, name: str):
        if self.nodes.pop(name, None) is not None:
            self.note_event(ev.NODE_DELETE)

    def add_pod(self, pod: Pod):
        self.note_event(
            ev.POD_UPDATE if pod.uid in self.pods else ev.POD_ADD
        )
        self.pods[pod.uid] = pod
        if self.nrt_cache is not None and hasattr(self.nrt_cache,
                                                  "track_pod"):
            # foreign-pod detection (cache/foreign_pods.go:42-99)
            self.nrt_cache.track_pod(pod)

    def remove_pod(self, uid: str):
        self.release_reservation(uid)  # notifies the NRT cache too
        self.unschedulable_since.pop(uid, None)
        self._clear_backoff(uid)
        pod = self.pods.pop(uid, None)
        if pod is not None:
            self.note_event(ev.POD_DELETE)
            if pod.node_name is not None and self.nrt_cache is not None:
                # a bound pod's assumed deduction must not outlive it
                self.nrt_cache.unreserve(pod.node_name, pod)

    def mark_terminating(self, uid: str, now_ms: int):
        """DELETE issued (a preemption victim): the pod turns terminating
        and keeps its node until it is removed."""
        pod = self.pods.get(uid)
        if pod is None:
            return
        pod.deletion_ms = now_ms
        self.note_event(ev.POD_UPDATE)

    def add_pod_group(self, pg: PodGroup):
        self.note_event(
            ev.POD_GROUP_UPDATE if pg.full_name in self.pod_groups
            else ev.POD_GROUP_ADD
        )
        self.pod_groups[pg.full_name] = pg

    def add_quota(self, eq: ElasticQuota):
        self.note_event(
            ev.ELASTIC_QUOTA_UPDATE if eq.namespace in self.quotas
            else ev.ELASTIC_QUOTA_ADD
        )
        self.quotas[eq.namespace] = eq

    def add_nrt(self, nrt: NodeResourceTopology):
        self.note_event(
            ev.NRT_UPDATE if nrt.node_name in self.nrts else ev.NRT_ADD
        )
        self.nrts[nrt.node_name] = nrt
        if self.nrt_cache is not None:
            self.nrt_cache.update_nrt(nrt)

    def remove_nrt(self, node_name: str):
        """The CR is deleted: the cache tier drops its copy too, or the
        snapshot would keep building zone tables from it."""
        if node_name in self.nrts:
            self.note_event(ev.NRT_DELETE)
        self.nrts.pop(node_name, None)
        if self.nrt_cache is not None:
            self.nrt_cache.delete_nrt(node_name)

    def add_app_group(self, ag: AppGroup):
        key = f"{ag.namespace}/{ag.name}"
        self.note_event(
            ev.APP_GROUP_UPDATE if key in self.app_groups
            else ev.APP_GROUP_ADD
        )
        self.app_groups[key] = ag

    def add_network_topology(self, nt: NetworkTopology):
        key = f"{nt.namespace}/{nt.name}"
        self.note_event(
            ev.NETWORK_TOPOLOGY_UPDATE if key in self.network_topologies
            else ev.NETWORK_TOPOLOGY_ADD
        )
        self.network_topologies[key] = nt

    def add_namespace(self, ns: Namespace):
        self.note_event(
            ev.NAMESPACE_UPDATE if ns.name in self.namespaces
            else ev.NAMESPACE_ADD
        )
        self.namespaces[ns.name] = ns

    def add_pdb(self, pdb: PodDisruptionBudget):
        key = f"{pdb.namespace}/{pdb.name}"
        self.note_event(ev.PDB_UPDATE if key in self.pdbs else ev.PDB_ADD)
        self.pdbs[key] = pdb

    # -- derived -------------------------------------------------------------
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

    def gang_members(self, pg: PodGroup) -> list[Pod]:
        return [
            p for p in self.pods.values()
            if p.namespace == pg.namespace and p.pod_group() == pg.name
        ]

    def _pending_eligible(self, pod: Pod) -> bool:
        return (
            pod.node_name is None
            and pod.uid not in self.reserved
            and pod.phase == PodPhase.PENDING
            and not pod.terminating
            and not pod.scheduling_gated
            and pod.scheduler_name in self.scheduler_names
        )

    def pending_pods(self) -> list[Pod]:
        """The schedulable queue in insertion order: reserved and gated
        pods stay out, and only pods addressed to one of `scheduler_names`
        enter."""
        return [p for p in self.pods.values() if self._pending_eligible(p)]

    def gated_pods(self) -> list[Pod]:
        return [
            p for p in self.pods.values()
            if p.node_name is None and p.scheduling_gated and not p.terminating
        ]

    # -- binding and reservations ---------------------------------------------
    def bind(self, uid: str, node_name: str, now_ms: int = 0):
        self.reserved.pop(uid, None)
        self.pod_deadline_ms.pop(uid, None)
        self.unschedulable_since.pop(uid, None)
        self._clear_backoff(uid)
        self.note_event(ev.POD_UPDATE)  # assigned: spec.nodeName set
        self.pods[uid].node_name = node_name
        self.recent_bindings[uid] = (now_ms, node_name)
        if self.nrt_cache is not None:
            # the NRT cache's Reserve -> bind -> PostBind lifecycle
            self.nrt_cache.reserve(node_name, self.pods[uid])
            self.nrt_cache.post_bind(node_name, self.pods[uid])

    def reserve(self, uid: str, node_name: str):
        """Permit said Wait: hold the placement without binding."""
        self.reserved[uid] = node_name
        if self.nrt_cache is not None:
            self.nrt_cache.reserve(node_name, self.pods[uid])

    def release_reservation(self, uid: str):
        self.pod_deadline_ms.pop(uid, None)
        node = self.reserved.pop(uid, None)
        if node is not None and self.nrt_cache is not None:
            self.nrt_cache.unreserve(node, self.pods[uid])

    def gang_reservations(self, pg: PodGroup) -> list[str]:
        return [
            uid for uid in self.reserved
            if (p := self.pods.get(uid)) is not None
            and p.namespace == pg.namespace and p.pod_group() == pg.name
        ]

    #: the metrics agent's reporting interval: pods bound within it are
    #: presumed unreported and their predicted CPU is added (handler.go)
    METRICS_REPORT_INTERVAL_MS = 60_000
    #: the ScheduledPodsCache GC horizon (handler.go: 5 minutes)
    BINDING_CACHE_GC_MS = 300_000

    def _metrics_with_missing(self, now_ms: int) -> Optional[dict]:
        """The node metrics with the missing-utilization compensation
        merged in (targetloadpacking.go:148-168): per node, the predicted
        CPU of the pods bound there within the reporting interval. GCs
        the binding cache first, with or without metrics."""
        for uid, (ts, _) in list(self.recent_bindings.items()):
            if now_ms - ts > self.BINDING_CACHE_GC_MS:
                del self.recent_bindings[uid]
        if self.node_metrics is None:
            return None
        missing: dict[str, int] = {}
        for uid, (ts, node) in self.recent_bindings.items():
            pod = self.pods.get(uid)
            if pod is None or now_ms - ts >= self.METRICS_REPORT_INTERVAL_MS:
                continue
            missing[node] = missing.get(node, 0) + pod.tlp_predicted_cpu_millis(
                *self.tlp_prediction
            )
        if not missing:
            return self.node_metrics
        merged = {name: dict(m) for name, m in self.node_metrics.items()}
        for node, millis in missing.items():
            merged.setdefault(node, {})["missing_cpu_millis"] = (
                merged.get(node, {}).get("missing_cpu_millis", 0) + millis
            )
        return merged

    # -- snapshot ------------------------------------------------------------
    def _assigned_pods(self, exclude=frozenset()) -> list[Pod]:
        """Bound pods plus reserved (permit-waiting) pods, each reserved
        one as a copy with its held node set: the stored pod stays
        unbound. The uids in `exclude` are left out (the preemption dry
        run's evicted set)."""
        assigned = [p for p in self.pods.values()
                    if p.node_name is not None and p.uid not in exclude]
        for uid, node in self.reserved.items():
            pod = self.pods.get(uid)
            if (pod is not None and pod.node_name is None
                    and uid not in exclude):
                held = copy.copy(pod)
                held.node_name = node
                assigned.append(held)
        return assigned

    def snapshot(self, pending: list[Pod], now_ms: int = 0, device=None,
                 **kwargs):
        """Lower the current state for the solver onto `device` (None =
        the CUDA card). Reserved pods count as assigned to their reserved
        node: they hold capacity, quota and quorum exactly like the
        reference's waiting pods. The metrics table carries the
        missing-CPU compensation at `now_ms`; the zone tables are the NRT
        CRs as published, or the cache tier's adjusted view with its
        stale nodes when a cache is installed."""
        backed_off = [
            name for name, until in self.gang_backoff_until_ms.items()
            if until > now_ms
        ]
        nrt_list = list(self.nrts.values())
        stale_nodes: list[str] = []
        if self.nrt_cache is not None:
            nrt_list, stale = self.nrt_cache.view()
            stale_nodes = list(stale)
        return build_snapshot(
            list(self.nodes.values()),
            pending,
            assigned_pods=self._assigned_pods(),
            pod_groups=list(self.pod_groups.values()),
            quotas=list(self.quotas.values()),
            nrts=nrt_list,
            stale_nrt_nodes=stale_nodes,
            app_groups=list(self.app_groups.values()),
            backed_off_gangs=backed_off,
            extra_pods=self.gated_pods(),
            device=device,
            node_metrics=self._metrics_with_missing(now_ms),
            tlp_prediction=self.tlp_prediction,
            namespaces=list(self.namespaces.values()),
            **kwargs,
        )

    def post_eviction_tables(self, snap, meta, exclude_uids):
        """The pod-derived side tables with `exclude_uids` evicted: the
        preemption dry run's post-eviction Filter view (upstream
        SelectVictimsOnNode removes victims from the NodeInfo before
        RunFilterPluginsWithNominatedPods). Rebuilds the in-tree scheduling
        tables without the evicted pods (the spread and affinity counts,
        the anti-affinity domains and symmetric-score carriers of the
        existing pods) and decrements the network placed-workload counts
        of the evicted pods' nodes; the NRT cache view is deliberately
        untouched (upstream's TopologyMatch reads its own cache, which
        victim removal does not update either). Returns a snapshot on
        `snap`'s device sharing every other table with it."""
        from scheduler_plugins_tpu_torch.state.scheduling import (
            build_scheduling,
        )

        excl = set(exclude_uids)
        new_sched = snap.scheduling
        if snap.scheduling is not None:
            nodes = [self.nodes[n] for n in meta.node_names if n in self.nodes]
            pending = [
                self.pods[uid] for uid in meta.pod_names if uid in self.pods
            ]
            new_sched = build_scheduling(
                nodes, pending, snap.num_nodes, snap.num_pods,
                assigned=self._assigned_pods(exclude=excl),
                namespaces=list(self.namespaces.values()),
            )
            if new_sched is not None:
                new_sched = new_sched.to(snap.device)
        new_network = snap.network
        if snap.network is not None and meta.workloads:
            placed = snap.network.placed_node.cpu().numpy().copy()
            node_pos = {name: i for i, name in enumerate(meta.node_names)}
            wl_pos = {name: i for i, name in enumerate(meta.workloads)}
            for uid in excl:
                pod = self.pods.get(uid)
                if pod is None or pod.node_name not in node_pos:
                    continue
                sel = pod.workload_selector()
                wc = wl_pos.get(f"{pod.namespace}/{sel}") if sel else None
                if wc is not None:
                    ni = node_pos[pod.node_name]
                    placed[wc, ni] = max(placed[wc, ni] - 1, 0)
            new_network = snap.network.replace(placed_node=torch.from_numpy(
                placed).to(snap.device))
        return snap.replace(scheduling=new_sched, network=new_network)
