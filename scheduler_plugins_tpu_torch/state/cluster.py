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
objects a PodAffinityTerm's namespaceSelector matches. For SySched it
holds the SeccompProfile CRs and the default profile the plugin installs,
and for PreemptionToleration the PriorityClasses.

For the serving engine (`serving.engine.ServeEngine`) the mutators push
typed node-column deltas into `delta_sink` when one is attached: the
O(changed) feed the engine folds into its resident tensors instead of
re-snapshotting. The mutators also feed the pod-lifecycle ledger
(`obs.ledger.LEDGER`, off by default: each hook is one branch then) and,
once `enable_pending_index` turns it on, an O(changed) pending index that
`pending_pods` reads in the scan's exact order (the pipelined engine's
ingest path).

`attach_native_store` mirrors the hot node columns into the C++ columnar
store (`bridge.NativeStore`): every mutator then keeps the mirror
incrementally, and `snapshot` takes the node usage columns from its
exports instead of the O(assigned pods) Python accumulation whenever no
table needs the assigned pod objects (the `native` fast path; the
snapshot is equal either way, tensor by tensor).
"""

from __future__ import annotations

import copy
import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.api.resources import CANONICAL
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
    PriorityClass,
    SeccompProfile,
)
from scheduler_plugins_tpu_torch.obs import ledger as podledger
from scheduler_plugins_tpu_torch.state.snapshot import build_snapshot
from scheduler_plugins_tpu_torch.utils import observability as obs

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
    #: ns/name -> SeccompProfile CR (SySched's syscall sets)
    seccomp_profiles: dict[str, SeccompProfile] = field(default_factory=dict)
    #: name -> PriorityClass (PreemptionToleration's policies)
    priority_classes: dict[str, PriorityClass] = field(default_factory=dict)
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
    #: "namespace/name" of the all-syscalls SeccompProfile a pod that
    #: names no profile falls back to, installed by SySched's
    #: `configure_cluster` (sysched.go:198-208); None = no fallback
    sysched_default_profile: Optional[str] = None

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
    #: uids of live pods carrying spread / inter-pod affinity specs: while
    #: any exists the serving engine cannot own the snapshot (the
    #: scheduling tables need the assigned pod objects)
    _selector_spec_pods: set = field(default_factory=set)
    #: the serving engine's `serving.deltas.DeltaSink` (`ServeEngine
    #: .attach`), or None: when set, the mutators push typed node-column
    #: deltas beside their `note_event` calls
    delta_sink: Optional[object] = None
    #: opt-in O(changed) pending index (`enable_pending_index`, the
    #: pipelined engine's ingest path): uid -> Pod for every schedulable
    #: pod, kept by the same mutators that feed the delta sink. None (the
    #: default) keeps `pending_pods` the O(pods) scan.
    _pending_idx: Optional[dict] = None
    #: admission serial per uid, reproducing the pods dict's iteration
    #: order: assigned at the first add (an update keeps its place) and
    #: again when a removed uid is re-added (the dict moves it to the
    #: end), so the indexed queue order equals the scan's, ties and all
    _pod_order: dict = field(default_factory=dict)
    _order_next: int = 0
    #: the C++ columnar mirror (`attach_native_store`), or None
    _native: Optional[object] = None
    #: node name -> mirror row id, pod uid -> mirror pod id; pod ids are
    #: never reused (a delete and re-add is a new incarnation)
    _native_node_ids: dict = field(default_factory=dict)
    _native_pod_ids: dict = field(default_factory=dict)
    _native_next_pod_id: int = 0
    #: keys ("node/<name>", "pod/<uid>") of live objects naming a resource
    #: the 4-slot mirror cannot carry: the fast path stays off while any
    #: exists, and deleting the object turns it back on
    _native_incompat: set = field(default_factory=set)
    _native_replaying: bool = False

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
            led = podledger.LEDGER
            if led.enabled:
                # the charged branch only: a same-now re-mark is one
                # attempt and one ledger transition
                pod = self.pods.get(uid)
                led.on_unschedulable(
                    uid, attempts,
                    self.pod_backoff_until_ms[uid] - now_ms,
                    bool(pod is not None and pod.pod_group()),
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

    # -- the native mirror ---------------------------------------------------
    def attach_native_store(self):
        """Mirror the hot node columns into the C++ columnar store
        (`bridge.NativeStore`, built with g++ on first use), replaying the
        current state; the mutators keep it incrementally from then on.
        Returns the store."""
        from scheduler_plugins_tpu_torch.bridge import NativeStore

        self._native = NativeStore(len(CANONICAL))
        self._native_node_ids = {}
        self._native_pod_ids = {}
        self._native_next_pod_id = 0
        self._native_incompat = set()
        self._native_replaying = True
        try:
            for node in self.nodes.values():
                self._native_upsert_node(node)
            for pod in self.pods.values():
                self._native_upsert_pod(pod)  # re-binds live reservations
        finally:
            self._native_replaying = False
        return self._native

    @property
    def native(self):
        return self._native

    def _canon_vecs(self, key: str, *quantity_maps) -> list:
        """Each mapping as an int64 vector on the canonical axis; an
        extended resource marks `key` incompatible (it is dropped from the
        vector), a compatible update clears the mark."""
        vecs = []
        incompat = False
        for quantities in quantity_maps:
            vec = np.zeros(len(CANONICAL), np.int64)
            for r, v in quantities.items():
                if r in CANONICAL:
                    vec[CANONICAL.index(r)] = v
                else:
                    incompat = True
            vecs.append(vec)
        if incompat:
            self._native_incompat.add(key)
        else:
            self._native_incompat.discard(key)
        return vecs

    def _native_upsert_node(self, node: Node):
        is_new = node.name not in self._native_node_ids
        if is_new:
            self._native_node_ids[node.name] = len(self._native_node_ids)
        alloc, cap = self._canon_vecs(f"node/{node.name}", node.allocatable,
                                      node.capacity)
        self._native.upsert_node(self._native_node_ids[node.name], alloc, cap)
        if not is_new or self._native_replaying:
            # a status update of a known node, or the attach replay, which
            # upserts every pod afterwards: nothing to re-link
            return
        # pods mirrored before their node arrived (watch streams are not
        # ordered across kinds) were stored unbound: re-upsert them
        for pod in self.pods.values():
            if pod.node_name == node.name:
                self._native_upsert_pod(pod)
        for uid, rnode in self.reserved.items():
            if rnode == node.name and uid in self._native_pod_ids:
                self._native.bind(self._native_pod_ids[uid],
                                  self._native_node_ids[node.name])

    def _native_upsert_pod(self, pod: Pod):
        if pod.uid not in self._native_pod_ids:
            self._native_pod_ids[pod.uid] = self._native_next_pod_id
            self._native_next_pod_id += 1
        req, lim = self._canon_vecs(f"pod/{pod.uid}", pod.effective_request(),
                                    pod.effective_limits())
        self._native.upsert_pod(
            self._native_pod_ids[pod.uid], req, limits=lim,
            priority=pod.priority, creation_ms=pod.creation_ms,
            node_id=self._native_node_ids.get(pod.node_name, -1),
            terminating=pod.terminating,
        )
        # a re-upsert of a permit-reserved pod keeps its hold
        rnode = self.reserved.get(pod.uid)
        if rnode is not None and rnode in self._native_node_ids:
            self._native.bind(self._native_pod_ids[pod.uid],
                              self._native_node_ids[rnode])

    def _native_rebuild(self):
        """A node delete invalidates the mirror's row order: replay it from
        scratch (a rare control-plane event; all else is incremental)."""
        self._native.close()
        self.attach_native_store()

    def _native_exports(self) -> Optional[dict]:
        """The mirror's node exports when the snapshot may take its node
        columns from them, else None: no incompatible object, no table
        that reads the assigned pod objects (gangs, quotas, the network
        tables, the syscall tables, spread and inter-pod affinity), and
        the mirror's rows in the store's node order."""
        if (self._native is None or self._native_incompat or self.pod_groups
                or self.quotas or self.app_groups or self.seccomp_profiles
                or self._selector_spec_pods):
            return None
        exports = self._native.export_nodes()
        if len(exports["ids"]) != len(self.nodes) or any(
                self._native_node_ids.get(n) != i
                for i, n in enumerate(self.nodes)):
            return None
        return exports

    # -- upserts and deletes -------------------------------------------------
    def add_node(self, node: Node):
        self.note_event(
            ev.NODE_UPDATE if node.name in self.nodes else ev.NODE_ADD
        )
        self.nodes[node.name] = node
        if self._native is not None:
            self._native_upsert_node(node)
        if self.delta_sink is not None:
            self.delta_sink.node_upsert(node)

    def remove_node(self, name: str):
        if self.nodes.pop(name, None) is not None:
            self.note_event(ev.NODE_DELETE)
            if self.delta_sink is not None:
                self.delta_sink.node_delete(name)
        if self._native is not None:
            self._native_rebuild()

    @staticmethod
    def _has_selector_specs(pod: Pod) -> bool:
        return bool(
            pod.topology_spread
            or pod.pod_affinity_required
            or pod.pod_anti_affinity_required
            or pod.pod_affinity_preferred
            or pod.pod_anti_affinity_preferred
        )

    def _held_node(self, pod: Optional[Pod]) -> Optional[str]:
        """The node whose usage columns `pod` contributes to: its binding,
        else its permit reservation (reserved pods hold capacity exactly
        like bound ones in the snapshot's assigned view); None for a plain
        pending pod."""
        if pod is None:
            return None
        return pod.node_name or self.reserved.get(pod.uid)

    def _gang_gated_key(self, pod: Optional[Pod]) -> Optional[str]:
        """The gang `pod` counts into as an unbound, scheduling-gated
        member (the `gated_pods()` share of the snapshot's gang gated and
        total counts), or None: the serving engine's gang side table
        follows transitions of this predicate."""
        if pod is None or pod.node_name is not None:
            return None
        if not pod.scheduling_gated or pod.terminating:
            return None
        name = pod.pod_group()
        if not name:
            return None
        return f"{pod.namespace}/{name}"

    def add_pod(self, pod: Pod):
        t0 = time.perf_counter_ns() if obs.tracer.enabled else 0
        old = self.pods.get(pod.uid)
        self.note_event(ev.POD_UPDATE if old is not None else ev.POD_ADD)
        if old is None and pod.node_name is None:
            led = podledger.LEDGER
            if led.enabled:
                led.on_first_seen(pod)
        if self.delta_sink is not None:
            # an upsert swaps the pod's contribution wholesale (its
            # requests may have changed; a stale echo may drop the node)
            old_hold = self._held_node(old)
            if old_hold is not None:
                self.delta_sink.pod_unassigned(old, old_hold)
            # the gated-gang transition, taken at event time: the upsert
            # replaces the object
            old_gated = self._gang_gated_key(old)
            new_gated = self._gang_gated_key(pod)
            if old_gated != new_gated:
                if old_gated is not None:
                    self.delta_sink.gang_gated(old_gated, -1)
                if new_gated is not None:
                    self.delta_sink.gang_gated(new_gated, +1)
        self.pods[pod.uid] = pod
        if self.delta_sink is not None:
            new_hold = self._held_node(pod)
            if new_hold is not None:
                self.delta_sink.pod_assigned(pod, new_hold)
            self.delta_sink.note_nomination(pod)
        if self._has_selector_specs(pod):
            # pod specs are immutable: count on add and remove
            self._selector_spec_pods.add(pod.uid)
        if self.nrt_cache is not None and hasattr(self.nrt_cache,
                                                  "track_pod"):
            # foreign-pod detection (cache/foreign_pods.go:42-99)
            self.nrt_cache.track_pod(pod)
        if self._native is not None:
            self._native_upsert_pod(pod)
        self._index_add_pod(pod, was_present=old is not None)
        if t0:
            # a counter, not a span: a span would cost more than the call
            obs.tracer.add_ns("store.add_pod", time.perf_counter_ns() - t0)

    def remove_pod(self, uid: str):
        t0 = time.perf_counter_ns() if obs.tracer.enabled else 0
        self.release_reservation(uid)  # notifies the NRT cache too
        self._selector_spec_pods.discard(uid)
        self.unschedulable_since.pop(uid, None)
        self._clear_backoff(uid)
        pod = self.pods.pop(uid, None)
        # after the pop: the release above may have re-indexed the pod;
        # a removed uid leaves both tables (a re-add lands at the end,
        # as in the pods dict)
        self._index_drop_pod(uid, forget_order=True)
        if pod is not None:
            self.note_event(ev.POD_DELETE)
            if pod.node_name is None:
                led = podledger.LEDGER
                if led.enabled:
                    led.on_delete(uid)
            if self.delta_sink is not None:
                if pod.node_name is not None:
                    # a bound pod's usage leaves with it (a reserved pod's
                    # hold was released above)
                    self.delta_sink.pod_unassigned(pod, pod.node_name)
                gated = self._gang_gated_key(pod)
                if gated is not None:
                    self.delta_sink.gang_gated(gated, -1)
                self.delta_sink.forget_nomination(uid)
            if pod.node_name is not None and self.nrt_cache is not None:
                # a bound pod's assumed deduction must not outlive it
                self.nrt_cache.unreserve(pod.node_name, pod)
            if self._native is not None:
                pod_id = self._native_pod_ids.pop(uid, None)
                if pod_id is not None:
                    self._native.delete_pod(pod_id)
                self._native_incompat.discard(f"pod/{uid}")
        if t0:
            obs.tracer.add_ns("store.remove_pod", time.perf_counter_ns() - t0)

    def mark_terminating(self, uid: str, now_ms: int):
        """DELETE issued (a preemption victim): the pod turns terminating
        and keeps its node until it is removed."""
        pod = self.pods.get(uid)
        if pod is None:
            return
        was_terminating = pod.terminating
        # the gated-gang share, taken before the in-place flip (a
        # terminating gated member leaves `gated_pods()`)
        gated = (
            self._gang_gated_key(pod)
            if self.delta_sink is not None and not was_terminating else None
        )
        pod.deletion_ms = now_ms
        if not was_terminating:
            led = podledger.LEDGER
            if led.enabled:
                led.on_terminating(uid)
        if gated is not None:
            self.delta_sink.gang_gated(gated, -1)
        self._index_drop_pod(uid)
        self.note_event(ev.POD_UPDATE)
        if self._native is not None:
            self._native_upsert_pod(pod)
        if self.delta_sink is not None and not was_terminating:
            # at the held node, binding or reservation: a reserved
            # victim's flag counts at its reserved node, and the release
            # later subtracts the event-time flag
            held = self._held_node(pod)
            if held is not None:
                self.delta_sink.pod_terminating(pod, held)

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

    def add_seccomp_profile(self, sp: SeccompProfile):
        self.note_event(
            ev.SECCOMP_PROFILE_UPDATE if sp.full_name in self.seccomp_profiles
            else ev.SECCOMP_PROFILE_ADD
        )
        self.seccomp_profiles[sp.full_name] = sp

    def add_priority_class(self, pc: PriorityClass):
        self.note_event(
            ev.PRIORITY_CLASS_UPDATE if pc.name in self.priority_classes
            else ev.PRIORITY_CLASS_ADD
        )
        self.priority_classes[pc.name] = pc

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
        """The schedulable-queue predicate, shared by the scan and the
        index so the two views cannot drift."""
        return (
            pod.node_name is None
            and pod.uid not in self.reserved
            and pod.phase == PodPhase.PENDING
            and not pod.terminating
            and not pod.scheduling_gated
            and pod.scheduler_name in self.scheduler_names
        )

    def enable_pending_index(self) -> None:
        """Switch `pending_pods` from the O(pods) scan to a maintained
        O(changed) index. Call after `scheduler_names` and the initial
        population are set; the mutators keep it exact from then on. Code
        that flips a pod's eligibility in place (outside the mutators, the
        delta sink's blind spot too) must call `reindex_pod`."""
        self._pod_order = {uid: i for i, uid in enumerate(self.pods)}
        self._order_next = len(self._pod_order)
        self._pending_idx = {
            p.uid: p for p in self.pods.values() if self._pending_eligible(p)
        }

    def disable_pending_index(self) -> None:
        self._pending_idx = None
        self._pod_order = {}
        self._order_next = 0

    def reindex_pod(self, uid: str) -> None:
        """Re-evaluate one pod's pending-index membership after an
        in-place eligibility flip (phase, scheduling gate)."""
        pod = self.pods.get(uid)
        if pod is not None and pod.node_name is None:
            led = podledger.LEDGER
            if led.enabled:
                led.on_gate_flip(uid, bool(pod.scheduling_gated))
        if self._pending_idx is None:
            return
        if pod is not None and self._pending_eligible(pod):
            self._pending_idx[uid] = pod
        else:
            self._pending_idx.pop(uid, None)

    def _index_add_pod(self, pod: Pod, was_present: bool) -> None:
        if self._pending_idx is None:
            return
        if not was_present or pod.uid not in self._pod_order:
            # a first sighting, or a re-add after a remove: dicts append
            self._pod_order[pod.uid] = self._order_next
            self._order_next += 1
        if self._pending_eligible(pod):
            self._pending_idx[pod.uid] = pod
        else:
            self._pending_idx.pop(pod.uid, None)

    def _index_drop_pod(self, uid: str, forget_order: bool = False) -> None:
        if self._pending_idx is None:
            return
        self._pending_idx.pop(uid, None)
        if forget_order:
            self._pod_order.pop(uid, None)

    def pending_pods(self) -> list[Pod]:
        """The schedulable queue in insertion order: reserved and gated
        pods stay out, and only pods addressed to one of `scheduler_names`
        enter. With the index on, the list is assembled in O(pending log
        pending) in the identical order."""
        if self._pending_idx is not None:
            order = self._pod_order
            return sorted(
                self._pending_idx.values(), key=lambda p: order[p.uid]
            )
        return [p for p in self.pods.values() if self._pending_eligible(p)]

    def admission_serial(self, uid: str) -> int:
        """The pod's position in admission order (the K-lane engine's
        reproducible "hash" partition key): the maintained serial with
        the index on, else the dict-iteration position (the serial the
        index would have given). -1 for an unknown uid."""
        if self._pod_order:
            return self._pod_order.get(uid, -1)
        for i, known in enumerate(self.pods):
            if known == uid:
                return i
        return -1

    def gated_pods(self) -> list[Pod]:
        return [
            p for p in self.pods.values()
            if p.node_name is None and p.scheduling_gated and not p.terminating
        ]

    # -- binding and reservations ---------------------------------------------
    def bind(self, uid: str, node_name: str, now_ms: int = 0):
        held = self.reserved.pop(uid, None)
        self.pod_deadline_ms.pop(uid, None)
        self.unschedulable_since.pop(uid, None)
        self._clear_backoff(uid)
        self.note_event(ev.POD_UPDATE)  # assigned: spec.nodeName set
        if self.delta_sink is not None:
            if held != node_name:
                # a reservation bound on its own node is counted already;
                # anything else moves the contribution
                if held is not None:
                    self.delta_sink.pod_unassigned(self.pods[uid], held)
                self.delta_sink.pod_assigned(self.pods[uid], node_name)
            # a gated pod leaves `gated_pods()` once nodeName lands
            gated = self._gang_gated_key(self.pods[uid])
            if gated is not None:
                self.delta_sink.gang_gated(gated, -1)
            # bound pods never count toward the nominated column
            self.delta_sink.forget_nomination(uid)
        self.pods[uid].node_name = node_name
        self._index_drop_pod(uid)
        led = podledger.LEDGER
        if led.enabled:
            led.on_bind(uid, node_name)
        self.recent_bindings[uid] = (now_ms, node_name)
        if self.nrt_cache is not None:
            # the NRT cache's Reserve -> bind -> PostBind lifecycle
            self.nrt_cache.reserve(node_name, self.pods[uid])
            self.nrt_cache.post_bind(node_name, self.pods[uid])
        if self._native is not None:
            # a no-op when the reservation bound it to this node already
            self._native.bind(self._native_pod_ids[uid],
                              self._native_node_ids[node_name])

    def reserve(self, uid: str, node_name: str):
        """Permit said Wait: hold the placement without binding."""
        self.reserved[uid] = node_name
        self._index_drop_pod(uid)
        led = podledger.LEDGER
        if led.enabled:
            led.on_reserve(uid, node_name)
        if self.delta_sink is not None:
            # a reservation holds capacity exactly like a binding
            self.delta_sink.pod_assigned(self.pods[uid], node_name)
        if self.nrt_cache is not None:
            self.nrt_cache.reserve(node_name, self.pods[uid])
        if self._native is not None:
            # a reservation holds capacity exactly like a binding
            self._native.bind(self._native_pod_ids[uid],
                              self._native_node_ids[node_name])

    def release_reservation(self, uid: str):
        self.pod_deadline_ms.pop(uid, None)
        node = self.reserved.pop(uid, None)
        if node is not None and self.delta_sink is not None:
            self.delta_sink.pod_unassigned(self.pods[uid], node)
        if node is not None and self.nrt_cache is not None:
            self.nrt_cache.unreserve(node, self.pods[uid])
        if node is not None and self._native is not None:
            # re-upserted unbound: the hold's contribution leaves
            self._native_upsert_pod(self.pods[uid])
        if node is not None:
            self.reindex_pod(uid)

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
        stale nodes when a cache is installed. The SeccompProfile CRs
        and the default profile become the syscall tables. With the native
        mirror attached and no table reading the assigned pod objects, the
        node usage columns come from the mirror's exports. Traced: the
        binding cache's walk, the assigned-pod walk and the lowering are
        `Snapshot/binding_cache`, `Snapshot/assigned` and `Snapshot/lower`
        on the "cycle" row."""
        with obs.tracer.span("Snapshot/binding_cache", tid="cycle",
                             entries=len(self.recent_bindings)):
            node_metrics = self._metrics_with_missing(now_ms)
        native = self._native_exports()
        assigned = []
        if native is None:
            with obs.tracer.span("Snapshot/assigned", tid="cycle") as span:
                assigned = self._assigned_pods()
                if span is not None:
                    span.args["pods"] = len(assigned)
        backed_off = [
            name for name, until in self.gang_backoff_until_ms.items()
            if until > now_ms
        ]
        nrt_list = list(self.nrts.values())
        stale_nodes: list[str] = []
        if self.nrt_cache is not None:
            nrt_list, stale = self.nrt_cache.view()
            stale_nodes = list(stale)
        with obs.tracer.span("Snapshot/lower", tid="cycle"):
            return build_snapshot(
                list(self.nodes.values()),
                pending,
                assigned_pods=assigned,
                pod_groups=list(self.pod_groups.values()),
                quotas=list(self.quotas.values()),
                nrts=nrt_list,
                stale_nrt_nodes=stale_nodes,
                app_groups=list(self.app_groups.values()),
                backed_off_gangs=backed_off,
                extra_pods=self.gated_pods(),
                device=device,
                node_metrics=node_metrics,
                tlp_prediction=self.tlp_prediction,
                namespaces=list(self.namespaces.values()),
                seccomp_profiles=list(self.seccomp_profiles.values()),
                sysched_default_profile=self.sysched_default_profile,
                native_nodes=native,
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
