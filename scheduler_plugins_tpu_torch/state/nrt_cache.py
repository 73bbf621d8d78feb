"""NodeResourceTopology cache tier (port of
`scheduler_plugins_tpu.state.nrt_cache`): host-side, event-driven
bookkeeping of the zone availability the snapshot reads between a Reserve
and the node agent's next NRT report (upstream pkg/noderesourcetopology/
cache). Three interchangeable policies:

- `PassthroughCache`     the live NRT objects, always fresh
  (cache/passthrough.go).
- `DiscardReservedCache` a node is stale between Reserve and PostBind /
  Unreserve (the reservation map keyed node -> pod uids,
  cache/discardreserved.go:46-110).
- `OverReserveCache`     NRT deep copies plus the assumed pod requests of
  each node; the view deducts the assumed requests from EVERY zone
  (cache/store.go:129-160, overreserve.go:101-127); nodes hosting foreign
  pods are stale; the resync accepts a node's newer NRT only when the
  agent-stamped pod fingerprint matches the pods the scheduler knows on
  the node (overreserve.go:276-348), then flushes and bumps the
  generation (overreserve.go:351-373).

The pod fingerprint is the podfingerprint library's contract: a stable
hash over the sorted (namespace, name) pairs of the node's pods, the same
string, byte for byte, as the JAX package's. Host Python only: nothing
here touches a tensor.
"""

from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass, field
from typing import Iterable

from scheduler_plugins_tpu_torch.api.objects import (
    DEFAULT_SCHEDULER_NAME,
    NodeResourceTopology,
    Pod,
    PodPhase,
    QOSClass,
)
from scheduler_plugins_tpu_torch.api.resources import (
    CPU,
    MEMORY,
    add_quantities,
)
from scheduler_plugins_tpu_torch.utils import observability as obs


def uses_exclusive_resources(pod: Pod) -> bool:
    """AreExclusiveForPod (resourcerequests/exclusive.go:47-95): extended
    resources are always exclusive (devices); for Guaranteed pods,
    integral CPU, any memory and hugepages are exclusive. Non-restartable
    init containers are ignored (they finish before steady state)."""
    qos = pod.qos_class()
    containers = [
        c for c in pod.init_containers if c.restart_policy_always
    ] + list(pod.containers)
    for c in containers:
        for name, qty in c.requests.items():
            # extended resources are devices; kubernetes.io/-prefixed
            # names are native (IsNativeResource, exclusive.go:74-77)
            if "/" in name and not name.startswith("kubernetes.io/"):
                return True
            if qos != QOSClass.GUARANTEED:
                continue
            if name == CPU and qty > 0 and qty % 1000 == 0:
                return True
            if (name == MEMORY or name.startswith("hugepages-")) and qty > 0:
                return True
    return False


def compute_pod_fingerprint(pods: Iterable[tuple[str, str]]) -> str:
    """Stable fingerprint over (namespace, name) pairs: agent and
    scheduler compute it independently from their own view of the node's
    pods and compare."""
    h = hashlib.sha256()
    for ns, name in sorted(pods):
        h.update(f"{ns}/{name};".encode())
    return "pfp0v1:" + h.hexdigest()[:16]


class NrtCache:
    """Interface: the snapshot-facing view plus the scheduling lifecycle
    hooks."""

    def view(self) -> tuple[list[NodeResourceTopology], set[str]]:
        """(adjusted NRT list, stale node names)."""
        raise NotImplementedError

    def reserve(self, node: str, pod: Pod) -> None:  # Reserve
        pass

    def unreserve(self, node: str, pod: Pod) -> None:  # Unreserve
        pass

    def post_bind(self, node: str, pod: Pod) -> None:  # PostBind
        pass

    def update_nrt(self, nrt: NodeResourceTopology) -> None:  # informer
        raise NotImplementedError

    def delete_nrt(self, node: str) -> None:
        """CR deleted: the node no longer publishes topology; every tier
        drops its copy and any pending resync state."""
        for attr in ("nrts", "pending"):
            store = getattr(self, attr, None)
            if store is not None:
                store.pop(node, None)


class PassthroughCache(NrtCache):
    """Live reads, always fresh (cache/passthrough.go)."""

    def __init__(self):
        self.nrts: dict[str, NodeResourceTopology] = {}

    def update_nrt(self, nrt: NodeResourceTopology) -> None:
        self.nrts[nrt.node_name] = nrt

    def view(self):
        return list(self.nrts.values()), set()


class DiscardReservedCache(NrtCache):
    """A node is blocked while any reservation on it is in flight
    (cache/discardreserved.go:46-110)."""

    def __init__(self):
        self.nrts: dict[str, NodeResourceTopology] = {}
        self.reservations: dict[str, set[str]] = {}

    def update_nrt(self, nrt: NodeResourceTopology) -> None:
        self.nrts[nrt.node_name] = nrt

    def reserve(self, node: str, pod: Pod) -> None:
        self.reservations.setdefault(node, set()).add(pod.uid)

    def unreserve(self, node: str, pod: Pod) -> None:
        self._clear(node, pod)

    def post_bind(self, node: str, pod: Pod) -> None:
        self._clear(node, pod)

    def _clear(self, node: str, pod: Pod) -> None:
        uids = self.reservations.get(node)
        if uids is not None:
            uids.discard(pod.uid)
            if not uids:
                del self.reservations[node]

    def view(self):
        stale = {node for node, uids in self.reservations.items() if uids}
        return list(self.nrts.values()), stale


@dataclass
class OverReserveCache(NrtCache):
    """Pessimistic over-reservation with a fingerprint-gated resync."""

    #: profile names counted as ours: a running pod with another
    #: schedulerName marks its node foreign (cache/foreign_pods.go:42-99)
    our_schedulers: set[str] = field(
        default_factory=lambda: {DEFAULT_SCHEDULER_NAME}
    )
    #: ForeignPodsDetect: "All" (the default) or "OnlyExclusiveResources",
    #: which counts only pods that pin cpus or devices
    foreign_pods_detect: str = "All"
    #: Cache.ResyncMethod (store.go:204-222): which pods enter the
    #: expected fingerprint. "All" every known pod,
    #: "OnlyExclusiveResources" only the pods pinning cpus or devices,
    #: "Autodetect" (the default) follows each NRT's stamped method
    #: (pod_fingerprint_method == "with-exclusive-resources")
    resync_method: str = "Autodetect"
    #: Cache.InformerMode (podprovider.go:37-93): which pod events the
    #: cache's pod view sees. "Dedicated" (the default) every bound pod,
    #: "Shared" only pods in the Running phase
    informer_mode: str = "Dedicated"

    def pod_relevant(self, pod: Pod) -> bool:
        """The pod provider's filter. A bound pod in the Pending phase
        counts under Dedicated: the store binds without kubelet phase
        transitions, so bound and Pending is the normal case here."""
        if self.informer_mode == "Shared":
            return pod.phase == PodPhase.RUNNING
        return pod.node_name is not None

    def __post_init__(self):
        self.nrts: dict[str, NodeResourceTopology] = {}  # flushed copies
        self.pending: dict[str, NodeResourceTopology] = {}  # to resync
        #: node -> uid -> (namespace, name, request)
        self.assumed: dict[str, dict[str, tuple[str, str, dict]]] = {}
        self.foreign: set[str] = set()
        self.maybe_overreserved: set[str] = set()
        self.attr_changed: set[str] = set()
        self.generation = 0

    # -- informer events -------------------------------------------------
    def update_nrt(self, nrt: NodeResourceTopology) -> None:
        node = nrt.node_name
        old = self.nrts.get(node)
        if nrt.policy != getattr(old, "policy", nrt.policy) or (
            nrt.scope != getattr(old, "scope", nrt.scope)
        ):
            # a kubelet config change must resync (cache/attr_watch.go)
            self.attr_changed.add(node)
        if (node not in self.assumed and node not in self.foreign
                and node not in self.maybe_overreserved):
            # a clean node takes the report directly; only nodes with live
            # deductions wait for the fingerprint-gated resync
            self.nrts[node] = copy.deepcopy(nrt)
            self.pending.pop(node, None)
        else:
            self.pending[node] = copy.deepcopy(nrt)

    def track_pod(self, pod: Pod) -> None:
        """A bound pod of another scheduler marks its node foreign
        (cache/foreign_pods.go); under OnlyExclusiveResources only pods
        pinning cpus or devices count, and the informer mode decides which
        pods the cache sees at all."""
        if not pod.node_name or pod.scheduler_name in self.our_schedulers:
            return
        if not self.pod_relevant(pod):
            return
        if (self.foreign_pods_detect == "OnlyExclusiveResources"
                and not uses_exclusive_resources(pod)):
            return
        self.foreign.add(pod.node_name)

    # -- scheduling lifecycle ---------------------------------------------
    def reserve(self, node: str, pod: Pod) -> None:
        if node not in self.nrts:
            # no NRT data yet: nothing to over-reserve against
            # (overreserve.go:151-163)
            return
        self.assumed.setdefault(node, {})[pod.uid] = (
            pod.namespace, pod.name, pod.effective_request(),
        )

    def unreserve(self, node: str, pod: Pod) -> None:
        self.assumed.get(node, {}).pop(pod.uid, None)

    def mark_maybe_overreserved(self, node: str) -> None:
        """A Filter failure on a cached view: the deduction may be stale
        (filter.go:220-223)."""
        self.maybe_overreserved.add(node)

    # -- view -------------------------------------------------------------
    def view(self):
        out = []
        for node, nrt in self.nrts.items():
            total = {}
            for _, _, req in self.assumed.get(node, {}).values():
                total = add_quantities(total, req)
            if total:
                adjusted = copy.deepcopy(nrt)
                for zone in adjusted.zones:
                    # the assumed requests leave EVERY zone
                    # (cache/store.go:129-160)
                    zone.available = {
                        name: qty - total.get(name, 0)
                        for name, qty in zone.available.items()
                    }
                out.append(adjusted)
            else:
                out.append(nrt)
        return out, set(self.foreign)

    # -- resync -----------------------------------------------------------
    def desynced_nodes(self) -> set[str]:
        """foreign | maybe-overreserved | attr-changed (GetDesyncedNodes,
        overreserve.go:212-245)."""
        return self.foreign | self.maybe_overreserved | self.attr_changed

    def resync(self, node_pods: dict[str, list[Pod]]) -> list[str]:
        """One resync pass over the dirty nodes in name order: a node's
        pending NRT is accepted only when its fingerprint matches the pods
        the scheduler knows there (overreserve.go:276-348); a config
        change flushes unconditionally. Returns the flushed nodes and
        bumps the generation once when any flushed. (The JAX package also
        counts the flushes in its metrics registry, which the port does
        not have yet.)"""
        flushed = []
        for node in sorted(self.desynced_nodes()):
            candidate = self.pending.get(node)
            if candidate is None:
                if node in self.attr_changed and node in self.nrts:
                    # the config change already came through the informer
                    self.attr_changed.discard(node)
                continue
            if node not in self.attr_changed:
                # the expected fingerprint from the scheduler's pod view,
                # over the pods the resync method selects (store.go:
                # 204-250)
                only_excl = self.resync_method == "OnlyExclusiveResources" or (
                    self.resync_method == "Autodetect"
                    and candidate.pod_fingerprint_method
                    == "with-exclusive-resources"
                )
                known = {
                    (p.namespace, p.name)
                    for p in node_pods.get(node, [])
                    if not only_excl or uses_exclusive_resources(p)
                }
                expected = compute_pod_fingerprint(known)
                if not candidate.pod_fingerprint:
                    continue  # no fingerprint: refuse (overreserve.go:306)
                if candidate.pod_fingerprint != expected:
                    continue  # the agent has not caught up yet
            self.nrts[node] = candidate
            del self.pending[node]
            # the matched report covers the node's bound pods: drop their
            # deductions, keep the in-flight (permit-waiting) ones the
            # agent cannot know about yet
            covered = {(p.namespace, p.name) for p in node_pods.get(node, [])}
            remaining = {
                uid: entry
                for uid, entry in self.assumed.get(node, {}).items()
                if (entry[0], entry[1]) not in covered
            }
            if remaining:
                self.assumed[node] = remaining
            else:
                self.assumed.pop(node, None)
            self.foreign.discard(node)
            self.maybe_overreserved.discard(node)
            self.attr_changed.discard(node)
            flushed.append(node)
        if flushed:
            self.generation += 1  # overreserve.go:369
            obs.metrics.inc(obs.CACHE_RESYNC_FLUSHES, len(flushed))
        return flushed
