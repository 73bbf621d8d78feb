"""Cluster event feed — the cross-process bridge front end (port of
`scheduler_plugins_tpu.bridge.feed`; the wire contract below is the JAX
package's, unchanged, so one agent feeds either package).

The reference's cross-process feed is apiserver List/Watch into informer
caches; here a cluster-side agent ships events to the scheduler host, which
solves on the card. This module implements that
boundary as a newline-delimited JSON event protocol over TCP — deliberately
language-agnostic so a Go/C++ agent can speak it without Python bindings —
applied to the host `Cluster` store (and through it the native columnar
store when attached):

    {"op": "upsert_node", "name": ..., "allocatable": {res: int}, ...}
    {"op": "upsert_pod",  "name": ..., "namespace": ..., "requests": {...},
     "limits": {...}, "priority": 0, "node": null|name, "labels": {...}}
    {"op": "delete_pod", "uid": ...}          (or namespace+name)
    {"op": "delete_node", "name": ...}
    {"op": "upsert_quota"|"delete_quota", ...}
    {"op": "upsert_pod_group"|"delete_pod_group", ...}
    {"op": "metrics", "nodes": {node: {"cpu_avg": ..., ...}}}

Protocol v2 covers the FULL CR surface the reference's informers watch
(plugin.go:86-115 NRT; networkoverhead.go:136-171 AppGroup/NetworkTopology;
sysched.go:305-396 pod/profile handlers; PriorityClass/PDB consumed by the
preemption tier):

    {"op": "upsert_nrt", "node": ..., "policy": int, "scope": int,
     "max_numa_nodes": 8, "pod_fingerprint": "...",
     "zones": [{"numa_id": 0, "available": {...}, "allocatable": {...},
                "costs": {"1": 20}}]}                      | "delete_nrt"
    {"op": "upsert_app_group", "name": ..., "namespace": ...,
     "workloads": [{"selector": ..., "dependencies":
                    [{"workload_selector": ..., "max_network_cost": 10}]}],
     "topology_order": {selector: index}}                  | "delete_app_group"
    {"op": "upsert_network_topology", "name": ..., "weights":
     {weightsName: {"zone"|"region": [[orig, dest, cost], ...]}}}
                                                  | "delete_network_topology"
    {"op": "upsert_seccomp_profile", "name": ..., "syscalls": [...]}
                                                  | "delete_seccomp_profile"
    {"op": "upsert_priority_class", "name": ..., "value": 0,
     "annotations": {...}}                        | "delete_priority_class"
    {"op": "upsert_pdb", "name": ..., "selector": {...},
     "disruptions_allowed": 1, "disrupted_pods": [...]}    | "delete_pdb"

Pod events may carry scheduler_name/phase/deletion_ms so foreign-pod
detection and lifecycle accounting work through this boundary, plus the full
spec surface: "containers"/"init_containers" (each {"requests", "limits",
"restart_policy_always", "seccomp_profile"}), "overhead", "annotations",
"nominated_node", "priority_class_name" and "scheduling_gated" — the
single-container "requests"/"limits" shorthand remains valid. A bound pod
is not demoted by a stale echo without a node (informer-cache semantics).

Node events may carry "taints"; pod events the in-tree spec fragments the
companion plugins consume (plugins/intree.py): "node_selector",
"node_affinity" {"required": [term], "preferred": [{"weight", "preference":
term}]} (term = {"match_expressions"/"match_fields":
[{"key","operator","values"}]}), "tolerations", "topology_spread"
[{"max_skew","topology_key","when_unsatisfiable","label_selector"}], and
"pod_affinity"/"pod_anti_affinity" {"required": [pterm], "preferred":
[{"weight","term": pterm}]} (pterm = {"topology_key","label_selector",
"namespaces","namespace_selector"}; label_selector =
{"match_labels","match_expressions"}). Spread constraints also accept
"min_domains", "match_label_keys", "node_affinity_policy" and
"node_taints_policy"; {"op": "upsert_namespace", "name": ..., "labels":
{...}} | "delete_namespace" carry the namespaceSelector targets.

Every object event may carry "rv" — a per-object monotonic resource
version; the server drops events at or below the last applied version
({"ok": true, "stale": true}), giving informer-grade fencing across
replays, reordering, and redundant agents.

Each line is acknowledged with {"ok": true} or {"ok": false, "error": ...};
the {"op": "sync"} barrier acks with cluster counts, so an agent can fence a
batch before requesting a scheduling cycle.

Transports: newline-JSON (above), the same events in gRPC message framing
(5-byte prefix; auto-detected per connection, `FramedFeedClient`), or real
gRPC via `bridge.grpc_feed` (HTTP/2, JSON codec, no protobuf stubs).
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

from scheduler_plugins_tpu_torch.api.objects import (
    AppGroup,
    AppGroupDependency,
    AppGroupWorkload,
    Container,
    ElasticQuota,
    LabelSelector,
    LabelSelectorRequirement,
    Namespace,
    NetworkTopology,
    Node,
    NodeResourceTopology,
    NodeSelectorTerm,
    NUMAZone,
    Pod,
    PodAffinityTerm,
    PodDisruptionBudget,
    PodGroup,
    PreferredSchedulingTerm,
    PriorityClass,
    SeccompProfile,
    Taint,
    Toleration,
    TopologyManagerPolicy,
    TopologyManagerScope,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.state.cluster import Cluster

#: framed-transport sanity bound — far above any real event, far below a
#: memory-exhausting allocation from a garbage header
MAX_FRAME_BYTES = 16 << 20


def _container(spec: dict) -> Container:
    return Container(
        name=spec.get("name", "c"),
        requests={k: int(v) for k, v in spec.get("requests", {}).items()},
        limits={k: int(v) for k, v in spec.get("limits", {}).items()},
        restart_policy_always=bool(spec.get("restart_policy_always", False)),
        seccomp_profile=spec.get("seccomp_profile"),
    )


_node_term = NodeSelectorTerm.from_wire


def _label_selector(spec: Optional[dict]) -> Optional[LabelSelector]:
    if spec is None:
        return None
    return LabelSelector(
        match_labels=spec.get("match_labels") or {},
        match_expressions=[
            LabelSelectorRequirement(
                key=r["key"], operator=r["operator"],
                values=tuple(r.get("values") or ()),
            )
            for r in spec.get("match_expressions") or []
        ],
    )


def _pod_term(spec: dict) -> PodAffinityTerm:
    return PodAffinityTerm(
        topology_key=spec["topology_key"],
        label_selector=_label_selector(spec.get("label_selector")),
        namespaces=tuple(spec.get("namespaces") or ()),
        namespace_selector=_label_selector(spec.get("namespace_selector")),
    )


def _pod_spec_fragments(event: dict) -> dict:
    """In-tree scheduling spec fragments (nodeSelector / affinity /
    tolerations / topology spread) from a pod event — the pieces real
    profiles need for the companion plugins (plugins/intree.py)."""
    out: dict = {}
    # `or {}` / `or []` throughout: agents marshaling structs without
    # omitempty emit JSON null for absent fields
    if event.get("node_selector"):
        out["node_selector"] = dict(event["node_selector"])
    na = event.get("node_affinity") or {}
    if na.get("required"):
        out["node_affinity_required"] = [
            _node_term(t) for t in na["required"]
        ]
    if na.get("preferred"):
        out["node_affinity_preferred"] = [
            PreferredSchedulingTerm(
                weight=int(t["weight"]),
                preference=_node_term(t.get("preference", {})),
            )
            for t in na["preferred"]
        ]
    if event.get("tolerations"):
        out["tolerations"] = [
            Toleration(
                key=t.get("key", ""),
                operator=t.get("operator", "Equal"),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
            for t in event["tolerations"]
        ]
    if event.get("topology_spread"):
        out["topology_spread"] = [
            TopologySpreadConstraint(
                max_skew=int(c["max_skew"]),
                topology_key=c["topology_key"],
                when_unsatisfiable=c.get(
                    "when_unsatisfiable", "DoNotSchedule"
                ),
                label_selector=_label_selector(c.get("label_selector")),
                min_domains=(
                    int(c["min_domains"]) if c.get("min_domains") else None
                ),
                match_label_keys=tuple(c.get("match_label_keys") or ()),
                node_affinity_policy=c.get("node_affinity_policy", "Honor"),
                node_taints_policy=c.get("node_taints_policy", "Ignore"),
            )
            for c in event["topology_spread"]
        ]
    for side, attr in (
        ("pod_affinity", "pod_affinity"),
        ("pod_anti_affinity", "pod_anti_affinity"),
    ):
        spec = event.get(side) or {}
        if spec.get("required"):
            out[f"{attr}_required"] = [_pod_term(t) for t in spec["required"]]
        if spec.get("preferred"):
            out[f"{attr}_preferred"] = [
                WeightedPodAffinityTerm(
                    weight=int(t["weight"]), term=_pod_term(t["term"])
                )
                for t in spec["preferred"]
            ]
    return out


#: op -> (kind, key fields) for resource-version fencing; namespaced kinds
#: key on "namespace/name"
_RV_KINDS = {
    "upsert_node": ("node", ("name",)),
    "delete_node": ("node", ("name",)),
    "upsert_pod": ("pod", ("namespace", "name")),
    "delete_pod": ("pod", ("namespace", "name")),
    "upsert_quota": ("quota", ("namespace",)),
    "delete_quota": ("quota", ("namespace",)),
    "upsert_pod_group": ("pod_group", ("namespace", "name")),
    "delete_pod_group": ("pod_group", ("namespace", "name")),
    "upsert_nrt": ("nrt", ("node",)),
    "delete_nrt": ("nrt", ("node",)),
    "upsert_app_group": ("app_group", ("namespace", "name")),
    "delete_app_group": ("app_group", ("namespace", "name")),
    "upsert_network_topology": ("network_topology", ("namespace", "name")),
    "delete_network_topology": ("network_topology", ("namespace", "name")),
    "upsert_seccomp_profile": ("seccomp_profile", ("namespace", "name")),
    "delete_seccomp_profile": ("seccomp_profile", ("namespace", "name")),
    "upsert_priority_class": ("priority_class", ("name",)),
    "upsert_namespace": ("namespace", ("name",)),
    "delete_namespace": ("namespace", ("name",)),
    "delete_priority_class": ("priority_class", ("name",)),
    "upsert_pdb": ("pdb", ("namespace", "name")),
    "delete_pdb": ("pdb", ("namespace", "name")),
}


def _rv_key(event: dict):
    spec = _RV_KINDS.get(event.get("op"))
    if spec is None:
        return None
    kind, fields = spec
    if kind == "pod":
        # one fence lane per pod regardless of which identifier a given
        # agent sends: namespace/name when available (the default uid
        # format), bare uid only as the delete-by-uid fallback
        if event.get("name"):
            return (kind, f"{event.get('namespace', 'default')}/{event['name']}")
        return (kind, event.get("uid", ""))
    ident = "/".join(
        str(event.get(f, "default" if f == "namespace" else ""))
        for f in fields
    )
    return (kind, ident)


def apply_event(
    cluster: Cluster, event: dict, rv_table: Optional[dict] = None
) -> dict:
    """Apply one event to the store; returns the ack payload.

    When the event carries `rv` (a per-object monotonic resource version,
    the informer-cache fencing the reference gets from the apiserver) and
    `rv_table` is provided, an event at or below the last applied version
    for that object is dropped with ``{"ok": true, "stale": true}`` — so
    replays, races between redundant agents, and out-of-order delivery
    cannot regress the store. Events without `rv` apply unconditionally
    (last-writer-wins, protocol v1/v2 behavior).
    """
    op = event.get("op")
    fence = None
    if rv_table is not None and "rv" in event:
        key = _rv_key(event)
        if key is not None:
            rv = int(event["rv"])
            last = rv_table.get(key)
            if last is not None and rv <= last:
                return {"ok": True, "stale": True, "last_rv": last}
            # recorded only AFTER the op applies cleanly — a malformed
            # event must not burn its version (the agent retries the
            # corrected event under the same rv)
            fence = (key, rv)
    ack = _apply_op(cluster, event, op)
    if fence is not None and ack.get("ok", True):
        rv_table[fence[0]] = fence[1]
    return ack


def _apply_op(cluster: Cluster, event: dict, op) -> dict:
    if op == "upsert_node":
        cluster.add_node(
            Node(
                name=event["name"],
                allocatable={k: int(v) for k, v in event["allocatable"].items()},
                labels=event.get("labels", {}),
                unschedulable=event.get("unschedulable", False),
                taints=[
                    Taint(
                        key=t["key"],
                        value=t.get("value", ""),
                        effect=t.get("effect", "NoSchedule"),
                    )
                    for t in event.get("taints", [])
                ],
            )
        )
    elif op == "upsert_pod":
        if "containers" in event:
            containers = [_container(c) for c in event["containers"]]
        else:  # single-container shorthand (protocol v1)
            containers = [
                Container(
                    requests={k: int(v) for k, v in event.get("requests", {}).items()},
                    limits={k: int(v) for k, v in event.get("limits", {}).items()},
                )
            ]
        pod = Pod(
            name=event["name"],
            namespace=event.get("namespace", "default"),
            uid=event.get("uid", ""),
            priority=int(event.get("priority", 0)),
            creation_ms=int(event.get("creation_ms", 0)),
            labels=event.get("labels", {}),
            annotations=event.get("annotations", {}),
            scheduler_name=event.get(
                "scheduler_name", "tpu-scheduler"
            ),
            phase=event.get("phase", "Pending"),
            deletion_ms=event.get("deletion_ms"),
            scheduling_gated=bool(event.get("scheduling_gated", False)),
            priority_class_name=event.get("priority_class_name", ""),
            preemption_policy=event.get("preemption_policy"),
            overhead={k: int(v) for k, v in event.get("overhead", {}).items()},
            containers=containers,
            init_containers=[
                _container(c) for c in event.get("init_containers", [])
            ],
            **_pod_spec_fragments(event),
        )
        pod.node_name = event.get("node")
        pod.nominated_node_name = event.get("nominated_node")
        existing = cluster.pods.get(pod.uid)
        if (
            existing is not None
            and existing.node_name is not None
            and pod.node_name is None
            and "rv" not in event
        ):
            # un-fenced stale watch echo predating our bind: the local
            # binding is the newer truth. An rv-carrying event already
            # passed the fence, so its missing node is REAL (e.g. the
            # apiserver rejected the bind) and must apply as-is.
            pod.node_name = existing.node_name
        cluster.add_pod(pod)
    elif op == "delete_pod":
        uid = event.get("uid") or f"{event.get('namespace', 'default')}/{event.get('name')}"
        if uid not in cluster.pods:
            return {"ok": False, "error": f"unknown pod {uid!r}"}
        cluster.remove_pod(uid)
    elif op == "delete_node":
        cluster.remove_node(event["name"])
    elif op == "delete_quota":
        if cluster.quotas.pop(event.get("namespace", "default"), None):
            cluster.note_event(ev.ELASTIC_QUOTA_DELETE)
    elif op == "delete_pod_group":
        if cluster.pod_groups.pop(
            f"{event.get('namespace', 'default')}/{event['name']}", None
        ):
            cluster.note_event(ev.POD_GROUP_DELETE)
    elif op == "upsert_quota":
        cluster.add_quota(
            ElasticQuota(
                name=event["name"],
                namespace=event.get("namespace", "default"),
                min={k: int(v) for k, v in event.get("min", {}).items()},
                max={k: int(v) for k, v in event.get("max", {}).items()},
            )
        )
    elif op == "upsert_pod_group":
        cluster.add_pod_group(
            PodGroup(
                name=event["name"],
                namespace=event.get("namespace", "default"),
                min_member=int(event.get("min_member", 1)),
                min_resources={
                    k: int(v) for k, v in event.get("min_resources", {}).items()
                },
                creation_ms=int(event.get("creation_ms", 0)),
            )
        )
    elif op == "upsert_nrt":
        cluster.add_nrt(
            NodeResourceTopology(
                node_name=event["node"],
                policy=TopologyManagerPolicy(int(event.get("policy", 0))),
                scope=TopologyManagerScope(int(event.get("scope", 0))),
                max_numa_nodes=int(event.get("max_numa_nodes", 8)),
                pod_fingerprint=event.get("pod_fingerprint", ""),
                pod_fingerprint_method=event.get(
                    "pod_fingerprint_method", ""
                ),
                zones=[
                    NUMAZone(
                        numa_id=int(z["numa_id"]),
                        available={
                            k: int(v)
                            for k, v in z.get("available", {}).items()
                        },
                        allocatable={
                            k: int(v)
                            for k, v in z.get("allocatable", {}).items()
                        },
                        costs={
                            int(k): int(v)
                            for k, v in z.get("costs", {}).items()
                        },
                    )
                    for z in event.get("zones", [])
                ],
            )
        )
    elif op == "delete_nrt":
        cluster.remove_nrt(event["node"])
    elif op == "upsert_app_group":
        cluster.add_app_group(
            AppGroup(
                name=event["name"],
                namespace=event.get("namespace", "default"),
                workloads=[
                    AppGroupWorkload(
                        selector=w["selector"],
                        dependencies=[
                            AppGroupDependency(
                                workload_selector=d["workload_selector"],
                                max_network_cost=int(
                                    d.get("max_network_cost", 0)
                                ),
                            )
                            for d in w.get("dependencies", [])
                        ],
                    )
                    for w in event.get("workloads", [])
                ],
                topology_order={
                    k: int(v)
                    for k, v in event.get("topology_order", {}).items()
                },
            )
        )
    elif op == "delete_app_group":
        if cluster.app_groups.pop(
            f"{event.get('namespace', 'default')}/{event['name']}", None
        ):
            cluster.note_event(ev.APP_GROUP_DELETE)
    elif op == "upsert_network_topology":
        # (origin, dest) pairs ride as [orig, dest, cost] triples on the wire
        cluster.add_network_topology(
            NetworkTopology(
                name=event.get("name", "nt-default"),
                namespace=event.get("namespace", "default"),
                weights={
                    wname: {
                        key: {
                            (str(o), str(d)): int(c) for o, d, c in triples
                        }
                        for key, triples in keys.items()
                    }
                    for wname, keys in event.get("weights", {}).items()
                },
            )
        )
    elif op == "delete_network_topology":
        if cluster.network_topologies.pop(
            f"{event.get('namespace', 'default')}/{event['name']}", None
        ):
            cluster.note_event(ev.NETWORK_TOPOLOGY_DELETE)
    elif op == "upsert_seccomp_profile":
        cluster.add_seccomp_profile(
            SeccompProfile(
                name=event["name"],
                namespace=event.get("namespace", "default"),
                syscalls=frozenset(event.get("syscalls", [])),
            )
        )
    elif op == "delete_seccomp_profile":
        if cluster.seccomp_profiles.pop(
            f"{event.get('namespace', 'default')}/{event['name']}", None
        ):
            cluster.note_event(ev.SECCOMP_PROFILE_DELETE)
    elif op == "upsert_priority_class":
        cluster.add_priority_class(
            PriorityClass(
                name=event["name"],
                value=int(event.get("value", 0)),
                annotations=event.get("annotations", {}),
            )
        )
    elif op == "delete_priority_class":
        if cluster.priority_classes.pop(event["name"], None):
            cluster.note_event(ev.PRIORITY_CLASS_DELETE)
    elif op == "upsert_namespace":
        cluster.add_namespace(
            Namespace(name=event["name"], labels=event.get("labels") or {})
        )
    elif op == "delete_namespace":
        if cluster.namespaces.pop(event["name"], None):
            cluster.note_event(ev.NAMESPACE_DELETE)
    elif op == "upsert_pdb":
        cluster.add_pdb(
            PodDisruptionBudget(
                name=event["name"],
                namespace=event.get("namespace", "default"),
                selector=event.get("selector", {}),
                disruptions_allowed=int(event.get("disruptions_allowed", 0)),
                disrupted_pods=frozenset(event.get("disrupted_pods", [])),
            )
        )
    elif op == "delete_pdb":
        if cluster.pdbs.pop(
            f"{event.get('namespace', 'default')}/{event['name']}", None
        ):
            cluster.note_event(ev.PDB_DELETE)
    elif op == "metrics":
        cluster.node_metrics = event["nodes"]
    elif op == "drain_deltas":
        # the streaming-delta bridge seam: export ONLY the node
        # rows the native columnar mirror touched since the last drain —
        # a remote consumer (mirror shard, dashboard) polls this instead
        # of a full O(cluster) snapshot. Single-consumer semantics: the
        # drain consumes the delta window and bumps the generation.
        native = cluster.native
        if native is None:
            return {
                "ok": False,
                "error": "no native store attached "
                         "(Cluster.attach_native_store)",
            }
        deltas = native.export_dirty()
        return {
            "ok": True,
            "generation": int(deltas["generation"]),
            "count": int(len(deltas["ids"])),
            "nodes": [
                {
                    "id": int(deltas["ids"][i]),
                    "alloc": [int(v) for v in deltas["alloc"][i]],
                    "capacity": [int(v) for v in deltas["capacity"][i]],
                    "requested": [int(v) for v in deltas["requested"][i]],
                    "nonzero_requested": [
                        int(v) for v in deltas["nonzero_requested"][i]
                    ],
                    "limits": [int(v) for v in deltas["limits"][i]],
                    "pod_count": int(deltas["pod_count"][i]),
                    "terminating": int(deltas["terminating"][i]),
                }
                for i in range(len(deltas["ids"]))
            ],
        }
    elif op == "sync":
        return {
            "ok": True,
            "nodes": len(cluster.nodes),
            "pods": len(cluster.pods),
            "pending": len(cluster.pending_pods()),
        }
    else:
        return {"ok": False, "error": f"unknown op {op!r}"}
    return {"ok": True}


class FeedServer:
    """TCP server applying the event protocol to a Cluster store.

    `lock` serializes event application; anything else touching the store
    concurrently (scheduling cycles, controllers) must hold it too — use
    `run_cycle` / `locked()` rather than calling framework.run_cycle
    directly on a live-fed cluster.
    """

    def __init__(self, cluster: Cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        self.lock = threading.Lock()
        #: (kind, id) -> last applied resource version (shared across
        #: connections: redundant agents fence against each other)
        self.rv_table: dict = {}
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def _apply(self, raw: bytes) -> bytes:
                try:
                    event = json.loads(raw)
                    with outer.lock:
                        ack = apply_event(
                            outer.cluster, event, rv_table=outer.rv_table
                        )
                except Exception as exc:  # malformed: report, keep going
                    ack = {"ok": False, "error": str(exc)}
                return json.dumps(ack).encode()

            def handle(self):
                # transport sniff: a gRPC-style frame starts with the
                # 0x00/0x01 compressed-flag byte; newline-JSON starts with
                # "{" — one port speaks both
                first = self.rfile.peek(1)[:1]
                if first in (b"\x00", b"\x01"):
                    self._handle_framed()
                else:
                    self._handle_lines()

            def _handle_lines(self):
                for raw in self.rfile:
                    raw = raw.strip()
                    if not raw:
                        continue
                    self.wfile.write(self._apply(raw) + b"\n")
                    self.wfile.flush()

            def _handle_framed(self):
                """gRPC message framing (1-byte compressed flag + 4-byte
                big-endian length) carrying the same JSON events — the wire
                shape a Go agent's grpc stack produces, minus HTTP/2."""
                import struct as _struct

                while True:
                    header = self.rfile.read(5)
                    if len(header) < 5:
                        return
                    _flag, length = _struct.unpack(">BI", header)
                    if length > MAX_FRAME_BYTES:
                        # a bogus length would commit us to buffering GiBs
                        # (one garbage byte routes a connection here) —
                        # refuse and drop the connection
                        body = json.dumps({
                            "ok": False,
                            "error": f"frame of {length} bytes exceeds "
                                     f"max {MAX_FRAME_BYTES}",
                        }).encode()
                        self.wfile.write(
                            _struct.pack(">BI", 0, len(body)) + body
                        )
                        self.wfile.flush()
                        return
                    payload = self.rfile.read(length)
                    if len(payload) < length:
                        return
                    body = self._apply(payload)
                    self.wfile.write(_struct.pack(">BI", 0, len(body)) + body)
                    self.wfile.flush()

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="feed-server",
        )
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    def locked(self):
        """Context manager guarding store access against the feed threads."""
        return self.lock

    def run_cycle(self, scheduler, now=None, serve=None, resilience=None,
                  tuner=None, *, device=None):
        """One scheduling cycle holding the feed lock, its snapshot and
        solve on `device` (None = the CUDA card)."""
        from scheduler_plugins_tpu_torch.framework.cycle import run_cycle

        with self.lock:
            return run_cycle(scheduler, self.cluster, now, serve=serve,
                             resilience=resilience, tuner=tuner,
                             device=device)


class FeedClient:
    """Minimal agent-side client (what a Go/C++ sidecar would implement)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._file = self._sock.makefile("rwb")

    def send(self, event: dict) -> dict:
        self._file.write((json.dumps(event) + "\n").encode())
        self._file.flush()
        return json.loads(self._file.readline())

    def close(self):
        self._file.close()
        self._sock.close()


class FramedFeedClient:
    """Agent-side client speaking the gRPC-framed transport (same events,
    5-byte message prefix instead of newlines)."""

    def __init__(self, host: str, port: int):
        import struct as _struct

        self._struct = _struct
        self._sock = socket.create_connection((host, port))
        self._file = self._sock.makefile("rwb")

    def send(self, event: dict) -> dict:
        body = json.dumps(event).encode()
        self._file.write(self._struct.pack(">BI", 0, len(body)) + body)
        self._file.flush()
        header = self._file.read(5)
        _flag, length = self._struct.unpack(">BI", header)
        return json.loads(self._file.read(length))

    def close(self):
        self._file.close()
        self._sock.close()
