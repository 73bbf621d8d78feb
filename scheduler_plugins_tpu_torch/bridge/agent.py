"""Cluster-side agent: Kubernetes apiserver watch streams -> feed-v2 events
(port of `scheduler_plugins_tpu.bridge.agent`; host code, no tensors).

The reference's entire comm tier is client-go informers List/Watching the
apiserver (pkg/util/client_util.go:14-32);
this module is the drop-in adapter on the cluster side of our bridge: it
consumes the apiserver's own wire format — `{"type": "ADDED"|"MODIFIED"|
"DELETED", "object": {...}}` newline-JSON watch events for core/v1 Nodes,
Pods, Namespaces, PriorityClasses, PodDisruptionBudgets and the CRDs the
reference registers informers for (PodGroup, ElasticQuota,
NodeResourceTopology, AppGroup, NetworkTopology, SeccompProfile) — and
emits the equivalent feed-v2 events (`bridge/feed.py`) to a FeedServer.

No SDK: live mode watches with plain streaming HTTP (`?watch=1`, bearer
token), exactly the protocol client-go speaks; tests replay RECORDED watch
streams through the same translation path and drive `FeedServer.run_cycle`
end to end (tests/test_torch_agent.py).

Quantities convert to this repo's reference units: cpu ->
millicores, memory/storage -> bytes, pods/extended -> counts.
"""

from __future__ import annotations

import json
from decimal import Decimal
from typing import Callable, Iterable, Optional

# -- resource quantities -----------------------------------------------------

_DECIMAL_SUFFIX = {
    "n": Decimal("1e-9"), "u": Decimal("1e-6"), "m": Decimal("1e-3"),
    "k": Decimal("1e3"), "M": Decimal("1e6"), "G": Decimal("1e9"),
    "T": Decimal("1e12"), "P": Decimal("1e15"), "E": Decimal("1e18"),
    "Ki": Decimal(1 << 10), "Mi": Decimal(1 << 20), "Gi": Decimal(1 << 30),
    "Ti": Decimal(1 << 40), "Pi": Decimal(1 << 50), "Ei": Decimal(1 << 60),
}


def parse_quantity(text) -> Decimal:
    """resource.Quantity string -> Decimal in base units."""
    text = str(text).strip()
    for suffix in sorted(_DECIMAL_SUFFIX, key=len, reverse=True):
        if text.endswith(suffix):
            return Decimal(text[: -len(suffix)]) * _DECIMAL_SUFFIX[suffix]
    return Decimal(text)


def quantity_to_units(resource: str, text) -> int:
    """Quantity -> int64 reference units: cpu in MILLIcores, everything
    else in base units (bytes / counts), ceiling like Go's ScaledValue."""
    value = parse_quantity(text)
    if resource == "cpu":
        value *= 1000
    return int(value.to_integral_value(rounding="ROUND_CEILING"))


def _resource_map(spec: Optional[dict]) -> dict:
    return {
        res: quantity_to_units(res, qty) for res, qty in (spec or {}).items()
    }


def _rfc3339_ms(text) -> int:
    """metadata timestamps -> epoch milliseconds (0 when absent)."""
    if not text:
        return 0
    from datetime import datetime

    try:
        stamp = datetime.fromisoformat(str(text).replace("Z", "+00:00"))
    except ValueError:
        return 0
    return int(stamp.timestamp() * 1000)


def _rv(obj: dict) -> Optional[int]:
    raw = (obj.get("metadata") or {}).get("resourceVersion")
    try:
        return int(raw)
    except (TypeError, ValueError):
        return None


def _meta(obj: dict) -> dict:
    return obj.get("metadata") or {}


def _with_rv(event: dict, obj: dict) -> dict:
    rv = _rv(obj)
    if rv is not None:
        event["rv"] = rv
    return event


# -- core/v1 translators -----------------------------------------------------

def node_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    status = obj.get("status") or {}
    return _with_rv({
        "op": "upsert_node",
        "name": meta.get("name", ""),
        "allocatable": _resource_map(
            status.get("allocatable") or status.get("capacity")
        ),
        "labels": meta.get("labels") or {},
        "unschedulable": bool(spec.get("unschedulable", False)),
        "taints": [
            {"key": t.get("key", ""), "value": t.get("value", ""),
             "effect": t.get("effect", "NoSchedule")}
            for t in spec.get("taints") or []
        ],
    }, obj)


def _selector_fragment(sel: Optional[dict]) -> Optional[dict]:
    if sel is None:
        return None
    return {
        "match_labels": sel.get("matchLabels") or {},
        "match_expressions": [
            {"key": e.get("key", ""), "operator": e.get("operator", "In"),
             "values": e.get("values") or []}
            for e in sel.get("matchExpressions") or []
        ],
    }


def _node_term_fragment(term: dict) -> dict:
    out = {}
    for src, dst in (("matchExpressions", "match_expressions"),
                     ("matchFields", "match_fields")):
        if term.get(src):
            out[dst] = [
                {"key": e.get("key", ""), "operator": e.get("operator", "In"),
                 "values": e.get("values") or []}
                for e in term[src]
            ]
    return out


def _pod_term_fragment(term: dict) -> dict:
    return {
        "topology_key": term.get("topologyKey", ""),
        "label_selector": _selector_fragment(term.get("labelSelector")),
        "namespaces": term.get("namespaces") or [],
        "namespace_selector": _selector_fragment(
            term.get("namespaceSelector")
        ),
    }


def _container_fragment(spec: dict, init: bool = False) -> dict:
    resources = spec.get("resources") or {}
    out = {
        "requests": _resource_map(resources.get("requests")),
        "limits": _resource_map(resources.get("limits")),
    }
    if init and spec.get("restartPolicy") == "Always":
        out["restart_policy_always"] = True
    # SPO localhost profile "operator/<ns>/<name>.json" -> "<ns>/<name>"
    # (sysched.go:124-210 profile resolution)
    profile = (
        (spec.get("securityContext") or {}).get("seccompProfile") or {}
    ).get("localhostProfile")
    if profile:
        parts = str(profile).removesuffix(".json").split("/")
        if len(parts) >= 2:
            out["seccomp_profile"] = "/".join(parts[-2:])
    return out


def pod_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    status = obj.get("status") or {}
    event = {
        "op": "upsert_pod",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "uid": meta.get("uid", ""),
        "labels": meta.get("labels") or {},
        "annotations": meta.get("annotations") or {},
        "creation_ms": _rfc3339_ms(meta.get("creationTimestamp")),
        "priority": int(spec.get("priority") or 0),
        "priority_class_name": spec.get("priorityClassName", ""),
        "preemption_policy": spec.get("preemptionPolicy"),
        "scheduler_name": spec.get("schedulerName", "tpu-scheduler"),
        "phase": status.get("phase", "Pending"),
        "node": spec.get("nodeName"),
        "nominated_node": status.get("nominatedNodeName"),
        "scheduling_gated": bool(spec.get("schedulingGates")),
        "overhead": _resource_map(spec.get("overhead")),
        "containers": [
            _container_fragment(c) for c in spec.get("containers") or []
        ],
        "init_containers": [
            _container_fragment(c, init=True)
            for c in spec.get("initContainers") or []
        ],
    }
    if meta.get("deletionTimestamp"):
        event["deletion_ms"] = _rfc3339_ms(meta["deletionTimestamp"])
    if spec.get("nodeSelector"):
        event["node_selector"] = dict(spec["nodeSelector"])
    affinity = spec.get("affinity") or {}
    node_aff = affinity.get("nodeAffinity") or {}
    required = (
        node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    ).get("nodeSelectorTerms")
    preferred = node_aff.get(
        "preferredDuringSchedulingIgnoredDuringExecution"
    )
    if required or preferred:
        event["node_affinity"] = {}
        if required:
            event["node_affinity"]["required"] = [
                _node_term_fragment(t) for t in required
            ]
        if preferred:
            event["node_affinity"]["preferred"] = [
                {"weight": int(t.get("weight", 1)),
                 "preference": _node_term_fragment(t.get("preference") or {})}
                for t in preferred
            ]
    for src, dst in (("podAffinity", "pod_affinity"),
                     ("podAntiAffinity", "pod_anti_affinity")):
        aff = affinity.get(src) or {}
        required = aff.get("requiredDuringSchedulingIgnoredDuringExecution")
        preferred = aff.get("preferredDuringSchedulingIgnoredDuringExecution")
        if required or preferred:
            event[dst] = {}
            if required:
                event[dst]["required"] = [
                    _pod_term_fragment(t) for t in required
                ]
            if preferred:
                event[dst]["preferred"] = [
                    {"weight": int(t.get("weight", 1)),
                     "term": _pod_term_fragment(t.get("podAffinityTerm")
                                                or {})}
                    for t in preferred
                ]
    if spec.get("tolerations"):
        event["tolerations"] = [
            {"key": t.get("key", ""), "operator": t.get("operator", "Equal"),
             "value": t.get("value", ""), "effect": t.get("effect", "")}
            for t in spec["tolerations"]
        ]
    if spec.get("topologySpreadConstraints"):
        event["topology_spread"] = [
            {
                "max_skew": int(c.get("maxSkew", 1)),
                "topology_key": c.get("topologyKey", ""),
                "when_unsatisfiable": c.get(
                    "whenUnsatisfiable", "DoNotSchedule"
                ),
                "label_selector": _selector_fragment(c.get("labelSelector")),
                "min_domains": c.get("minDomains"),
                "match_label_keys": c.get("matchLabelKeys") or [],
                "node_affinity_policy": c.get("nodeAffinityPolicy", "Honor"),
                "node_taints_policy": c.get("nodeTaintsPolicy", "Ignore"),
            }
            for c in spec["topologySpreadConstraints"]
        ]
    return _with_rv(event, obj)


def namespace_event(obj: dict) -> dict:
    meta = _meta(obj)
    return _with_rv({
        "op": "upsert_namespace",
        "name": meta.get("name", ""),
        "labels": meta.get("labels") or {},
    }, obj)


def priority_class_event(obj: dict) -> dict:
    meta = _meta(obj)
    return _with_rv({
        "op": "upsert_priority_class",
        "name": meta.get("name", ""),
        "value": int(obj.get("value", 0)),
        "annotations": meta.get("annotations") or {},
    }, obj)


def pdb_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    status = obj.get("status") or {}
    return _with_rv({
        "op": "upsert_pdb",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "selector": _selector_fragment(spec.get("selector")),
        "disruptions_allowed": int(status.get("disruptionsAllowed", 0)),
        "disrupted_pods": sorted(status.get("disruptedPods") or {}),
    }, obj)


# -- CRD translators ---------------------------------------------------------

def pod_group_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    return _with_rv({
        "op": "upsert_pod_group",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "min_member": int(spec.get("minMember", 1)),
        "min_resources": _resource_map(spec.get("minResources")),
        "creation_ms": _rfc3339_ms(meta.get("creationTimestamp")),
    }, obj)


def elastic_quota_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    return _with_rv({
        "op": "upsert_quota",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "min": _resource_map(spec.get("min")),
        "max": _resource_map(spec.get("max")),
    }, obj)


#: NRT attribute/deprecated-policy decoding
#: (pkg/noderesourcetopology/nodeconfig/topologymanager.go
#: :64-162): attributes "topologyManagerPolicy"/"topologyManagerScope"
#: preferred; TopologyPolicies fallback.
_POLICY_CODES = {
    "none": 0, "best-effort": 1, "restricted": 2, "single-numa-node": 3,
}
_SCOPE_CODES = {"container": 0, "pod": 1}
_DEPRECATED_POLICIES = {
    "None": (0, 0),
    "BestEffort": (1, 0),
    "Restricted": (2, 0),
    "SingleNUMANodeContainerLevel": (3, 0),
    "SingleNUMANodePodLevel": (3, 1),
}
#: podfingerprint attribute stamped by the node agent
#: (cache/overreserve.go fingerprint check; podfingerprint.Attribute)
_FINGERPRINT_ATTR = "nodeTopologyPodsFingerprint"


def nrt_event(obj: dict) -> dict:
    meta = _meta(obj)
    attrs = {
        a.get("name"): a.get("value") for a in obj.get("attributes") or []
    }
    policy = _POLICY_CODES.get(str(attrs.get("topologyManagerPolicy")), None)
    scope = _SCOPE_CODES.get(str(attrs.get("topologyManagerScope")), None)
    if policy is None or scope is None:
        for deprecated in obj.get("topologyPolicies") or []:
            if deprecated in _DEPRECATED_POLICIES:
                dep_policy, dep_scope = _DEPRECATED_POLICIES[deprecated]
                policy = dep_policy if policy is None else policy
                scope = dep_scope if scope is None else scope
                break
    zones = []
    for zone in obj.get("zones") or []:
        if zone.get("type") not in (None, "Node"):
            continue  # only NUMA-node zones build the model (:105-134)
        name = str(zone.get("name", ""))
        digits = "".join(ch for ch in name if ch.isdigit())
        numa_id = int(digits) if digits else len(zones)
        available, allocatable = {}, {}
        for res in zone.get("resources") or []:
            rname = res.get("name", "")
            if "available" in res:
                available[rname] = quantity_to_units(rname, res["available"])
            if "allocatable" in res:
                allocatable[rname] = quantity_to_units(
                    rname, res["allocatable"]
                )
        costs = {}
        for cost in zone.get("costs") or []:
            dest = "".join(ch for ch in str(cost.get("name", "")) if ch.isdigit())
            if dest:
                costs[dest] = int(cost.get("value", 10))
        zones.append({
            "numa_id": numa_id,
            "available": available,
            "allocatable": allocatable,
            "costs": costs,
        })
    event = {
        "op": "upsert_nrt",
        "node": meta.get("name", ""),
        "zones": zones,
    }
    if policy is not None:
        event["policy"] = policy
    if scope is not None:
        event["scope"] = scope
    max_numa = attrs.get("topologyManagerPolicyMaxNUMANodes") or attrs.get(
        "maxNUMANodes"
    )
    if max_numa is not None:
        event["max_numa_nodes"] = int(max_numa)
    fingerprint = attrs.get(_FINGERPRINT_ATTR) or (
        meta.get("annotations") or {}
    ).get("topology.node.k8s.io/fingerprint")
    if fingerprint:
        event["pod_fingerprint"] = str(fingerprint)
    return _with_rv(event, obj)


def app_group_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    status = obj.get("status") or {}

    def selector_of(workload_ref: Optional[dict]) -> str:
        return str((workload_ref or {}).get("selector", ""))

    workloads = []
    for entry in spec.get("workloads") or []:
        workloads.append({
            "selector": selector_of(entry.get("workload")),
            "dependencies": [
                {
                    "workload_selector": selector_of(dep.get("workload")),
                    "max_network_cost": int(dep.get("maxNetworkCost", 0)),
                }
                for dep in entry.get("dependencies") or []
            ],
        })
    topology_order = {
        selector_of(item.get("workload")): int(item.get("index", 0))
        for item in status.get("topologyOrder") or []
    }
    return _with_rv({
        "op": "upsert_app_group",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "workloads": workloads,
        "topology_order": topology_order,
    }, obj)


def network_topology_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    weights: dict = {}
    for weight in spec.get("weights") or []:
        per_key = weights.setdefault(str(weight.get("name", "")), {})
        for topology in weight.get("topologyList") or []:
            key = str(topology.get("topologyKey", ""))
            triples = per_key.setdefault(key, [])
            for origin in topology.get("originList") or []:
                orig = str(origin.get("origin", ""))
                for cost in origin.get("costList") or []:
                    triples.append([
                        orig,
                        str(cost.get("destination", "")),
                        int(cost.get("networkCost", 0)),
                    ])
    return _with_rv({
        "op": "upsert_network_topology",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "weights": weights,
    }, obj)


def seccomp_profile_event(obj: dict) -> dict:
    meta, spec = _meta(obj), obj.get("spec") or {}
    syscalls = []
    for group in spec.get("syscalls") or []:
        if group.get("action") in ("SCMP_ACT_ALLOW", None):
            syscalls.extend(group.get("names") or [])
    return _with_rv({
        "op": "upsert_seccomp_profile",
        "name": meta.get("name", ""),
        "namespace": meta.get("namespace", "default"),
        "syscalls": sorted(set(syscalls)),
    }, obj)


# -- watch-event dispatch ----------------------------------------------------

#: kind -> (upsert translator, delete-op name, delete key builder)
_KINDS = {
    "Node": (node_event, "delete_node",
             lambda m: {"name": m.get("name", "")}),
    "Pod": (pod_event, "delete_pod",
            lambda m: {"namespace": m.get("namespace", "default"),
                       "name": m.get("name", ""),
                       "uid": m.get("uid", "")}),
    "Namespace": (namespace_event, "delete_namespace",
                  lambda m: {"name": m.get("name", "")}),
    "PriorityClass": (priority_class_event, "delete_priority_class",
                      lambda m: {"name": m.get("name", "")}),
    "PodDisruptionBudget": (pdb_event, "delete_pdb",
                            lambda m: {"namespace": m.get("namespace",
                                                          "default"),
                                       "name": m.get("name", "")}),
    "PodGroup": (pod_group_event, "delete_pod_group",
                 lambda m: {"namespace": m.get("namespace", "default"),
                            "name": m.get("name", "")}),
    "ElasticQuota": (elastic_quota_event, "delete_quota",
                     lambda m: {"namespace": m.get("namespace", "default"),
                                "name": m.get("name", "")}),
    "NodeResourceTopology": (nrt_event, "delete_nrt",
                             lambda m: {"node": m.get("name", "")}),
    "AppGroup": (app_group_event, "delete_app_group",
                 lambda m: {"namespace": m.get("namespace", "default"),
                            "name": m.get("name", "")}),
    "NetworkTopology": (network_topology_event, "delete_network_topology",
                        lambda m: {"namespace": m.get("namespace",
                                                      "default"),
                                   "name": m.get("name", "")}),
    "SeccompProfile": (seccomp_profile_event, "delete_seccomp_profile",
                       lambda m: {"namespace": m.get("namespace", "default"),
                                  "name": m.get("name", "")}),
}

#: the List/Watch surface the agent covers — core/v1 + every CRD the
#: reference registers informers for
DEFAULT_WATCH_PATHS = (
    "/api/v1/nodes",
    "/api/v1/pods",
    "/api/v1/namespaces",
    "/apis/scheduling.k8s.io/v1/priorityclasses",
    "/apis/policy/v1/poddisruptionbudgets",
    "/apis/scheduling.x-k8s.io/v1alpha1/podgroups",
    "/apis/scheduling.x-k8s.io/v1alpha1/elasticquotas",
    "/apis/topology.node.k8s.io/v1alpha2/noderesourcetopologies",
    "/apis/appgroup.diktyo.x-k8s.io/v1alpha1/appgroups",
    "/apis/networktopology.diktyo.x-k8s.io/v1alpha1/networktopologies",
    "/apis/security-profiles-operator.x-k8s.io/v1beta1/seccompprofiles",
)


def translate(watch_event: dict) -> Optional[dict]:
    """One apiserver watch event -> one feed-v2 event (None for BOOKMARK/
    ERROR/unknown kinds)."""
    etype = watch_event.get("type")
    obj = watch_event.get("object") or {}
    kind = obj.get("kind", "")
    if kind not in _KINDS or etype not in ("ADDED", "MODIFIED", "DELETED"):
        return None
    upsert, delete_op, delete_keys = _KINDS[kind]
    if etype == "DELETED":
        event = {"op": delete_op, **delete_keys(_meta(obj))}
        return _with_rv(event, obj)
    return upsert(obj)


class ClusterAgent:
    """Feeds translated watch events to a send callable (e.g.
    `FeedClient.send`). `replay` drives recorded streams; `watch` follows a
    live apiserver with plain streaming HTTP."""

    def __init__(self, send: Callable[[dict], dict]):
        self.send = send
        self.translated = 0
        self.skipped = 0

    def replay(self, watch_events: Iterable[dict]) -> int:
        """Translate + send recorded watch events; returns events sent."""
        sent = 0
        for watch_event in watch_events:
            event = translate(watch_event)
            if event is None:
                self.skipped += 1
                continue
            self.send(event)
            sent += 1
            self.translated += 1
        return sent

    def replay_lines(self, lines: Iterable[str]) -> int:
        """Replay newline-JSON watch records (the wire format)."""
        return self.replay(
            json.loads(line) for line in lines if line.strip()
        )

    def sync(self) -> dict:
        """Feed barrier: returns the server's cluster counts."""
        return self.send({"op": "sync"})

    # -- live mode -----------------------------------------------------
    def list_then_watch(self, apiserver: str, path: str, token: str = "",
                        insecure_skip_verify: bool = False,
                        ca_file: Optional[str] = None,
                        max_events: Optional[int] = None,
                        max_failures: Optional[int] = 8,
                        backoff_base_s: float = 0.25,
                        backoff_cap_s: float = 30.0,
                        timeout_s: float = 300.0,
                        _sleep=None) -> int:
        """client-go Reflector semantics over plain streaming HTTP
        (ListAndWatch, the machinery behind
        pkg/util/client_util.go:14-32):

        - LIST (items emitted as ADDED events; the server's rv-fence
          dedupes re-lists), then WATCH with ``allowWatchBookmarks=true``
          from the list's resourceVersion.
        - The resume point advances on EVERY event's object
          resourceVersion, including BOOKMARKs (whose whole purpose is
          advancing rv without payload traffic) — but only AFTER the event
          was delivered downstream, so a send-side failure redelivers the
          event on reconnect instead of silently dropping it.
        - ``410 Gone`` — as an HTTP status or an ERROR watch event with
          ``code: 410`` — means the rv is too old: relist. Relists count
          toward the failure budget/backoff so a persistent 410 storm
          (watch-cache compaction loops) cannot hammer the apiserver with
          back-to-back full LISTs.
        - An idle-stream read timeout (``timeout_s`` with no traffic) on
          an ESTABLISHED watch stream is NOT a failure: a
          healthy-but-quiet watch re-connects from the same rv without
          consuming the budget. A timeout during LIST or while opening
          the watch connection IS a failure (with backoff): an apiserver
          that consistently times out must not hold ``max_failures``
          callers in an unbounded relist loop.
        - Any other stream failure or clean close reconnects the WATCH
          from the last delivered rv with exponential backoff
          (``backoff_base_s * 2^k`` capped at ``backoff_cap_s``); the
          failure counter resets whenever an event arrives.

        Stops after ``max_events`` sends or ``max_failures`` consecutive
        failures (None = retry forever). Returns events sent."""
        import time as _time
        import urllib.error
        import urllib.request

        from scheduler_plugins_tpu_torch.utils.httptls import ssl_context

        sleep = _sleep if _sleep is not None else _time.sleep

        def request(url):
            req = urllib.request.Request(url)
            if token:
                req.add_header("Authorization", f"Bearer {token}")
            ctx = ssl_context(url, ca_file, insecure_skip_verify)
            return urllib.request.urlopen(req, timeout=timeout_s, context=ctx)

        base = apiserver.rstrip("/") + path
        sent = 0
        rv: Optional[str] = None  # None -> (re)list before watching
        failures = 0

        stream_open = False  # True once the current watch stream is up

        while True:
            try:
                stream_open = False
                if rv is None:
                    with request(base) as resp:
                        listing = json.loads(resp.read())
                    sent += self.replay(
                        {"type": "ADDED",
                         "object": {**item,
                                    "kind": _list_item_kind(listing)}}
                        for item in listing.get("items", [])
                    )
                    rv = str(
                        (listing.get("metadata") or {})
                        .get("resourceVersion", "")
                    )
                    failures = 0
                    if max_events is not None and sent >= max_events:
                        return sent
                watch_url = f"{base}?watch=1&allowWatchBookmarks=true"
                if rv:
                    watch_url += f"&resourceVersion={rv}"
                with request(watch_url) as stream:
                    stream_open = True
                    for raw in stream:
                        line = raw.decode("utf-8", "replace").strip()
                        if not line:
                            continue
                        watch_event = json.loads(line)
                        etype = watch_event.get("type")
                        obj = watch_event.get("object") or {}
                        if etype == "ERROR":
                            if (obj.get("code") == 410
                                    or obj.get("reason") == "Expired"):
                                rv = None  # too old: relist
                            break
                        # deliver FIRST (replay skips BOOKMARK/unknown
                        # kinds itself), advance the resume point after:
                        # a send that raises must redeliver this event
                        sent += self.replay([watch_event])
                        new_rv = (obj.get("metadata") or {}).get(
                            "resourceVersion"
                        )
                        if new_rv:
                            rv = str(new_rv)
                        failures = 0
                        if max_events is not None and sent >= max_events:
                            return sent
            except TimeoutError:
                if stream_open:
                    # idle healthy stream: re-watch from rv, no budget burn
                    continue
                # LIST/connect timeout: an ordinary failure
                failures += 1
            except urllib.error.HTTPError as exc:
                if exc.code == 410:
                    rv = None  # relist (counted below like any failure)
                failures += 1
            except (urllib.error.URLError, OSError, ValueError):
                # connection refused/reset, mid-line JSON truncation, ...
                failures += 1
            else:
                # clean close or ERROR break: reconnect (relist when the
                # ERROR was a 410); both count toward the backoff budget
                failures += 1
            if max_failures is not None and failures >= max_failures:
                return sent
            sleep(min(backoff_base_s * (2 ** (failures - 1)),
                      backoff_cap_s))


def _list_item_kind(listing: dict) -> str:
    """PodList -> Pod etc. (list items omit kind on the wire)."""
    kind = str(listing.get("kind", ""))
    return kind[:-4] if kind.endswith("List") else kind
