"""The port's event feed (`bridge.feed`: `apply_event` over protocol v2,
`FeedServer` with its resourceVersion fence, the newline-JSON and
gRPC-framed transports on one port, `drain_deltas`; `bridge.grpc_feed`)
against the JAX package, with tolerance 0 on every ack, store field and
decision.

- The cases of `tests/test_feed.py` run again on the port, gRPC included,
  every JAX name they call swapped for the port's (the store's snapshots
  and the servers' cycles on the CPU).
- One seeded event stream over the whole CR surface, fenced replays and
  malformed events included, through both packages' `FeedServer` over TCP
  (and the gRPC service): equal acks, equal store dumps, equal cycle
  reports.
- `drain_deltas` over both packages' feeds with the native mirror: equal
  windows."""

import json

import numpy as np
import pytest

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.api.resources as port_resources
import scheduler_plugins_tpu_torch.bridge.feed as port_feed
import scheduler_plugins_tpu_torch.bridge.grpc_feed as port_grpc
import scheduler_plugins_tpu_torch.framework as port_framework
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.state.cluster as port_cluster
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_table_runner import mirror, run_case, table_params

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.api.resources as jax_resources
    import scheduler_plugins_tpu.bridge.feed as jax_feed
    import scheduler_plugins_tpu.bridge.grpc_feed as jax_grpc
    import scheduler_plugins_tpu.framework as jax_framework
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.state.cluster as jax_cluster
    import tests.test_feed as jax_tables
except ImportError:
    jax_objects = None

CPU = "cpu"
GIB = 1 << 30


@pytest.fixture
def jax_package():
    if jax_objects is None:
        pytest.skip("the JAX package is not importable here")


class _CPUCluster(PCluster):
    """The port's store, its snapshots on the CPU by default."""

    def snapshot(self, pending, now_ms=0, device=CPU, **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


def _cpu_run_cycle(s, c, now=None, stream_chunk=None, **kw):
    kw.setdefault("device", CPU)
    return port_cycle.run_cycle(s, c, now, stream_chunk, **kw)


class _CPUFeedServer(port_feed.FeedServer):
    def run_cycle(self, scheduler, now=None, serve=None, resilience=None,
                  tuner=None, *, device=CPU):
        return super().run_cycle(scheduler, now, serve, resilience, tuner,
                                 device=device)


class _CPUGrpcFeedServer(port_grpc.GrpcFeedServer):
    def run_cycle(self, scheduler, now=None, *, device=CPU):
        return super().run_cycle(scheduler, now, device=device)


def swap_feed_stack(monkeypatch):
    """Every name of the JAX modules a feed case's body imports from
    (objects, resources, plugins, framework, the feeds, the store) swapped
    for the port's, the store, the feed servers and the cycle on the
    CPU."""
    mirror(monkeypatch, jax_objects, port_objects)
    mirror(monkeypatch, jax_resources, port_resources)
    mirror(monkeypatch, jax_plugins, port_plugins)
    mirror(monkeypatch, jax_framework, port_framework,
           run_cycle=_cpu_run_cycle)
    mirror(monkeypatch, jax_feed, port_feed, FeedServer=_CPUFeedServer)
    mirror(monkeypatch, jax_grpc, port_grpc,
           GrpcFeedServer=_CPUGrpcFeedServer)
    mirror(monkeypatch, jax_cluster, port_cluster, Cluster=_CPUCluster)


def _tables():
    if jax_objects is None:
        return []
    return table_params([
        jax_tables.TestFeed, jax_tables.TestFeedChurnFullSurface,
        jax_tables.TestSpecFragments, jax_tables.TestResourceVersionFencing,
        jax_tables.TestFramedTransport, jax_tables.TestGrpcTransport,
        jax_tables.TestFencingEdgeCases])


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch, request):
    """Each case of `tests/test_feed.py` on the port."""
    swap_feed_stack(monkeypatch)
    mirror(monkeypatch, jax_tables, port_feed, FeedServer=_CPUFeedServer,
           Cluster=_CPUCluster, run_cycle=_cpu_run_cycle,
           Profile=port_framework.Profile,
           Scheduler=port_framework.Scheduler,
           NodeResourcesAllocatable=port_plugins.NodeResourcesAllocatable,
           CPU=port_resources.CPU, MEMORY=port_resources.MEMORY,
           PODS=port_resources.PODS)
    run_case(cls, method, request)


# --- one event stream through both packages ---------------------------------

def event_stream(seed: int = 5) -> list:
    """A seeded stream over protocol v2's surface: nodes (taints, labels),
    namespaces, a quota, a gang, priority classes, a PDB, NRTs, an
    AppGroup and a NetworkTopology, seccomp profiles, metrics, pods with
    spec fragments and rv fences (stale replays, a failed event that must
    not burn its rv), deletes by uid and by name, malformed events and
    sync barriers."""
    rng = np.random.default_rng(seed)
    zone = "topology.kubernetes.io/zone"
    ev = []
    for i in range(6):
        ev.append({"op": "upsert_node", "name": f"n{i}", "rv": 1,
                   "allocatable": {"cpu": 16_000, "memory": 64 * GIB,
                                   "pods": 30},
                   "labels": {zone: f"z{i % 2}"},
                   "taints": ([{"key": "dedicated", "value": "x"}]
                              if i == 5 else [])})
    ev += [
        {"op": "upsert_namespace", "name": "team", "labels": {"t": "1"}},
        {"op": "upsert_quota", "name": "eq", "namespace": "team",
         "min": {"cpu": 20_000, "memory": 80 * GIB},
         "max": {"cpu": 40_000, "memory": 160 * GIB}},
        {"op": "upsert_pod_group", "name": "g", "namespace": "team",
         "min_member": 2, "creation_ms": 3},
        {"op": "upsert_priority_class", "name": "high", "value": 100},
        {"op": "upsert_pdb", "name": "web", "namespace": "team",
         "selector": {"app": "web"}, "disruptions_allowed": 1},
        {"op": "upsert_nrt", "node": "n0", "policy": 3, "scope": 1,
         "zones": [{"numa_id": 0, "available": {"cpu": 8000}},
                   {"numa_id": 1, "available": {"cpu": 8000},
                    "costs": {"0": 20}}]},
        {"op": "upsert_app_group", "name": "mesh", "namespace": "team",
         "workloads": [{"selector": "a", "dependencies": [
             {"workload_selector": "b", "max_network_cost": 10}]},
             {"selector": "b"}], "topology_order": {"a": 0, "b": 1}},
        {"op": "upsert_network_topology", "name": "nt", "weights": {
            "UserDefined": {"zone": [["z0", "z1", 5]]}}},
        {"op": "upsert_seccomp_profile", "name": "web",
         "namespace": "team", "syscalls": ["read", "write"]},
        {"op": "metrics", "nodes": {f"n{i}": {"cpu_avg": 10.0 * i}
                                    for i in range(6)}},
        {"op": "explode"},
        {"op": "upsert_pod", "name": "broken"},
    ]
    for j in range(24):
        pod = {"op": "upsert_pod", "name": f"p{j}", "namespace": "team",
               "rv": 1, "creation_ms": int(rng.integers(0, 50)),
               "priority": int(rng.integers(0, 3)),
               "labels": {"app": "web" if j % 3 else "db"},
               "containers": [{"requests": {
                   "cpu": int(rng.integers(200, 3000)),
                   "memory": int(rng.integers(1, 6)) * GIB}}]}
        if j % 4 == 0:
            pod["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                   "value": "x", "effect": "NoSchedule"}]
        if j % 5 == 0:
            pod["node_affinity"] = {"preferred": [{"weight": 3, "preference": {
                "match_expressions": [{"key": zone, "operator": "In",
                                       "values": ["z1"]}]}}]}
        if j % 6 == 1:
            pod["node"] = f"n{j % 6}"
        if j in (2, 3):
            pod["labels"]["pod-group.scheduling.sigs.k8s.io"] = "g"
        ev.append(pod)
    ev += [
        # a stale replay, a failed rv'd event, then its retry
        {"op": "upsert_pod", "name": "p4", "namespace": "team", "rv": 1,
         "requests": {"cpu": 99}},
        {"op": "delete_pod", "namespace": "team", "name": "ghost", "rv": 7},
        {"op": "upsert_pod", "name": "p4", "namespace": "team", "rv": 2,
         "requests": {"cpu": 150, "memory": GIB}},
        {"op": "delete_pod", "uid": "team/p7"},
        {"op": "delete_pod", "namespace": "team", "name": "p8", "rv": 3},
        {"op": "delete_node", "name": "n4", "rv": 2},
        {"op": "upsert_node", "name": "n4", "rv": 1,
         "allocatable": {"cpu": 1}},
        {"op": "sync"},
    ]
    return ev


def store_dump(cluster) -> dict:
    """A store's content as plain values, comparable across packages."""
    return {
        "nodes": {n: (dict(v.allocatable), dict(v.labels), v.unschedulable,
                      [(t.key, t.value, t.effect) for t in v.taints])
                  for n, v in cluster.nodes.items()},
        "pods": {u: (p.node_name, p.effective_request(), p.priority,
                     str(p.phase), dict(p.labels),
                     len(p.tolerations), len(p.node_affinity_preferred))
                 for u, p in cluster.pods.items()},
        "quotas": {k: (dict(q.min), dict(q.max))
                   for k, q in cluster.quotas.items()},
        "pod_groups": {k: g.min_member
                       for k, g in cluster.pod_groups.items()},
        "nrts": {k: [(z.numa_id, dict(z.available), dict(z.costs))
                     for z in t.zones] for k, t in cluster.nrts.items()},
        "app_groups": sorted(cluster.app_groups),
        "network_topologies": {k: t.weights for k, t in
                               cluster.network_topologies.items()},
        "seccomp": {k: sorted(p.syscalls)
                    for k, p in cluster.seccomp_profiles.items()},
        "priority_classes": {k: p.value
                             for k, p in cluster.priority_classes.items()},
        "pdbs": sorted(cluster.pdbs),
        "namespaces": sorted(cluster.namespaces),
        "metrics": cluster.node_metrics,
        "events": (cluster.event_seq, dict(cluster.event_last)),
    }


def _profile(framework, plugins):
    return framework.Scheduler(framework.Profile(plugins=[
        plugins.NodeResourcesAllocatable(),
        plugins.Coscheduling(permit_waiting_seconds=5),
        plugins.CapacityScheduling(), plugins.TaintToleration(),
        plugins.NodeAffinity()]))


def _feed_run(feed_mod, Cluster, framework, plugins, events, run_kw,
              cycles=(1000, 2000)):
    cluster = Cluster()
    server = feed_mod.FeedServer(cluster).start()
    try:
        client = feed_mod.FeedClient(*server.address)
        acks = [client.send(e) for e in events]
        client.close()
        reports = []
        sched = _profile(framework, plugins)
        for now in cycles:
            r = server.run_cycle(sched, now=now, **run_kw)
            reports.append((dict(r.bound), list(r.failed), dict(r.reserved)))
    finally:
        server.stop()
    return acks, store_dump(cluster), reports


def test_event_stream_equals_jax(jax_package):
    """The stream through both packages' TCP feeds: every ack, the store
    dumps after it, and two cycles' reports equal."""
    events = event_stream()
    want = _feed_run(jax_feed, jax_cluster.Cluster, jax_framework,
                     jax_plugins, events, {})
    got = _feed_run(port_feed, _CPUCluster, port_framework, port_plugins,
                    events, {"device": CPU})
    assert got[0] == want[0]
    assert any(not a["ok"] for a in got[0])
    assert any(a.get("stale") for a in got[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[2][0][0]


def test_grpc_stream_equals_tcp():
    """The same stream over the port's gRPC service (the JSON codec) and
    over its TCP feed: equal acks and stores."""
    pytest.importorskip("grpc")
    events = event_stream()
    tcp = _feed_run(port_feed, _CPUCluster, port_framework, port_plugins,
                    events, {"device": CPU}, cycles=())
    cluster = _CPUCluster()
    server = port_grpc.GrpcFeedServer(cluster).start()
    try:
        client = port_grpc.GrpcFeedClient("127.0.0.1", server.port)
        acks = client.send_batch(events)
        client.close()
    finally:
        server.stop()
    assert acks == tcp[0]
    assert store_dump(cluster) == tcp[1]


def test_drain_deltas_equals_jax(jax_package):
    """`drain_deltas` through both feeds over the native mirror: the first
    drain is the full resync, the next returns the rows a bind touched;
    equal windows."""
    def run(feed_mod, Cluster):
        cluster = Cluster()
        cluster.attach_native_store()
        out = []
        for e in event_stream()[:6]:
            out.append(feed_mod.apply_event(cluster, e))
        out.append(feed_mod.apply_event(cluster, {"op": "drain_deltas"}))
        feed_mod.apply_event(cluster, {
            "op": "upsert_pod", "name": "x", "node": "n2",
            "requests": {"cpu": 700}})
        out.append(feed_mod.apply_event(cluster, {"op": "drain_deltas"}))
        out.append(feed_mod.apply_event(cluster, {"op": "drain_deltas"}))
        return out

    got = run(port_feed, _CPUCluster)
    assert got == run(jax_feed, jax_cluster.Cluster)
    assert got[6]["count"] == 6 and got[7]["count"] == 1
    assert got[8]["count"] == 0
    assert not port_feed.apply_event(_CPUCluster(), {
        "op": "drain_deltas"})["ok"]
    json.dumps(got)  # the window is JSON
