"""The port's native bridge (`bridge.NativeStore` over its copy of
`snapshot_store.cc`) and the store's native mirror
(`Cluster.attach_native_store`, the snapshot's `native_nodes` fast path)
against the JAX package, with tolerance 0 on every integer.

- The cases of `tests/test_bridge.py` run again on the port, every JAX
  name they call swapped for the port's (the store's snapshots on the
  CPU).
- One seeded sequence of upserts, binds, deletes, batch upserts and
  drains applied to JAX's `NativeStore` and the port's: every export and
  every dirty-row drain equal.
- The mirror on or off gives the same snapshot, tensor by tensor, through
  a churn of binds, reservations, terminations, deletes and node deletes;
  `nonzero_requested` equals JAX's snapshot's.
- `tests/test_intree.py` TestNativeStoreGate's counterpart: pods with
  spread or inter-pod affinity specs turn the fast path off, removing
  them turns it back on, and the cycle decides as JAX's does."""

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.api.resources as port_resources
import scheduler_plugins_tpu_torch.bridge as port_bridge
import scheduler_plugins_tpu_torch.bridge.feed as port_feed
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.state.nrt_cache as port_nrt_cache
from scheduler_plugins_tpu_torch import _build
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.state.snapshot import (
    build_snapshot as p_build_snapshot,
)
from torch_table_runner import run_case, swap, table_params

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.bridge as jax_bridge
    import scheduler_plugins_tpu.bridge.feed as jax_feed
    import scheduler_plugins_tpu.framework as jax_framework
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.state.cluster as jax_cluster
    import scheduler_plugins_tpu.state.nrt_cache as jax_nrt_cache
    import tests.test_bridge as jax_tables
    from scheduler_plugins_tpu.framework import run_cycle as j_run_cycle
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


def _cpu_build_snapshot(*args, device=CPU, **kw):
    return p_build_snapshot(*args, device=device, **kw)


def _cpu_run_cycle(s, c, now=None, stream_chunk=None, **kw):
    return port_cycle.run_cycle(s, c, now, stream_chunk, device=CPU, **kw)


# --- the JAX tables on the port ---------------------------------------------

def _tables():
    if jax_objects is None:
        return []
    return table_params([
        jax_tables.TestNativeStore, jax_tables.TestStreamingDeltaExport,
        jax_tables.TestNativeSnapshotSource, jax_tables.TestNativeCycle,
        jax_tables.TestNativeMirrorEdgeOrdering])


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch, request):
    """Each case of `tests/test_bridge.py` with every JAX name it calls,
    at module level and in its body's imports, swapped for the port's."""
    swap(monkeypatch, jax_tables, {
        "Container": port_objects.Container, "Node": port_objects.Node,
        "Pod": port_objects.Pod, "CANONICAL": port_resources.CANONICAL,
        "CPU": port_resources.CPU, "MEMORY": port_resources.MEMORY,
        "PODS": port_resources.PODS,
        "ResourceIndex": port_resources.ResourceIndex,
        "build_snapshot": _cpu_build_snapshot, "bridge": port_bridge,
    })
    swap(monkeypatch, jax_cluster, {"Cluster": _CPUCluster})
    swap(monkeypatch, jax_feed, {"apply_event": port_feed.apply_event})
    swap(monkeypatch, jax_framework, {
        "Profile": PProfile, "Scheduler": PScheduler,
        "run_cycle": _cpu_run_cycle})
    swap(monkeypatch, jax_plugins, {
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable})
    swap(monkeypatch, jax_objects, {
        "NodeResourceTopology": port_objects.NodeResourceTopology,
        "NUMAZone": port_objects.NUMAZone})
    swap(monkeypatch, jax_nrt_cache, {
        "OverReserveCache": port_nrt_cache.OverReserveCache})
    run_case(cls, method, request)


# --- one op sequence through both stores ------------------------------------

def _op_sequence(seed: int, n_nodes: int = 12, n_ops: int = 400):
    """A seeded sequence of store operations: (name, args) tuples, with a
    drain every so often."""
    rng = np.random.default_rng(seed)
    ops = [("upsert_nodes_batch", (np.arange(n_nodes),
                                   rng.integers(1000, 9000, (n_nodes, 4))))]
    live = []
    next_pod = 0
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.35 or not live:
            req = rng.integers(0, 900, 4)
            req[rng.random(4) < 0.25] = 0
            lim = rng.integers(0, 1200, 4)
            node = int(rng.integers(-1, n_nodes))
            ops.append(("upsert_pod", (next_pod, req, lim,
                                       int(rng.integers(0, 5)),
                                       int(rng.integers(0, 10_000)), node,
                                       bool(rng.random() < 0.1))))
            live.append(next_pod)
            next_pod += 1
        elif roll < 0.5:
            ops.append(("bind", (int(rng.choice(live)),
                                 int(rng.integers(0, n_nodes)))))
        elif roll < 0.6:
            pid = int(rng.choice(live))
            live.remove(pid)
            ops.append(("delete_pod", (pid,)))
        elif roll < 0.68:
            ops.append(("upsert_node", (int(rng.integers(0, n_nodes + 3)),
                                        rng.integers(1000, 9000, 4))))
        elif roll < 0.74:
            k = int(rng.integers(1, 6))
            ids = np.arange(next_pod, next_pod + k)
            live.extend(int(i) for i in ids)
            next_pod += k
            ops.append(("upsert_pods_batch", (
                ids, rng.integers(0, 900, (k, 4)),
                rng.integers(0, 900, (k, 4)), rng.integers(0, 5, k),
                rng.integers(0, 100, k), rng.integers(-1, n_nodes, k),
                (rng.random(k) < 0.2).astype(np.int64))))
        elif roll < 0.8:
            ops.append(("export_dirty", ()))
        else:
            pid = int(rng.choice(live))
            ops.append(("upsert_pod", (pid, rng.integers(0, 900, 4), None,
                                       0, 0, int(rng.integers(-1, n_nodes)),
                                       False)))
    ops.append(("export_dirty", ()))
    return ops


def _apply(store, op, args):
    if op == "upsert_pod":
        pid, req, lim, pri, created, node, term = args
        return store.upsert_pod(pid, req, lim, priority=pri,
                                creation_ms=created, node_id=node,
                                terminating=term)
    if op == "upsert_pods_batch":
        ids, req, lim, pri, created, nodes, flags = args
        return store.upsert_pods_batch(ids, req, lim, priority=pri,
                                       creation_ms=created, node_ids=nodes,
                                       flags=flags)
    return getattr(store, op)(*args)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_sequence_equals_jax(jax_package, seed):
    """The same seeded operations on JAX's store and the port's: every
    dirty drain, and the node and pending exports after each drain,
    equal."""
    port, jax = port_bridge.NativeStore(4), jax_bridge.NativeStore(4)
    try:
        drains = 0
        for op, args in _op_sequence(seed):
            got, want = _apply(port, op, args), _apply(jax, op, args)
            if op == "export_dirty":
                drains += 1
                _same(got, want)
                _same(port.export_nodes(), jax.export_nodes())
                _same(port.export_pending(), jax.export_pending())
                assert (port.num_nodes, port.num_pending, port.generation) \
                    == (jax.num_nodes, jax.num_pending, jax.generation)
        assert drains >= 5
    finally:
        port.close()
        jax.close()


def test_library_built_under_build_native():
    """The library is built under the checkout's `build/native/`, named by
    a hash of the source and the flags, never next to the source."""
    path = _build.build_host("snapshot_store")
    assert path.parent == _build.HOST_BUILD_DIR
    assert path.name.startswith("libsnapshot_store-") and path.exists()
    assert not list(_build.HOST_SOURCES["snapshot_store"].parent.glob("*.so"))


# --- the mirror on and off ----------------------------------------------------

def _churned(pkg_objects, Cluster, native: bool, seed: int = 3):
    """A store through a seeded churn of binds, reservations, terminations,
    deletes, re-adds and a node delete."""
    o = pkg_objects
    rng = np.random.default_rng(seed)
    c = Cluster()
    if native:
        c.attach_native_store()
    for i in range(10):
        c.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 16_000, "memory": 64 * GIB, "pods": 40}))
    for i in range(60):
        reqs = {}
        if rng.random() < 0.8:
            reqs["cpu"] = int(rng.integers(50, 900))
        if rng.random() < 0.7:
            reqs["memory"] = int(rng.integers(1, 8)) * GIB // 4
        lim = {"cpu": int(rng.integers(0, 1500))} if rng.random() < 0.5 \
            else {}
        pod = o.Pod(name=f"p{i}", creation_ms=i, containers=[
            o.Container(requests=reqs, limits=lim)])
        if rng.random() < 0.6:
            pod.node_name = f"n{int(rng.integers(0, 10))}"
        c.add_pod(pod)
    pending = [p.uid for p in c.pending_pods()]
    for uid in pending[:6]:
        c.bind(uid, f"n{int(rng.integers(0, 10))}", now_ms=5)
    for uid in pending[6:10]:
        c.reserve(uid, f"n{int(rng.integers(0, 10))}")
    c.release_reservation(pending[6])
    bound = [u for u, p in c.pods.items() if p.node_name is not None]
    for uid in bound[:5]:
        c.mark_terminating(uid, 7)
    for uid in bound[5:12]:
        c.remove_pod(uid)
    c.remove_node("n3")
    c.add_node(o.Node(name="n10", allocatable={
        "cpu": 8_000, "memory": 32 * GIB, "pods": 20}))
    return c


def test_mirror_on_and_off_snapshot_equal():
    """The churned store's snapshot with the mirror (the fast path engaged)
    equals the Python accumulation's tensor by tensor."""
    mirrored = _churned(port_objects, _CPUCluster, native=True)
    plain = _churned(port_objects, _CPUCluster, native=False)
    assert mirrored._native_exports() is not None
    pending = mirrored.pending_pods()
    a, _ = mirrored.snapshot(pending, now_ms=10)
    b, _ = plain.snapshot(plain.pending_pods(), now_ms=10)
    ta, tb = a.numpy(), b.numpy()
    for part in ("nodes", "pods"):
        for k in ta[part]:
            np.testing.assert_array_equal(ta[part][k], tb[part][k], k)
    assert ta["nodes"]["nonzero_requested"].any()


def test_nonzero_requested_equals_jax(jax_package):
    """The port's `nonzero_requested` column, from the mirror and from the
    Python accumulation, equals JAX's snapshot's."""
    import scheduler_plugins_tpu.state.cluster as jc

    want, _ = _churned(jax_objects, jc.Cluster, native=False).snapshot(
        [], now_ms=10)
    want = np.asarray(want.nodes.nonzero_requested)
    for native in (True, False):
        got, _ = _churned(port_objects, _CPUCluster, native).snapshot(
            [], now_ms=10)
        np.testing.assert_array_equal(got.nodes.nonzero_requested.numpy(),
                                      want)


# --- the fast-path gate ------------------------------------------------------

def _port_engaged(c) -> bool:
    return c._native_exports() is not None


def _jax_engaged(c) -> bool:
    """JAX `Cluster.snapshot`'s fast-path condition (it has no method)."""
    return not (c._native_incompat or c.pod_groups or c.quotas
                or c.app_groups or c.seccomp_profiles
                or c._selector_spec_pods)


def _gate_case(o, Cluster, plugins, Profile, Scheduler, run, engaged):
    ZONE = o.ZONE_LABEL
    c = Cluster()
    for i, z in enumerate(["z-a", "z-b"]):
        c.add_node(o.Node(name=f"n{i}", labels={ZONE: z}, allocatable={
            "cpu": 8000, "memory": 32 * GIB, "pods": 110}))
    c.attach_native_store()
    assert engaged(c)
    e = o.Pod(name="e", labels={"app": "web"},
              containers=[o.Container(requests={"cpu": 100})],
              pod_anti_affinity_required=[o.PodAffinityTerm(
                  topology_key=ZONE,
                  label_selector=o.LabelSelector(
                      match_labels={"app": "web"}))])
    e.node_name = "n0"
    c.add_pod(e)
    c.add_pod(o.Pod(name="p", labels={"app": "web"},
                    containers=[o.Container(requests={"cpu": 100})]))
    gate_off = not engaged(c)
    sched = Scheduler(Profile(plugins=[plugins.NodeResourcesAllocatable(),
                                       plugins.InterPodAffinity()]))
    r = run(sched, c, 1000)
    c.remove_pod("default/e")
    c.remove_pod("default/p")
    return dict(r.bound), gate_off, engaged(c)


class TestNativeStoreGate:
    def test_fast_path_disengages_for_selector_specs(self):
        """Pods with inter-pod affinity specs turn the fast path off (the
        symmetry from the assigned carrier still blocks z-a), removing them
        turns it back on."""
        bound, gate_off, back_on = _gate_case(
            port_objects, _CPUCluster, port_plugins, PProfile, PScheduler,
            lambda s, c, now: _cpu_run_cycle(s, c, now=now), _port_engaged)
        assert bound == {"default/p": "n1"} and gate_off and back_on
        c = _CPUCluster()
        c.attach_native_store()
        c.add_node(port_objects.Node(name="n0", allocatable={"cpu": 1000}))
        assert c._native_exports() is not None

    def test_gate_decides_as_jax(self, jax_package):
        want = _gate_case(jax_objects, jax_cluster.Cluster, jax_plugins,
                          jax_framework.Profile, jax_framework.Scheduler,
                          lambda s, c, now: j_run_cycle(s, c, now=now),
                          _jax_engaged)
        got = _gate_case(port_objects, _CPUCluster, port_plugins, PProfile,
                         PScheduler,
                         lambda s, c, now: _cpu_run_cycle(s, c, now=now),
                         _port_engaged)
        assert got == want

    def test_extended_resource_turns_it_off(self):
        c = _CPUCluster()
        c.add_node(port_objects.Node(name="n0", allocatable={
            "cpu": 8000, "memory": 32 * GIB, "pods": 10}))
        c.attach_native_store()
        c.add_pod(port_objects.Pod(name="gpu", containers=[
            port_objects.Container(requests={"cpu": 100,
                                             "nvidia.com/gpu": 1})]))
        assert c._native_exports() is None
        snap, meta = c.snapshot(c.pending_pods())
        assert "nvidia.com/gpu" in meta.index.names
        c.remove_pod("default/gpu")
        assert c._native_exports() is not None
        # the deleted pod's usage left the mirror with it
        assert not c.snapshot([])[0].nodes.requested.any()
