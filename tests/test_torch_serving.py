"""The port's serving engine (`scheduler_plugins_tpu_torch.serving`: the
delta sink, the packed batches, the scatter-add apply, `ServeEngine`
through `run_cycle(serve=)`) against the JAX package's, on the same
seeded event streams.

Each scenario is one function of a package namespace run on both
packages (the port on the CPU). It records what a caller sees: every
cycle's report (bound, failed, reserved, rejected gangs), the engine's
generation, rebases, gang fallbacks and anti-entropy divergences, and
the resident node columns the two packages share (the port has no
`nonzero_requested` column). The two records must be equal, integers
with tolerance 0. Inside the scenario, after every cycle, the engine's
resident columns must equal a fresh `Cluster.snapshot` of the same store
byte for byte, and the served run must place exactly as a
full-resnapshot run: the JAX package's own `tests/test_serving.py`
assertions, held on both packages.

The cases mirror `tests/test_serving.py`'s `TestDeltaEquivalence` (seeds
0-3), `TestServeEdgePaths`, `TestSinkLifecycle`, `TestEventKindTable` and
`TestResidentGangQuota`; the flight-recorder case (TestServeFlightRecorder)
runs in `tests/test_torch_flightrec.py`. Unit cases hold the packed batches, the apply, the side tables,
the fault transform and the snapshot's lowering helpers against JAX."""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.events as port_events
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.resilience.faults as port_faults
import scheduler_plugins_tpu_torch.serving.deltas as port_deltas
import scheduler_plugins_tpu_torch.state.snapshot as port_snapshot
import scheduler_plugins_tpu_torch.utils.observability as port_obs
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.framework.plugin import (
    BUILTIN_EVENTS as PORT_BUILTIN_EVENTS,
)
from scheduler_plugins_tpu_torch.serving import ServeEngine as PServeEngine
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster

try:
    import scheduler_plugins_tpu.api.events as jax_events
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.resilience.faults as jax_faults
    import scheduler_plugins_tpu.serving.deltas as jax_deltas
    import scheduler_plugins_tpu.state.snapshot as jax_snapshot
    import scheduler_plugins_tpu.utils.observability as jax_obs
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.serving import ServeEngine as JServeEngine
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
except ImportError:
    jax_objects = None

GIB = 1 << 30
EXT = "example.com/gpu"
CPU = "cpu"

#: the resident NodeState columns, compared bit-exact
NODE_COLUMNS = (
    "alloc", "capacity", "requested", "nonzero_requested", "limits", "mask",
    "region", "zone", "pod_count", "terminating", "nominated",
)


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


PORT = SimpleNamespace(
    name="port", o=port_objects, Cluster=PCluster, Profile=PProfile,
    Scheduler=PScheduler, plugins=port_plugins, Engine=PServeEngine,
    obs=port_obs, deltas=port_deltas, faults=port_faults,
    run=lambda s, c, now, e=None: port_cycle.run_cycle(
        s, c, now=now, serve=e, device=CPU),
    refresh=lambda e, c, pending, now: e.refresh(c, pending, now_ms=now,
                                                 device=CPU),
    snapshot=lambda c, pending, now, npad: c.snapshot(
        pending, now_ms=now, pad_nodes=npad, device=CPU),
)
JAX = None if jax_objects is None else SimpleNamespace(
    name="jax", o=jax_objects, Cluster=JCluster, Profile=JProfile,
    Scheduler=JScheduler, plugins=jax_plugins, Engine=JServeEngine,
    obs=jax_obs, deltas=jax_deltas, faults=jax_faults,
    run=lambda s, c, now, e=None: jax_cycle.run_cycle(s, c, now=now,
                                                      serve=e),
    refresh=lambda e, c, pending, now: e.refresh(c, pending, now_ms=now),
    snapshot=lambda c, pending, now, npad: c.snapshot(
        pending, now_ms=now, pad_nodes=npad),
)


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def both(script, *args):
    """Run `script(pkg, *args)` on both packages; their records must be
    equal."""
    port = script(PORT, *args)
    jax = script(JAX, *args)
    assert port == jax
    return port


# --- the same objects in either package --------------------------------------

def make_node(pkg, i, cpu=8000, unschedulable=False, extra=None):
    alloc = {"cpu": cpu, "memory": 32 * GIB, "pods": 32}
    if extra:
        alloc.update(extra)
    return pkg.o.Node(
        name=f"n{i:03d}", allocatable=alloc,
        labels={pkg.o.REGION_LABEL: "r1", pkg.o.ZONE_LABEL: f"z{i % 2}"},
        unschedulable=unschedulable,
    )


def make_cluster(pkg, n_nodes=6):
    cluster = pkg.Cluster()
    for i in range(n_nodes):
        cluster.add_node(make_node(pkg, i))
    return cluster


def make_pod(pkg, serial, now, cpu=500, mem=GIB):
    return pkg.o.Pod(
        name=f"p{serial:05d}", creation_ms=now + serial,
        containers=[pkg.o.Container(requests={"cpu": cpu, "memory": mem})],
    )


def make_scheduler(pkg):
    return pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourcesAllocatable()]))


def report_of(report) -> tuple:
    return (dict(report.bound), list(report.failed), dict(report.reserved),
            list(report.rejected_gangs))


def engine_state(engine) -> tuple:
    return (engine.generation, engine.rebases, engine.gang_fallbacks,
            engine.antientropy_divergences, engine.npad)


def resident_matches(pkg, engine, cluster, now) -> dict:
    """Drain the sink (a cycle's own binds apply at the next refresh),
    hold the resident columns to a fresh snapshot of the same store, and
    return them."""
    refreshed = pkg.refresh(engine, cluster, [], now)
    assert refreshed is not None, "engine fell back while compatible"
    snap, _ = pkg.snapshot(cluster, [], now, engine.npad)
    out = {}
    for col in NODE_COLUMNS:
        mine = _host(getattr(engine.resident_nodes, col))
        fresh = _host(getattr(snap.nodes, col))
        np.testing.assert_array_equal(
            mine, fresh, err_msg=f"{pkg.name}: resident {col} diverged")
        assert mine.dtype == fresh.dtype, col
        out[col] = mine.tolist()
    return out


def attach(pkg, cluster):
    return pkg.Engine().attach(cluster)


# --- scenarios ---------------------------------------------------------------

def randomized_sequence(pkg, seed):
    """`TestDeltaEquivalence.test_randomized_event_sequences`: ten cycles
    of arrivals, bound arrivals, departures, terminations, node adds and
    node updates, served against a full-resnapshot twin."""
    rng = np.random.default_rng(seed)
    serve_cluster = make_cluster(pkg, 6)
    engine = attach(pkg, serve_cluster)
    base_cluster = make_cluster(pkg, 6)
    serve_sched, base_sched = make_scheduler(pkg), make_scheduler(pkg)
    record = []
    serial = 0
    extra_nodes = 0
    for cycle in range(10):
        now = 1000 * (cycle + 1)
        events = []
        for _ in range(int(rng.integers(0, 5))):
            serial += 1
            events.append(("arrive", serial, int(rng.integers(100, 3000)),
                           int(rng.integers(1, 4)) * GIB))
        if rng.random() < 0.3:
            serial += 1
            events.append(("arrive_bound", serial,
                           int(rng.integers(100, 1000)), GIB,
                           f"n{int(rng.integers(0, 6)):03d}"))
        bound = sorted(uid for uid, p in serve_cluster.pods.items()
                       if p.node_name is not None)
        for _ in range(int(rng.integers(0, 3))):
            if not bound:
                break
            uid = bound.pop(int(rng.integers(0, len(bound))))
            events.append(("terminate", uid) if rng.random() < 0.3
                          else ("depart", uid))
        if rng.random() < 0.25:
            extra_nodes += 1
            events.append(("node_add", 100 + extra_nodes))
        if rng.random() < 0.2:
            events.append(("node_update", int(rng.integers(0, 6)),
                           bool(rng.random() < 0.5)))
        for cl in (serve_cluster, base_cluster):
            for e in events:
                if e[0] == "arrive":
                    cl.add_pod(make_pod(pkg, e[1], now, e[2], e[3]))
                elif e[0] == "arrive_bound":
                    pod = make_pod(pkg, e[1], now, e[2], e[3])
                    pod.node_name = e[4]
                    cl.add_pod(pod)
                elif e[0] == "depart":
                    cl.remove_pod(e[1])
                elif e[0] == "terminate":
                    cl.mark_terminating(e[1], now)
                elif e[0] == "node_add":
                    cl.add_node(make_node(pkg, e[1]))
                elif e[0] == "node_update":
                    cl.add_node(make_node(pkg, e[1], unschedulable=e[2]))
        serve_report = pkg.run(serve_sched, serve_cluster, now, engine)
        base_report = pkg.run(base_sched, base_cluster, now)
        assert report_of(serve_report) == report_of(base_report)
        record.append((report_of(serve_report),
                       resident_matches(pkg, engine, serve_cluster, now),
                       engine_state(engine)))
    return record


def steady_state(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 99, 500))
    pkg.run(sched, cluster, 1000, engine)
    rebases0 = engine.rebases
    gen0 = engine.generation
    scope = pkg.obs.metrics.scoped()
    for cycle in range(5):
        now = 2000 + 1000 * cycle
        cluster.add_pod(make_pod(pkg, cycle + 1, now))
        pkg.run(sched, cluster, now, engine)
    assert engine.rebases == rebases0
    assert scope.get(pkg.obs.SERVE_REBASES) == 0
    assert engine.generation > gen0  # deltas applied
    return (resident_matches(pkg, engine, cluster, now), engine_state(engine))


class TestDeltaEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_randomized_event_sequences(self, jax_package, seed):
        record = both(randomized_sequence, seed)
        assert any(r[0][0] for r in record)  # the streams place pods

    def test_steady_state_is_delta_applied_not_rebased(self, jax_package):
        both(steady_state)


# --- edge paths --------------------------------------------------------------

def grow_across_bucket(pkg):
    cluster = make_cluster(pkg, 7)  # bucket 8
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    assert engine.npad == 8
    rebases0 = engine.rebases
    for i in range(7, 12):  # 12 nodes -> bucket 16
        cluster.add_node(make_node(pkg, i))
    cluster.add_pod(make_pod(pkg, 2, 1500))
    report = pkg.run(sched, cluster, 2000, engine)
    assert engine.npad == 16 and engine.rebases == rebases0
    return (report_of(report), resident_matches(pkg, engine, cluster, 2500),
            engine_state(engine))


def node_delete_rebases(pkg):
    cluster = make_cluster(pkg, 6)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    rebases0 = engine.rebases
    victim = next(iter(cluster.nodes))
    for uid in [u for u, p in cluster.pods.items() if p.node_name == victim]:
        cluster.remove_pod(uid)
    cluster.remove_node(victim)
    cluster.add_pod(make_pod(pkg, 2, 1500))
    report = pkg.run(sched, cluster, 2000, engine)
    assert report.bound and engine.rebases == rebases0 + 1
    return (report_of(report), resident_matches(pkg, engine, cluster, 2500),
            engine_state(engine))


def label_change_rebases(pkg):
    cluster = make_cluster(pkg, 6)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    rebases0 = engine.rebases
    relabeled = make_node(pkg, 1)
    relabeled.labels = {pkg.o.REGION_LABEL: "r9", pkg.o.ZONE_LABEL: "z9"}
    cluster.add_node(relabeled)
    cluster.add_pod(make_pod(pkg, 2, 1500))
    report = pkg.run(sched, cluster, 2000, engine)
    assert engine.rebases == rebases0 + 1
    return (report_of(report), resident_matches(pkg, engine, cluster, 2500),
            engine_state(engine))


def extended_node_disengages(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 90, 500))
    base = make_cluster(pkg, 4)
    base.add_pod(make_pod(pkg, 90, 500))
    base_sched = make_scheduler(pkg)
    pkg.run(sched, cluster, 1000, engine)
    pkg.run(base_sched, base, 1000)
    assert engine.resident_nodes is not None
    for cl in (cluster, base):
        cl.add_node(make_node(pkg, 50, extra={EXT: 4}))
        cl.add_pod(make_pod(pkg, 1, 1500))
    serve_report = pkg.run(sched, cluster, 2000, engine)
    base_report = pkg.run(base_sched, base, 2000)
    assert report_of(serve_report) == report_of(base_report)
    assert serve_report.bound
    assert engine.resident_nodes is None  # disowned, not corrupted
    for uid in [u for u, p in cluster.pods.items() if p.node_name == "n050"]:
        cluster.remove_pod(uid)
    cluster.remove_node("n050")
    cluster.add_pod(make_pod(pkg, 2, 2500))
    report = pkg.run(sched, cluster, 3000, engine)
    assert engine.resident_nodes is not None  # serving resumed
    return (report_of(serve_report), report_of(report),
            resident_matches(pkg, engine, cluster, 3500),
            engine_state(engine))


def extended_pending_falls_back(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    pkg.run(sched, cluster, 1000, engine)
    pod = pkg.o.Pod(name="gpu-pod", creation_ms=1500, containers=[
        pkg.o.Container(requests={"cpu": 100, EXT: 1})])
    cluster.add_pod(pod)
    assert not engine.compatible(cluster, cluster.pending_pods())
    cluster.remove_pod(pod.uid)
    assert engine.compatible(cluster, cluster.pending_pods())
    return resident_matches(pkg, engine, cluster, 2000), engine_state(engine)


def side_table_fallback(pkg):
    cluster = make_cluster(pkg, 6)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 99, 500))
    pkg.run(sched, cluster, 1000, engine)
    assert engine.resident_nodes is not None
    rebases0 = engine.rebases
    cluster.node_metrics = {"n000": {"cpu_avg": 50.0}}
    assert not engine.compatible(cluster, [])
    reports = []
    for cycle in range(3):
        now = 2000 + 1000 * cycle
        cluster.add_pod(make_pod(pkg, cycle + 1, now))
        report = pkg.run(sched, cluster, now, engine)
        assert report.bound  # fallback cycles still place
        reports.append(report_of(report))
    cluster.node_metrics = None
    assert engine.rebases == rebases0
    return (reports, resident_matches(pkg, engine, cluster, 9000),
            engine_state(engine))


def tainted_node_delete(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    tainted = make_node(pkg, 60)
    tainted.taints = [pkg.o.Taint(key="k", value="v")]
    cluster.add_node(tainted)
    assert pkg.refresh(engine, cluster, [], 2000) is None
    assert not engine.compatible(cluster, [])
    cluster.remove_node("n060")
    pkg.run(sched, cluster, 3000, engine)
    return resident_matches(pkg, engine, cluster, 3500), engine_state(engine)


def terminating_same_window(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    report = pkg.run(sched, cluster, 1000, engine)
    (uid,) = report.bound
    # the bind's assign is still queued; flip terminating now
    cluster.mark_terminating(uid, 1500)
    return resident_matches(pkg, engine, cluster, 2000), engine_state(engine)


def reserved_terminating(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    held = make_pod(pkg, 2, 600)
    cluster.add_pod(held)
    cluster.reserve(held.uid, "n001")
    cluster.mark_terminating(held.uid, 1500)
    first = resident_matches(pkg, engine, cluster, 2000)
    cluster.release_reservation(held.uid)
    return (first, resident_matches(pkg, engine, cluster, 3000),
            engine_state(engine))


def gated_nominated_falls_back(pkg):
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    pkg.run(sched, cluster, 1000, engine)
    pod = make_pod(pkg, 1, 1500)
    pod.scheduling_gated = True
    pod.nominated_node_name = "n000"
    cluster.add_pod(pod)
    assert not engine.compatible(cluster, [])
    cluster.remove_pod(pod.uid)
    assert engine.compatible(cluster, [])
    return resident_matches(pkg, engine, cluster, 2000), engine_state(engine)


EDGE_SCRIPTS = {
    "grow_across_padding_bucket": grow_across_bucket,
    "node_delete_rebases": node_delete_rebases,
    "label_change_rebases": label_change_rebases,
    "extended_resource_node_disengages_then_resumes":
        extended_node_disengages,
    "extended_resource_pending_pod_falls_back": extended_pending_falls_back,
    "side_table_fallback_absorbs_deltas": side_table_fallback,
    "tainted_node_delete_resumes_serving": tainted_node_delete,
    "terminating_flip_in_same_drain_window_counts_once":
        terminating_same_window,
    "reserved_pod_terminating_counts_at_reserved_node":
        reserved_terminating,
    "gated_nominated_pod_falls_back": gated_nominated_falls_back,
}


class TestServeEdgePaths:
    @pytest.mark.parametrize("name", sorted(EDGE_SCRIPTS))
    def test_edge_path(self, jax_package, name):
        both(EDGE_SCRIPTS[name])

    def test_served_cycle_keeps_no_explain_context(self):
        cluster = make_cluster(PORT, 4)
        engine = attach(PORT, cluster)
        sched = make_scheduler(PORT)
        cluster.add_pod(make_pod(PORT, 1, 500))
        report = PORT.run(sched, cluster, 1000, engine)
        with pytest.raises(RuntimeError, match="released"):
            report.explain(next(iter(report.bound)))

    def test_crash_after_bind_carries_the_report(self):
        """The post-bind crash site: the bindings landed, the report
        rides the exception (the JAX package's `CRASH_POST_BIND`)."""
        cluster = make_cluster(PORT, 4)
        sched = make_scheduler(PORT)
        cluster.add_pod(make_pod(PORT, 1, 500))
        plan = port_faults.FaultPlan(seed=0, specs=[port_faults.FaultSpec(
            site=port_faults.CRASH_POST_BIND, cycle=0, kind="crash")])
        plan.begin_cycle(0)
        port_faults.install(plan)
        try:
            with pytest.raises(port_faults.CrashInjected) as info:
                PORT.run(sched, cluster, 1000)
        finally:
            port_faults.clear()
        assert info.value.report.bound
        assert plan.unfired() == []


# --- the sink's lifecycle ----------------------------------------------------

def detach_uninstalls(pkg):
    cluster = make_cluster(pkg, 3)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    engine.detach()
    assert cluster.delta_sink is None and engine.resident_nodes is None
    cluster.add_pod(make_pod(pkg, 2, 600))
    report = pkg.run(sched, cluster, 2000)
    assert engine._sink.events == []
    return report_of(report), engine_state(engine)


def overflow_rebases(pkg):
    cluster = make_cluster(pkg, 3)
    engine = attach(pkg, cluster)
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    rebases0 = engine.rebases
    sink_cls = pkg.deltas.DeltaSink
    old_max = sink_cls.MAX_EVENTS
    sink_cls.MAX_EVENTS = 4
    try:
        for s in range(2, 9):  # bound arrivals: 7 usage events > cap
            pod = make_pod(pkg, s, 1500)
            pod.node_name = "n000"
            cluster.add_pod(pod)
        assert engine._sink.overflowed
    finally:
        sink_cls.MAX_EVENTS = old_max
    cluster.add_pod(make_pod(pkg, 50, 1800))
    pkg.run(sched, cluster, 2000, engine)
    assert engine.rebases == rebases0 + 1
    return resident_matches(pkg, engine, cluster, 3000), engine_state(engine)


class TestSinkLifecycle:
    def test_detach_uninstalls_sink(self, jax_package):
        both(detach_uninstalls)

    def test_sink_overflow_forces_rebase_not_corruption(self, jax_package):
        both(overflow_rebases)

    def test_sink_events_match_jax(self, jax_package):
        """The same store mutations push the same typed events, in order
        (pod objects compared by uid)."""
        def events(pkg):
            cluster = make_cluster(pkg, 3)
            engine = attach(pkg, cluster)
            pod = make_pod(pkg, 1, 100)
            cluster.add_pod(pod)
            cluster.reserve(pod.uid, "n001")
            cluster.bind(pod.uid, "n002", 200)
            cluster.mark_terminating(pod.uid, 300)
            gated = make_pod(pkg, 2, 100)
            gated.labels = {pkg.o.POD_GROUP_LABEL: "g"}
            gated.scheduling_gated = True
            cluster.add_pod(gated)
            cluster.remove_pod(gated.uid)
            cluster.remove_pod(pod.uid)
            cluster.add_node(make_node(pkg, 7))
            cluster.remove_node("n000")
            return [tuple(getattr(x, "uid", getattr(x, "name", x))
                          for x in ev) for ev in engine._sink.drain()]
        recorded = both(events)
        assert [ev[0] for ev in recorded] == [
            "pod_assign", "pod_unassign", "pod_assign", "pod_terminating",
            "gang_gated", "gang_gated", "pod_unassign", "node_upsert",
            "node_delete"]


class TestEventKindTable:
    def test_builtin_events_are_known(self):
        assert set(PORT_BUILTIN_EVENTS) <= port_events.EVENT_KINDS

    def test_plugin_registrations_are_known(self):
        checked = 0
        for name in dir(port_plugins):
            cls = getattr(port_plugins, name)
            if not (isinstance(cls, type)
                    and hasattr(cls, "events_to_register")):
                continue
            try:
                plugin = cls()
            except TypeError:
                continue
            assert set(plugin.events_to_register()) <= port_events.EVENT_KINDS
            checked += 1
        assert checked >= 8

    def test_kind_format(self):
        for kind in port_events.EVENT_KINDS:
            resource, _, action = kind.partition("/")
            assert resource and action in {"Add", "Update", "Delete"}, kind

    def test_serve_taxonomy_is_within_the_table(self):
        assert port_events.NODE_COLUMN_EVENTS <= port_events.EVENT_KINDS
        assert port_events.SERVE_REBASE_EVENTS <= port_events.EVENT_KINDS

    def test_table_equals_jax(self, jax_package):
        names = [n for n in dir(jax_events) if n.isupper()]
        assert names == [n for n in dir(port_events) if n.isupper()]
        for n in names:
            assert getattr(port_events, n) == getattr(jax_events, n), n


# --- resident gang/quota side tables -----------------------------------------

def gang_quota_cluster(pkg):
    cluster = make_cluster(pkg, 6)
    cluster.add_quota(pkg.o.ElasticQuota(
        name="eq", namespace="team",
        min={"cpu": 24_000, "memory": 96 * GIB},
        max={"cpu": 48_000, "memory": 160 * GIB},
    ))
    return cluster


def gang_sched(pkg):
    P = pkg.plugins
    return pkg.Scheduler(pkg.Profile(plugins=[
        P.NodeResourcesAllocatable(),
        P.Coscheduling(permit_waiting_seconds=5),
        P.CapacityScheduling(),
    ]))


def side_tables_match(pkg, engine, cluster, now) -> dict:
    """The engine-assembled snapshot's gang and quota tensors against a
    fresh one's, bit-equal; returns them."""
    pend = cluster.pending_pods()
    refreshed = pkg.refresh(engine, cluster, pend, now)
    assert refreshed is not None, "gang/quota roster fell back"
    snap, meta = refreshed
    fsnap, fmeta = pkg.snapshot(cluster, pend, now, engine.npad)
    assert fmeta.gang_names == meta.gang_names
    assert set(fmeta.namespaces) == set(meta.namespaces)
    out = {}
    for fam in ("gangs", "quota"):
        mine, fresh = getattr(snap, fam), getattr(fsnap, fam)
        assert (mine is None) == (fresh is None), fam
        if mine is None:
            continue
        for f in fields(mine):
            got, want = _host(getattr(mine, f.name)), _host(
                getattr(fresh, f.name))
            assert got.shape == want.shape, (fam, f.name)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{fam}.{f.name}")
            out[f"{fam}.{f.name}"] = got.tolist()
    return out


def gang_quota_stream(pkg, seed):
    rng = np.random.default_rng(100 + seed)
    serve_cluster = gang_quota_cluster(pkg)
    base_cluster = gang_quota_cluster(pkg)
    engine = attach(pkg, serve_cluster)
    s_sched, b_sched = gang_sched(pkg), gang_sched(pkg)
    o = pkg.o

    def team_pod(serial, now, cpu, mem_gib, gang=None, gated=False):
        pod = o.Pod(
            name=f"tp{serial:04d}", namespace="team",
            creation_ms=now + serial,
            labels={o.POD_GROUP_LABEL: gang} if gang else {},
            containers=[o.Container(
                requests={"cpu": cpu, "memory": mem_gib * GIB})],
        )
        pod.scheduling_gated = gated
        return pod

    record = []
    serial = 0
    for cycle in range(8):
        now = 1000 * (cycle + 1)
        events = []
        for _ in range(int(rng.integers(0, 4))):
            serial += 1
            events.append(("pod", serial, int(rng.integers(200, 2500)),
                           int(rng.integers(1, 4))))
        if cycle % 3 == 1:
            events.append(("gang", cycle, int(rng.integers(2, 4))))
        if cycle % 4 == 2:
            serial += 1
            events.append(("gated", serial, f"g{cycle - 1}"))
        bound = sorted(uid for uid, p in serve_cluster.pods.items()
                       if p.node_name is not None)
        for _ in range(int(rng.integers(0, 2))):
            if bound:
                events.append(
                    ("del", bound.pop(int(rng.integers(0, len(bound))))))
        for cl in (serve_cluster, base_cluster):
            for e in events:
                if e[0] == "pod":
                    cl.add_pod(team_pod(e[1], now, e[2], e[3]))
                elif e[0] == "gang":
                    gname = f"g{e[1]}"
                    cl.add_pod_group(o.PodGroup(
                        name=gname, namespace="team", min_member=e[2],
                        creation_ms=now))
                    for m in range(e[2] + 1):
                        cl.add_pod(o.Pod(
                            name=f"{gname}-m{m}", namespace="team",
                            creation_ms=now + m,
                            labels={o.POD_GROUP_LABEL: gname},
                            containers=[o.Container(requests={
                                "cpu": 1200, "memory": 2 * GIB})],
                        ))
                elif e[0] == "gated":
                    cl.add_pod(team_pod(e[1], now, 500, 1, gang=e[2],
                                        gated=True))
                elif e[0] == "del":
                    cl.remove_pod(e[1])
        serve_report = pkg.run(s_sched, serve_cluster, now, engine)
        base_report = pkg.run(b_sched, base_cluster, now)
        assert report_of(serve_report) == report_of(base_report)
        record.append((report_of(serve_report),
                       side_tables_match(pkg, engine, serve_cluster,
                                         now + 500)))
    assert engine.gang_fallbacks == 0
    record.append((resident_matches(pkg, engine, serve_cluster, 20_000),
                   engine_state(engine), sorted(engine.resident_ranks)))
    return record


def gang_member_cluster(pkg, name="g0", members=3, min_member=2):
    cluster = gang_quota_cluster(pkg)
    cluster.add_pod_group(pkg.o.PodGroup(
        name=name, namespace="team", min_member=min_member, creation_ms=100))
    for m in range(members):
        cluster.add_pod(pkg.o.Pod(
            name=f"{name}-m{m}", namespace="team", creation_ms=100 + m,
            labels={pkg.o.POD_GROUP_LABEL: name},
            containers=[pkg.o.Container(
                requests={"cpu": 1000, "memory": 2 * GIB})],
        ))
    return cluster


def dropped_gang_delta(pkg):
    cluster = gang_member_cluster(pkg)
    engine = attach(pkg, cluster)
    pkg.run(gang_sched(pkg), cluster, 1000, engine)
    assert pkg.refresh(engine, cluster, [], 1500) is not None
    # corrupt the resident gang-assigned count
    if pkg is PORT:
        engine._side.gang_assigned[0:1] += 1
    else:
        import jax.numpy as jnp

        engine._side = engine._side.replace(
            gang_assigned=engine._side.gang_assigned.at[0].add(jnp.int32(1)))
    assert engine._verify_side(cluster) == "side-gang"
    divergences0 = engine.antientropy_divergences
    engine.note_fault("test-side-corruption")
    assert pkg.refresh(engine, cluster, [], 2000) is not None
    assert engine.antientropy_divergences == divergences0 + 1
    assert engine._verify_side(cluster) is None  # the rebase healed it
    return side_tables_match(pkg, engine, cluster, 2500), engine_state(engine)


def reserved_gated_member(pkg):
    cluster = gang_quota_cluster(pkg)
    engine = attach(pkg, cluster)
    o = pkg.o
    cluster.add_pod_group(o.PodGroup(name="rg", namespace="team",
                                     min_member=1, creation_ms=1))
    cluster.add_pod(o.Pod(
        name="rg-m0", namespace="team", creation_ms=2,
        labels={o.POD_GROUP_LABEL: "rg"},
        containers=[o.Container(requests={"cpu": 800, "memory": GIB})]))
    pkg.run(gang_sched(pkg), cluster, 1000, engine)
    gated = o.Pod(
        name="rg-held", namespace="team", creation_ms=3,
        labels={o.POD_GROUP_LABEL: "rg"},
        containers=[o.Container(requests={"cpu": 500, "memory": GIB})])
    gated.scheduling_gated = True
    cluster.add_pod(gated)
    cluster.reserve(gated.uid, "n001")
    assert pkg.refresh(engine, cluster, [], 2000) is not None
    assert engine._verify_side(cluster) is None
    return side_tables_match(pkg, engine, cluster, 2500), engine_state(engine)


def gang_fallback_table(pkg):
    o = pkg.o
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    scope = pkg.obs.metrics.scoped()
    cluster.add_pod_group(o.PodGroup(name="pg", namespace="default",
                                     min_member=1, creation_ms=1))
    cluster.add_pod(o.Pod(
        name="pg-m0", creation_ms=2, labels={o.POD_GROUP_LABEL: "pg"},
        containers=[o.Container(requests={"cpu": 500, "memory": GIB})]))
    report = pkg.run(make_scheduler(pkg), cluster, 1000, engine)
    assert report.bound and engine.gang_fallbacks == 0
    assert scope.get(pkg.obs.SERVE_GANG_FALLBACKS) == 0
    cluster.add_nrt(o.NodeResourceTopology(node_name="n000", zones=[]))
    assert pkg.refresh(engine, cluster, [], 2000) is None
    assert engine.gang_fallbacks == 1
    assert scope.get(pkg.obs.SERVE_GANG_FALLBACKS) == 1
    assert ("scheduler_serve_gang_fallbacks_total"
            in pkg.obs.metrics.prometheus_text())
    cluster.pod_groups.clear()
    assert pkg.refresh(engine, cluster, [], 3000) is None
    assert engine.gang_fallbacks == 1
    return report_of(report), engine_state(engine)


class TestResidentGangQuota:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_randomized_gang_quota_streams(self, jax_package, seed):
        both(gang_quota_stream, seed)

    def test_side_table_anti_entropy_detects_dropped_gang_delta(
            self, jax_package):
        both(dropped_gang_delta)

    def test_reserved_gated_gang_member_counts_both_ways(self, jax_package):
        both(reserved_gated_member)

    def test_gang_fallback_metric_decision_table(self, jax_package):
        both(gang_fallback_table)


# --- anti-entropy under injected delta faults --------------------------------

def corrupted_delta(pkg, kind):
    """A delta-sink fault (drop, dup or corrupt) of the JAX package's
    taxonomy poisons only the resident columns; a verify every refresh
    finds it and rebuilds."""
    cluster = make_cluster(pkg, 4)
    engine = attach(pkg, cluster)
    engine.verify_every = 1
    sched = make_scheduler(pkg)
    cluster.add_pod(make_pod(pkg, 1, 500))
    pkg.run(sched, cluster, 1000, engine)
    plan = pkg.faults.FaultPlan(seed=3, specs=[pkg.faults.FaultSpec(
        site=pkg.faults.DELTA_EVENT, cycle=1, kind=kind)])
    plan.begin_cycle(1)
    pkg.faults.install(plan)
    try:
        cluster.add_pod(make_pod(pkg, 2, 1500))
        first = pkg.run(sched, cluster, 2000, engine)
    finally:
        pkg.faults.clear()
    assert plan.unfired() == []
    cluster.add_pod(make_pod(pkg, 3, 2500))
    second = pkg.run(sched, cluster, 3000, engine)
    assert engine.antientropy_divergences == 1
    return (report_of(first), report_of(second), plan.log,
            resident_matches(pkg, engine, cluster, 3500),
            engine_state(engine))


class TestAntiEntropy:
    @pytest.mark.parametrize("kind", ["drop", "dup", "corrupt"])
    def test_delta_fault_is_healed(self, jax_package, kind):
        both(corrupted_delta, kind)

    def test_standard_plan_equals_jax(self, jax_package):
        for seed in range(3):
            p = port_faults.FaultPlan.standard(seed, 20)
            j = jax_faults.FaultPlan.standard(seed, 20)
            assert [(s.site, s.cycle, s.kind, s.repeat, s.seconds)
                    for s in p.specs] == [
                (s.site, s.cycle, s.kind, s.repeat, s.seconds)
                for s in j.specs]

    def test_verify_digest_equals_jax(self, jax_package):
        """The port's digest of the resident columns equals the JAX
        package's digest of the same arrays."""
        from scheduler_plugins_tpu.utils.flightrec import _pack_digest
        from scheduler_plugins_tpu_torch.utils.flightrec import pack_digest

        cluster = make_cluster(PORT, 5)
        cluster.add_pod(make_pod(PORT, 1, 0))
        snap, _ = PORT.snapshot(cluster, [], 0, 8)
        cols = {k: getattr(snap.nodes, k) for k in NODE_COLUMNS}
        assert pack_digest(cols) == _pack_digest(
            {k: _host(v) for k, v in cols.items()})


# --- the packed batches, the apply and the lowering helpers ------------------

def _sample_rows(rng, R, n_up, n_use):
    up = [(int(s), rng.integers(0, 9, R), rng.integers(0, 9, R),
           bool(rng.random() < 0.5), int(rng.integers(-1, 3)),
           int(rng.integers(-1, 3)))
          for s in rng.choice(12, size=n_up, replace=False)]
    use = [(int(rng.integers(0, 12)), rng.integers(-5, 9, R),
            rng.integers(-5, 9, R), rng.integers(-5, 9, R),
            int(rng.integers(-1, 2)), int(rng.integers(-1, 2)))
           for _ in range(n_use)]
    return up, use


class TestDeltasAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pack_and_apply(self, jax_package, seed):
        """The packed batches pad to JAX's buckets, and folding them into
        a node state gives JAX's columns."""
        rng = np.random.default_rng(seed)
        R = len(port_deltas.CANON_INDEX)
        up, use = _sample_rows(rng, R, int(rng.integers(0, 12)),
                               int(rng.integers(0, 100)))
        p_up = port_deltas.NodeUpserts.pack(up, R)
        j_up = jax_deltas.NodeUpserts.pack(up, R)
        for a, b in zip(p_up.as_args(), j_up.as_args()):
            np.testing.assert_array_equal(a, b)
        p_use = port_deltas.UsageDeltas.pack(use, R)
        j_use = jax_deltas.UsageDeltas.pack(use, R)
        for a, b in zip(p_use.as_args(), j_use.as_args()):
            np.testing.assert_array_equal(a, b)

        cluster = make_cluster(PORT, 10)
        cluster.add_pod(make_pod(PORT, 1, 0))
        snap, _ = PORT.snapshot(cluster, [], 0, 16)
        jcluster = make_cluster(JAX, 10)
        jcluster.add_pod(make_pod(JAX, 1, 0))
        jsnap, _ = JAX.snapshot(jcluster, [], 0, 16)
        got = port_deltas.apply_node_deltas(
            snap.nodes, *port_deltas.stage(p_up.as_args() + p_use.as_args(),
                                           torch.device(CPU)))
        want = jax_deltas.apply_node_deltas(jsnap.nodes, *j_up.as_args(),
                                            *j_use.as_args())
        for col in NODE_COLUMNS:
            np.testing.assert_array_equal(_host(getattr(got, col)),
                                          _host(getattr(want, col)), col)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_side_pack_and_apply(self, jax_package, seed):
        rng = np.random.default_rng(10 + seed)
        R = len(port_deltas.CANON_INDEX)
        gang_rows = [(int(rng.integers(0, 6)), int(rng.integers(-2, 3)),
                      int(rng.integers(-2, 3)), rng.integers(-9, 9, R))
                     for _ in range(int(rng.integers(0, 20)))]
        ns_rows = [(int(rng.integers(0, 4)), rng.integers(-9, 9, R),
                    int(rng.integers(-2, 3)))
                   for _ in range(int(rng.integers(0, 20)))]
        p = port_deltas.SideDeltas.pack(gang_rows, ns_rows, R)
        j = jax_deltas.SideDeltas.pack(gang_rows, ns_rows, R)
        for a, b in zip(p.as_args(), j.as_args()):
            np.testing.assert_array_equal(a, b)
        got = port_deltas.apply_side_deltas(
            port_deltas.zero_side_tables(8, 8, R, CPU),
            *port_deltas.stage(p.as_args(), torch.device(CPU)))
        want = jax_deltas.apply_side_deltas(
            jax_deltas.zero_side_tables(8, 8, R), *j.as_args())
        for f in fields(got):
            np.testing.assert_array_equal(_host(getattr(got, f.name)),
                                          _host(getattr(want, f.name)))

    def test_pod_vectors(self, jax_package):
        for pkg_cpu, mem, lim in ((0, 0, {}), (700, GIB, {"cpu": 300}),
                                  (1500, 0, {"memory": 8 * GIB})):
            vecs = []
            for pkg in (PORT, JAX):
                pod = pkg.o.Pod(name="v", containers=[pkg.o.Container(
                    requests={"cpu": pkg_cpu, "memory": mem}, limits=lim)])
                vecs.append((pkg.deltas.pod_usage_vectors(pod),
                             pkg.deltas.pod_quota_vector(pod)))
            (p_req, p_nz, p_lim), p_q = vecs[0]
            (j_req, j_nz, j_lim), j_q = vecs[1]
            for a, b in ((p_req, j_req), (p_nz, j_nz), (p_lim, j_lim),
                         (p_q, j_q)):
                np.testing.assert_array_equal(a, b)
        with pytest.raises(port_deltas.UnsupportedResource):
            port_deltas.pod_usage_vectors(port_objects.Pod(
                name="x", containers=[port_objects.Container(
                    requests={EXT: 1})]))

    @pytest.mark.parametrize("kind", ["drop", "dup", "corrupt"])
    def test_mutate_delta_equals_jax(self, jax_package, kind):
        out = []
        for faults in (port_faults, jax_faults):
            plan = faults.FaultPlan(seed=1, specs=[faults.FaultSpec(
                site=faults.DELTA_EVENT, cycle=0, kind=kind, repeat=3)])
            plan.begin_cycle(0)
            faults.install(plan)
            try:
                out.append([faults.mutate_delta(ev) for ev in (
                    ("pod_assign", "p", "n0", False),
                    ("pod_unassign", "p", "n0", True),
                    ("node_upsert", "n1"))])
            finally:
                faults.clear()
        assert out[0] == out[1]


class TestSnapshotBuilders:
    def _pods(self, pkg):
        o = pkg.o
        return [
            o.Pod(name=f"b{i}", namespace=f"ns{i % 3}", creation_ms=i,
                  priority=i % 4,
                  labels={o.POD_GROUP_LABEL: "g"} if i % 2 else {},
                  init_containers=[o.Container(requests={"cpu": 50})]
                  if i % 3 == 0 else [],
                  containers=[o.Container(
                      requests={"cpu": 100 * i, "memory": i * GIB},
                      limits={"cpu": 200 * i})])
            for i in range(7)
        ]

    def test_build_pod_state_equals_jax(self, jax_package):
        outs = {}
        for pkg, mod in ((PORT, port_snapshot), (JAX, jax_snapshot)):
            meta_ns = []
            state = mod.build_pod_state(
                self._pods(pkg), 8, pkg.deltas.CANON_INDEX,
                mod._Interner(meta_ns),
                lambda p: 0 if p.pod_group() else -1)
            outs[pkg.name] = ({f.name: np.asarray(getattr(state, f.name))
                               for f in fields(state)}, meta_ns)
        assert outs["port"][1] == outs["jax"][1]
        for k, v in outs["port"][0].items():
            np.testing.assert_array_equal(v, outs["jax"][0][k], err_msg=k)

    def test_object_tables_equal_jax(self, jax_package):
        results = []
        for pkg, mod in ((PORT, port_snapshot), (JAX, jax_snapshot)):
            o, idx = pkg.o, pkg.deltas.CANON_INDEX
            pgs = [o.PodGroup(name="a", namespace="x", min_member=3,
                              creation_ms=5,
                              min_resources={"cpu": 900}),
                   o.PodGroup(name="b", namespace="y", min_member=1)]
            pos = {pg.full_name: i for i, pg in enumerate(pgs)}
            gang = mod.gang_object_tables(pgs, pos, idx, 2, ["y/b"])
            quotas = [o.ElasticQuota(name="q", namespace="x",
                                     min={"cpu": 10}, max={"memory": 20})]
            ns_in = mod._Interner(["w", "x"])
            quota = mod.quota_object_tables(quotas, idx, ns_in, 2)
            results.append((gang, quota, mod.empty_quota_nominees(4, 8)))
        (pg, pq, pe), (jg, jq, je) = results
        assert sorted(pg) == sorted(jg)
        for k in pg:
            np.testing.assert_array_equal(pg[k], jg[k], err_msg=k)
        for a, b in zip(pq + pe, jq + je):
            np.testing.assert_array_equal(a, b)
