"""The port's resilience layer (`scheduler_plugins_tpu_torch.resilience`:
the solve watchdog, degraded-mode failover, the host parity solve; the
serving engine's checkpoint; `run_chunk_pipeline(fetch_deadline_s=)`)
against the JAX package, on the same inputs and the same seeded fault
plans.

Each scenario is one function of a package namespace run on both
packages (the port on the CPU); the two records must be equal, integers
with tolerance 0. They mirror `tests/test_resilience.py`: host-solve
parity (failures included), the watchdog's timeout, retry, classification
and seeded backoff schedule, the output-anomaly contract,
`run_cycle(resilience=)` cycle by cycle under device-error, garbage, hang
and probe faults (bound, failed, solve path, degraded, failovers and
recoveries), the anti-entropy recoveries and the checkpoint restore. Then
the port alone: an abandoned hung worker leaves the served state exact,
two solves in two threads share no plugin context, and the fetch
deadline. Last, bench config 9's harness (`tests/torch_chaos_cases.py`)
at the bench's reduced shape, against the JAX package's arms.

The watchdog deadlines and hang lengths here are shorter than the
bench's (time knobs, not data), except in the config 9 case, which runs
the bench's own reduced shape."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.parallel.pipeline as port_pipeline
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.resilience as port_rz
import scheduler_plugins_tpu_torch.utils.observability as port_obs
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.models import (
    allocatable_scenario as p_allocatable_scenario,
)
from scheduler_plugins_tpu_torch.serving import ServeEngine as PServeEngine
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_chaos_cases import (
    CHAOS_SMOKE_SHAPE,
    RECOVERY_BOUND,
    chaos_fault_plan,
    chaos_gates,
    run_chaos_arm,
)

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.parallel.pipeline as jax_pipeline
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.resilience as jax_rz
    import scheduler_plugins_tpu.utils.observability as jax_obs
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.models import (
        allocatable_scenario as j_allocatable_scenario,
    )
    from scheduler_plugins_tpu.serving import ServeEngine as JServeEngine
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
except ImportError:
    jax_objects = None

CPU = "cpu"
GIB = 1 << 30


def _port_corrupt(engine, slot):
    nodes = engine.resident_nodes
    engine._nodes = nodes.replace(requested=nodes.requested.index_add(
        0, torch.tensor([slot]),
        torch.tensor([[1 << 20] + [0] * (nodes.requested.shape[1] - 1)])))


def _jax_corrupt(engine, slot):
    nodes = engine.resident_nodes
    engine._nodes = nodes.replace(
        requested=nodes.requested.at[slot, 0].add(1 << 20))


PORT = SimpleNamespace(
    name="port", o=port_objects, objects=port_objects, Cluster=PCluster,
    Profile=PProfile, Scheduler=PScheduler, plugins=port_plugins,
    Engine=PServeEngine, rz=port_rz, faults=port_rz.faults,
    Resilience=port_rz.Resilience, SolveWatchdog=port_rz.SolveWatchdog,
    obs=port_obs, allocatable_scenario=p_allocatable_scenario,
    run=lambda s, c, now, e=None, rz=None, chunk=None: port_cycle.run_cycle(
        s, c, now=now, stream_chunk=chunk, serve=e, resilience=rz,
        device=CPU),
    restore=lambda e, ckpt: e.restore_checkpoint(ckpt, device=CPU),
    refresh=lambda e, c, pending, now: e.refresh(c, pending, now_ms=now,
                                                 device=CPU),
    snapshot=lambda c, pending: c.snapshot(pending, now_ms=0, device=CPU),
    solve=lambda s, snap: s.solve(snap, device=CPU),
    host=lambda t: t.cpu().numpy(),
    corrupt=_port_corrupt,
)
JAX = None if jax_objects is None else SimpleNamespace(
    name="jax", o=jax_objects, objects=jax_objects, Cluster=JCluster,
    Profile=JProfile, Scheduler=JScheduler, plugins=jax_plugins,
    Engine=JServeEngine, rz=jax_rz, faults=jax_rz.faults,
    Resilience=jax_rz.Resilience, SolveWatchdog=jax_rz.SolveWatchdog,
    obs=jax_obs, allocatable_scenario=j_allocatable_scenario,
    run=lambda s, c, now, e=None, rz=None, chunk=None: jax_cycle.run_cycle(
        s, c, now=now, stream_chunk=chunk, serve=e, resilience=rz),
    restore=lambda e, ckpt: e.restore_checkpoint(ckpt),
    refresh=lambda e, c, pending, now: e.refresh(c, pending, now_ms=now),
    snapshot=lambda c, pending: c.snapshot(pending, now_ms=0),
    solve=lambda s, snap: s.solve(snap),
    host=np.asarray,
    corrupt=_jax_corrupt,
)


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


@pytest.fixture(autouse=True)
def no_faults():
    yield
    port_rz.faults.clear()
    if JAX is not None:
        jax_rz.faults.clear()


def both(script, *args):
    """Run `script(pkg, *args)` on both packages; their records must be
    equal."""
    port = script(PORT, *args)
    jax = script(JAX, *args)
    assert port == jax
    return port


# --- the same objects in either package --------------------------------------

def make_cluster(pkg, n_nodes=6, cpu=8000):
    cluster = pkg.Cluster()
    for i in range(n_nodes):
        cluster.add_node(pkg.o.Node(
            name=f"n{i:03d}",
            allocatable={"cpu": cpu, "memory": 32 * GIB, "pods": 32},
        ))
    return cluster


def make_pod(pkg, serial, now=0, cpu=500, mem=GIB):
    return pkg.o.Pod(
        name=f"p{serial:05d}", creation_ms=now + serial,
        containers=[pkg.o.Container(requests={"cpu": cpu, "memory": mem})],
    )


def allocatable(pkg):
    return pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourcesAllocatable()]))


def fast_resilience(pkg, engine=None, timeout_s=30.0, attempts=2,
                    probe_every=1):
    return pkg.Resilience(
        watchdog=pkg.SolveWatchdog(
            timeout_s=timeout_s, max_attempts=attempts,
            backoff_base_s=0.005, seed=0,
        ),
        probe_every=probe_every, engine=engine,
    )


def report_of(report) -> tuple:
    return (dict(report.bound), list(report.failed), dict(report.reserved),
            report.solve_path, report.degraded)


# --- the host solve ------------------------------------------------------------

def host_parity(pkg, case):
    """Host solve and device solve outputs of one problem; the two must be
    equal inside the package."""
    s = allocatable(pkg)
    if case == "mixed":
        cluster = make_cluster(pkg, cpu=3000)
        # placeable pods, an oversized one (built-in fit failure) and a
        # scheduling-gated one (PreFilter gate)
        for i in range(4):
            cluster.add_pod(make_pod(pkg, i, cpu=1000))
        cluster.add_pod(make_pod(pkg, 4, cpu=50_000))
        gated = make_pod(pkg, 5, cpu=100)
        gated.scheduling_gated = True
        cluster.add_pod(gated)
    else:
        cluster = pkg.allocatable_scenario(4, 200, seed=case)
    pending = s.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = pkg.snapshot(cluster, pending)
    s.prepare(meta, cluster)
    assert pkg.rz.supports_host_solve(s, snap)
    host = pkg.rz.host_sequential_solve(s, snap)
    dev = pkg.solve(s, snap)
    dev = [pkg.host(x) for x in (dev.assignment, dev.admitted, dev.wait,
                                 dev.failed_plugin)]
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, d)
        assert h.dtype == d.dtype
    assert (host[0] >= 0).any() and (host[0] < 0).any()
    return [x.tolist() for x in host]


def supports_gate(pkg):
    cluster = make_cluster(pkg)
    cluster.add_pod(make_pod(pkg, 0))
    s = allocatable(pkg)
    pending = s.sort_pending(cluster.pending_pods(), cluster)
    snap, _ = pkg.snapshot(cluster, pending)
    mixed = pkg.Scheduler(pkg.Profile(plugins=[
        pkg.plugins.NodeResourcesAllocatable(), pkg.plugins.Coscheduling()]))
    cluster.add_pod_group(pkg.o.PodGroup(name="g", min_member=1))
    member = make_pod(pkg, 1)
    member.labels = {pkg.o.POD_GROUP_LABEL: "g"}
    cluster.add_pod(member)
    gang_snap, _ = pkg.snapshot(cluster, cluster.pending_pods())
    return (pkg.rz.supports_host_solve(s, snap),
            pkg.rz.supports_host_solve(mixed, snap),
            pkg.rz.supports_host_solve(s, gang_snap))


class TestHostSolveParity:
    @pytest.mark.parametrize("case", ["mixed", 0, 1])
    def test_bit_identical_to_jax_including_failures(self, jax_package,
                                                     case):
        both(host_parity, case)

    def test_supports_gates_on_profile_and_side_tables(self, jax_package):
        assert both(supports_gate) == (True, False, False)


# --- the watchdog --------------------------------------------------------------

class TestWatchdog:
    def test_timeout_then_retry_succeeds(self):
        wd = port_rz.SolveWatchdog(timeout_s=0.15, max_attempts=3,
                                   backoff_base_s=0.005, seed=0)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                time.sleep(0.6)  # the first attempt hangs past the deadline
            return "ok"

        assert wd.run(flaky) == "ok"
        assert len(calls) == 2
        assert wd.abandoned == 1
        assert "timeout" in wd.last_reason
        # every watchdog worker, the abandoned one included, is a DAEMON
        # thread: it can never block the process's exit
        workers = [t for t in threading.enumerate()
                   if t.name.startswith("solve-watchdog")]
        assert workers and all(t.daemon for t in workers)

    def test_classification_equals_jax(self, jax_package):
        def classify(pkg):
            wd = pkg.SolveWatchdog(timeout_s=1.0, max_attempts=2,
                                   backoff_base_s=0.001, seed=0)

            def broken():
                raise RuntimeError("xla went away")

            def garbage():
                raise pkg.rz.GarbageOutput("assignment out of range")

            out = []
            for fn in (broken, garbage):
                with pytest.raises(pkg.rz.BackendUnavailable) as exc:
                    wd.run(fn)
                out.append(exc.value.reason)
            return out

        reasons = both(classify)
        assert "device-error: RuntimeError" in reasons[0]
        assert reasons[1].startswith("garbage-output")

    @pytest.mark.parametrize("seed,base,cap", [(7, 0.1, 0.4), (0, 0.05, 2.0),
                                               (3, 0.01, 0.02)])
    def test_backoff_schedule_equals_jax(self, jax_package, seed, base, cap):
        def schedule(pkg):
            wd = pkg.SolveWatchdog(backoff_base_s=base, backoff_cap_s=cap,
                                   seed=seed)
            return [wd.backoff_s(k) for k in range(1, 9)]

        seq = both(schedule)
        for attempt, s in enumerate(seq, start=1):
            top = min(base * 2 ** (attempt - 1), cap)
            assert 0.5 * top <= s <= top

    def test_call_with_deadline(self):
        assert port_rz.call_with_deadline(lambda: 7, 1.0) == 7
        with pytest.raises(port_rz.BackendUnavailable, match="in probe-x"):
            port_rz.call_with_deadline(lambda: time.sleep(0.5), 0.05,
                                       label="probe-x")
        with pytest.raises(ValueError):
            port_rz.call_with_deadline(
                lambda: (_ for _ in ()).throw(ValueError("v")), 1.0)

    def test_output_anomaly_contract_equals_jax(self, jax_package):
        a = np.array([0, -1, 2], np.int32)
        ok = np.ones(3, bool)
        bad = a.copy()
        bad[0] = 3  # >= n_nodes
        cases = [
            (a, ok, ok), (bad, ok, ok), (a, np.ones(2, bool), ok),
            (a, np.array([1.0, np.nan, 1.0]), ok),
            (a.astype(np.float32), ok, ok), (a[None], ok, ok),
        ]
        got = [port_rz.solve_output_anomaly(*c, 3) for c in cases]
        want = [jax_rz.solve_output_anomaly(*c, 3) for c in cases]
        assert got == want
        assert got[0] is None and "out of range" in got[1]
        assert "shape" in got[2] and "NaN" in got[3]
        # tensors on the port's side take the same contract
        assert port_rz.solve_output_anomaly(
            torch.from_numpy(bad), torch.from_numpy(ok),
            torch.from_numpy(ok), 3) == got[1]


# --- run_cycle(resilience=) under fault plans -------------------------------

#: (name, [(site, cycle, kind, extra)], watchdog kwargs)
PLANS = [
    ("device_error_failover",
     [("SOLVE_DISPATCH", 0, "device-error", dict(repeat=8))], {}),
    ("garbage_retried", [("SOLVE_DISPATCH", 0, "garbage", {})], {}),
    ("garbage_failover",
     [("SOLVE_DISPATCH", 0, "garbage", dict(repeat=2))], {}),
    ("hang_failover",
     [("SOLVE_DISPATCH", 1, "hang", dict(seconds=0.6, repeat=2))],
     dict(timeout_s=0.25)),
    ("probe_stays_sick",
     [("SOLVE_DISPATCH", 0, "device-error", dict(repeat=2)),
      ("PROBE", 1, "device-error", {}), ("PROBE", 2, "device-error", {})],
     {}),
]


def fault_cycles(pkg, specs, wd_kwargs, probe_every=1):
    """Five cycles of arrivals through `run_cycle(resilience=)` under a
    fault plan: each cycle's report, the watchdog's and the state
    machine's counters, the degraded gauge; the first cycle's placements
    against a fault-free control."""
    s = allocatable(pkg)
    # warm the solve's shapes outside the watchdog (the JAX package
    # compiles on its first call; the deadline times the backend only)
    warm = make_cluster(pkg)
    for i in range(5):
        warm.add_pod(make_pod(pkg, i))
    control = pkg.run(s, warm, 1000)
    F = pkg.faults
    plan = F.install(F.FaultPlan(seed=3))
    for site, cycle, kind, extra in specs:
        plan.specs.append(F.FaultSpec(site=getattr(F, site), cycle=cycle,
                                      kind=kind, **extra))
    rz = fast_resilience(pkg, probe_every=probe_every, **wd_kwargs)
    cluster = make_cluster(pkg)
    for i in range(5):
        cluster.add_pod(make_pod(pkg, i))
    record = []
    try:
        for cycle in range(5):
            plan.begin_cycle(cycle)
            if cycle:
                for i in range(3):
                    cluster.add_pod(make_pod(pkg, 10 * cycle + i,
                                             now=1000 * cycle))
            r = pkg.run(s, cluster, 1000 * (cycle + 1), rz=rz)
            record.append(report_of(r) + (
                pkg.obs.metrics.get(pkg.obs.DEGRADED),))
            if cycle == 0:
                assert r.bound == control.bound
    finally:
        F.clear()
    return (record, rz.failovers, list(rz.recoveries), rz.degraded_cycles,
            rz.mode, [list(e) for e in plan.log], len(plan.unfired()))


class TestResilienceCycle:
    @pytest.mark.parametrize("name,specs,wd_kwargs", PLANS,
                             ids=[p[0] for p in PLANS])
    def test_cycles_equal_jax_under_faults(self, jax_package, name, specs,
                                           wd_kwargs):
        record, failovers, recoveries, degraded, mode, log, unfired = both(
            fault_cycles, specs, wd_kwargs)
        assert unfired == 0
        paths = [r[3] for r in record]
        if name == "garbage_retried":
            assert paths == ["device"] * 5 and failovers == 0
        else:
            # failover is reported, never hidden, and recovers
            assert "host" in paths and failovers == 1
            assert all(r[4] == (r[3] == "host") for r in record)
            assert recoveries and mode == "fast"
        if name == "probe_stays_sick":
            assert paths[:3] == ["host"] * 3 and recoveries == [(1, 4)]

    def test_no_fault_never_takes_the_host_path(self, jax_package):
        record, failovers, *_ = both(fault_cycles, [], {})
        assert [r[3] for r in record] == ["device"] * 5 and failovers == 0

    def test_no_host_fallback_surfaces_backend_unavailable(self):
        cluster = make_cluster(PORT)
        cluster.add_pod(make_pod(PORT, 0))
        mixed = PScheduler(PProfile(plugins=[
            port_plugins.NodeResourcesAllocatable(),
            port_plugins.Coscheduling()]))
        F = port_rz.faults
        plan = F.install(F.FaultPlan(seed=0))
        plan.specs.append(F.FaultSpec(site=F.SOLVE_DISPATCH, cycle=0,
                                      kind="device-error", repeat=8))
        plan.begin_cycle(0)
        rz = fast_resilience(PORT, attempts=1)
        with pytest.raises(port_rz.BackendUnavailable):
            PORT.run(mixed, cluster, 1000, rz=rz)
        assert rz.degraded  # parked, not silently guessed
        assert all(p.node_name is None for p in cluster.pods.values())

    def test_streamed_cycle_under_the_watchdog(self, jax_package,
                                               monkeypatch):
        """`run_cycle(stream_chunk=4, resilience=)` goes through the
        streamed solve with the fetch deadline, equal to the plain
        streamed cycle and to the JAX package's."""
        def streamed(pkg):
            out = []
            for rz in (None, fast_resilience(pkg)):
                cluster = make_cluster(pkg)
                for i in range(8):
                    cluster.add_pod(make_pod(pkg, i, cpu=1500))
                s = pkg.Scheduler(pkg.Profile(plugins=[
                    pkg.plugins.NodeResourcesAllocatable(),
                    pkg.plugins.Coscheduling(),
                    pkg.plugins.CapacityScheduling()]))
                out.append(report_of(pkg.run(s, cluster, 1000, rz=rz,
                                             chunk=4))[:3])
            assert out[0] == out[1]
            return out[0]

        served = []
        stream = port_pipeline.streamed_profile_solve

        def counted(*args, **kwargs):
            out = stream(*args, **kwargs)
            served.append((out is not None, kwargs.get("fetch_deadline_s")))
            return out

        # the watchdog looks the streamed solve up in its module at call
        # time
        monkeypatch.setattr(port_pipeline, "streamed_profile_solve", counted)
        both(streamed)
        assert (True, 30.0) in served


# --- anti-entropy and the checkpoint (tests/test_resilience.py) -------------

def serve_cycle(pkg, scheduler, cluster, engine, now, serial, n_new=3):
    for _ in range(n_new):
        serial[0] += 1
        cluster.add_pod(make_pod(pkg, serial[0], now=now, cpu=100))
    return pkg.run(scheduler, cluster, now, engine)


def corrupted_column(pkg):
    """`TestAntiEntropy.test_corrupted_resident_column_recovers_in_one_
    window`: a corrupted resident cell is caught by the next refresh's
    digest and rebased before the solve, placements equal to a clean
    control."""
    s = allocatable(pkg)
    cluster, control = make_cluster(pkg), make_cluster(pkg)
    engine = pkg.Engine().attach(cluster)
    ctrl_engine = pkg.Engine().attach(control)
    engine.verify_every = ctrl_engine.verify_every = 1
    for now in (1000, 2000):
        serve_cycle(pkg, s, cluster, engine, now, [now])
        serve_cycle(pkg, s, control, ctrl_engine, now, [now])
    slot = int(np.random.default_rng(0).integers(0, len(cluster.nodes)))
    pkg.corrupt(engine, slot)
    div0 = engine.antientropy_divergences
    record = []
    for now in (3000, 4000):
        r = serve_cycle(pkg, s, cluster, engine, now, [now])
        rc = serve_cycle(pkg, s, control, ctrl_engine, now, [now])
        assert r.bound == rc.bound
        record.append((dict(r.bound), engine.antientropy_divergences - div0,
                       engine.rebases, engine.generation))
    assert [x[1] for x in record] == [1, 1]
    return record


def dropped_event(pkg):
    s = allocatable(pkg)
    cluster = make_cluster(pkg)
    engine = pkg.Engine().attach(cluster)
    engine.verify_every = 1
    serve_cycle(pkg, s, cluster, engine, 1000, [1])
    F = pkg.faults
    plan = F.install(F.FaultPlan(seed=0))
    plan.specs.append(F.FaultSpec(site=F.DELTA_EVENT, cycle=0, kind="drop",
                                  sticky=True))
    plan.begin_cycle(0)
    div0 = engine.antientropy_divergences
    serve_cycle(pkg, s, cluster, engine, 2000, [2])  # a bind dropped
    F.clear()
    r = serve_cycle(pkg, s, cluster, engine, 3000, [3])
    assert plan.unfired() == []
    assert engine.antientropy_divergences == div0 + 1
    return dict(r.bound), engine.rebases, engine.generation


def note_fault_verify(pkg):
    s = allocatable(pkg)
    cluster = make_cluster(pkg)
    engine = pkg.Engine().attach(cluster)
    engine.verify_every = 0  # periodic checks OFF
    scope = pkg.obs.metrics.scoped()
    serve_cycle(pkg, s, cluster, engine, 1000, [100])
    serve_cycle(pkg, s, cluster, engine, 2000, [200])
    checks = [scope.get(pkg.obs.ANTIENTROPY_CHECKS)]
    engine.note_fault("test-fault")
    serve_cycle(pkg, s, cluster, engine, 3000, [300])
    checks.append(scope.get(pkg.obs.ANTIENTROPY_CHECKS))
    assert checks[1] == checks[0] + 1
    return checks


def fallback_reentry(pkg):
    """Taint on, taint off, twice: the fallback windows absorb the deltas
    and serving resumes with no rebase; a later corruption is still
    caught."""
    s = allocatable(pkg)
    cluster = make_cluster(pkg)
    engine = pkg.Engine().attach(cluster)
    engine.verify_every = 1
    serial = [0]
    serve_cycle(pkg, s, cluster, engine, 1000, serial)
    rebases0 = engine.rebases
    gens = []
    for round_ in range(2):
        node = cluster.nodes["n000"]
        node.taints = [pkg.o.Taint(key="k", value="v")]
        cluster.add_node(node)
        assert pkg.refresh(engine, cluster, [], 2000) is None
        node.taints = []
        cluster.add_node(node)
        serve_cycle(pkg, s, cluster, engine, 3000 + round_, serial)
        gens.append(engine.generation)
    assert engine.rebases == rebases0
    assert engine.antientropy_divergences == 0
    pkg.corrupt(engine, 1)
    serve_cycle(pkg, s, cluster, engine, 5000, serial)
    return gens, engine.rebases, engine.antientropy_divergences


class TestAntiEntropy:
    @pytest.mark.parametrize("scenario", [corrupted_column, dropped_event,
                                          note_fault_verify,
                                          fallback_reentry],
                             ids=lambda f: f.__name__)
    def test_recovery_equals_jax(self, jax_package, scenario):
        both(scenario)


def served_engine(pkg, s, cluster):
    engine = pkg.Engine().attach(cluster)
    engine.verify_every = 1
    serve_cycle(pkg, s, cluster, engine, 1000, [10])
    # drain the last cycle's binds: the checkpoint is a settled base
    pkg.refresh(engine, cluster, [], 1500)
    return engine


def restore_exact(pkg, tmp_path):
    s = allocatable(pkg)
    cluster = make_cluster(pkg)
    engine = served_engine(pkg, s, cluster)
    path = str(tmp_path / f"{pkg.name}.ckpt")
    assert engine.save_checkpoint(path)
    gen = engine.generation
    columns = {k: pkg.host(getattr(engine.resident_nodes, k))
               for k in ("alloc", "requested", "mask", "zone", "pod_count")}
    engine.detach()
    restored = pkg.Engine().attach(cluster)
    restored.verify_every = 1
    assert pkg.restore(restored, path)
    assert restored.generation == gen  # continuity, not a cold start
    for k, v in columns.items():
        np.testing.assert_array_equal(
            pkg.host(getattr(restored.resident_nodes, k)), v)
    r = serve_cycle(pkg, s, cluster, restored, 2000, [20])
    # the forced verify passed: no divergence, no rebase
    assert restored.rebases == 0 and restored.antientropy_divergences == 0
    assert r.bound
    return dict(r.bound), restored.generation


def restore_stale(pkg):
    s = allocatable(pkg)
    cluster = make_cluster(pkg)
    engine = served_engine(pkg, s, cluster)
    ckpt = engine.checkpoint_bytes()
    assert ckpt is not None
    engine.detach()
    # the store moves on while the process is down
    victim = next(uid for uid, p in cluster.pods.items()
                  if p.node_name is not None)
    cluster.remove_pod(victim)
    restored = pkg.Engine().attach(cluster)
    restored.verify_every = 1
    pkg.restore(restored, ckpt)
    r = serve_cycle(pkg, s, cluster, restored, 2000, [30])
    assert restored.antientropy_divergences == 1 and restored.rebases == 1
    serve_cycle(pkg, s, cluster, restored, 3000, [40])
    assert restored.antientropy_divergences == 1
    return dict(r.bound), restored.generation, restored.rebases


class TestCheckpointRestore:
    def test_restore_resumes_without_rebase(self, jax_package, tmp_path):
        both(restore_exact, tmp_path)

    def test_stale_checkpoint_rebases_within_one_window(self, jax_package):
        both(restore_stale)

    def test_checkpoint_none_before_first_refresh(self, tmp_path):
        engine = PServeEngine()
        assert engine.checkpoint_bytes() is None
        assert not engine.save_checkpoint(str(tmp_path / "x.ckpt"))

    def test_version_and_source_checked(self):
        s = allocatable(PORT)
        cluster = make_cluster(PORT)
        engine = served_engine(PORT, s, cluster)
        ckpt = engine.checkpoint_bytes()
        with pytest.raises(TypeError):
            engine.restore_checkpoint(memoryview(ckpt), device=CPU)
        engine.CHECKPOINT_VERSION = 2
        with pytest.raises(ValueError, match="version"):
            engine.restore_checkpoint(ckpt, device=CPU)


# --- the port alone: abandoned workers and threads -------------------------

class TestAbandonedWorker:
    def test_abandoned_hang_leaves_the_served_state_exact(self):
        """A hung solve's worker is abandoned, wakes after the cycle moved
        on and solves its stale snapshot, whose node columns are the
        engine's resident tensors: nothing it does reaches the resident
        state or a later cycle."""
        s = allocatable(PORT)
        threads = []
        solve = s.solve

        def recorded(*args, **kwargs):
            threads.append(threading.current_thread().name)
            return solve(*args, **kwargs)

        s.solve = recorded
        cluster, control = make_cluster(PORT), make_cluster(PORT)
        engine = PServeEngine().attach(cluster)
        ctrl_engine = PServeEngine().attach(control)
        engine.verify_every = ctrl_engine.verify_every = 0
        F = port_rz.faults
        plan = F.install(F.FaultPlan(seed=0))
        plan.specs.append(F.FaultSpec(site=F.SOLVE_DISPATCH, cycle=1,
                                      kind="hang", seconds=0.5))
        rz = fast_resilience(PORT, engine=engine, timeout_s=0.2)
        ctrl_s = allocatable(PORT)
        serial, ctrl_serial = [0], [0]
        for cycle in range(6):
            plan.begin_cycle(cycle)
            for _ in range(3):
                serial[0] += 1
                cluster.add_pod(make_pod(PORT, serial[0], now=cycle * 1000,
                                         cpu=700))
                ctrl_serial[0] += 1
                control.add_pod(make_pod(PORT, ctrl_serial[0],
                                         now=cycle * 1000, cpu=700))
            r = PORT.run(s, cluster, 1000 * (cycle + 1), engine, rz)
            rc = PORT.run(ctrl_s, control, 1000 * (cycle + 1), ctrl_engine)
            assert r.bound == rc.bound
            if cycle == 1:
                assert r.solve_path == "device"  # the retry answered
                time.sleep(0.05)
        F.clear()
        time.sleep(0.7)  # the abandoned worker wakes and solves
        assert rz.watchdog.abandoned == 1
        assert threads.count("solve-watchdog") == 7  # 6 cycles + 1 stale
        # drain the last cycle's binds, then digest against the store
        assert PORT.refresh(engine, cluster, [], 9000) is not None
        assert engine.verify(cluster) is None
        assert engine.antientropy_divergences == 0

    def test_concurrent_solves_share_no_plugin_context(self):
        """Two solves of two snapshots of different widths on one
        scheduler, in two threads at once, equal the same solves run
        alone (each plugin's per-solve context is per thread)."""
        s = allocatable(PORT)
        problems = []
        for n_nodes, n_pods, seed in ((8, 40, 0), (24, 64, 1)):
            c = p_allocatable_scenario(n_nodes, n_pods, seed=seed)
            pending = s.sort_pending(c.pending_pods(), c)
            snap, meta = c.snapshot(pending, now_ms=0, device=CPU)
            problems.append((snap, meta, c))
        alone = []
        for snap, meta, c in problems:
            s.prepare(meta, c)
            alone.append(s.solve(snap, device=CPU).assignment)
        results = {}
        barrier = threading.Barrier(2)

        def run(i):
            snap = problems[i][0]
            barrier.wait()
            for _ in range(3):
                results.setdefault(i, []).append(
                    s.solve(snap, device=CPU).assignment)

        workers = [threading.Thread(target=run, args=(i,),
                                    name=f"concurrent-solve-{i}",
                                    daemon=True) for i in (0, 1)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in (0, 1):
            for got in results[i]:
                assert torch.equal(got, alone[i])


class TestFetchDeadline:
    def test_deadline_equals_no_deadline(self, jax_package):
        """`streamed_profile_solve(fetch_deadline_s=)` equals the call
        without one and the JAX package's with one."""
        def streamed(pkg, deadline):
            cluster = pkg.allocatable_scenario(12, 64, seed=2)
            s = pkg.Scheduler(pkg.Profile(plugins=[
                pkg.plugins.NodeResourcesAllocatable()]))
            pending = s.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = pkg.snapshot(cluster, pending)
            s.prepare(meta, cluster)
            if pkg is PORT:
                out = port_pipeline.streamed_profile_solve(
                    s, snap, chunk=16, fetch_deadline_s=deadline,
                    device=CPU)
            else:
                out = jax_pipeline.streamed_profile_solve(
                    s, snap, chunk=16, fetch_deadline_s=deadline)
            return [pkg.host(x).tolist() for x in out]

        plain = streamed(PORT, None)
        assert streamed(PORT, 30.0) == plain
        assert streamed(JAX, 30.0) == plain


# --- bench config 9 ------------------------------------------------------------

def chaos_record(pkg, shape):
    """Bench config 9's two arms through `tests/torch_chaos_cases.py`:
    the control, then the chaos arm under the standard plan, one
    scheduler for both (its shapes are warm when the deadlines count)."""
    s = allocatable(pkg)
    control = run_chaos_arm(pkg, s, shape, seed=0, plan=None)
    plan = chaos_fault_plan(pkg, shape, seed=0)
    chaos = run_chaos_arm(pkg, s, shape, seed=0, plan=plan)
    gates = chaos_gates(chaos, control, plan)
    for key in ("decision_latency_p50_ms", "decision_latency_p99_ms"):
        gates.pop(key)  # wall times
    assert all(p == "device" for p in control["paths"])
    return (gates, chaos["bound"], chaos["paths"], control["rebases"],
            chaos["abandoned"])


class TestChaosChurn:
    def test_config9_smoke_shape_equals_jax(self, jax_package):
        gates, _bound, paths, _rebases, abandoned = both(
            chaos_record, CHAOS_SMOKE_SHAPE)
        assert gates["all_cycles_bit_identical"]
        assert gates["cumulative_placements_match"]
        assert gates["capacity_violations"] == 0
        assert gates["faults_unfired"] == 0 and gates["crashes"] == 1
        assert gates["recovery_cycles_max"] <= RECOVERY_BOUND
        assert "host" in paths and abandoned == 2
        assert gates["antientropy_divergences"] >= 3
