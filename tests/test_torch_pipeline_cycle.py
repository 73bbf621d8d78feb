"""The port's pipelined cycle engine (`framework.pipeline_cycle`: the
conflict fence, the flusher thread, the deferred finalize), the store's
O(changed) pending index and `StreamingServeEngine` (node-delete row
compaction, the fast anti-entropy verify, the per-pod memos) against the
JAX package, with tolerance 0 on every integer output.

- The tables of `tests/test_pipeline_cycle.py` run again on the port,
  every JAX name they call swapped for the port's (the engines and the
  store defaulting to the CPU). Two cases read JAX-only API (`.at[]`
  on the resident columns, the usage memo's nonzero column) and run here
  in the port's terms.
- `tests/test_differential.py` TestPipelinedCycleEquivalence's two
  rosters (plain serve with a node delete; gangs and a quota) through
  both packages' serial and pipelined engines: every cycle's decisions
  and the final store equal across the four.
- `compact_node_rows` and `build_pod_state(row_cache=)` against JAX's on
  numpy-made inputs.
- Bench config 11 (`tests/torch_life_cases.py`) at `ENDURANCE_SMOKE_SHAPE`
  through JAX's pipelined engine and the port's pipelined and serial
  ones, cycle by cycle, the ledger sequences included.
- Two trouble spots: the failure decode and the preemption dry run on
  the flusher thread (a streamed cycle script, against JAX), and a
  deferred finalize whose rows the next refresh and a compaction
  rewrite."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.framework.preemption as port_preemption
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.serving.engine as port_engine
from scheduler_plugins_tpu_torch import resilience as port_resilience
from scheduler_plugins_tpu_torch.framework import (
    PipelinedCycle as PPipelinedCycle,
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.framework.pipeline_cycle import (
    CycleTimeline as PCycleTimeline,
)
from scheduler_plugins_tpu_torch.obs import ledger as port_ledger
from scheduler_plugins_tpu_torch.serving import deltas as port_deltas
from scheduler_plugins_tpu_torch.state import snapshot as port_snapshot
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.utils import observability as port_obs
from torch_cycle_scripts import SCRIPT_COSCHED, cycle_script
from torch_life_cases import (
    ENDURANCE_SMOKE_SHAPE,
    LifeArm,
    life_gates,
)

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.serving.deltas as j_deltas
    import scheduler_plugins_tpu.serving.engine as j_engine
    import scheduler_plugins_tpu.state.snapshot as j_snapshot
    import scheduler_plugins_tpu.utils as jax_utils
    import tests.test_pipeline_cycle as jax_tables
    from scheduler_plugins_tpu import resilience as jax_resilience
    from scheduler_plugins_tpu.framework import (
        PipelinedCycle as JPipelinedCycle,
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.obs import ledger as jax_ledger
    from scheduler_plugins_tpu.serving import (
        ServeEngine as JServeEngine,
        StreamingServeEngine as JStreamingServeEngine,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
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


class _CPUServeEngine(port_engine.ServeEngine):
    def refresh(self, cluster, pending, now_ms=0, *, device=CPU):
        return super().refresh(cluster, pending, now_ms, device=device)


class _CPUStreamingEngine(port_engine.StreamingServeEngine):
    def refresh(self, cluster, pending, now_ms=0, *, device=CPU):
        return super().refresh(cluster, pending, now_ms, device=device)


def _cpu_pipelined(s, c, **kw):
    return PPipelinedCycle(s, c, device=CPU, **kw)


def _cpu_run_cycle(s, c, now=None, stream_chunk=None, **kw):
    return port_cycle.run_cycle(s, c, now, stream_chunk, device=CPU, **kw)


# --- the JAX tables on the port ---------------------------------------------

#: cases that read JAX-only API, run below in the port's terms
REWRITTEN = {
    "test_fast_verify_detects_corruption_like_base",
    "test_usage_vector_memo_invalidates_on_new_pod_object",
}


def _tables():
    if jax_objects is None:
        return []
    classes = [jax_tables.TestPendingIndex, jax_tables.TestCycleTimeline,
               jax_tables.TestPipelinedTickBasics,
               jax_tables.TestConflictFence,
               jax_tables.TestStreamingServeEngine,
               jax_tables.TestReviewRegressions,
               jax_tables.TestPipelinedObservability]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_") and name not in REWRITTEN]


def _swap_in_port(monkeypatch):
    swaps = {
        "REGION_LABEL": port_objects.REGION_LABEL,
        "ZONE_LABEL": port_objects.ZONE_LABEL,
        "Container": port_objects.Container,
        "Node": port_objects.Node,
        "Pod": port_objects.Pod,
        "PipelinedCycle": _cpu_pipelined,
        "Profile": PProfile,
        "Scheduler": PScheduler,
        "run_cycle": _cpu_run_cycle,
        "CycleTimeline": PCycleTimeline,
        "PreemptionEngine": port_preemption.PreemptionEngine,
        "PreemptionMode": port_preemption.PreemptionMode,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "ServeEngine": _CPUServeEngine,
        "StreamingServeEngine": _CPUStreamingEngine,
        "Cluster": _CPUCluster,
    }
    for name, value in swaps.items():
        assert hasattr(jax_tables, name), name
        monkeypatch.setattr(jax_tables, name, value)
    # the names the cases import inside their bodies
    monkeypatch.setattr(jax_utils, "observability", port_obs)
    monkeypatch.setattr(j_deltas, "CANON_INDEX", port_deltas.CANON_INDEX)
    monkeypatch.setattr(j_snapshot, "_Interner", port_snapshot._Interner)
    monkeypatch.setattr(j_snapshot, "build_pod_state",
                        port_snapshot.build_pod_state)


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_pipeline_cycle.py` (but the two in
    `REWRITTEN`) with every JAX name it calls, at module level and in its
    body's imports, swapped for the port's."""
    _swap_in_port(monkeypatch)
    getattr(cls(), method)()


class TestRewrittenCases:
    """`REWRITTEN`'s cases in the port's terms."""

    def _churny(self):
        c = _CPUCluster()
        for i in range(5):
            c.add_node(port_objects.Node(name=f"n{i}", allocatable={
                "cpu": 16_000, "memory": 64 * GIB, "pods": 110}))
        for i in range(8):
            p = port_objects.Pod(
                name=f"b{i}", creation_ms=i,
                containers=[port_objects.Container(
                    requests={"cpu": 500, "memory": GIB})])
            p.node_name = f"n{i % 5}"
            c.add_pod(p)
        return c, _CPUStreamingEngine().attach(c)

    def test_fast_verify_detects_corruption_like_base(self):
        c, engine = self._churny()
        sched = PScheduler(PProfile(
            plugins=[port_plugins.NodeResourcesAllocatable()]))
        c.add_pod(port_objects.Pod(
            name="seed", creation_ms=40,
            containers=[port_objects.Container(requests={"cpu": 500})]))
        _cpu_run_cycle(sched, c, now=1000, serve=engine)
        assert engine.refresh(c, [], now_ms=1500) is not None
        assert engine.verify(c) is None
        # the base engine's verify agrees on clean state
        assert port_engine.ServeEngine.verify(engine, c) is None
        engine._nodes.requested[1, 0] += 17
        assert engine.verify(c) == "column-digest"
        assert port_engine.ServeEngine.verify(engine, c) == "column-digest"
        engine._names = list(reversed(engine._names))
        assert engine.verify(c) == "row-order"

    def test_usage_vector_memo_invalidates_on_new_pod_object(self):
        _, engine = self._churny()

        def pod(cpu):
            return port_objects.Pod(name="x", containers=[
                port_objects.Container(requests={"cpu": cpu,
                                                 "memory": GIB})])

        first = pod(700)
        v1 = engine._pod_vectors(first)
        assert engine._pod_vectors(first)[0] is v1[0]  # a memo hit
        replacement = pod(900)  # the same uid, a new object
        v2 = engine._pod_vectors(replacement)
        assert v2[0][0] == 900
        assert v2[3][0] == 900  # the quota vector rides the same memo
        engine._pod_vectors(replacement, final=True)
        assert "default/x" not in engine._vec_cache


class TestPendingIndexAgainstJax:
    @pytest.mark.parametrize("indexed", [True, False])
    def test_order_and_serials_equal_jax(self, jax_package, indexed):
        """One random mutator stream (adds, re-adds after removes, binds,
        reservations and their release, terminations, in-place gate flips)
        on JAX's store and the port's: the pending queue in the same
        order and every uid's `admission_serial` equal, with the index on
        and off."""
        rng = np.random.default_rng(29)
        stores = []
        for o, cls in ((jax_objects, JCluster), (port_objects, PCluster)):
            c = cls()
            for i in range(3):
                c.add_node(o.Node(name=f"n{i}", allocatable={
                    "cpu": 16_000, "memory": 64 * GIB, "pods": 110}))
            stores.append((o, c))

        seen = set()

        def add(name):
            seen.add(f"default/{name}")
            for o, c in stores:
                c.add_pod(o.Pod(name=name, creation_ms=len(c.pods),
                                containers=[o.Container(
                                    requests={"cpu": 100})]))

        for i in range(8):
            add(f"p{i}")
        if indexed:
            for _, c in stores:
                c.enable_pending_index()
        serial = 8
        for step in range(400):
            jc = stores[0][1]
            pend = [u for u, p in jc.pods.items() if p.node_name is None
                    and u not in jc.reserved]
            r = rng.random()
            u = pend[int(rng.integers(len(pend)))] if pend else None
            if r < 0.3 or u is None:
                serial += 1
                add(f"p{serial}")
            elif r < 0.45:
                for _, c in stores:
                    c.bind(u, "n1", step)
            elif r < 0.6:
                victim = list(jc.pods)[int(rng.integers(len(jc.pods)))]
                name = jc.pods[victim].name
                for _, c in stores:
                    c.remove_pod(victim)
                if rng.random() < 0.5:
                    add(name)  # a re-add lands at the queue's end
            elif r < 0.7:
                for _, c in stores:
                    c.reserve(u, "n2")
            elif r < 0.8 and jc.reserved:
                held = list(jc.reserved)[0]
                for _, c in stores:
                    c.release_reservation(held)
            elif r < 0.9:
                for _, c in stores:
                    c.pods[u].scheduling_gated = not c.pods[u].scheduling_gated
                    c.reindex_pod(u)
            else:
                for _, c in stores:
                    c.mark_terminating(u, step)
            want, got = ([p.uid for p in c.pending_pods()] for _, c in stores)
            assert got == want, step
        jc, pc = stores[0][1], stores[1][1]
        # removed uids included: a removed uid has no serial (-1)
        assert len(seen) > len(jc.pods)
        for uid in sorted(seen) + ["default/absent"]:
            assert pc.admission_serial(uid) == jc.admission_serial(uid), uid


# --- the differential's rosters, both packages, both engines ----------------

def _pkg(side):
    if side == "port":
        return SimpleNamespace(
            o=port_objects, Cluster=PCluster, plugins=port_plugins,
            Profile=PProfile, Scheduler=PScheduler,
            Engine=port_engine.ServeEngine,
            StreamingEngine=port_engine.StreamingServeEngine,
            Pipelined=lambda s, c, e, **kw: PPipelinedCycle(
                s, c, serve=e, device=CPU, **kw),
            run=lambda s, c, now, e, rz=None, **kw: port_cycle.run_cycle(
                s, c, now=now, serve=e, resilience=rz, device=CPU, **kw),
            faults=port_resilience.faults,
            Resilience=port_resilience.Resilience,
            SolveWatchdog=port_resilience.SolveWatchdog,
            ledger=port_ledger,
        )
    return SimpleNamespace(
        o=jax_objects, Cluster=JCluster, plugins=jax_plugins,
        Profile=JProfile, Scheduler=JScheduler, Engine=JServeEngine,
        StreamingEngine=JStreamingServeEngine,
        Pipelined=lambda s, c, e, **kw: JPipelinedCycle(s, c, serve=e, **kw),
        run=lambda s, c, now, e, rz=None, **kw: jax_cycle.run_cycle(
            s, c, now=now, serve=e, resilience=rz, **kw),
        faults=jax_resilience.faults, Resilience=jax_resilience.Resilience,
        SolveWatchdog=jax_resilience.SolveWatchdog, ledger=jax_ledger,
    )


def _drive(pkg, cluster, sched, pipelined, events, n_cycles):
    """`n_cycles` cycles of `events(cycle, now)` then one cycle through
    the serial engine (`run_cycle` + `ServeEngine`) or the pipelined one
    (`PipelinedCycle` + `StreamingServeEngine`, fenced after each tick
    and flushed at the end). Returns every cycle's report fields and the
    final store."""
    engine = (pkg.StreamingEngine() if pipelined
              else pkg.Engine()).attach(cluster)
    pipe = pkg.Pipelined(sched, cluster, engine) if pipelined else None
    reports = []
    for cycle in range(n_cycles):
        now = 1000 * (cycle + 1)
        events(cycle, now)
        if pipelined:
            reports.append(pipe.tick(now))
            pipe.fence()
        else:
            reports.append(pkg.run(sched, cluster, now, engine))
    if pipelined:
        # the failure decode of the last cycle is complete only now
        pipe.flush()
        pipe.close()
    per_cycle = [(dict(r.bound), dict(r.reserved), list(r.failed),
                  dict(r.failed_by), list(r.rejected_gangs),
                  dict(r.preempted)) for r in reports]
    final = {u: p.node_name for u, p in sorted(cluster.pods.items())}
    return per_cycle, final


def plain_roster(pkg, pipelined):
    """TestPipelinedCycleEquivalence `_run_plain`: six nodes, arrivals, a
    node added, a pod that fits nowhere, a departure and a
    drain-then-delete."""
    o = pkg.o
    rng = np.random.default_rng(23)

    def node(i):
        return o.Node(name=f"n{i:03d}", allocatable={
            "cpu": 8000, "memory": 32 * GIB, "pods": 32},
            labels={o.REGION_LABEL: "r1", o.ZONE_LABEL: f"z{i % 2}"})

    cluster = pkg.Cluster()
    for i in range(6):
        cluster.add_node(node(i))
    sched = pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourcesAllocatable()]))
    serial = [0]

    def events(cycle, now):
        for _ in range(int(rng.integers(1, 4))):
            serial[0] += 1
            cluster.add_pod(o.Pod(
                name=f"p{serial[0]:05d}", creation_ms=now + serial[0],
                containers=[o.Container(requests={
                    "cpu": int(rng.integers(200, 2500)), "memory": GIB})]))
        if cycle == 3:
            cluster.add_node(node(40))
        if cycle == 4:
            cluster.add_pod(o.Pod(
                name="nofit", creation_ms=now + 999,
                containers=[o.Container(requests={"cpu": 10**9})]))
        if cycle == 5:
            bound = sorted(u for u, p in cluster.pods.items()
                           if p.node_name is not None)
            cluster.remove_pod(bound[0])
        if cycle == 7:
            victim = next(iter(cluster.nodes))
            for uid in [u for u, p in cluster.pods.items()
                        if p.node_name == victim]:
                cluster.remove_pod(uid)
            cluster.remove_node(victim)

    return _drive(pkg, cluster, sched, pipelined, events, 10)


def gang_quota_roster(pkg, pipelined):
    """TestPipelinedCycleEquivalence `_run_gang_quota`: eight nodes, an
    ElasticQuota, the flagship profile, gangs every five cycles and
    random completions, served resident."""
    o = pkg.o
    rng = np.random.default_rng(5)
    cluster = pkg.Cluster()
    for i in range(8):
        cluster.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 16_000, "memory": 64 * GIB, "pods": 30}))
    cluster.add_quota(o.ElasticQuota(
        name="eq", namespace="team",
        min={"cpu": 64_000, "memory": 256 * GIB},
        max={"cpu": 96_000, "memory": 384 * GIB}))
    P = pkg.plugins
    sched = pkg.Scheduler(pkg.Profile(plugins=[
        P.NodeResourcesAllocatable(), P.Coscheduling(permit_waiting_seconds=5),
        P.CapacityScheduling()]))
    serial = [0]

    def events(cycle, now):
        for _ in range(int(rng.integers(0, 5))):
            serial[0] += 1
            cluster.add_pod(o.Pod(
                name=f"p{serial[0]:04d}", namespace="team",
                creation_ms=now + serial[0],
                priority=int(rng.integers(0, 5)),
                containers=[o.Container(requests={
                    "cpu": int(rng.integers(200, 4000)),
                    "memory": int(rng.integers(1, 8)) * GIB})]))
        if cycle % 5 == 1:
            gname = f"g{cycle}"
            cluster.add_pod_group(o.PodGroup(
                name=gname, namespace="team", min_member=3, creation_ms=now))
            for m in range(3):
                serial[0] += 1
                cluster.add_pod(o.Pod(
                    name=f"{gname}-m{m}", namespace="team",
                    creation_ms=now + m, labels={o.POD_GROUP_LABEL: gname},
                    containers=[o.Container(requests={
                        "cpu": 2000, "memory": 4 * GIB})]))
        bound = [p for p in cluster.pods.values()
                 if p.node_name is not None and not p.pod_group()]
        for pod in bound:
            if rng.random() < 0.15:
                cluster.remove_pod(pod.uid)

    return _drive(pkg, cluster, sched, pipelined, events, 12)


class TestPipelinedCycleEquivalence:
    @pytest.mark.parametrize("roster", [plain_roster, gang_quota_roster],
                             ids=["plain", "gang_quota"])
    def test_four_engines_identical(self, jax_package, roster):
        want = roster(_pkg("jax"), pipelined=False)
        if roster is plain_roster:
            assert any(cycle[3] for cycle in want[0]), "no failure decoded"
        else:
            assert any("-m" in uid for cycle in want[0] for uid in cycle[0]), \
                "no gang member bound"
        for side, pipelined in (("jax", True), ("port", False),
                                ("port", True)):
            got = roster(_pkg(side), pipelined)
            assert got[0] == want[0], (side, pipelined)
            assert got[1] == want[1], (side, pipelined)


# --- compaction and the row cache against JAX --------------------------------

def _random_nodes(rng, npad, n_real, R=4):
    cols = {
        "alloc": rng.integers(0, 1 << 40, (npad, R)),
        "capacity": rng.integers(0, 1 << 40, (npad, R)),
        "requested": rng.integers(0, 1 << 30, (npad, R)),
        "nonzero_requested": rng.integers(0, 1 << 30, (npad, R)),
        "limits": rng.integers(0, 1 << 30, (npad, R)),
        "mask": rng.random(npad) < 0.8,
        "region": rng.integers(-1, 4, npad).astype(np.int32),
        "zone": rng.integers(-1, 6, npad).astype(np.int32),
        "pod_count": rng.integers(0, 50, npad).astype(np.int32),
        "terminating": rng.integers(0, 3, npad).astype(np.int32),
        "nominated": rng.integers(0, 3, npad).astype(np.int32),
    }
    # a fresh snapshot's pad rows
    for k in ("alloc", "capacity", "requested", "nonzero_requested",
              "limits", "pod_count", "terminating", "nominated"):
        cols[k][n_real:] = 0
    cols["mask"][n_real:] = False
    cols["region"][n_real:] = -1
    cols["zone"][n_real:] = -1
    return cols


class TestCompactionAgainstJax:
    @pytest.mark.parametrize("npad,n_real,slot", [
        (16, 16, 0), (16, 16, 15), (16, 11, 4), (32, 17, 16), (8, 1, 0)])
    def test_compact_node_rows_equals_jax(self, jax_package, npad, n_real,
                                          slot):
        rng = np.random.default_rng(npad * 100 + slot)
        cols = _random_nodes(rng, npad, n_real)
        idx, valid = port_engine._shift_gather_args(npad, slot, n_real - 1)
        jidx, jvalid = j_engine._shift_gather_args(npad, slot, n_real - 1)
        assert (idx == jidx).all() and (valid == jvalid).all()
        want = j_deltas.compact_node_rows(
            j_snapshot.NodeState(**{k: jnp.asarray(v)
                                    for k, v in cols.items()}),
            jnp.asarray(jidx), jnp.asarray(jvalid))
        port_cols = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
        got = port_deltas.compact_node_rows(
            port_snapshot.NodeState(**port_cols), torch.from_numpy(idx),
            torch.from_numpy(valid))
        for k in port_cols:
            w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
            assert g.dtype == w.dtype and (g == w).all(), k
            # new tensors: a snapshot still reading the old rows keeps them
            assert getattr(got, k).data_ptr() != port_cols[k].data_ptr(), k

    def test_row_cache_equals_jax(self, jax_package):
        """`build_pod_state` cold, then twice through one row cache (the
        second pass all hits, one pod replaced by a new object), on both
        packages: every field equal."""
        rng = np.random.default_rng(3)

        def pods(o):
            out = []
            for i in range(9):
                kw = {}
                if i % 3 == 0:
                    kw["init_containers"] = [o.Container(requests={
                        "cpu": int(rng.integers(10, 90))})]
                out.append(o.Pod(
                    name=f"p{i}", namespace=f"ns{i % 2}", creation_ms=i,
                    priority=int(rng.integers(0, 4)),
                    containers=[o.Container(
                        requests={"cpu": int(rng.integers(100, 900)),
                                  "memory": int(rng.integers(1, 9)) * GIB},
                        limits={"cpu": int(rng.integers(900, 1900))})
                        for _ in range(1 + i % 3)],
                    **kw))
            return out

        state = rng.bit_generator.state
        jpods = pods(jax_objects)
        rng.bit_generator.state = state
        ppods = pods(port_objects)
        fields = ("req", "limits", "predicted_cpu_millis", "container_req",
                  "container_is_init", "container_mask", "priority", "ns",
                  "gang", "qos", "mask", "creation_ms", "gated")
        jcache, pcache = {}, {}
        for k in range(3):
            if k == 2:
                # a feed upsert: the same uid as a new object
                jpods[4] = jax_objects.Pod(name="p4", namespace="ns0",
                                           containers=[jax_objects.Container(
                                               requests={"cpu": 5})])
                ppods[4] = port_objects.Pod(name="p4", namespace="ns0",
                                            containers=[port_objects.Container(
                                                requests={"cpu": 5})])
            want = j_snapshot.build_pod_state(
                jpods, 16, j_deltas.CANON_INDEX,
                j_snapshot._Interner([]), lambda p: -1,
                row_cache=None if k == 0 else jcache)
            got = port_snapshot.build_pod_state(
                ppods, 16, port_deltas.CANON_INDEX,
                port_snapshot._Interner([]), lambda p: -1,
                row_cache=None if k == 0 else pcache)
            for f in fields:
                w, g = np.asarray(getattr(want, f)), getattr(got, f)
                assert g.dtype == w.dtype and (g == w).all(), (k, f)
        assert len(pcache) == 9 and pcache["ns0/p4"].pod is ppods[4]


# --- bench config 11, cut to the bench's smoke shape ---------------------------

class TestConfig11:
    def test_endurance_smoke_shape_equals_jax(self, jax_package):
        """Config 11 at `ENDURANCE_SMOKE_SHAPE` (500 nodes, 4,096 bound
        pods, 3 + 38 cycles of churn, gangs, chaos and node waves) through
        JAX's pipelined engine and the port's pipelined and serial
        engines: every cycle's decisions (failure attribution included),
        the final store, the ledger sequences and the engines' counters
        equal; compactions in the waves phase; fewer rebases than the
        serial engine."""
        arms = {}
        for side, pipelined in (("jax", True), ("port", True),
                                ("port", False)):
            arm = LifeArm(_pkg(side), ENDURANCE_SMOKE_SHAPE, pipelined)
            while not arm.done:
                arm.step()
            arms[side, pipelined] = arm.finish()
        jax_pipe, port_pipe = arms["jax", True], arms["port", True]
        assert life_gates(port_pipe, jax_pipe) == []
        assert life_gates(port_pipe, arms["port", False]) == []
        for key in ("rebases", "compactions", "phase_counters",
                    "gang_fallbacks", "antientropy_divergences",
                    "faults_fired", "degraded_end", "placements"):
            assert port_pipe[key] == jax_pipe[key], key
        assert port_pipe["faults_fired"] == 4
        assert port_pipe["ledger_sequence"]


# --- the trouble spots --------------------------------------------------------

class TestFlusherThread:
    def test_streamed_attribution_and_preemption_on_flusher(
            self, jax_package, monkeypatch):
        """`cycle_script` streamed in chunks of 4 (the decode of a
        streamed solve reads the snapshot, so it runs eagerly in the bind
        stage) through `PipelinedCycle(stream_chunk=4)`: the failure
        decode and the preemption dry run run on the flusher thread, and
        every report's decisions, `failed_by` and nominations equal JAX
        `run_cycle(stream_chunk=4)`'s."""
        threads = {"attribution": set(), "preempt": set()}
        attribution = PScheduler.attribution_codes

        def traced_attribution(self, snap, indices):
            threads["attribution"].add(threading.current_thread().name)
            return attribution(self, snap, indices)

        preempt = port_preemption.PreemptionEngine.preempt

        def traced_preempt(self, *args, **kwargs):
            threads["preempt"].add(threading.current_thread().name)
            return preempt(self, *args, **kwargs)

        monkeypatch.setattr(PScheduler, "attribution_codes",
                            traced_attribution)
        monkeypatch.setattr(port_preemption.PreemptionEngine, "preempt",
                            traced_preempt)

        def flagship(pkg):
            P = pkg.plugins
            return pkg.Scheduler(pkg.Profile(plugins=[
                P.NodeResourcesAllocatable(),
                P.Coscheduling(**SCRIPT_COSCHED), P.CapacityScheduling()]))

        jc, steps = cycle_script(jax_objects, JCluster, n_nodes=16)
        pc, psteps = cycle_script(port_objects, PCluster, n_nodes=16)
        jsched, psched = flagship(_pkg("jax")), flagship(_pkg("port"))
        pipe = PPipelinedCycle(psched, pc, stream_chunk=4, device=CPU)
        want, got = [], []
        for (now, mutate), (_, pmutate) in zip(steps, psteps):
            if mutate is not None:
                mutate(jax_objects, jc)
                pmutate(port_objects, pc)
            want.append(jax_cycle.run_cycle(jsched, jc, now, 4))
            got.append(pipe.tick(now))
            pipe.fence()
        pipe.close()
        for k, (w, g) in enumerate(zip(want, got)):
            for field in ("bound", "reserved", "failed", "failed_by",
                          "skipped", "rejected_gangs", "expired_gangs",
                          "preempted"):
                assert getattr(g, field) == getattr(w, field), (k, field)
        assert any(r.preempted for r in got)
        assert any(r.failed_by for r in got)
        for name, seen in threads.items():
            assert seen and all(t.startswith("spt-bind-flusher")
                                for t in seen), (name, seen)
        assert {uid: p.nominated_node_name for uid, p in pc.pods.items()} \
            == {uid: p.nominated_node_name for uid, p in jc.pods.items()}


class TestDeferredFinalize:
    def test_finalize_reads_the_fence_copies(self, jax_package):
        """Cycle A fails a pod (its decode and quality stamp deferred);
        before cycle B a node is drained and deleted and pods arrive, so
        B's refresh adds into the rows A solved on and compacts them.
        A's report, finished in B's overlap window, equals the serial
        engine's and JAX's; read from the live rows it would not."""
        def build(pkg):
            o = pkg.o
            c = pkg.Cluster()
            for i in range(6):
                c.add_node(o.Node(name=f"n{i}", allocatable={
                    "cpu": 8000, "memory": 32 * GIB, "pods": 32}))
            for i in range(9):
                p = o.Pod(name=f"b{i}", creation_ms=i, containers=[
                    o.Container(requests={"cpu": 900, "memory": GIB})])
                p.node_name = f"n{i % 6}"
                c.add_pod(p)
            for i in range(5):
                c.add_pod(o.Pod(name=f"a{i}", creation_ms=100 + i,
                                containers=[o.Container(requests={
                                    "cpu": 1500, "memory": GIB})]))
            c.add_pod(o.Pod(name="nofit", creation_ms=200, containers=[
                o.Container(requests={"cpu": 10**9})]))
            return c

        def between(pkg, c):
            o = pkg.o
            for uid in [u for u, p in c.pods.items() if p.node_name == "n0"]:
                c.remove_pod(uid)
            c.remove_node("n0")
            for i in range(4):
                c.add_pod(o.Pod(name=f"late{i}", creation_ms=300 + i,
                                containers=[o.Container(requests={
                                    "cpu": 2500, "memory": GIB})]))

        def sched(pkg):
            return pkg.Scheduler(pkg.Profile(
                plugins=[pkg.plugins.NodeResourcesAllocatable()]))

        def fields(r):
            return (r.bound, r.failed, r.failed_by, r.quality)

        reports = {}
        for side in ("jax", "port"):
            pkg = _pkg(side)
            c = build(pkg)
            engine = pkg.Engine().attach(c)
            s = sched(pkg)
            a = pkg.run(s, c, 1000, engine)
            between(pkg, c)
            pkg.run(s, c, 2000, engine)
            reports[side, "serial"] = fields(a)
        pkg = _pkg("port")
        c = build(pkg)
        engine = pkg.StreamingEngine().attach(c)
        pipe = pkg.Pipelined(sched(pkg), c, engine)
        a = pipe.tick(1000)
        ctx_a = pipe._pending_finalize[0]
        assert a.quality is None and not a.failed_by  # deferred
        pipe.fence()
        between(pkg, c)
        pipe.tick(2000)
        assert engine.compactions == 1 and engine.rebases == 1
        pipe.close()
        assert fields(a) == reports["port", "serial"] \
            == reports["jax", "serial"]
        assert a.failed_by == {"default/nofit": "NodeResourcesFit"}
        # the hazard is real: A's snapshot rows changed under it
        live = port_cycle._observe_quality
        stale = SimpleNamespace(quality=None, preempted={})
        live(stale, port_cycle._quality_view(ctx_a.snap), ctx_a.assignment,
             ctx_a.admitted, ctx_a.wait)
        assert stale.quality != a.quality
