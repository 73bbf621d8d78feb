"""The port's K-lane engine (`parallel.lanes`: the partition, the fence-
exact gate, the lane solve over a leading lane axis, the screens, the host
fence twins and `LaneSolver`; `framework.laned_cycle.LanedCycle`) against
the JAX package, with tolerance 0 on every output: all are integers or
integer-valued float64.

- `partition_segments` / `lane_of`, `fence_exact`, `lane_screen` /
  `lane_screen_fit` and `_fence_refine` against JAX's on inputs made with
  numpy from a seed.
- `LaneSolver.solve` at K in {1, 2, 4} in every dispatch mode against
  JAX's: outputs and `LaneStats`. The fused lane program runs one step
  body over the lane axis: its dispatched ops do not grow with K, it
  raises no warning (vmap's per-example fallback warns) and reads nothing
  on the host.
- The decision tables of `tests/test_lanes.py` run again on the port,
  every JAX name they call swapped for the port's; the bench-line case
  runs as config 15's bench runner (`tests/torch_lane_cases.py`) in both
  packages, against `bench.lane_scaling` too.
- `tests/test_differential.py` TestLanedCycleEquivalence's two rosters:
  the port's `LanedCycle`, report by report and final store, against JAX's
  serial `run_cycle` (slow marks where JAX has them).
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.parallel.lanes as port_lanes
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.serving.engine as port_engine
from scheduler_plugins_tpu_torch.device import to_device
from scheduler_plugins_tpu_torch.framework import (
    LanedCycle as PLanedCycle,
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.framework.plugin import Plugin as PPlugin
from scheduler_plugins_tpu_torch.models import scenarios as port_scenarios
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.tuning.gates import pod_fit_demand_np
from scheduler_plugins_tpu_torch.utils import observability as port_obs
import torch_lane_cases as lane_cases

try:
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.models as jax_scenarios
    import scheduler_plugins_tpu.parallel.lanes as jax_lanes
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.serving as jax_serving
    import tests.test_lanes as jax_tables
    from scheduler_plugins_tpu.framework import (
        LanedCycle as JLanedCycle,
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.framework.plugin import Plugin as JPlugin
    from scheduler_plugins_tpu.serving import (
        ServeEngine as JServeEngine,
        StreamingServeEngine as JStreamingServeEngine,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    import tests.test_differential as jax_differential
except ImportError:
    jax_objects = None

CPU = "cpu"
GIB = 1 << 30
FLAGSHIP = ("NodeResourcesAllocatable", "Coscheduling", "CapacityScheduling")


@pytest.fixture(autouse=True)
def jax_package():
    if jax_objects is None:
        pytest.skip("the JAX package is not importable here")


def _port():
    return SimpleNamespace(
        o=port_objects, Cluster=PCluster, Scheduler=PScheduler,
        Profile=PProfile, plugins=port_plugins, Plugin=PPlugin,
        scenarios=port_scenarios, lanes=port_lanes,
        snapshot=lambda c, pending, now, dev=CPU: c.snapshot(
            pending, now_ms=now, device=dev),
        serial=lambda s, snap, dev=CPU: tuple(
            x.cpu().numpy() for x in _triple(s.solve(snap, device=dev))),
        LaneSolver=lambda s, k, part, disp, dev=CPU: port_lanes.LaneSolver(
            s, k=k, partition=part, dispatch=disp, device=dev),
        Engine=_CPUServeEngine, StreamingEngine=_CPUStreamingEngine,
        Laned=lambda s, c, e: PLanedCycle(s, c, k=4, dispatch="fused",
                                          serve=e, async_bind=True,
                                          device=CPU),
        run=lambda s, c, now, e: port_cycle.run_cycle(
            s, c, now=now, serve=e, device=CPU),
    )


def _jax():
    return SimpleNamespace(
        o=jax_objects, Cluster=JCluster, Scheduler=JScheduler,
        Profile=JProfile, plugins=jax_plugins, Plugin=JPlugin,
        scenarios=jax_scenarios, lanes=jax_lanes,
        snapshot=lambda c, pending, now, dev=None: c.snapshot(
            pending, now_ms=now),
        serial=lambda s, snap, dev=None: tuple(
            np.asarray(x) for x in _triple(s.solve(snap, mode="sequential"))),
        LaneSolver=lambda s, k, part, disp, dev=None: jax_lanes.LaneSolver(
            s, k=k, partition=part, dispatch=disp),
        Engine=JServeEngine, StreamingEngine=JStreamingServeEngine,
        Laned=lambda s, c, e: JLanedCycle(s, c, k=4, dispatch="fused",
                                          serve=e, async_bind=True),
        run=lambda s, c, now, e: jax_cycle.run_cycle(s, c, now=now, serve=e),
    )


def _triple(result):
    return result.assignment, result.admitted, result.wait


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


def _profile(pkg, names=FLAGSHIP):
    return pkg.Scheduler(pkg.Profile(
        plugins=[getattr(pkg.plugins, n)() for n in names]))


# --- the partition -----------------------------------------------------------

def partition_cluster(pkg, seed):
    """60 pods over six namespaces, three registered gangs and one pod
    labelled for a group that is not registered yet."""
    o = pkg.o
    rng = np.random.default_rng(seed)
    c = pkg.Cluster()
    c.enable_pending_index()
    for g in range(3):
        c.add_pod_group(o.PodGroup(name=f"g{g}", namespace=f"t{g}",
                                   min_member=2))
    pods = []
    for i in range(60):
        ns = f"t{int(rng.integers(0, 6))}"
        labels = {}
        r = rng.random()
        if r < 0.25:
            g = int(rng.integers(0, 3))
            ns, labels = f"t{g}", {o.POD_GROUP_LABEL: f"g{g}"}
        elif r < 0.3:
            ns, labels = "t0", {o.POD_GROUP_LABEL: "late"}
        pod = o.Pod(name=f"p{i:03d}", namespace=ns, creation_ms=i,
                    labels=labels, containers=[o.Container(
                        requests={"cpu": 100})])
        c.add_pod(pod)
        pods.append(pod)
    return c, pods


def _same_partition(a, b):
    lanes_a, seg_a, los_a, keys_a, fresh_a = a
    lanes_b, seg_b, los_b, keys_b, fresh_b = b
    assert [list(x) for x in lanes_a] == [list(x) for x in lanes_b]
    np.testing.assert_array_equal(seg_a, seg_b)
    np.testing.assert_array_equal(los_a, los_b)
    assert list(keys_a) == list(keys_b)
    assert list(fresh_a) == list(fresh_b)


class TestPartition:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("mode", ["namespace", "hash"])
    def test_partition_segments_equal_jax(self, seed, mode):
        (jc, jpods), (pc, ppods) = (partition_cluster(pkg, seed)
                                    for pkg in (_jax(), _port()))
        for k in (1, 2, 3, 4, 8):
            _same_partition(
                port_lanes.partition_segments(ppods, pc, k, mode),
                jax_lanes.partition_segments(jpods, jc, k, mode))
            assert (port_lanes.partition_lanes(ppods, pc, k, mode)
                    == jax_lanes.partition_lanes(jpods, jc, k, mode))

    def test_key_cache_and_gang_label_holdout_equal_jax(self):
        """With caller-owned key caches: the second call hits, the orphan
        (a group label without its PodGroup) stays out of the cache and
        re-keys every call, then flips to its gang key once the group
        registers; every output and both caches equal JAX's."""
        sides = [(pkg, *partition_cluster(pkg, 2), {})
                 for pkg in (_jax(), _port())]
        for step in range(3):
            if step == 2:
                for pkg, c, _, _ in sides:
                    c.add_pod_group(pkg.o.PodGroup(name="late",
                                                   namespace="t0"))
            (_, jc, jpods, jcache), (_, pc, ppods, pcache) = sides
            got = port_lanes.partition_segments(ppods, pc, 4, "namespace",
                                                pcache)
            want = jax_lanes.partition_segments(jpods, jc, 4, "namespace",
                                                jcache)
            _same_partition(got, want)
            assert pcache == jcache
            orphans = [i for i, p in enumerate(ppods)
                       if p.pod_group() == "late"]
            assert orphans
            if step == 1:
                assert list(got[4]) == orphans
        assert all(pcache[ppods[i].uid].startswith("gang:") for i in orphans)

    def test_lane_of_equal_jax(self):
        rng = np.random.default_rng(3)
        keys = [f"ns:tenant-{int(x)}" for x in rng.integers(0, 10**6, 200)]
        for k in (1, 2, 3, 4, 8, 13):
            assert ([port_lanes.lane_of(key, k) for key in keys]
                    == [jax_lanes.lane_of(key, k) for key in keys])
            assert ([port_lanes.lane_key(p, None, "hash")
                     for p in partition_cluster(_port(), 0)[1]]
                    == [jax_lanes.lane_key(p, None, "hash")
                        for p in partition_cluster(_jax(), 0)[1]])


# --- the fence-exact gate ----------------------------------------------------

def _gate_plugin(pkg):
    class Gate(pkg.Plugin):
        """An admit plugin the fence has no host twin for."""

        name = "Gate"

        def admit(self, state, snap, p):
            return None

        def admit_rows(self, state, snap, rows):
            return None

    return Gate()


def gate_case(pkg, name):
    """(scheduler, snapshot) of one row of the fence-exact gate."""
    o, sc = pkg.o, pkg.scenarios
    sched = _profile(pkg)
    if name in ("clean", "admit"):
        c = sc.gang_quota_scenario(2, 4, 8)
        if name == "admit":
            sched = pkg.Scheduler(pkg.Profile(
                plugins=[pkg.plugins.NodeResourcesAllocatable(),
                         _gate_plugin(pkg)]))
    elif name == "scheduling":
        c = sc.allocatable_scenario(4, 8)
        node = next(iter(c.nodes.values()))
        node.taints.append(o.Taint(key="dedicated"))
    elif name == "network":
        c = sc.network_scenario(8, 8)
    elif name == "numa":
        c = sc.numa_scenario(8, 8, zones=2)
    elif name in ("nominees", "quota_nominees"):
        c = pkg.Cluster()
        c.add_node(o.Node(name="n0", allocatable={
            "cpu": 16_000, "memory": 64 * GIB, "pods": 110}))
        c.add_quota(o.ElasticQuota(
            name="eq", namespace="team", min={"cpu": 4000},
            max={"cpu": 8000}))
        nominee = o.Pod(name="nom", namespace="team", creation_ms=5,
                        containers=[o.Container(requests={"cpu": 500})])
        nominee.nominated_node_name = "n0"
        c.add_pod(nominee)
        c.add_pod(o.Pod(name="p0", namespace="team", creation_ms=10,
                        containers=[o.Container(requests={"cpu": 500})]))
    snap, _ = pkg.snapshot(c, c.pending_pods(), 1000)
    if name == "quota_nominees":
        # the quota's nominee rows alone couple the admit to placed_mask
        snap = snap.replace(nominees=None)
    return sched, snap


GATE_ROWS = ("clean", "scheduling", "network", "numa", "nominees",
             "quota_nominees", "admit")


@pytest.mark.parametrize("name", GATE_ROWS)
def test_fence_exact_equal_jax(name):
    got = port_lanes.fence_exact(*gate_case(_port(), name))
    want = jax_lanes.fence_exact(*gate_case(_jax(), name))
    assert got == want
    assert got[0] == (name == "clean")
    assert got[1] == {"clean": None, "admit": "admit:Gate"}.get(name, name)


# --- the screens and the refine, on numpy-made inputs ------------------------

def screen_inputs(seed, k=3, P=64, N=6, R=4, S=5, Q=4, G=3):
    """Tight random screen inputs: small free capacity against the
    lanes' speculative placements, so every branch flags pods."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 6, (P, R)).astype(np.int64)
    seg_of_pod = rng.integers(0, S, P)
    lane_of_seg = rng.integers(0, k, S).astype(np.int32)
    demand = pod_fit_demand_np(req)
    seg_mx = np.full((S, R), -np.inf)
    seg_mn = np.full((S, R), np.inf)
    for s in range(S):
        rows = demand[seg_of_pod == s]
        if len(rows):
            seg_mx[s], seg_mn[s] = rows.max(0), rows.min(0)
    return dict(
        req=req, pod_mask=rng.random(P) < 0.9, gated=rng.random(P) < 0.1,
        free0=rng.integers(4, 30, (N, R)).astype(np.int64),
        node_mask=rng.random(N) < 0.85,
        assignment=rng.integers(-1, N, P).astype(np.int32),
        lane_of_pod=lane_of_seg[seg_of_pod].astype(np.int32),
        seg_mx=seg_mx, seg_mn=seg_mn, lane_of_seg=lane_of_seg,
        ns=rng.integers(0, Q, P).astype(np.int32), qm=rng.random(Q) < 0.7,
        q_min=rng.integers(20, 120, (Q, R)).astype(np.int64),
        q_max=rng.integers(10, 60, (Q, R)).astype(np.int64),
        eq_used0=rng.integers(0, 20, (Q, R)).astype(np.int64),
        gang=rng.integers(-1, G, P).astype(np.int32),
        g_slack=rng.integers(0, 10, (G, R)).astype(np.int64),
        g_min_res=rng.integers(20, 90, (G, R)).astype(np.int64),
        g_has_min_res=rng.random(G) < 0.8,
        infl_used0=rng.integers(0, 10, (G, R)).astype(np.int64),
    )


CORE = ("req", "pod_mask", "gated", "free0", "node_mask", "assignment",
        "lane_of_pod", "seg_mx", "seg_mn", "lane_of_seg")
QUOTA = ("ns", "qm", "q_min", "q_max", "eq_used0")
GANG = ("gang", "g_slack", "g_min_res", "g_has_min_res", "infl_used0")


class TestScreen:
    @pytest.mark.parametrize("quota_on", [False, True])
    @pytest.mark.parametrize("gang_on", [False, True])
    def test_lane_screen_equal_jax(self, quota_on, gang_on):
        """Over four seeds: `fit_unsafe` and `flagged` equal JAX's, and
        each branch that is on flags some pod."""
        k = 3
        flagged_any = False
        for seed in range(4):
            x = screen_inputs(seed)

            def args(conv):
                return (tuple(conv(x[n]) for n in CORE),
                        tuple(conv(x[n]) for n in QUOTA) if quota_on else (),
                        tuple(conv(x[n]) for n in GANG) if gang_on else ())

            unsafe, flagged = port_lanes.lane_screen(k,
                                                     *args(torch.from_numpy))
            j_unsafe, j_flagged = jax_lanes.lane_screen_fn(
                k, quota_on, gang_on)(*args(jnp.asarray))
            assert bool(unsafe) == bool(j_unsafe)
            np.testing.assert_array_equal(flagged.numpy(),
                                          np.asarray(j_flagged))
            flagged_any |= bool(flagged.any())
        assert flagged_any == (quota_on or gang_on)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_lane_screen_fit_equal_jax(self, seed):
        x = screen_inputs(seed)
        cols = CORE[:7]
        got = port_lanes.lane_screen_fit(
            3, *(torch.from_numpy(x[n]) for n in cols))
        want = jax_lanes.lane_screen_fit_fn(3)(
            *(jnp.asarray(x[n]) for n in cols))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


def fence_tables(lanes_mod, x, admit_plugins):
    demand = pod_fit_demand_np(x["req"])
    gang_min = np.full(3, 2, np.int32)
    return lanes_mod._FenceTables(
        req=x["req"].copy(), demand=demand, ns=x["ns"].copy(),
        gang=x["gang"].copy(), ok0=x["pod_mask"] & ~x["gated"],
        node_mask=x["node_mask"].copy(), has_quota=x["qm"].copy(),
        eq_min=x["q_min"].copy(), eq_max=x["q_max"].copy(),
        g_min_member=gang_min, g_total=np.full(3, 4, np.int32),
        g_gated=np.zeros(3, np.int32), g_backed_off=np.zeros(3, bool),
        g_slack=x["g_slack"].copy(), g_min_res=x["g_min_res"].copy(),
        g_has_min_res=x["g_has_min_res"].copy(),
        g_assigned=np.zeros(3, np.int32), admit_plugins=list(admit_plugins),
    )


def test_fence_refine_equal_jax():
    """`_fence_refine` on the screen's numpy inputs, every pod a
    candidate: the conflict position and the committed state at it equal
    JAX's, over seeds and admit-plugin orders, both outcomes seen."""
    outcomes = set()
    for seed in range(6):
        x = screen_inputs(seed)
        if seed == 5:
            # nothing placed: every lane mirror equals the committed state
            x["assignment"] = np.full_like(x["assignment"], -1)
        for admit in ((), ("gang", "quota"), ("quota", "gang")):
            cands = np.flatnonzero(x["pod_mask"] & ~x["gated"])
            res = []
            for mod in (port_lanes, jax_lanes):
                res.append(mod._fence_refine(
                    fence_tables(mod, x, admit), x["free0"], x["eq_used0"],
                    x["infl_used0"], x["assignment"], x["lane_of_pod"],
                    cands, 3))
            (p_at, p_state), (j_at, j_state) = res
            assert p_at == j_at
            outcomes.add(p_at >= 0)
            if p_at >= 0:
                for f in ("free", "total_free", "eq_used", "gang_inflight"):
                    np.testing.assert_array_equal(getattr(p_state, f),
                                                  getattr(j_state, f))
            else:
                assert p_state is None and j_state is None
    assert outcomes == {True, False}


# --- LaneSolver.solve against JAX's ------------------------------------------

def tenants_cluster(pkg):
    """Five small nodes and 48 pods over six namespaces: more demand than
    capacity, so lanes collide."""
    o = pkg.o
    rng = np.random.default_rng(11)
    c = pkg.Cluster()
    for i in range(5):
        c.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": int(rng.integers(2000, 6000)), "memory": 16 * GIB,
            "pods": 32}))
    for i in range(48):
        c.add_pod(o.Pod(
            name=f"p{i:03d}", namespace=f"t{int(rng.integers(0, 6))}",
            creation_ms=i, priority=int(rng.integers(0, 3)),
            containers=[o.Container(requests={
                "cpu": int(rng.integers(100, 1500)), "memory": GIB})]))
    return c, ("NodeResourcesAllocatable",)


def gang_quota_cluster(pkg):
    """Six nodes, two quota'd namespaces and a free one, two gangs (one
    with MinResources) and contended singles: the flagship profile."""
    o = pkg.o
    rng = np.random.default_rng(12)
    c = pkg.Cluster()
    for i in range(6):
        c.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 8000, "memory": 32 * GIB, "pods": 16}))
    for ns in ("t0", "t1"):
        c.add_quota(o.ElasticQuota(
            name=f"eq-{ns}", namespace=ns,
            min={"cpu": 6000, "memory": 16 * GIB},
            max={"cpu": 14_000, "memory": 48 * GIB}))
    c.add_pod_group(o.PodGroup(name="g0", namespace="t0", min_member=3))
    c.add_pod_group(o.PodGroup(name="g1", namespace="t2", min_member=2,
                               min_resources={"cpu": 30_000}))
    serial = 0
    for gname, ns, n in (("g0", "t0", 4), ("g1", "t2", 3)):
        for m in range(n):
            serial += 1
            c.add_pod(o.Pod(
                name=f"{gname}-m{m}", namespace=ns, creation_ms=serial,
                labels={o.POD_GROUP_LABEL: gname},
                containers=[o.Container(requests={
                    "cpu": 2000, "memory": 2 * GIB})]))
    for i in range(36):
        serial += 1
        c.add_pod(o.Pod(
            name=f"p{i:03d}", namespace=f"t{int(rng.integers(0, 4))}",
            creation_ms=serial, priority=int(rng.integers(0, 3)),
            containers=[o.Container(requests={
                "cpu": int(rng.integers(200, 3000)),
                "memory": int(rng.integers(1, 4)) * GIB})]))
    return c, FLAGSHIP


def nominee_cluster(pkg):
    """A nominated pod: the gate rejects the snapshot ("nominees")."""
    o = pkg.o
    c = pkg.Cluster()
    c.add_node(o.Node(name="n0", allocatable={
        "cpu": 16_000, "memory": 64 * GIB, "pods": 110}))
    nominee = o.Pod(name="nom", creation_ms=5, containers=[o.Container(
        requests={"cpu": 500, "memory": GIB})])
    nominee.nominated_node_name = "n0"
    c.add_pod(nominee)
    for i in range(4):
        c.add_pod(o.Pod(name=f"p{i}", namespace=f"t{i}", creation_ms=10 + i,
                        containers=[o.Container(requests={
                            "cpu": 500, "memory": GIB})]))
    return c, ("NodeResourcesAllocatable",)


SOLVE_CLUSTERS = {"tenants": tenants_cluster,
                  "gang_quota": gang_quota_cluster,
                  "nominees": nominee_cluster}


def solve_inputs(pkg, name):
    cluster, names = SOLVE_CLUSTERS[name](pkg)
    sched = _profile(pkg, names)
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = pkg.snapshot(cluster, pending, 1000)
    sched.prepare(meta, cluster)
    return sched, cluster, pending, snap, meta


STAT_FIELDS = ("path", "sizes", "committed", "conflicts", "re_resolved",
               "serial_fallback_reason")
_JAX_SOLVES: dict = {}


def jax_lane_solve(name, k, partition):
    key = (name, k, partition)
    if key not in _JAX_SOLVES:
        sched, cluster, pending, snap, meta = solve_inputs(_jax(), name)
        solver = jax_lanes.LaneSolver(sched, k=k, partition=partition)
        out = solver.solve(snap, pending, cluster, meta=meta)
        solver.close()
        _JAX_SOLVES[key] = tuple(np.asarray(o) for o in out[:4]) + (out[4],)
    return _JAX_SOLVES[key]


class TestLaneSolver:
    @pytest.mark.parametrize("name", sorted(SOLVE_CLUSTERS))
    @pytest.mark.parametrize("k", [1, 2, 4])
    @pytest.mark.parametrize("dispatch", ["fused", "threads", "sequential"])
    def test_solve_equal_jax(self, name, k, dispatch):
        """Outputs and `LaneStats` equal JAX's (its fused solve: its
        dispatch modes agree with each other by its own tests), with every
        warning an error."""
        want = jax_lane_solve(name, k, "namespace")
        sched, cluster, pending, snap, meta = solve_inputs(_port(), name)
        solver = port_lanes.LaneSolver(sched, k=k, dispatch=dispatch,
                                       device=CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = solver.solve(snap, pending, cluster, meta=meta)
        solver.close()
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        for f in STAT_FIELDS:
            assert getattr(got[4], f) == getattr(want[4], f), f
        if dispatch == "fused" or got[4].path == "serial":
            assert got[4].lane_ms == []
        else:
            assert len(got[4].lane_ms) == k

    def test_cases_exercise_the_fence(self):
        """The clusters above reach what they are for: a conflict and a
        repair at K = 4 on both laned clusters, the gate's fallback on the
        nominee one."""
        for name in ("tenants", "gang_quota"):
            stats = jax_lane_solve(name, 4, "namespace")[4]
            assert stats.path == "laned" and sum(stats.conflicts) == 1
            assert stats.re_resolved > 0
        assert jax_lane_solve("nominees", 4, "namespace")[4] \
            .serial_fallback_reason == "nominees"

    @pytest.mark.parametrize("k", [2, 4])
    def test_hash_partition_equal_jax(self, k):
        want = jax_lane_solve("tenants", k, "hash")
        sched, cluster, pending, snap, meta = solve_inputs(_port(),
                                                           "tenants")
        solver = port_lanes.LaneSolver(sched, k=k, partition="hash",
                                       device=CPU)
        got = solver.solve(snap, pending, cluster, meta=meta)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        for f in STAT_FIELDS:
            assert getattr(got[4], f) == getattr(want[4], f), f

    def test_cross_cycle_caches_equal_jax(self):
        """Two solves of one solver (the key cache and the segment demand
        extremes warm on the second) and a resource axis change (both
        dropped) keep every output equal to JAX's."""
        outs = {}
        for side, pkg in (("jax", _jax()), ("port", _port())):
            sched, cluster, pending, snap, meta = solve_inputs(pkg,
                                                               "tenants")
            solver = pkg.LaneSolver(sched, 4, "namespace", "fused")
            runs = [solver.solve(snap, pending, cluster, meta=meta)
                    for _ in range(2)]
            runs.append(solver.solve(snap, pending, cluster))
            solver.close()
            outs[side] = [(tuple(np.asarray(o) for o in r[:4]),
                           [getattr(r[4], f) for f in STAT_FIELDS])
                          for r in runs]
            outs[side + "_cache"] = dict(solver._seg_stats)
        for (g, gs), (w, ws) in zip(outs["port"], outs["jax"]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
            assert gs == ws
        assert outs["port_cache"].keys() == outs["jax_cache"].keys()
        for key, (mx, mn) in outs["port_cache"].items():
            np.testing.assert_array_equal(mx, outs["jax_cache"][key][0])
            np.testing.assert_array_equal(mn, outs["jax_cache"][key][1])


class TestLaneProgram:
    """The fused lane program itself: one step body over the lane axis."""

    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    def _program_ops(self, k, steps=8, name="gang_quota"):
        sched, _, pending, snap, _ = solve_inputs(_port(), name)
        plugins = tuple(sched.profile.plugins)
        state0 = sched.initial_state(snap)
        auxes = tuple(p.aux() for p in plugins)
        idx = torch.arange(k * steps).reshape(k, steps) % len(pending)
        live = torch.ones(k, steps, dtype=torch.bool)
        ops, calls = [], []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        step = port_lanes._solve_step

        def counted(*a, **kw):
            calls.append(1)
            return step(*a, **kw)

        port_lanes._solve_step = counted
        try:
            with warnings.catch_warnings(), Log():
                warnings.simplefilter("error")
                out = port_lanes.lane_solve(plugins, snap, state0, auxes,
                                            idx, live)
        finally:
            port_lanes._solve_step = step
        assert [o.shape for o in out] == [(k, steps)] * 3
        return ops, len(calls)

    @pytest.mark.parametrize("name", ["tenants", "gang_quota"])
    def test_ops_do_not_grow_with_k(self, name):
        """K = 4 dispatches exactly the ATen ops of K = 1 (no loop over
        the lanes, neither in Python nor in a batching rule: `index_add`'s
        loops over the batch, which is why the step's commits scatter),
        and the step body runs once a step, not once a lane."""
        ops1, calls1 = self._program_ops(1, name=name)
        ops4, calls4 = self._program_ops(4, name=name)
        assert calls1 == calls4 == 8
        assert sorted(ops1) == sorted(ops4)

    def test_no_host_reads(self):
        ops, _ = self._program_ops(4)
        assert ops
        assert not [op for op in ops if op.split(".")[0] in self.HOST_READS]


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card (CUDA is not available)")
        return torch.device("cuda")

    @pytest.fixture(autouse=True)
    def jax_package(self):
        """The card test needs no JAX: it overrides the module's guard."""

    @pytest.mark.parametrize("dispatch", ["fused", "threads"])
    @pytest.mark.parametrize("name", ["tenants", "gang_quota"])
    def test_card_equals_cpu_without_host_reads(self, card, name,
                                                dispatch):
        """The fused lane program on the card reads nothing on the host
        (sync-debug "error" raises on a sync), and the whole K = 4 solve
        on the card, fused or on K threads sharing the card's stream,
        equals the CPU's."""
        outs = []
        for device in (card, torch.device(CPU)):
            pkg = _port()
            cluster, names = SOLVE_CLUSTERS[name](pkg)
            sched = _profile(pkg, names)
            pending = sched.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = cluster.snapshot(pending, now_ms=1000,
                                          device=device)
            sched.prepare(meta, cluster)
            if device.type == "cuda":
                plugins = tuple(sched.profile.plugins)
                state0 = sched.initial_state(snap)
                auxes = tuple(p.aux() for p in plugins)
                idx = to_device(
                    np.arange(16).reshape(4, 4) % len(pending), device)
                live = to_device(np.ones((4, 4), bool), device)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    port_lanes.lane_solve(plugins, snap, state0, auxes,
                                          idx, live)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            solver = port_lanes.LaneSolver(sched, k=4, dispatch=dispatch,
                                           device=device)
            outs.append(solver.solve(snap, pending, cluster, meta=meta))
            solver.close()
        for g, w in zip(outs[0][:4], outs[1][:4]):
            np.testing.assert_array_equal(g, w)
        for f in STAT_FIELDS:
            assert getattr(outs[0][4], f) == getattr(outs[1][4], f)


# --- the JAX decision tables on the port ------------------------------------

#: the bench-line case runs below as config 15's bench runner in both
#: packages
REWRITTEN = {"test_lane_scaling_micro_line"}


def _tables():
    if jax_objects is None:
        return []
    classes = [jax_tables.TestPartition, jax_tables.TestConflictFence,
               jax_tables.TestSerialFallbackGate,
               jax_tables.TestLaneDispatchModes, jax_tables.TestLateLaneBinds,
               jax_tables.TestLaneBenchMicro]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_") and name not in REWRITTEN]


def _swap_in_port(monkeypatch):
    swaps = {
        "Container": port_objects.Container,
        "ElasticQuota": port_objects.ElasticQuota,
        "Node": port_objects.Node,
        "Pod": port_objects.Pod,
        "PodGroup": port_objects.PodGroup,
        "POD_GROUP_LABEL": port_objects.POD_GROUP_LABEL,
        "LanedCycle": lambda *a, **kw: PLanedCycle(*a, device=CPU, **kw),
        "Profile": PProfile,
        "Scheduler": PScheduler,
        "run_cycle": lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now, device=CPU, **kw),
        "LaneSolver": lambda *a, **kw: port_lanes.LaneSolver(
            *a, device=CPU, **kw),
        "fence_exact": port_lanes.fence_exact,
        "lane_key": port_lanes.lane_key,
        "lane_of": port_lanes.lane_of,
        "partition_lanes": port_lanes.partition_lanes,
        "CapacityScheduling": port_plugins.CapacityScheduling,
        "Coscheduling": port_plugins.Coscheduling,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "Cluster": _CPUCluster,
        "obs": port_obs,
    }
    for name, value in swaps.items():
        assert hasattr(jax_tables, name), name
        monkeypatch.setattr(jax_tables, name, value)
    # the names the cases import inside their bodies
    monkeypatch.setattr(jax_lanes, "partition_segments",
                        port_lanes.partition_segments)
    monkeypatch.setattr(jax_serving, "StreamingServeEngine",
                        _CPUStreamingEngine)


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_lanes.py` (but the one in `REWRITTEN`)
    with every JAX name it calls, at module level and in its body's
    imports, swapped for the port's."""
    _swap_in_port(monkeypatch)
    getattr(cls(), method)()


# --- config 15's bench runner, both packages ------------------------------

MICRO = lane_cases.LANE_MICRO_SHAPE
NON_TIMING = ("digests_match", "conflicts", "re_resolved",
              "serial_fallbacks", "capacity_violations")


@pytest.fixture(scope="module")
def micro_lines():
    import bench

    arms = lane_cases.bench_arms(MICRO, CPU)
    return {
        "port": lane_cases.lane_scaling(_port(), MICRO, arms),
        "jax": lane_cases.lane_scaling(_jax(), MICRO),
        "bench": bench.lane_scaling(shape=MICRO, emit=False),
    }


class TestConfig15Micro:
    def test_line_equals_jax_and_bench(self, micro_lines):
        port, jax_line, bench_line = (micro_lines[k]
                                      for k in ("port", "jax", "bench"))
        for key in NON_TIMING:
            assert port[key] == jax_line[key] == bench_line[key], key
        assert port["digests_match"] and port["conflicts"] > 0
        assert port["re_resolved"] > 0 and port["capacity_violations"] == 0
        assert port["serial_fallbacks"] == 0
        assert port["digests"] == jax_line["digests"]
        assert port["lanes"]["contended"] == bench_line["lanes"]["contended"]
        for arm, rec in port["arms"].items():
            want = jax_line["arms"][arm]["cycles"]
            assert [r["digest"] for r in rec["cycles"]] == [
                r["digest"] for r in want]
            for f in STAT_FIELDS:
                assert [r.get(f) for r in rec["cycles"]] == [
                    r.get(f) for r in want], (arm, f)
        curve = {c["k"]: c for c in port["lanes"]["curve"]}
        assert set(curve) == {1, 2}
        for c in curve.values():
            for col in ("ratio", "ratio_full", "ratio_wall",
                        "pods_per_sec", "conflicts", "re_resolved",
                        "serial_fallbacks", "partition_ms_mean",
                        "max_lane_ms_mean", "fence_ms_mean"):
                assert col in c, col
        assert port["lane_ratio"] == curve[2]["ratio"]

    def test_every_dispatch_every_cycle(self, micro_lines):
        """The card's arms (the serial reference and fused K = 2 and 4
        every cycle; a second serial arm on the timed and contended
        cycles; threads and sequential K = 4 on the timed cycle) on the
        micro shape: every cycle's digest equals the serial solve's and
        JAX's."""
        arms = [("serial", 0, None, CPU, None),
                ("serial_card", 0, None, CPU, ("timed", "contended")),
                ("f2", 2, "fused", CPU, None),
                ("f4", 4, "fused", CPU, None),
                ("t4", 4, "threads", CPU, ("timed",)),
                ("s4", 4, "sequential", CPU, ("timed",))]
        line = lane_cases.lane_scaling(_port(), MICRO, arms)
        assert line["digests_match"] and line["conflicts"] > 0
        assert line["digests"] == micro_lines["jax"]["digests"]
        assert len(line["arms"]["t4"]["cycles"]) == line["lanes"][
            "timed_cycles"]
        assert len(line["arms"]["serial_card"]["cycles"]) == line["lanes"][
            "timed_cycles"] + line["lanes"]["contended"]["cycles"]

    def test_engine_equals_jax_serial_cycle(self):
        """The stream through the port's `LanedCycle` (K = 4, fused, async
        bind, streaming engine) equals JAX's serial `run_cycle`, cycle by
        cycle and in the final store, with conflicts on the contended
        cycle."""
        got, got_final, _ = lane_cases.lane_engine_run(_port(), MICRO, True)
        want, want_final, _ = lane_cases.lane_engine_run(_jax(), MICRO,
                                                         False)
        assert [g[:4] for g in got] == [w[:4] for w in want]
        assert got_final == want_final
        assert sum(sum(g[4]["conflicts"]) for g in got) > 0
        assert all(g[4]["path"] == "laned" for g in got)


# --- TestLanedCycleEquivalence's rosters ------------------------------------

def plain_roster(k):
    """`_run_plain(k)` on the port: six nodes, pods over three
    namespaces, a node added, a pod that fits nowhere, a departure and a
    drain-then-delete, through `LanedCycle` (the streaming engine attached
    to the store, as JAX's roster does)."""
    o = port_objects
    rng = np.random.default_rng(23)

    def node(i):
        return o.Node(name=f"n{i:03d}", allocatable={
            "cpu": 8000, "memory": 32 * GIB, "pods": 32},
            labels={o.REGION_LABEL: "r1", o.ZONE_LABEL: f"z{i % 2}"})

    cluster = PCluster()
    for i in range(6):
        cluster.add_node(node(i))
    _CPUStreamingEngine().attach(cluster)
    sched = _profile(_port(), ("NodeResourcesAllocatable",))
    laned = PLanedCycle(sched, cluster, k=k, device=CPU)
    serial, reports = 0, []
    for cycle in range(10):
        now = 1000 * (cycle + 1)
        for _ in range(int(rng.integers(1, 4))):
            serial += 1
            cluster.add_pod(o.Pod(
                name=f"p{serial:05d}", namespace=f"ns{serial % 3}",
                creation_ms=now + serial, containers=[o.Container(requests={
                    "cpu": int(rng.integers(200, 2500)), "memory": GIB})]))
        if cycle == 3:
            cluster.add_node(node(40))
        if cycle == 4:
            cluster.add_pod(o.Pod(name="nofit", creation_ms=now + 999,
                                  containers=[o.Container(
                                      requests={"cpu": 10**9})]))
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
        reports.append(laned.tick(now))
    laned.close()
    assert laned.serial_fallbacks == 0
    per_cycle = [(dict(r.bound), dict(r.reserved), list(r.failed),
                  dict(r.failed_by)) for r in reports]
    return per_cycle, {u: p.node_name for u, p in sorted(cluster.pods.items())}


def gang_quota_roster(k):
    """`_run_gang_quota(k)` on the port: eight nodes, an ElasticQuota, the
    flagship profile, a gang every five cycles and random completions."""
    o = port_objects
    rng = np.random.default_rng(5)
    cluster = PCluster()
    for i in range(8):
        cluster.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 16_000, "memory": 64 * GIB, "pods": 30}))
    cluster.add_quota(o.ElasticQuota(
        name="eq", namespace="team",
        min={"cpu": 64_000, "memory": 256 * GIB},
        max={"cpu": 96_000, "memory": 384 * GIB}))
    _CPUStreamingEngine().attach(cluster)
    P = port_plugins
    sched = PScheduler(PProfile(plugins=[
        P.NodeResourcesAllocatable(), P.Coscheduling(permit_waiting_seconds=5),
        P.CapacityScheduling()]))
    laned = PLanedCycle(sched, cluster, k=k, device=CPU)
    serial, reports = 0, []
    for cycle in range(12):
        now = 1000 * (cycle + 1)
        for _ in range(int(rng.integers(0, 5))):
            serial += 1
            cluster.add_pod(o.Pod(
                name=f"p{serial:04d}", namespace="team",
                creation_ms=now + serial, priority=int(rng.integers(0, 5)),
                containers=[o.Container(requests={
                    "cpu": int(rng.integers(200, 4000)),
                    "memory": int(rng.integers(1, 8)) * GIB})]))
        if cycle % 5 == 1:
            gname = f"g{cycle}"
            cluster.add_pod_group(o.PodGroup(
                name=gname, namespace="team", min_member=3, creation_ms=now))
            for m in range(3):
                serial += 1
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
        reports.append(laned.tick(now))
    laned.close()
    assert laned.serial_fallbacks == 0
    per_cycle = [(dict(r.bound), dict(r.reserved), list(r.failed),
                  dict(r.failed_by), list(r.rejected_gangs),
                  dict(r.preempted)) for r in reports]
    return per_cycle, {u: p.node_name for u, p in sorted(cluster.pods.items())}


ROSTERS = {"plain": plain_roster, "gang_quota": gang_quota_roster}


def _roster_equal_jax(roster, k):
    want = jax_differential.TestLanedCycleEquivalence()._serial_baseline(
        roster)
    assert ROSTERS[roster](k) == want


class TestLanedCycleAgainstJax:
    @pytest.mark.parametrize("k", [2])
    def test_plain_roster_identical(self, k):
        _roster_equal_jax("plain", k)

    @pytest.mark.slow
    @pytest.mark.parametrize("k", [1, 4])
    def test_plain_roster_identical_slow(self, k):
        _roster_equal_jax("plain", k)

    @pytest.mark.parametrize("k", [4])
    def test_gang_quota_roster_identical(self, k):
        _roster_equal_jax("gang_quota", k)

    @pytest.mark.slow
    @pytest.mark.parametrize("k", [1, 2])
    def test_gang_quota_roster_identical_slow(self, k):
        _roster_equal_jax("gang_quota", k)

    def test_stats_and_report_lanes(self):
        """`stats()` and `report.lanes` after a contended cycle: the
        fields JAX's engine reports, the conflict counted once."""
        reports = []
        for pkg, laned_cls in ((_jax(), JLanedCycle), (_port(), PLanedCycle)):
            c, names = tenants_cluster(pkg)
            sched = _profile(pkg, names)
            kw = {} if laned_cls is JLanedCycle else {"device": CPU}
            laned = laned_cls(sched, c, k=4, **kw)
            r = laned.tick(1000)
            laned.close()
            st = laned.stats()
            st.pop("last")
            reports.append((dict(r.bound), list(r.failed), dict(r.failed_by),
                            {f: r.lanes[f] for f in STAT_FIELDS}, st))
        assert reports[0] == reports[1]
        assert reports[1][4]["conflicts_total"] == 1
