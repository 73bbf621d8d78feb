"""The port's tuning observatory (`tuning/quality.py`, `tuning/gates.py`,
`tuning/sweep.py`, `parallel/solver.py` `sweep_solve_fn`) against the JAX
package's.

- The quality gauges and hard-constraint oracles on `tests/test_tuning.py`'s
  tables: the round-number two-node cluster with its fixed placements
  (fragmentation, imbalance, unplaced and gang-wait fractions, packed
  utilization with both, one and no node occupied), its gate cases (a fit
  overflow, an out-of-range node, the flagship solve of a gang / quota
  roster and a lone gang member), plus seeded random clusters.
- The JAX decision tables of `tests/test_tuning.py` (TestQualityDecision
  Tables, TestGangLatency, TestGates, TestCandidateWeights, TestSweep
  Parity, TestWeightsRoundTrip, TestCycleQualityStamp) run again on the
  port, every JAX name they call swapped for the port's on the CPU. Two
  cases stay JAX's: `pad_candidates` (the port runs K as given, ROADMAP
  "No eager counterpart") and the one-compile count (the port compiles
  nothing; `TestSweepProgram` holds its counterpart).
- `candidate_weights` equal to JAX's row for row; `sweep_cycle` lane by
  lane equal to JAX's at K in {1, 8, 13} on `trimaran_scenario` and the
  flagship gang + quota profile, each lane equal to the port's
  `Scheduler.solve` under those static weights; `batch_quality`,
  `state_quality` and `score_drift` against JAX's; a sweep step issues
  the same ATen ops at K = 1 and K = 16 and reads nothing on the host.

Tolerances: every integer output, and every gauge that sums exact
integers below 2^53, bit for bit. `util_imbalance` sums non-integer
per-node utilizations, whose float64 sum depends on the reduction order
(XLA's and torch's differ), so it is held to 1e-12 relative where the
inputs are not the tables' round numbers. Gate counts: tolerance 0."""

import functools
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.config as port_config
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.framework.runtime as port_runtime
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.utils.flightrec as port_flightrec
import scheduler_plugins_tpu_torch.utils.observability as port_obs
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.models import (
    gang_quota_scenario as port_gang_quota,
)
from scheduler_plugins_tpu_torch.parallel.solver import sweep_solve_fn
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.tuning import gates as t_gates
from scheduler_plugins_tpu_torch.tuning import quality as t_quality
from scheduler_plugins_tpu_torch.tuning import sweep as t_sweep

try:
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.config as j_config
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as j_cycle
    import scheduler_plugins_tpu.models as j_models
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.utils as j_utils
    import tests.test_tuning as jax_tables
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.models import (
        gang_quota_scenario as jax_gang_quota,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    from scheduler_plugins_tpu.models import (
        trimaran_scenario as jax_trimaran,
    )
    from scheduler_plugins_tpu.tuning import gates as j_gates
    from scheduler_plugins_tpu.tuning import quality as j_quality
    from scheduler_plugins_tpu.tuning import sweep as j_sweep
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    jax_objects = None

GIB = 1 << 30
PORT = SimpleNamespace(o=port_objects, Cluster=PCluster, plugins=port_plugins,
                       Profile=PProfile, Scheduler=PScheduler,
                       gang_quota=port_gang_quota,
                       trimaran=port_scenarios.trimaran_scenario,
                       snap=lambda c, pend: c.snapshot(pend, now_ms=0,
                                                       device="cpu"))
JAX = None if jax_objects is None else SimpleNamespace(
    o=jax_objects, Cluster=JCluster, plugins=jax_plugins, Profile=JProfile,
    Scheduler=JScheduler, gang_quota=jax_gang_quota, trimaran=jax_trimaran,
    snap=lambda c, pend: c.snapshot(pend, now_ms=0))


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def tiny_cluster(pkg):
    """`tests/test_tuning.py` `_tiny_cluster`: 2 nodes x 3 pods of round
    numbers."""
    cluster = pkg.Cluster()
    for name, cpu in (("n0", 1000), ("n1", 3000)):
        cluster.add_node(pkg.o.Node(
            name=name, allocatable={"cpu": cpu, "memory": 1000, "pods": 10}))
    for i, (c, m) in enumerate([(500, 200), (1000, 300), (100, 100)]):
        cluster.add_pod(pkg.o.Pod(
            name=f"p{i}", creation_ms=i,
            containers=[pkg.o.Container(requests={"cpu": c, "memory": m})]))
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    return pkg.snap(cluster, pending)[0]


def host_view(snap):
    """Host numpy copies of the columns the gauges and gates read (the
    form `run_cycle` stamps its quality from)."""
    def h(x):
        return x.numpy()

    return SimpleNamespace(
        nodes=SimpleNamespace(alloc=h(snap.nodes.alloc),
                              requested=h(snap.nodes.requested),
                              mask=h(snap.nodes.mask)),
        pods=SimpleNamespace(req=h(snap.pods.req), mask=h(snap.pods.mask)),
        quota=None, gangs=None)


def padded(n, values, fill):
    out = np.full(n, fill, dtype=np.asarray(values).dtype)
    out[: len(values)] = values
    return out


@pytest.fixture(scope="module")
def tiny():
    snap_j, snap_p = tiny_cluster(JAX), tiny_cluster(PORT)
    assert snap_j.num_pods == snap_p.num_pods
    return snap_j, snap_p


#: (assignment of the three real pods, wait of the three): the tables'
#: fixed placements
TABLE = {
    "fixed": ([0, 1, -1], [False, False, False]),
    "gang_wait": ([0, 1, -1], [True, False, False]),
    "only_n0": ([0, -1, -1], [False, False, False]),
    "nothing": ([-1, -1, -1], [False, False, False]),
    "both_on_n0": ([0, 0, -1], [False, False, False]),
    "all_placed": ([0, 1, 1], [False, True, False]),
}


class TestGauges:
    @pytest.mark.parametrize("case", sorted(TABLE))
    def test_cycle_quality_matches_jax(self, tiny, case):
        snap_j, snap_p = tiny
        a, w = TABLE[case]
        assignment = padded(snap_p.num_pods, np.array(a, np.int32), -1)
        wait = padded(snap_p.num_pods, np.array(w), False)
        want = j_quality.cycle_quality(snap_j, assignment, None, wait)
        got = t_quality.cycle_quality(snap_p, assignment, None, wait)
        assert got == want
        assert list(got) == list(t_quality.CYCLE_OBJECTIVES)
        # the tensor form and the cycle's numpy stamp agree too
        assert t_quality.cycle_quality_np(host_view(snap_p), assignment,
                                          None, wait) == want

    def test_hand_computed_table(self, tiny):
        """`tests/test_tuning.py`'s hand-computed values."""
        _, snap = tiny
        n = snap.num_pods
        a = padded(n, np.array([0, 1, -1], np.int32), -1)
        w = padded(n, np.zeros(3, bool), False)
        q = t_quality.cycle_quality(snap, a, None, w)
        frag = ((1 - 2000 / 2500) + (1 - 800 / 1500)) / 2
        u0, u1 = (0.5 + 0.2) / 2, (1000 / 3000 + 0.3) / 2
        mean = (u0 + u1) / 2
        imb = np.sqrt(((u0 - mean) ** 2 + (u1 - mean) ** 2) / 2)
        packed = 1 - ((500 + 2000) / 4000 + (800 + 700) / 2000) / 2
        assert q["fragmentation"] == pytest.approx(frag, abs=1e-12)
        assert q["util_imbalance"] == pytest.approx(imb, abs=1e-12)
        assert q["packed_utilization"] == pytest.approx(packed, abs=1e-12)
        assert q["unplaced_frac"] == pytest.approx(1 / 3, abs=1e-12)
        only = padded(n, np.array([0, -1, -1], np.int32), -1)
        assert t_quality.cycle_quality(snap, only, None, w)[
            "packed_utilization"] == pytest.approx(1 - (0.5 + 0.8) / 2,
                                                   abs=1e-12)
        none = np.full(n, -1, np.int32)
        assert t_quality.cycle_quality(snap, none, None, w)[
            "packed_utilization"] == 0.0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_functions_match_jax_on_random_clusters(self, seed):
        rng = np.random.default_rng(seed)
        N, P = 16, 40
        alloc = np.stack([rng.integers(1000, 64_000, N),
                          rng.integers(1, 256, N) * GIB,
                          np.zeros(N), rng.integers(8, 110, N)],
                         axis=1).astype(np.int64)
        alloc[rng.integers(0, N)] = 0  # a node with nothing allocatable
        free = (alloc * rng.uniform(0, 1, (N, 1))).astype(np.int64)
        idle = rng.random(N) < 0.2  # nothing used: not occupied
        free[idle] = alloc[idle]
        node_mask = rng.random(N) < 0.85
        req = np.stack([rng.integers(100, 2000, P),
                        rng.integers(1, 4, P) * GIB,
                        np.zeros(P), np.zeros(P)], axis=1).astype(np.int64)
        assignment = rng.integers(-1, N, P).astype(np.int32)
        tj = [jnp.asarray(x) for x in (alloc, free, node_mask)]
        tp = [torch.as_tensor(x) for x in (alloc, free, node_mask)]
        assert np.array_equal(
            t_quality.placed_demand(torch.as_tensor(req),
                                    torch.as_tensor(assignment), N).numpy(),
            np.asarray(j_quality.placed_demand(
                jnp.asarray(req), jnp.asarray(assignment), N)))
        assert float(t_quality.fragmentation(tp[1], tp[2])) == float(
            j_quality.fragmentation(tj[1], tj[2]))
        assert float(t_quality.packed_utilization(*tp)) == float(
            j_quality.packed_utilization(*tj))
        assert float(t_quality.util_imbalance(*tp)) == pytest.approx(
            float(j_quality.util_imbalance(*tj)), rel=1e-12)
        assert 0.0 < float(t_quality.util_imbalance(*tp))


class TestGates:
    def test_fit_and_mask_cases_match_jax(self, tiny):
        snap_j, snap_p = tiny
        n = snap_p.num_pods
        cases = {
            "both_heavy_on_n0": [0, 0, -1],
            "ok": [0, 1, 1],
            "out_of_range": [0, 5, -1],
            "none": [-1, -1, -1],
        }
        for name, a in cases.items():
            a = padded(n, np.array(a, np.int32), -1)
            w = np.zeros(n, bool)
            got = t_gates.hard_violations(snap_p, torch.as_tensor(a), w)
            assert got == j_gates.hard_violations(snap_j, a, w), name
            assert got == t_gates.hard_violations(host_view(snap_p), a, w)
        bad = padded(n, np.array([0, 0, -1], np.int32), -1)
        assert t_gates.fit_violations(snap_p, bad) > 0
        # a padded node row is in range: it overflows and is masked
        pad = padded(n, np.array([0, 5, -1], np.int32), -1)
        assert t_gates.mask_violations(snap_p, pad) > 0
        assert t_gates.fit_violations(snap_p, pad) > 0
        # past every row: the mask oracle's alone
        oor = padded(n, np.array([0, 99, -1], np.int32), -1)
        assert t_gates.mask_violations(snap_p, oor) == 1
        assert t_gates.fit_violations(snap_p, oor) == 0
        assert j_gates.hard_violations(snap_j, oor, np.zeros(n, bool)) == (
            t_gates.hard_violations(snap_p, oor, np.zeros(n, bool)))

    def test_pod_fit_demand_matches_jax(self, tiny):
        snap_j, snap_p = tiny
        assert np.array_equal(t_gates.pod_fit_demand_np(snap_p.pods.req),
                              j_gates.pod_fit_demand_np(snap_j.pods.req))

    def test_quota_and_quorum_on_gang_roster(self):
        """The flagship solve of a gang / quota roster is gate-clean in both
        packages; a lone bound member of an unmet gang is one quorum
        violation; placements past a quota's Max count in queue order."""
        out = {}
        for name, pkg in (("jax", JAX), ("port", PORT)):
            cluster = pkg.gang_quota(n_gangs=2, gang_size=4, n_nodes=16)
            sched = pkg.Scheduler(pkg.Profile(plugins=[
                pkg.plugins.NodeResourcesAllocatable(),
                pkg.plugins.Coscheduling(),
                pkg.plugins.CapacityScheduling()]))
            pending = sched.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = pkg.snap(cluster, pending)
            sched.prepare(meta, cluster)
            kw = {"device": "cpu"} if pkg is PORT else {}
            result = sched.solve(snap, **kw)
            out[name] = (snap, np.array(result.assignment),
                         np.array(result.wait))
        (snap_j, a, w), (snap_p, a_p, w_p) = out["jax"], out["port"]
        assert np.array_equal(a, a_p) and np.array_equal(w, w_p)
        gates = (t_gates, j_gates)
        for g, snap in zip(gates, (snap_p, snap_j)):
            assert g.hard_violations(snap, a, w)["total"] == 0
        gang = np.asarray(snap_j.pods.gang)
        g = int(gang[np.argmax(a >= 0)])
        lone = np.full_like(a, -1)
        member = int(np.argmax((gang == g) & (a >= 0)))
        lone[member] = a[member]
        assert int(np.asarray(snap_j.gangs.min_member)[g]) > 1
        assert t_gates.gang_quorum_violations(
            snap_p, lone, np.zeros_like(w)) == j_gates.gang_quorum_violations(
            snap_j, lone, np.zeros_like(w)) == 1

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_quota_and_quorum_tables_match_jax(self, seed):
        """Seeded quota and gang tables (host arrays, the form both
        packages' oracles take): tight Max and aggregate-Min pools and
        gangs part placed, part waiting; the counts equal JAX's and some
        are positive."""
        rng = np.random.default_rng(seed)
        P, NS, G, R = 40, 3, 4, 4
        req = np.stack([rng.integers(100, 900, P), rng.integers(1, 5, P),
                        np.zeros(P), np.zeros(P)], axis=1).astype(np.int64)
        quota = SimpleNamespace(
            has_quota=np.array([True, True, False]),
            max=np.stack([rng.integers(1000, 4000, NS),
                          rng.integers(5, 30, NS), np.zeros(NS),
                          np.full(NS, 100)], axis=1).astype(np.int64),
            min=np.stack([rng.integers(500, 3000, NS),
                          rng.integers(3, 20, NS), np.zeros(NS),
                          np.full(NS, 100)], axis=1).astype(np.int64),
            used=np.zeros((NS, R), np.int64))
        gangs = SimpleNamespace(min_member=rng.integers(1, 6, G),
                                assigned=rng.integers(0, 2, G))
        snap = SimpleNamespace(
            pods=SimpleNamespace(req=req, ns=rng.integers(0, NS, P),
                                 gang=rng.integers(-1, G, P)),
            quota=quota, gangs=gangs)
        assignment = np.where(rng.random(P) < 0.7,
                              rng.integers(0, 8, P), -1).astype(np.int32)
        wait = rng.random(P) < 0.3
        got = (t_gates.quota_violations(snap, assignment),
               t_gates.gang_quorum_violations(snap, assignment, wait))
        assert got == (j_gates.quota_violations(snap, assignment),
                       j_gates.gang_quorum_violations(snap, assignment,
                                                      wait))
        assert sum(got) > 0


# --- the JAX tables of tests/test_tuning.py on the port ----------------------

class _CPUCluster(PCluster):
    def snapshot(self, pending, now_ms=0, device="cpu", **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


class _CPUScheduler(PScheduler):
    """The JAX tables' `solve(snap, auxes=)`: the recorded auxes bound for
    the call, on the CPU."""

    def solve(self, snap, state0=None, *, device="cpu", mode=None,
              auxes=None):
        with port_runtime.bound_auxes(self.profile.plugins, auxes):
            return super().solve(snap, state0, device=device, mode=mode)


#: the JAX tables' cases that stay JAX's (the module docstring says why)
JAX_ONLY = {"test_pad_candidates_power_of_two",
            "test_sweep_compiles_once_and_buckets_candidates"}


def _tables():
    if JAX is None:
        return []
    classes = [jax_tables.TestQualityDecisionTables,
               jax_tables.TestGangLatency, jax_tables.TestGates,
               jax_tables.TestCandidateWeights, jax_tables.TestSweepParity,
               jax_tables.TestWeightsRoundTrip,
               jax_tables.TestCycleQualityStamp]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_") and name not in JAX_ONLY]


def swap_in_port(monkeypatch, tables) -> None:
    """Every JAX name `tables` (a JAX test module) calls, at module level
    and through its bodies' imports, swapped for the port's on the CPU."""
    port_sweep = SimpleNamespace(
        candidate_weights=t_sweep.candidate_weights,
        sweep_cycle=functools.partial(t_sweep.sweep_cycle, device="cpu"))
    swaps = {
        "Container": port_objects.Container, "Node": port_objects.Node,
        "Pod": port_objects.Pod, "Profile": PProfile,
        "Scheduler": _CPUScheduler, "Cluster": _CPUCluster,
        "run_cycle": lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now=now, device="cpu", **kw),
        "gates": t_gates, "quality": t_quality, "sweep": port_sweep,
        "obs": port_obs,
    }
    for name, value in swaps.items():
        if hasattr(tables, name):
            monkeypatch.setattr(tables, name, value)
    monkeypatch.setattr(port_scenarios, "Cluster", _CPUCluster)
    for name in ("trimaran_scenario", "gang_quota_scenario"):
        monkeypatch.setattr(j_models, name, getattr(port_scenarios, name))
    for name in ("TargetLoadPacking", "LoadVariationRiskBalancing",
                 "NodeResourcesAllocatable", "Coscheduling",
                 "CapacityScheduling"):
        monkeypatch.setattr(jax_plugins, name, getattr(port_plugins, name))
    for name in ("load_profile", "profile_spec"):
        monkeypatch.setattr(j_config, name, getattr(port_config, name))
    monkeypatch.setattr(j_cycle, "CycleReport", port_cycle.CycleReport)
    monkeypatch.setattr(j_utils, "flightrec", port_flightrec)


@pytest.mark.parametrize("cls,method", _tables())
def test_decision_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_tuning.py`'s tables (but `JAX_ONLY`), on
    the port."""
    swap_in_port(monkeypatch, jax_tables)
    getattr(cls(), method)()


# --- the sweep against JAX ----------------------------------------------------

class TestCandidateWeightsEqualJax:
    @pytest.mark.parametrize("base", [[1, 1], [1, 20], [3, 1, 1],
                                      [2, 5, 7, 1]])
    @pytest.mark.parametrize("seed", [0, 3, 97])
    def test_rows_equal(self, base, seed):
        for k in (1, 8, 13, 64):
            got = t_sweep.candidate_weights(base, k, seed=seed)
            want = j_sweep.candidate_weights(base, k, seed=seed)
            assert got.dtype == np.int64 and np.array_equal(got, want)

    def test_rejects_nonpositive_base(self):
        with pytest.raises(ValueError):
            t_sweep.candidate_weights([1, 0], 4)


#: the sweep's problems: (scenario builder, its kwargs, plugin names)
SWEEP_PROBLEMS = {
    "trimaran": ("trimaran", dict(n_nodes=32, n_pods=24, seed=1),
                 ("TargetLoadPacking", "LoadVariationRiskBalancing")),
    "flagship": ("gang_quota", dict(n_gangs=2, gang_size=4, n_nodes=16),
                 ("NodeResourcesAllocatable", "Coscheduling",
                  "CapacityScheduling")),
}


def sweep_problem(pkg, name, weights=None):
    """(scheduler, snapshot, meta, cluster) of a `SWEEP_PROBLEMS` entry,
    prepared; `weights` sets the plugins' static weights."""
    builder, kw, names = SWEEP_PROBLEMS[name]
    cluster = getattr(pkg, builder)(**kw)
    plugins = [getattr(pkg.plugins, n)() for n in names]
    for plugin, w in zip(plugins, [1] * len(plugins) if weights is None
                         else weights):
        plugin.weight = int(w)
    sched = pkg.Scheduler(pkg.Profile(plugins=plugins))
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = pkg.snap(cluster, pending)
    sched.prepare(meta, cluster)
    return sched, snap, meta, cluster


class TestSweepEqualJax:
    @pytest.mark.parametrize("name", sorted(SWEEP_PROBLEMS))
    @pytest.mark.parametrize("k", [1, 8, 13])
    def test_lanes_equal_jax_and_static_solves(self, name, k):
        """Every lane (assignment, admitted, wait) equal to JAX's vmapped
        lane and to the port's `Scheduler.solve` on a profile whose static
        weights are the lane's row: tolerance 0."""
        js, jsnap, _, _ = sweep_problem(JAX, name)
        ps, psnap, pmeta, pcluster = sweep_problem(PORT, name)
        L = len(ps.profile.plugins)
        W = t_sweep.candidate_weights([1] * L, k, seed=k)
        want = j_sweep.sweep_cycle(
            js, jsnap, W, auxes=tuple(p.aux() for p in js.profile.plugins))
        got = t_sweep.sweep_cycle(
            ps, psnap, W, auxes=tuple(p.aux() for p in ps.profile.plugins),
            device="cpu")
        for g, w, dtype in zip(got, want, (np.int32, bool, bool)):
            assert g.shape == (k, psnap.num_pods) and g.dtype == dtype
            np.testing.assert_array_equal(g, w)
        for lane in range(k):
            static = sweep_problem(PORT, name, weights=W[lane])[0]
            static.prepare(pmeta, pcluster)
            r = static.solve(psnap, device="cpu")
            for g, field in zip(got, ("assignment", "admitted", "wait")):
                np.testing.assert_array_equal(
                    g[lane], getattr(r, field).numpy(), err_msg=field)

    def test_sweep_moves_placements(self):
        """The trimaran sweep's lanes really differ (a sweep that ignored
        its weights would pass the equalities above only at K = 1)."""
        ps, psnap, _, _ = sweep_problem(PORT, "trimaran")
        W = t_sweep.candidate_weights([1, 1], 8, seed=0)
        A = t_sweep.sweep_cycle(ps, psnap, W, device="cpu")[0]
        assert any((A[k] != A[0]).any() for k in range(1, 8))

    def test_width_mismatch_raises(self):
        ps, psnap, _, _ = sweep_problem(PORT, "trimaran")
        with pytest.raises(ValueError, match="candidate width"):
            t_sweep.sweep_cycle(ps, psnap, np.ones((2, 3), np.int64),
                                device="cpu")


class TestSweepProgram:
    """The vmapped sweep: one program a step, whatever K."""

    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    def _ops(self, name, k):
        sched, snap, _, _ = sweep_problem(PORT, name)
        L = len(sched.profile.plugins)
        W = torch.as_tensor(t_sweep.candidate_weights([1] * L, k, seed=0))
        state0 = sched.initial_state(snap)
        fn = sweep_solve_fn(sched)
        ops, steps = [], []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        step = port_runtime._solve_step

        def counted(*a, **kw):
            steps.append(1)
            return step(*a, **kw)

        port_runtime._solve_step = counted
        try:
            with warnings.catch_warnings(), Log():
                warnings.simplefilter("error")
                out = fn(snap, state0, None, W)
        finally:
            port_runtime._solve_step = step
        assert [o.shape for o in out] == [(k, snap.num_pods)] * 3
        return ops, len(steps), snap.num_pods

    @pytest.mark.parametrize("name", sorted(SWEEP_PROBLEMS))
    def test_ops_do_not_grow_with_k(self, name):
        """K = 16 dispatches exactly the ATen ops of K = 1 (no loop over
        the lanes, in Python or in a batching rule), and the step body
        runs once a pod, not once a lane."""
        ops1, steps1, P = self._ops(name, 1)
        ops16, steps16, _ = self._ops(name, 16)
        assert steps1 == steps16 == P
        assert sorted(ops1) == sorted(ops16)

    def test_no_host_reads(self):
        ops, _, _ = self._ops("flagship", 4)
        assert ops
        assert not [op for op in ops if op.split(".")[0] in self.HOST_READS]


class TestQualityEqualJax:
    def test_batch_quality_on_sweep_lanes(self):
        """`batch_quality` of the trimaran sweep's 8 lanes against JAX's:
        the integer-sum gauges bit for bit, `util_imbalance` to 1e-12
        relative; each row equal to that lane's `cycle_quality`."""
        js, jsnap, _, _ = sweep_problem(JAX, "trimaran")
        ps, psnap, _, _ = sweep_problem(PORT, "trimaran")
        W = t_sweep.candidate_weights([1, 1], 8, seed=0)
        A, _, wt = t_sweep.sweep_cycle(ps, psnap, W, device="cpu")
        got = t_quality.batch_quality(psnap, A, wt)
        want = j_quality.batch_quality(jsnap, A, wt)
        assert set(got) == set(want) == set(t_quality.CYCLE_OBJECTIVES)
        for name in got:
            assert got[name].dtype == np.float64 and got[name].shape == (8,)
            if name == "util_imbalance":
                np.testing.assert_allclose(got[name], want[name],
                                           rtol=1e-12, atol=0)
            else:
                np.testing.assert_array_equal(got[name], want[name])
        for k in range(8):
            single = t_quality.cycle_quality(psnap, A[k], None, wt[k])
            for name, value in single.items():
                assert got[name][k] == pytest.approx(value, rel=1e-12)

    def test_out_of_range_placements_drop_like_jax(self):
        """A garbage placement (a node index past the rows) adds nothing,
        as JAX's scatter drops it; the gauges still equal JAX's."""
        js, jsnap, _, _ = sweep_problem(JAX, "trimaran")
        ps, psnap, _, _ = sweep_problem(PORT, "trimaran")
        rng = np.random.default_rng(7)
        A = rng.integers(-1, 2 * psnap.num_nodes, (3, psnap.num_pods))
        A = A.astype(np.int32)
        wt = rng.random((3, psnap.num_pods)) < 0.2
        got = t_quality.batch_quality(psnap, A, wt)
        want = j_quality.batch_quality(jsnap, A, wt)
        for name in got:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                       atol=0)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_state_quality_equal_jax(self, seed):
        rng = np.random.default_rng(seed)
        N = 24
        alloc = np.stack([rng.integers(1000, 64_000, N),
                          rng.integers(1, 256, N) * GIB, np.zeros(N),
                          rng.integers(8, 110, N)], axis=1).astype(np.int64)
        used = (alloc * rng.uniform(0, 1, (N, 1))).astype(np.int64)
        used[rng.random(N) < 0.2] = 0
        mask = rng.random(N) < 0.9
        for m in (None, mask):
            got = t_quality.state_quality(alloc, used, m)
            want = j_quality.state_quality(alloc, used, m)
            assert list(got) == list(want)
            for name in got:
                assert got[name] == pytest.approx(want[name], rel=1e-12)
            assert got["fragmentation"] == want["fragmentation"]

    def test_score_drift_and_sense_equal_jax(self):
        rng = np.random.default_rng(3)
        scores = rng.integers(0, 300, (12, 6))
        anchor = rng.integers(-1, 6, 12)
        for _ in range(5):
            a = rng.integers(-1, 9, 12)  # 6..8: out of range
            assert t_quality.score_drift(scores, a, anchor) == (
                j_quality.score_drift(scores, a, anchor))
        assert t_quality.SENSE == j_quality.SENSE
