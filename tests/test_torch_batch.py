"""The port's batched profile solve (`parallel.solver.profile_batch_solve`
and `ops.assign.waterfill_assign_stateful`) against the JAX package.

- The stateful waterfill alone, on a seeded toy problem with a plugin
  carry (per-node tokens a pod spends), a within-wave guard and a
  capacity estimate: dense waves with and without an initial batch, and
  sparse straggler waves with the stall escalation, every output and
  the wave stats (`occupancy`, `waves`) equal to JAX's.
- `profile_batch_solve` on reduced bench configs 2 (TLP + LVRB, the
  general branch over whole-batch score rows), 3 (NUMA) and 4 (the
  flagship, the targeted fast path), on config 4's faulted gang/quota
  cluster, on an allocatable + NUMA profile and on the NUMA cases of
  `tests/torch_numa_cases.py` (the per-pod filter and score fallbacks):
  assignment, admitted, wait, occupancy and waves equal JAX's, with no
  zone violation in the order the waves committed.
- The scenarios of `tests/test_parallel.py` TestBatchedStateDependentFilters,
  TestSparseStragglerWaves (with JAX's pairing, NodeResourcesAllocatable +
  PodState, and with two NodeResourcesAllocatable plugins) and
  TestTargetedFastPathGate, on both packages.
- The batch-versus-sequential score drift of the port within the bounds
  of `tests/test_drift_bounds.py`.
- Each normalizer over (P, N) rows equals its per-row call.

Every quantity compared is an integer or boolean: tolerance 0. The
`cuda`-marked test runs on a card only; it needs no JAX."""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
import scheduler_plugins_tpu_torch.parallel.solver as port_solver
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.framework import Plugin, Profile, Scheduler
from scheduler_plugins_tpu_torch.ops import CPU_I, MEMORY_I, PODS_I
from scheduler_plugins_tpu_torch.ops import fit as t_fit
from scheduler_plugins_tpu_torch.ops import normalize as t_norm
from scheduler_plugins_tpu_torch.ops import numa as t_numa
from scheduler_plugins_tpu_torch.ops.assign import waterfill_assign_stateful
from scheduler_plugins_tpu_torch.parallel.solver import (
    profile_batch_solve,
    score_drift_vs_sequential,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_numa_cases import numa_case, solve_inputs, zone_violations

try:
    import jax
    import jax.numpy as jnp

    import bench
    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.ops.assign as j_assign
    import scheduler_plugins_tpu.ops.fit as j_fit
    import scheduler_plugins_tpu.parallel.solver as j_solver
    import scheduler_plugins_tpu.plugins as jax_plugins
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from tests.test_drift_bounds import CFG2_DRIFT_ENVELOPE
    from tests.test_torch_parity_solve import gang_quota_cluster
    from tests.test_torch_snapshot import JAX, PORT
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    JAX = None

GIB = 1 << 30
CPU = torch.device("cpu")
PORT_PKG = SimpleNamespace(objects=port_objects, Cluster=PCluster,
                           scenarios=port_scenarios)


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def t(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


# --- the stateful waterfill alone --------------------------------------------

def toy(seed, P=48, N=10):
    """A seeded problem: pods of cpu/memory requests (the pods slot is the
    fit's), nodes of spread capacity, a static feasibility mask, tied
    scores, and a carry of per-node tokens each pod spends 0-2 of."""
    rng = np.random.default_rng(seed)
    req = np.zeros((P, 4), np.int64)
    req[:, CPU_I] = rng.integers(1, 9, P) * 250
    req[:, MEMORY_I] = rng.integers(1, 5, P) * GIB
    free = np.zeros((N, 4), np.int64)
    free[:, CPU_I] = rng.integers(2, 12, N) * 1000
    free[:, MEMORY_I] = rng.integers(4, 16, N) * GIB
    free[:, PODS_I] = rng.integers(2, 9, N)
    return SimpleNamespace(
        req=req, free=free, pod_mask=rng.random(P) < 0.9,
        node_mask=rng.random(N) < 0.9, static=rng.random((P, N)) < 0.85,
        scores=rng.integers(0, 4, (P, N)).astype(np.int32) * 25,
        tok=rng.integers(0, 3, P).astype(np.float64),
        tokens=rng.integers(1, 7, N).astype(np.float64),
    )


def jax_waterfill(z, dense, guard, capacity, initial, cap, max_waves):
    P = z.req.shape[0]
    req, pod_mask = jnp.asarray(z.req), jnp.asarray(z.pod_mask)
    node_mask, static = jnp.asarray(z.node_mask), jnp.asarray(z.static)
    scores, tok = jnp.asarray(z.scores), jnp.asarray(z.tok)

    def batch_fn(free, state, active):
        return (j_fit.fits(req, free, pod_mask=active, node_mask=node_mask)
                & static & (state[None, :] >= tok[:, None])), scores

    def sub_batch_fn(free, state, idx, act):
        return (j_fit.fits(req[idx], free, pod_mask=act, node_mask=node_mask)
                & static[idx] & (state[None, :] >= tok[idx][:, None])
                ), scores[idx]

    def commit_fn(state, placed, choice):
        return state - jnp.zeros_like(state).at[jnp.maximum(choice, 0)].add(
            jnp.where(placed, tok, 0.0))

    def cap_fn(state, active):
        mean = jnp.sum(jnp.where(active, tok, 0.0)) / jnp.maximum(
            active.sum(), 1)
        c = jnp.where(mean > 0, jnp.floor(state / jnp.maximum(mean, 1e-9)),
                      float(P))
        return jnp.clip(c, 0, P).astype(jnp.int32)

    def run(free0, state0):
        init = batch_fn(free0, state0, pod_mask) if initial else None
        return j_assign.waterfill_assign_stateful(
            batch_fn, commit_fn,
            (lambda s, p, n, pre: s[n] - pre[0] >= tok[p],) if guard else (),
            (tok[:, None],) if guard else (),
            req, pod_mask, free0, state0, max_waves=max_waves,
            capacity_fns=(cap_fn,) if capacity else (),
            initial_batch=init,
            sub_batch_fn=None if dense else sub_batch_fn,
            straggler_cap=cap, collect_stats=True)

    return jax.jit(run)(jnp.asarray(z.free), jnp.asarray(z.tokens))


def port_waterfill(z, dense, guard, capacity, initial, cap, max_waves):
    P = z.req.shape[0]
    req, pod_mask, node_mask = t(z.req), t(z.pod_mask), t(z.node_mask)
    static, scores, tok = t(z.static), t(z.scores), t(z.tok)

    def batch_fn(free, state, active):
        return (t_fit.fits(req, free, pod_mask=active, node_mask=node_mask)
                & static & (state[None, :] >= tok[:, None])), scores

    def sub_batch_fn(free, state, idx, act):
        return (t_fit.fits(req[idx], free, pod_mask=act, node_mask=node_mask)
                & static[idx] & (state[None, :] >= tok[idx][:, None])
                ), scores[idx]

    def commit_fn(state, placed, choice):
        return state - torch.zeros_like(state).index_add_(
            0, torch.clamp(choice, min=0).long(),
            torch.where(placed, tok, 0.0))

    def cap_fn(state, active):
        mean = torch.where(active, tok, 0.0).sum() / torch.clamp(
            active.sum(), min=1)
        c = torch.where(mean > 0, torch.floor(
            state / torch.clamp(mean, min=1e-9)), float(P))
        return torch.clamp(c, 0, P).to(torch.int32)

    init = batch_fn(t(z.free), t(z.tokens), pod_mask) if initial else None
    return waterfill_assign_stateful(
        batch_fn, commit_fn,
        (lambda s, pods, nodes, pre: s[nodes] - pre[:, 0] >= tok[pods],)
        if guard else (),
        (tok[:, None],) if guard else (),
        req, pod_mask, t(z.free), t(z.tokens), max_waves=max_waves,
        capacity_fns=(cap_fn,) if capacity else (), initial_batch=init,
        sub_batch_fn=None if dense else sub_batch_fn, straggler_cap=cap,
        collect_stats=True)


WATERFILLS = [
    # (dense, guard, capacity, initial batch, straggler cap, max waves)
    pytest.param(True, False, False, False, 256, 4, id="dense"),
    pytest.param(True, True, True, True, 256, 6, id="dense_guard_cap_init"),
    pytest.param(False, True, False, True, 8, 8, id="sparse_guard"),
    pytest.param(False, True, True, True, 4, 12, id="sparse_guard_cap"),
    pytest.param(False, False, True, True, 16, 3, id="sparse_short_budget"),
]


class TestStatefulWaterfill:
    @pytest.mark.parametrize("dense,guard,capacity,initial,cap,max_waves",
                             WATERFILLS)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_equals_jax(self, seed, dense, guard, capacity, initial, cap,
                        max_waves):
        z = toy(seed)
        args = (dense, guard, capacity, initial, cap, max_waves)
        ja, jf, js, jstats = jax_waterfill(z, *args)
        pa, pf, ps, pstats = port_waterfill(z, *args)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        assert pa.dtype == torch.int32
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pstats["occupancy"].numpy(),
                                      np.asarray(jstats["occupancy"]))
        assert pstats["waves"] == int(jstats["waves"])
        wave_of = pstats["wave_of"].numpy()
        assert ((wave_of >= 0) == (pa.numpy() >= 0)).all()
        np.testing.assert_array_equal(
            np.bincount(wave_of[wave_of >= 0], minlength=max_waves),
            pstats["occupancy"].numpy())

    def test_the_cases_reach_their_branches(self):
        """A stalled sparse wave escalates to a dense one (occupancy 0
        then more), the guard defers same-wave pods, and the wave budget
        cuts a run short."""
        z = toy(1)
        _, _, _, stats = port_waterfill(z, False, True, True, True, 4, 12)
        occ = stats["occupancy"].numpy()[:stats["waves"]]
        assert stats["waves"] > 2 and (occ[1:] == 0).any(), occ
        _, _, _, short = port_waterfill(z, False, False, True, True, 16, 3)
        assert short["waves"] == 3

    def test_sub_batch_needs_initial_batch(self):
        z = toy(0)
        with pytest.raises(ValueError, match="initial_batch"):
            waterfill_assign_stateful(
                lambda *a: None, lambda s, *a: s, (), (), t(z.req),
                t(z.pod_mask), t(z.free), None,
                sub_batch_fn=lambda *a: None)


# --- profile_batch_solve -------------------------------------------------------

def bench_config(n):
    """The `bench.config_problem` rosters at reduced shapes."""
    def build(pkg, side):
        plugins = jax_plugins if side == "jax" else port_plugins
        if n == 2:
            return (pkg.scenarios.trimaran_scenario(256, 512),
                    [plugins.TargetLoadPacking(),
                     plugins.LoadVariationRiskBalancing()])
        if n == 3:
            return (pkg.scenarios.numa_scenario(128, 256, zones=8),
                    [plugins.NodeResourceTopologyMatch()])
        if n == 4:
            return (pkg.scenarios.gang_quota_scenario(6, 16, 40),
                    [plugins.NodeResourcesAllocatable(),
                     plugins.Coscheduling(), plugins.CapacityScheduling()])
        if n == 40:  # config 4's roster on a faulted gang/quota cluster
            return (gang_quota_cluster(pkg),
                    [plugins.NodeResourcesAllocatable(),
                     plugins.Coscheduling(), plugins.CapacityScheduling()])
        # allocatable + NUMA on a tight NUMA cluster
        return (pkg.scenarios.numa_scenario(24, 300, zones=2, seed=3),
                [plugins.NodeResourcesAllocatable(),
                 plugins.NodeResourceTopologyMatch()])
    return build


def numa_problem(name):
    def build(pkg, side):
        cluster, config = numa_case(name, pkg)
        load = jax_config if side == "jax" else port_config
        return cluster, list(load.load_profile(config).plugins)
    return build


PROBLEMS = {
    "config2": bench_config(2), "config3": bench_config(3),
    "config4": bench_config(4), "config4_faults": bench_config(40),
    "alloc_numa": bench_config(0),
    **{name: numa_problem(name) for name in (
        "mixed_scope", "multi_container", "best_effort", "least_numa",
        "float64")},
}


def batch_pair(name):
    """Both packages' `profile_batch_solve(collect_stats=True)` of the
    problem, and the port's lowered snapshot and meta."""
    out = {}
    for side, pkg in (("jax", JAX), ("port", PORT)):
        cluster, plugins = PROBLEMS[name](pkg, side)
        if side == "jax":
            sched = JScheduler(JProfile(plugins=plugins))
            _, snap, meta = solve_inputs(sched, cluster)
            res = j_solver.profile_batch_solve(sched, snap,
                                               collect_stats=True)
        else:
            sched = Scheduler(Profile(plugins=plugins))
            _, snap, meta = solve_inputs(sched, cluster, device="cpu")
            res = profile_batch_solve(sched, snap, collect_stats=True,
                                      device="cpu")
        out[side] = SimpleNamespace(res=res, snap=snap, meta=meta,
                                    sched=sched, cluster=cluster)
    return out


@pytest.fixture(scope="module")
def batched():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = batch_pair(name)
        return cache[name]

    return get


def commit_order(wave_of):
    """Placed pods in (wave, queue) order: the order the batched solve
    committed them."""
    wave_of = np.asarray(wave_of)
    placed = np.nonzero(wave_of >= 0)[0]
    return placed[np.lexsort((placed, wave_of[placed]))]


def numa_zone_violations(snap, meta, assignment, order=None):
    index = meta.index
    return zone_violations(snap.numpy(), t_numa.numa_affine_mask(index),
                           t_numa.host_level_mask(index), assignment, order)


class TestProfileBatchSolve:
    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    def test_equals_jax(self, batched, name):
        b = batched(name)
        (ja, jad, jw, js), (pa, pad, pw, ps) = b["jax"].res, b["port"].res
        for got, want, what in ((pa, ja, "assignment"), (pad, jad, "admitted"),
                                (pw, jw, "wait")):
            assert got.numpy().dtype == np.asarray(want).dtype, what
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=what)
        np.testing.assert_array_equal(ps["occupancy"].numpy(),
                                      np.asarray(js["occupancy"]))
        assert ps["waves"] == int(js["waves"])
        assert (pa >= 0).any()

    @pytest.mark.parametrize("name", [n for n in sorted(PROBLEMS)
                                      if n not in ("config2", "config4",
                                                   "config4_faults")])
    def test_no_zone_violation(self, batched, name):
        b = batched(name)["port"]
        order = commit_order(b.res[3]["wave_of"])
        assert numa_zone_violations(b.snap, b.meta, b.res[0], order) == 0

    def test_the_problems_reach_their_branches(self, batched):
        """The general branch's sparse waves and their escalation, the
        per-pod fallbacks, the fast path, quota and quorum tails."""
        occ = batched("config3")["port"].res[3]
        assert occ["waves"] > 2
        c4 = batched("config4_faults")["port"].res
        assert c4[2].any() and not c4[1].all()
        assert batched("config4")["port"].res[3]["occupancy"].shape == (17,)
        numa_only = batched("least_numa")["port"]
        assert numa_only.sched.profile.plugins[0].strategy == "LeastNUMANodes"
        waves = [batched(n)["port"].res[3]["waves"] for n in (
            "mixed_scope", "multi_container", "alloc_numa")]
        assert max(waves) > 2, waves


class TestParallelScenarios:
    """`tests/test_parallel.py`'s batched-solve scenarios on both
    packages: outputs equal, and each scenario's own claim holds on the
    port."""

    @staticmethod
    def numa_cluster(pkg, n_nodes, zone_cpu, pods, node_cpu=8000):
        o = pkg.objects
        c = pkg.Cluster()
        for i in range(n_nodes):
            c.add_node(o.Node(name=f"n{i}", allocatable={
                "cpu": node_cpu, "memory": 64 * GIB, "pods": 110}))
            c.add_nrt(o.NodeResourceTopology(
                node_name=f"n{i}",
                zones=[o.NUMAZone(numa_id=z, available={
                    "cpu": zone_cpu, "memory": 24 * GIB}) for z in range(2)],
                policy=o.TopologyManagerPolicy.SINGLE_NUMA_NODE,
                scope=o.TopologyManagerScope.CONTAINER))
        for j, cpu in enumerate(pods):
            c.add_pod(o.Pod(name=f"p{j}", creation_ms=j, containers=[
                o.Container(requests={"cpu": cpu, "memory": 2 * GIB},
                            limits={"cpu": cpu, "memory": 2 * GIB})]))
        return c

    def solve_both(self, build, plugin_names, kwargs=({},)):
        out = []
        for side, pkg, plugins in (("jax", JAX, jax_plugins),
                                   ("port", PORT, port_plugins)):
            cluster = build(pkg)
            roster = [getattr(plugins, n)(**kw)
                      for n, kw in zip(plugin_names, kwargs)]
            if side == "jax":
                sched = JScheduler(JProfile(plugins=roster))
                pending, snap, meta = solve_inputs(sched, cluster)
                a = np.asarray(j_solver.profile_batch_solve(sched, snap)[0])
            else:
                sched = Scheduler(Profile(plugins=roster))
                pending, snap, meta = solve_inputs(sched, cluster,
                                                   device="cpu")
                res = profile_batch_solve(sched, snap, collect_stats=True,
                                          device="cpu")
                a = res[0].numpy()
            out.append(SimpleNamespace(a=a, snap=snap, meta=meta,
                                       pending=pending))
        np.testing.assert_array_equal(out[1].a, out[0].a)
        return out[1]

    NUMA = ("NodeResourcesAllocatable", "NodeResourceTopologyMatch")

    def test_saturated_zones_defer_not_violate(self):
        r = self.solve_both(
            lambda pkg: self.numa_cluster(pkg, 4, 3000, [2500] * 12),
            self.NUMA, ({}, {}))
        placed = r.a[:12]
        assert numa_zone_violations(r.snap, r.meta, r.a) == 0
        assert (np.bincount(placed[placed >= 0], minlength=4) <= 1).all()
        assert (placed >= 0).sum() == 4

    def test_within_wave_guard_allows_exact_multi_fill(self):
        r = self.solve_both(
            lambda pkg: self.numa_cluster(pkg, 3, 6000, [2500] * 9),
            self.NUMA, ({}, {}))
        placed = r.a[:9]
        assert numa_zone_violations(r.snap, r.meta, r.a) == 0
        assert (np.bincount(placed[placed >= 0], minlength=3) <= 2).all()
        assert (placed >= 0).sum() == 6

    def test_matches_sequential_placement_count(self):
        r = self.solve_both(
            lambda pkg: self.numa_cluster(pkg, 6, 4000, [1000] * 24),
            self.NUMA, ({}, {}))
        sched = Scheduler(Profile(plugins=[
            port_plugins.NodeResourcesAllocatable(),
            port_plugins.NodeResourceTopologyMatch()]))
        c2 = self.numa_cluster(PORT, 6, 4000, [1000] * 24)
        _, snap2, _ = solve_inputs(sched, c2, device="cpu")
        seq = sched.solve(snap2, device="cpu").assignment.numpy()
        assert int((r.a[:24] >= 0).sum()) == int((seq[:24] >= 0).sum())

    # two scoring plugins: the general stateful branch, not the targeted
    # fast path; JAX's test pairs NodeResourcesAllocatable with PodState
    STRAGGLER = pytest.mark.parametrize("plugins,args", [
        (("NodeResourcesAllocatable", "NodeResourcesAllocatable"),
         ({}, {"mode": "Most"})),
        (("NodeResourcesAllocatable", "PodState"), ({}, {})),
    ], ids=["alloc_pair", "alloc_podstate"])

    @STRAGGLER
    def test_cordoned_node_unreachable_in_straggler_waves(self, plugins,
                                                          args):
        def build(pkg):
            o = pkg.objects
            c = pkg.Cluster()
            c.add_node(o.Node(name="n0", allocatable={
                "cpu": 1500, "memory": 4 * GIB, "pods": 10}))
            c.add_node(o.Node(name="cordoned", allocatable={
                "cpu": 64_000, "memory": 256 * GIB, "pods": 110},
                unschedulable=True))
            for name in ("a", "b"):
                c.add_pod(o.Pod(name=name, containers=[
                    o.Container(requests={"cpu": 1000})]))
            return c

        r = self.solve_both(build, plugins, args)
        placed = {p.uid: r.a[i] for i, p in enumerate(r.pending)}
        assert placed["default/a"] == 0 and placed["default/b"] == -1

    @STRAGGLER
    def test_head_cohort_does_not_starve_tail_pod(self, plugins, args):
        def build(pkg):
            o = pkg.objects
            c = pkg.Cluster()
            c.add_node(o.Node(name="n0", allocatable={
                "cpu": 1500, "memory": 4 * GIB, "pods": 10}))
            c.add_node(o.Node(name="n1", allocatable={
                "cpu": 64_000, "memory": 256 * GIB, "pods": 110}))
            for j in range(260):
                c.add_pod(o.Pod(name=f"huge{j}", priority=100, creation_ms=j,
                                containers=[o.Container(
                                    requests={"cpu": 1_000_000})]))
            for name in ("a", "b"):
                c.add_pod(o.Pod(name=name, priority=0, creation_ms=10_000,
                                containers=[o.Container(
                                    requests={"cpu": 1000})]))
            return c

        r = self.solve_both(build, plugins, args)
        placed = {p.uid: r.a[i] for i, p in enumerate(r.pending)}
        assert placed["default/a"] >= 0 and placed["default/b"] >= 0
        assert placed["default/a"] != placed["default/b"]
        assert all(placed[f"default/huge{j}"] == -1 for j in range(260))

    @pytest.mark.parametrize("weight,fast", [(1, True), (0, False)])
    def test_fast_path_gate(self, weight, fast, monkeypatch):
        """A positive-weight single static scorer takes the targeted
        waterfill; weight 0 falls back to the general branch."""
        calls = []
        real = port_solver.waterfill_assign_targeted
        monkeypatch.setattr(
            port_solver, "waterfill_assign_targeted",
            lambda *a, **k: calls.append(1) or real(*a, **k))

        def build(pkg):
            return pkg.scenarios.allocatable_scenario(n_nodes=16, n_pods=32)

        out = []
        for side, pkg, plugins in (("jax", JAX, jax_plugins),
                                   ("port", PORT, port_plugins)):
            plugin = plugins.NodeResourcesAllocatable()
            plugin.weight = weight
            sched = (JScheduler(JProfile(plugins=[plugin])) if side == "jax"
                     else Scheduler(Profile(plugins=[plugin])))
            kw = {} if side == "jax" else {"device": "cpu"}
            _, snap, _ = solve_inputs(sched, build(pkg), **kw)
            fn = (j_solver.profile_batch_solve if side == "jax"
                  else profile_batch_solve)
            out.append(np.asarray(fn(sched, snap, **kw)[0]))
        np.testing.assert_array_equal(out[1], out[0])
        assert bool(calls) == fast


class TestDrift:
    """`tests/test_drift_bounds.py` on the port: the batched solve's score
    drift from the sequential solve on the shared cycle-initial
    objective."""

    def drift(self, cluster, plugins):
        sched = Scheduler(Profile(plugins=plugins))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        seq = sched.solve(snap, device="cpu").assignment.numpy()
        bat = profile_batch_solve(sched, snap, device="cpu")[0].numpy()
        return sched, snap, seq, bat

    def test_cfg2_batch_drift_within_envelope(self):
        sched, snap, seq, bat = self.drift(
            port_scenarios.trimaran_scenario(**bench.SMOKE_COMPARE_SHAPES[2]),
            [port_plugins.TargetLoadPacking(),
             port_plugins.LoadVariationRiskBalancing()])
        drift, placed_seq, placed_bat = score_drift_vs_sequential(
            sched, snap, seq, bat, device="cpu")
        assert placed_bat >= placed_seq
        assert drift >= CFG2_DRIFT_ENVELOPE, drift

    def test_numa_batch_drift_zero_and_anchor(self):
        sched, snap, seq, bat = self.drift(
            port_scenarios.numa_scenario(**bench.SMOKE_COMPARE_SHAPES[3]),
            [port_plugins.NodeResourceTopologyMatch()])
        drift, placed_seq, placed_bat = score_drift_vs_sequential(
            sched, snap, seq, bat, device="cpu")
        assert placed_bat >= placed_seq
        assert drift == 0.0
        anchor, _, _ = score_drift_vs_sequential(sched, snap, seq, seq,
                                                 device="cpu")
        assert anchor == 0.0


class TestNormalizeRows:
    """Each normalizer a loaded profile can use, over (P, N) rows, equals
    the stacked per-row calls: the batched solve normalizes every pod's
    row at once."""

    @pytest.mark.parametrize("fn", [
        t_norm.minmax_normalize, t_norm.peaks_normalize,
        t_norm.default_normalize,
        lambda s, m: t_norm.default_normalize(s, m, reverse=True),
        Plugin().normalize,
    ], ids=["minmax", "peaks", "default", "default_reverse", "identity"])
    def test_rows_equal_per_row(self, fn):
        rng = np.random.default_rng(4)
        scores = t(rng.integers(-(1 << 30), 1 << 20, (24, 40)))
        scores[3] = 7
        mask = t(rng.random((24, 40)) < 0.4)
        mask[5] = False
        mask[6] = True
        rows = fn(scores, mask)
        for p in range(24):
            assert torch.equal(rows[p], fn(scores[p], mask[p])), p


class TestGuards:
    def test_validator_plugin_raises(self):
        """A plugin with `validate_at` no longer raises: the validator
        branch walks every row of each wave in queue order with (1,)
        device indices, a rejected winner retries the next wave, and its
        `commit_batch` is left out (the validator's carries commit pod by
        pod). Here the validator rejects the odd pod rows wherever they
        go: the even ones place, the odd ones retry until a wave places
        nothing, and stay unplaced."""
        calls = []

        class Spread(Plugin):
            name = "PodTopologySpread"
            state_dependent_filter = True

            def commit_batch(self, state, snap, placed, choice):
                raise AssertionError("a validator's carry commits per pod")

            def validate_at(self, state, snap, p, node):
                calls.append((p.shape, node.shape))
                return p % 2 == 0

        cluster = port_scenarios.allocatable_scenario(4, 8)
        sched = Scheduler(Profile(plugins=[
            port_plugins.NodeResourcesAllocatable(), Spread()]))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        assignment, _, _, stats = profile_batch_solve(
            sched, snap, collect_stats=True, device="cpu")
        assert calls and set(calls) == {((1,), (1,))}
        assert len(calls) % snap.num_pods == 0
        assert (assignment[0::2] >= 0).all()
        assert (assignment[1::2] == -1).all()
        assert stats["waves"] >= 2 and stats["occupancy"][1:].sum() == 0

    def test_state_dependent_filter_without_commit_batch_raises(self):
        class Carry(Plugin):
            name = "Carry"
            state_dependent_filter = True

        cluster = port_scenarios.allocatable_scenario(4, 8)
        sched = Scheduler(Profile(plugins=[Carry()]))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        with pytest.raises(TypeError, match="commit_batch"):
            profile_batch_solve(sched, snap, device="cpu")

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cluster = port_scenarios.numa_scenario(4, 8, zones=2)
        sched = Scheduler(Profile(plugins=[
            port_plugins.NodeResourceTopologyMatch()]))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            profile_batch_solve(sched, snap)

    def test_snapshot_left_unwritten(self):
        cluster, config = numa_case("mixed_scope", PORT_PKG)
        sched = Scheduler(port_config.load_profile(config))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        before = {k: {f: v.clone() if isinstance(v, torch.Tensor) else v
                      for f, v in vars(getattr(snap, k)).items()}
                  for k in ("nodes", "pods", "numa")}
        profile_batch_solve(sched, snap, device="cpu")
        for k, table in before.items():
            for f, v in table.items():
                now = getattr(getattr(snap, k), f)
                assert (torch.equal(now, v) if isinstance(v, torch.Tensor)
                        else now == v), (k, f)


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

    @pytest.mark.parametrize("name", ["config3_small", "mixed_scope",
                                      "least_numa"])
    def test_card_equals_cpu_and_one_sync_a_wave(self, card, name):
        """The batched solve of each NUMA case on the card equals the
        CPU's, and under sync-debug "warn" the card waits on the host at
        most once a wave beyond a fixed set-up count."""
        outs = []
        for device in (card, CPU):
            cluster, config = numa_case(name, PORT_PKG)
            sched = Scheduler(port_config.load_profile(config))
            _, snap, _ = solve_inputs(sched, cluster, device=device)
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = profile_batch_solve(sched, snap,
                                              collect_stats=True,
                                              device=device)
                finally:
                    if device.type == "cuda":
                        torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchronizing" in str(w.message) for w in seen)
            outs.append((res, syncs))
        (card_res, syncs), (cpu_res, _) = outs
        for k in range(3):
            assert torch.equal(card_res[k].cpu(), cpu_res[k]), k
        assert card_res[3]["waves"] == cpu_res[3]["waves"]
        assert syncs <= card_res[3]["waves"] + 4, (syncs, card_res[3])
