"""The rest of the plugin roster on the port (PodState, QOSSort,
PreemptionToleration, CrossNodePreemption, with SySched beside them, and
`metric_affinity_scenario`) against the JAX package.

- `tests/test_decision_tables.py` TestQOSSortOrdering and
  TestPodStateReferenceVectors, `tests/test_preemption.py`
  TestPreemptionToleration, TestTolerationPolicyParseCorners and
  TestCandidateSampling (the sampling and argument rows, with
  PreemptionToleration), and `tests/test_crossnode_preemption.py` whole,
  run again with the JAX names they call replaced by the port's.
- The snapshot's terminating and nominated node columns, PodState's raw
  and normalized rows (negative minimums included) and its whole-batch
  rows against JAX's; which plugin sorts the queue, and the order, for a
  profile listing QOSSort and Coscheduling.
- The slice at a small size: `tests/torch_roster_cases.roster_cluster`
  (32 nodes x 64 pods, QOSSort + NodeResourcesAllocatable + SySched +
  PodState + PreemptionToleration) and `metric_affinity_scenario(16, 32)`
  (the JAX metric roster: TargetLoadPacking, LoadVariationRiskBalancing,
  InterPodAffinity, SySched) through `Scheduler.solve` (on the port's
  lowering and on JAX's snapshot carried across: assignment, admitted,
  wait, failed_plugin and the final carry) and `profile_batch_solve`
  (assignment, admitted, wait, occupancy, waves); the roster's two
  cycles (`roster_script`: the toleration policies spare, evict and are
  overridden) and `cross_node_script` through `run_cycle`, the reports
  and the store equal JAX's cycle by cycle.
- The roster solve issues no host read.

Every quantity compared is an integer or a boolean: tolerance 0. The
metric roster's Trimaran scores run in float64 in both packages, the same
operations in the same order on the same inputs (`tests/
test_torch_trimaran.py`), and only their integer results are compared.
The `cuda`-marked test runs the roster script on the card and on the CPU
(`python -m pytest tests/test_torch_roster.py -m cuda`); it needs no
JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.framework.preemption as port_preemption
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.ops.normalize import minmax_normalize
from scheduler_plugins_tpu_torch.parallel.solver import profile_batch_solve
from scheduler_plugins_tpu_torch.state import cluster as port_store
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.state.snapshot import build_snapshot
from torch_roster_cases import (
    HIGH_PRIORITY,
    METRIC_PROFILE,
    ROSTER_NOW,
    ROSTER_PROFILE,
    cross_node_script,
    roster_cluster,
    roster_script,
    toleration_outcomes,
)

try:
    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.framework.preemption as j_preemption
    import scheduler_plugins_tpu.ops.normalize as j_normalize
    import scheduler_plugins_tpu.plugins as jax_plugins
    import tests.test_crossnode_preemption as jax_crossnode
    import tests.test_decision_tables as jax_decision
    import tests.test_preemption as jax_preemption_tables
    from scheduler_plugins_tpu.framework import Scheduler as JScheduler
    from scheduler_plugins_tpu.parallel.solver import (
        profile_batch_solve as jax_profile_batch_solve,
    )
    from scheduler_plugins_tpu.state.snapshot import (
        build_snapshot as jax_build_snapshot,
    )
    from tests.test_torch_cycle import run_script
    from tests.test_torch_parity_solve import (
        assert_result_equal,
        jax_snapshot_tree,
        numpy_tree,
    )
    from tests.test_torch_snapshot import JAX, PORT
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    JAX = None

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


# --- the JAX decision tables against the port -------------------------------

class _CPUCluster(PCluster):
    """The port's store on the CPU. `requeue_flush_ms`, an attribute of
    the JAX store, is the port's module constant."""

    def snapshot(self, pending, now_ms=0, device="cpu", **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)

    @property
    def requeue_flush_ms(self):
        return port_store.REQUEUE_FLUSH_MS

    @requeue_flush_ms.setter
    def requeue_flush_ms(self, value):
        port_store.REQUEUE_FLUSH_MS = value


class _CPUScheduler(Scheduler):
    def solve(self, snap, state0=None, *, device="cpu"):
        return super().solve(snap, state0, device=device)


def _port_minmax(scores, mask):
    return minmax_normalize(torch.as_tensor(np.array(scores)),
                            torch.as_tensor(np.array(mask))).numpy()


def _tables():
    if JAX is None:
        return []
    classes = [jax_decision.TestQOSSortOrdering,
               jax_decision.TestPodStateReferenceVectors,
               jax_preemption_tables.TestPreemptionToleration,
               jax_preemption_tables.TestTolerationPolicyParseCorners,
               jax_preemption_tables.TestCandidateSampling,
               jax_crossnode.TestCrossNodePreemption]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_")]


@pytest.mark.parametrize("cls,method", _tables())
def test_reference_table_against_port(cls, method, monkeypatch):
    """Each case of the JAX tables, with every JAX name the table calls
    swapped for the port's (the store's requeue flush restored after)."""
    monkeypatch.setattr(port_store, "REQUEUE_FLUSH_MS",
                        port_store.REQUEUE_FLUSH_MS)
    for module in (jax_decision, jax_preemption_tables, jax_crossnode):
        for name in ("Container", "ElasticQuota", "Node", "Pod",
                     "PodDisruptionBudget", "PriorityClass"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name,
                                    getattr(port_objects, name))
        for name in ("QOSSort", "CapacityScheduling",
                     "NodeResourcesAllocatable", "PreemptionToleration",
                     "CrossNodePreemption"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name,
                                    getattr(port_plugins, name))
        for name in ("PreemptionEngine", "PreemptionMode"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name,
                                    getattr(port_preemption, name))
        monkeypatch.setattr(module, "Scheduler", _CPUScheduler)
        monkeypatch.setattr(module, "Profile", Profile)
        if hasattr(module, "Cluster"):
            monkeypatch.setattr(module, "Cluster", _CPUCluster)
        if hasattr(module, "run_cycle"):
            monkeypatch.setattr(
                module, "run_cycle",
                lambda s, c, now=None, **kw: port_cycle.run_cycle(
                    s, c, now=now, device="cpu", **kw))
    # the names the tables import inside their cases
    for name in ("PreemptionEngine", "PreemptionMode"):
        monkeypatch.setattr(j_preemption, name,
                            getattr(port_preemption, name))
    monkeypatch.setattr(jax_config, "load_profile", port_config.load_profile)
    monkeypatch.setattr(j_normalize, "minmax_normalize", _port_minmax)
    getattr(cls(), method)()


def test_toleration_annotations_are_jax_names():
    assert (port_preemption.ANNOTATION_MIN_PREEMPTABLE,
            port_preemption.ANNOTATION_TOLERATION_SECONDS) == (
        j_preemption.ANNOTATION_MIN_PREEMPTABLE,
        j_preemption.ANNOTATION_TOLERATION_SECONDS)


# --- lowering: both packages, one cluster ---------------------------------------

def lowered(build, config):
    """Both packages' schedulers (each loading `config` with its own
    `load_profile`), queue-sorted batches, snapshots and metas of the
    cluster `build(pkg)` makes, each plugin's `configure_cluster` run first
    and the plugins prepared."""
    out = []
    for pkg, sched_cls, load, kw in (
            (JAX, JScheduler, jax_config.load_profile, {}),
            (PORT, Scheduler, port_config.load_profile, {"device": "cpu"})):
        cluster = build(pkg)
        sched = sched_cls(load(config))
        for plugin in sched.profile.plugins:
            plugin.configure_cluster(cluster)
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, **kw)
        sched.prepare(meta, cluster)
        out.append(SimpleNamespace(cluster=cluster, sched=sched,
                                   pending=pending, snap=snap, meta=meta))
    return out


PROBLEMS = {
    "roster": (lambda pkg: roster_cluster(pkg, 32, 64), ROSTER_PROFILE),
    "roster_tight": (lambda pkg: roster_cluster(pkg, 8, 48, seed=4),
                     ROSTER_PROFILE),
    "metric": (lambda pkg: pkg.scenarios.metric_affinity_scenario(16, 32),
               METRIC_PROFILE),
}


@pytest.fixture(scope="module")
def problem():
    cache = {}

    def get(name):
        if name not in cache:
            build, config = PROBLEMS[name]
            cache[name] = lowered(build, config)
        return cache[name]

    return get


class TestPodStateAndQueue:
    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    @pytest.mark.parametrize("field", ["terminating", "nominated"])
    def test_node_columns_equal_jax(self, problem, name, field):
        j, p = problem(name)
        want = np.asarray(getattr(j.snap.nodes, field))
        got = getattr(p.snap.nodes, field).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)

    def test_roster_columns_are_not_zero(self, problem):
        _, p = problem("roster")
        assert p.snap.nodes.terminating.any()
        assert p.snap.nodes.nominated.any()

    def test_nominees_count_once_by_uid(self):
        """A nominated pod listed both pending and gated counts once."""
        outs = []
        for pkg, build, kw in ((JAX, jax_build_snapshot, {}),
                               (PORT, build_snapshot, {"device": "cpu"})):
            o = pkg.objects
            node = o.Node(name="n0", allocatable={"cpu": 1000, "pods": 10})
            pod = o.Pod(name="p", nominated_node_name="n0")
            snap, _ = build([node], [pod], extra_pods=[pod], **kw)
            nominated = snap.nodes.nominated
            outs.append(np.asarray(nominated) if pkg is JAX
                        else nominated.numpy())
        assert outs[0][0] == outs[1][0] == 1

    @pytest.mark.parametrize("name", ["roster", "roster_tight"])
    def test_podstate_rows_equal_jax(self, problem, name):
        """PodState's raw column, its batch rows and its min-max rows
        (over seeded masks, negative minimums included) equal JAX's."""
        import jax
        import jax.numpy as jnp

        j, p = problem(name)
        jplug, pplug = j.sched.profile.plugins[3], p.sched.profile.plugins[3]
        assert jplug.name == pplug.name == "PodState"
        raw_j = np.asarray(jplug.score(None, j.snap, 0))
        pplug.bind_presolve(pplug.prepare_solve(p.snap))
        raw_p = pplug.score(None, p.snap, 0)
        np.testing.assert_array_equal(raw_p.numpy(), raw_j)
        assert raw_p.dtype == torch.int64 and (raw_p < 0).any()
        batch = pplug.score_batch(None, p.snap)
        assert batch.shape == (p.snap.num_pods, p.snap.num_nodes)
        assert (batch == raw_p[None, :]).all()
        rng = np.random.default_rng(7)
        mask = rng.random(batch.shape) < 0.7
        want = np.asarray(jax.vmap(jplug.normalize)(
            jnp.broadcast_to(jnp.asarray(raw_j), mask.shape),
            jnp.asarray(mask)))
        np.testing.assert_array_equal(
            pplug.normalize(batch, torch.as_tensor(mask)).numpy(), want)

    def test_queue_sort_plugin_and_order_match_jax(self):
        """A profile listing QOSSort and Coscheduling sorts with the
        first plugin that overrides `queue_key` or has `queue_compare`, in
        either order, and both packages give the same queue."""
        def build(pkg):
            c = roster_cluster(pkg, 8, 40, seed=3)
            o = pkg.objects
            c.add_pod_group(o.PodGroup(name="g", namespace="team-a",
                                       min_member=2, creation_ms=5))
            for k in range(3):
                c.add_pod(o.Pod(name=f"g-{k}", namespace="team-a",
                                creation_ms=15_000 + k, priority=100,
                                labels={o.POD_GROUP_LABEL: "g"},
                                containers=[o.Container(
                                    requests={"cpu": 100})]))
            return c

        for plugins in (["QOSSort", "Coscheduling"],
                        ["Coscheduling", "QOSSort"]):
            j, p = lowered(build, {"plugins": plugins})
            assert j.sched.profile.queue_sort.name == \
                p.sched.profile.queue_sort.name == plugins[0]
            assert [x.uid for x in p.pending] == [x.uid for x in j.pending]


# --- the slice: solve, batched solve, cycles -----------------------------------

class TestSolve:
    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    def test_solve_equals_jax(self, problem, name):
        j, p = problem(name)
        res_j = j.sched.solve(j.snap)
        res_p = p.sched.solve(p.snap, device="cpu")
        for k in ("assignment", "admitted", "wait", "failed_plugin"):
            np.testing.assert_array_equal(getattr(res_p, k).numpy(),
                                          np.asarray(getattr(res_j, k)),
                                          err_msg=k)
        assert (res_p.assignment >= 0).any()
        # the very same tensors: JAX's snapshot and carry taken across
        snap_c = snapshot_from_numpy(jax_snapshot_tree(j.snap), device="cpu")
        state_c = state_from_numpy(numpy_tree(j.sched.initial_state(j.snap)),
                                   device="cpu")
        assert_result_equal(p.sched.solve(snap_c, state_c, device="cpu"),
                            res_j)

    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    def test_batch_solve_equals_jax(self, problem, name):
        j, p = problem(name)
        ja, jad, jw, js = jax_profile_batch_solve(j.sched, j.snap,
                                                  collect_stats=True)
        pa, pad, pw, ps = profile_batch_solve(p.sched, p.snap,
                                              collect_stats=True,
                                              device="cpu")
        for got, want, what in ((pa, ja, "assignment"),
                                (pad, jad, "admitted"), (pw, jw, "wait")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=what)
        np.testing.assert_array_equal(ps["occupancy"].numpy(),
                                      np.asarray(js["occupancy"]))
        assert ps["waves"] == int(js["waves"])
        assert (pa >= 0).any()

    def test_roster_reaches_its_branches(self, problem):
        """The roster problem fills every kind: SySched's fallback and
        references, PodState's negative scores, all placed in one cycle's
        solve; the tight one leaves pods unplaced."""
        _, p = problem("roster")
        res = p.sched.solve(p.snap, device="cpu")
        assert (res.assignment[:len(p.pending)] >= 0).all()
        _, t = problem("roster_tight")
        res = t.sched.solve(t.snap, device="cpu")
        assert (res.assignment[:len(t.pending)] < 0).any()


class TestCycles:
    def test_roster_script_matches_jax(self):
        """Two cycles: the first binds the batch; the second's
        preemptors evict only what the toleration policies allow, and the
        HIGH_PRIORITY one overrides them."""
        cluster, (r1, r2) = run_script(roster_script)
        assert len(r1.bound) == 64 and not r1.preempted
        out = toleration_outcomes(cluster, r2.preempted, ROSTER_NOW[1])
        assert out["violations"] == 0
        assert out["evicted"] > 0 and out["overridden"] > 0
        assert out["spared"] > 0
        assert any(cluster.pods[u].priority == HIGH_PRIORITY
                   for u in r2.preempted)

    def test_cross_node_script_matches_jax(self):
        cluster, (r1, r2, r3) = run_script(cross_node_script)
        assert r1.preempted == {
            "default/small": ("a", ["default/v-a2"]),
            "default/big": ("c", ["default/v-c"])}
        assert not r2.bound and not r2.preempted
        assert r3.bound == {"default/small": "a", "default/big": "c"}
        assert r3.failed == ["default/wide"]

    def test_cross_node_tie_goes_to_first_leaf(self):
        """Four identical victims on one node: every one-victim subset
        ranks alike up to the leaf order, so the first leaf of the
        depth-first enumeration (the pool's first pod by (priority, uid))
        is taken."""
        def script(pkg):
            c = pkg.Cluster()
            c.add_node(pkg.o.Node(name="n0", allocatable={
                "cpu": 4000, "memory": 32 * (1 << 30), "pods": 110}))
            for k in range(4):
                v = pkg.o.Pod(name=f"t-{k}", priority=1, containers=[
                    pkg.o.Container(requests={"cpu": 1000})])
                v.node_name = "n0"
                c.add_pod(v)
            c.add_pod(pkg.o.Pod(name="p", priority=10, creation_ms=5,
                                containers=[pkg.o.Container(
                                    requests={"cpu": 1000})]))
            sched = pkg.Scheduler(pkg.Profile(plugins=[
                pkg.plugins.NodeResourcesAllocatable(),
                pkg.plugins.CrossNodePreemption()]))
            return c, sched, [(1000, None)]

        _, (report,) = run_script(script)
        assert report.preempted == {"default/p": ("n0", ["default/t-0"])}

    def test_engines_of_the_two_plugins(self):
        """The engines the plugins select carry JAX's attributes."""
        for pkg_plugins in (jax_plugins, port_plugins):
            tol = pkg_plugins.PreemptionToleration(
                min_candidate_nodes_absolute=3).preemption_engine()
            cross = pkg_plugins.CrossNodePreemption(
                max_pool=5).preemption_engine()
            assert (tol.mode.value, tol.toleration,
                    tol.min_candidate_nodes_absolute) == (
                "Default", True, 3)
            assert (cross.mode.value, cross.CROSS_NODE_MAX_POOL,
                    cross.toleration) == ("CrossNodePreemption", 5, False)
        with pytest.raises(ValueError, match="max_pool"):
            port_plugins.CrossNodePreemption(max_pool=0)


class TestStepIssuesNoHostRead:
    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    @pytest.mark.parametrize("name", ["roster", "metric"])
    def test_no_host_reads(self, problem, name):
        """The roster and metric solves read nothing on the host (so on
        the card they never wait), nor do SySched's and PodState's batch
        rows."""
        _, p = problem(name)
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        with Log():
            p.sched.solve(p.snap, device="cpu")
            for plugin in p.sched.profile.plugins:
                if plugin.name in ("SySched", "PodState"):
                    plugin.score_batch(None, p.snap)
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

    def test_roster_script_card_equals_cpu(self, card):
        """The roster's two cycles on the card and on the CPU: the same
        reports and the same pods, tolerance 0."""
        pkg = SimpleNamespace(o=port_objects, Cluster=PCluster,
                              Profile=Profile, Scheduler=Scheduler,
                              plugins=port_plugins)
        runs = []
        for device in (card, CPU):
            cluster, sched, steps = roster_script(pkg)
            out = []
            for now, mutate in steps:
                if mutate is not None:
                    mutate(pkg, cluster)
                r = port_cycle.run_cycle(sched, cluster, now=now,
                                         device=device)
                out.append((r.bound, r.failed, r.preempted,
                            [(u, p.node_name, p.nominated_node_name,
                              p.deletion_ms)
                             for u, p in cluster.pods.items()]))
            runs.append(out)
        assert runs[0] == runs[1]
