"""The port's explain surface and live weights against the JAX package.

On three flagship clusters (heterogeneous allocatable with a pod that fits
nowhere, `nominee_cluster`, and a small gang + quota cluster with a
quota-rejected gang and a gang below quorum), both packages lower the same
cluster and the port must equal JAX exactly (tolerance 0: every output is
an integer or a bool):

- `Scheduler.explain_rows` in all six outputs, and
  `parallel.solver.batch_explain_rows` equal to it;
- the columns sum to the explain total, which equals the independent
  objective `profile_initial_scores` wherever the two see the same
  feasible set (mirrors tests/test_explain.py);
- pod 0's explain winner is `Scheduler.solve`'s choice for it;
- `utils.flightrec.explain_solver` tables equal JAX's dicts, placed and
  failed pods alike;
- `CycleReport.explain`: the retention window, the empty cycle, a uid
  outside the batch and a retained report explained with its own cycle's
  configuration (mirrors tests/test_explain.py);
- the metric roster of tests/test_explain.py (`metric_affinity_scenario(8,
  16)` with a pod that fits nowhere; TargetLoadPacking,
  LoadVariationRiskBalancing, InterPodAffinity and SySched) through one
  `run_cycle` in both packages: `CycleReport.explain` of every pod equal
  to JAX's, SySched's column among the scores;
- `Scheduler.set_live_weights` + `solve` equal JAX's, with JAX's
  validation errors, the `None` revert and `weights_key`; the explain
  columns under a live vector are JAX's and scale with its weights, and
  a profile of two opposed scoring plugins places differently under two
  vectors.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.api import objects as port_objects
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.parallel.solver import (
    batch_explain_rows,
    profile_initial_scores,
)
from scheduler_plugins_tpu_torch.state import Cluster as PCluster
from scheduler_plugins_tpu_torch.utils import flightrec as port_flightrec
from torch_parity_cases import nominee_cluster

try:
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.parallel.solver import (
        profile_initial_scores as jax_profile_initial_scores,
    )
    from scheduler_plugins_tpu.utils import flightrec as jax_flightrec
    from tests.test_torch_snapshot import JAX, PORT
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    JAX = None

GIB = 1 << 30
CPU = "cpu"
FLAGSHIP = ("NodeResourcesAllocatable", "Coscheduling", "CapacityScheduling")
FIELDS = ("admitted", "fail_code", "feasible", "fit_margin", "columns",
          "total")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def hetero_cluster(pkg):
    """`allocatable_scenario(8, 24)` with small nodes of spread sizes
    (identical nodes would min-max normalize every allocatable column to
    0; small ones fill up in the cycle) and a pod that fits nowhere."""
    o = pkg.objects
    cluster = pkg.scenarios.allocatable_scenario(n_nodes=8, n_pods=24)
    for i, node in enumerate(cluster.nodes.values()):
        node.allocatable["cpu"] = 8000 + 1000 * i
    cluster.add_pod(o.Pod(
        name="impossible", creation_ms=10 ** 6,
        containers=[o.Container(requests={"cpu": 10 ** 9})],
    ))
    return cluster


def small_gang_quota(pkg):
    """`gang_quota_scenario(3, 8, 3)` on nodes of spread sizes, with
    team-2's quota Max letting only 3 of its gang's 8 members in (the rest
    fail on CapacityScheduling in the cycle), a team-0 pod over its
    quota's Max and a gang with fewer members than its MinMember (both
    rejected at PreFilter cycle-initially), and a gang of big members
    outside any quota that cannot reach its MinMember (placed members
    wait, the rest fail on fit)."""
    o = pkg.objects
    cluster = pkg.scenarios.gang_quota_scenario(3, 8, 3)
    for i, node in enumerate(cluster.nodes.values()):
        node.allocatable["cpu"] = 64_000 + 8000 * i
    cluster.quotas["team-2"].max = {"cpu": 3000, "memory": 1024 * GIB}
    cluster.add_pod(o.Pod(
        name="greedy", namespace="team-0", creation_ms=60_000,
        containers=[o.Container(requests={"cpu": 30_000, "memory": GIB})],
    ))
    cluster.add_pod_group(o.PodGroup(name="short", min_member=4))
    for m in range(2):
        cluster.add_pod(o.Pod(
            name=f"short-m{m}", creation_ms=70_000 + m,
            containers=[o.Container(requests={"cpu": 100})],
            labels={o.POD_GROUP_LABEL: "short"},
        ))
    cluster.add_pod_group(o.PodGroup(name="big", namespace="default",
                                     min_member=6))
    for m in range(8):
        cluster.add_pod(o.Pod(
            name=f"big-m{m}", namespace="default", creation_ms=50_000 + m,
            containers=[o.Container(requests={"cpu": 40_000,
                                              "memory": 8 * GIB})],
            labels={o.POD_GROUP_LABEL: "big"},
        ))
    return cluster


def schedulers(names=FLAGSHIP, **alloc_args):
    """(JAX, port) schedulers of the plugins `names`,
    NodeResourcesAllocatable built with `alloc_args`."""
    def build(plugins, name):
        return getattr(plugins, name)(
            **(alloc_args if name == "NodeResourcesAllocatable" else {}))

    return (JScheduler(JProfile(plugins=[build(jax_plugins, n)
                                         for n in names])),
            PScheduler(PProfile(plugins=[build(port_plugins, n)
                                         for n in names])))


def lowered(build, names=FLAGSHIP):
    """Both packages' schedulers, QueueSorted batches, snapshots and metas
    of the cluster `build(pkg)` makes, the plugins prepared."""
    jc, pc = build(JAX), build(PORT)
    js, ps = schedulers(names)
    jpend = js.sort_pending(jc.pending_pods(), jc)
    ppend = ps.sort_pending(pc.pending_pods(), pc)
    snap_j, meta_j = jc.snapshot(jpend, now_ms=0)
    snap_p, meta_p = pc.snapshot(ppend, now_ms=0, device=CPU)
    js.prepare(meta_j, jc)
    ps.prepare(meta_p, pc)
    return SimpleNamespace(js=js, ps=ps, jpend=jpend, ppend=ppend,
                           snap_j=snap_j, snap_p=snap_p, meta_j=meta_j,
                           meta_p=meta_p)


CLUSTERS = {
    "hetero": hetero_cluster,
    "nominees": lambda pkg: nominee_cluster(pkg.objects, pkg.Cluster,
                                            n_nodes=8, n_pods=32),
    "gang_quota": small_gang_quota,
}


@pytest.fixture(scope="module", params=sorted(CLUSTERS))
def case(request):
    """Both packages lowered, and both packages' explain rows of every
    pod of the batch."""
    low = lowered(CLUSTERS[request.param])
    idx = list(range(len(low.ppend)))
    low.name = request.param
    low.idx = idx
    low.rows_j = low.js.explain_rows(low.snap_j, idx)
    low.rows_p = low.ps.explain_rows(low.snap_p, idx, device=CPU)
    return low


class TestExplainRows:
    def test_batch_and_pods_agree(self, case):
        assert case.rows_p["admitted"].shape == (len(case.idx),)
        assert [p.uid for p in case.ppend] == [p.uid for p in case.jpend]

    @pytest.mark.parametrize("field", FIELDS)
    def test_matches_jax(self, case, field):
        want = np.asarray(case.rows_j[field])
        got = case.rows_p[field]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=field)

    def test_columns_sum_to_total_and_objective(self, case):
        rows = case.rows_p
        totals, feasible = profile_initial_scores(case.ps, case.snap_p,
                                                  device=CPU)
        j_totals, j_feasible = jax_profile_initial_scores(case.js,
                                                          case.snap_j)
        np.testing.assert_array_equal(totals.numpy(), np.asarray(j_totals))
        np.testing.assert_array_equal(feasible.numpy(),
                                      np.asarray(j_feasible))
        np.testing.assert_array_equal(rows["columns"].sum(axis=1),
                                      rows["total"])
        # the objective sees no PreFilter and no nominee holds: where the
        # explain's feasible set is the same, so are the scores
        same = [i for i in np.nonzero(rows["admitted"])[0]
                if np.array_equal(rows["feasible"][i], feasible[i].numpy())]
        assert same
        for i in same:
            np.testing.assert_array_equal(rows["total"][i],
                                          totals[i].numpy(), err_msg=str(i))

    def test_batched_equals_sequential(self, case):
        bat = batch_explain_rows(case.ps, case.snap_p, case.idx, device=CPU)
        for field in FIELDS:
            np.testing.assert_array_equal(bat[field], case.rows_p[field],
                                          err_msg=field)

    def test_empty_indices_schema(self, case):
        got = case.ps.explain_rows(case.snap_p, [], device=CPU)
        want = case.js.explain_rows(case.snap_j, [])
        for field in FIELDS:
            assert got[field].shape == want[field].shape, field
            assert got[field].dtype == want[field].dtype, field

    def test_pod0_winner_is_the_solves_choice(self, case):
        assignment = case.ps.solve(case.snap_p, device=CPU).assignment.numpy()
        rows = case.rows_p
        feasible = rows["feasible"][0]
        if assignment[0] < 0:
            assert not feasible.any() or not rows["admitted"][0]
            return
        masked = np.where(feasible, rows["total"][0], -(2 ** 62))
        assert int(np.argmax(masked)) == int(assignment[0])


class TestExplainSolver:
    def test_tables_match_jax(self, case):
        """Every pod's table, placed and failed, with the solve's own
        assignment: the port's dict equals JAX's."""
        a_j = np.asarray(case.js.solve(case.snap_j).assignment)
        a_p = case.ps.solve(case.snap_p, device=CPU).assignment.numpy()
        np.testing.assert_array_equal(a_p, a_j)
        assert (a_p >= 0).any()
        meta_p, meta_j = case.meta_p, case.meta_j
        failed = [i for i in case.idx if a_p[i] < 0]
        placed = [i for i in case.idx if a_p[i] >= 0]
        picks = failed + placed[:6] + placed[-2:]
        assert failed or case.name == "nominees"
        for i in picks:
            uid = meta_p.pod_names[i]
            want = jax_flightrec.explain_solver(
                case.js, case.snap_j, meta_j, uid, top_k=4, assignment=a_j)
            got = port_flightrec.explain_solver(
                case.ps, case.snap_p, meta_p, uid, top_k=4, assignment=a_p,
                device=CPU)
            assert got == want, uid
            batched = port_flightrec.explain_solver(
                case.ps, case.snap_p, meta_p, uid, top_k=4, assignment=a_p,
                batched=True, device=CPU)
            assert batched == {**want, "path": "batched"}, uid
        if placed:
            table = port_flightrec.explain_solver(
                case.ps, case.snap_p, meta_p, meta_p.pod_names[0],
                assignment=a_p, device=CPU)
            if a_p[0] >= 0:
                assert table["winner"] == meta_p.node_names[a_p[0]]
                assert table["candidates"][0]["gap_to_winner"] == 0
        with pytest.raises(KeyError):
            port_flightrec.explain_solver(case.ps, case.snap_p, meta_p,
                                          "not/a-pod", device=CPU)

    def test_nominee_hold_shows_in_fit_margin(self):
        """With a fresh placed mask every live nominee holds capacity, so
        the explain margin sits below the bare free - demand somewhere."""
        low = lowered(CLUSTERS["nominees"])
        idx = list(range(len(low.ppend)))
        rows = low.ps.explain_rows(low.snap_p, idx, device=CPU)
        snap = low.snap_p
        free = (snap.nodes.alloc - snap.nodes.requested).numpy()
        req = snap.pods.req.numpy().copy()
        req[:, low.meta_p.index.position("pods")] = 1
        bare = (free[None, :, :] - req[idx][:, None, :]).min(axis=2)
        mask = snap.nodes.mask.numpy()
        held = rows["fit_margin"][:, mask] < bare[:, mask]
        assert held.any()
        assert (rows["fit_margin"][:, mask] <= bare[:, mask]).all()


class TestExplainIssuesNoHostRead:
    """The explain body reads nothing on the host (no `.item()`, no
    boolean-mask indexing, no tensor made from host data): on the card
    the only wait is the call's one fetch of its outputs."""

    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    def test_no_host_reads(self, case):
        from torch.utils._python_dispatch import TorchDispatchMode

        from scheduler_plugins_tpu_torch.framework.runtime import (
            _explain_rows,
        )

        plugins = tuple(case.ps.profile.plugins)
        for plugin in plugins:
            plugin.bind_presolve(plugin.prepare_solve(case.snap_p))
        state0 = case.ps.initial_state(case.snap_p)
        rows = torch.arange(len(case.idx))
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        with Log():
            out = _explain_rows(plugins, state0, case.snap_p, case.idx, rows)
        assert ops
        assert not [op for op in ops if op.split(".")[0] in self.HOST_READS]
        for field, got in zip(FIELDS, out):
            np.testing.assert_array_equal(got.numpy(), case.rows_p[field])


# --- CycleReport.explain -----------------------------------------------------

def one_node_cluster(pkg_objects, cluster_cls):
    cluster = cluster_cls()
    cluster.add_node(pkg_objects.Node(name="n0", allocatable={
        "cpu": 4000, "memory": 1 << 33, "pods": 110}))
    cluster.add_pod(pkg_objects.Pod(name="p", creation_ms=0, containers=[
        pkg_objects.Container(requests={"cpu": 100})]))
    return cluster


def alloc_scheduler():
    return schedulers(("NodeResourcesAllocatable",))[1]


class TestCycleReportExplain:
    def test_retention_window(self, monkeypatch):
        monkeypatch.setenv("SPT_EXPLAIN_RETAIN", "2")

        def one_cycle():
            return port_cycle.run_cycle(
                alloc_scheduler(), one_node_cluster(port_objects, PCluster),
                now=1000, device=CPU)

        reports = [one_cycle() for _ in range(3)]
        with pytest.raises(RuntimeError, match="released"):
            reports[0].explain("default/p")
        assert reports[-1].explain("default/p")["placed"] is True
        # 0 disables explain outright: not even this cycle's snapshot
        monkeypatch.setenv("SPT_EXPLAIN_RETAIN", "0")
        with pytest.raises(RuntimeError, match="released"):
            one_cycle().explain("default/p")

    def test_empty_cycle_and_foreign_uid(self):
        report = port_cycle.run_cycle(alloc_scheduler(), PCluster(),
                                      now=1000, device=CPU)
        with pytest.raises(RuntimeError, match="no solve"):
            report.explain("any/pod")
        report = port_cycle.run_cycle(
            alloc_scheduler(), one_node_cluster(port_objects, PCluster),
            now=1000, device=CPU)
        with pytest.raises(KeyError):
            report.explain("not/a-pod")

    def test_retained_report_explains_with_its_own_cycles_aux(self):
        """A later cycle re-prepares the SHARED plugins for a cluster with
        one more resource; the old report must explain exactly as before,
        and the cycle after must still equal JAX's."""
        j_sched, p_sched = schedulers(
            ("NodeResourcesAllocatable",),
            resources=(("cpu", 3), ("memory", 1), ("example.com/gpu", 7)))
        seen = []
        for pkg, sched, run in (
            (JAX, j_sched, lambda s, c, now: jax_cycle.run_cycle(s, c, now)),
            (PORT, p_sched, lambda s, c, now: port_cycle.run_cycle(
                s, c, now, device=CPU)),
        ):
            report_a = run(sched, hetero_cluster(pkg), 1000)
            uid, node = next(iter(report_a.bound.items()))
            before = report_a.explain(uid)
            assert before["assigned"] == node
            cluster_b = pkg.scenarios.allocatable_scenario(n_nodes=4,
                                                           n_pods=3)
            for i, n in enumerate(cluster_b.nodes.values()):
                n.allocatable["example.com/gpu"] = 4 + i
            report_b = run(sched, cluster_b, 2000)
            live = [p.aux() for p in sched.profile.plugins]
            after = report_a.explain(uid)
            assert after == before
            # the shared plugins hold cycle B's tensors again
            assert all(p.aux() is a
                       for p, a in zip(sched.profile.plugins, live))
            cluster_b.add_pod(pkg.objects.Pod(
                name="late", creation_ms=3000,
                containers=[pkg.objects.Container(requests={"cpu": 500})]))
            report_c = run(sched, cluster_b, 3000)
            seen.append((before, report_b.bound, report_c.bound,
                         report_c.explain("default/late")))
        assert seen[0] == seen[1]


class TestMetricRosterExplain:
    def test_cycle_explain_matches_jax(self):
        """Every placed and failed pod's explain table, the SySched
        column included, equals JAX's."""
        names = ("TargetLoadPacking", "LoadVariationRiskBalancing",
                 "InterPodAffinity", "SySched")
        tables = []
        for pkg, plugins, sched_cls, profile_cls, run in (
                (JAX, jax_plugins, JScheduler, JProfile,
                 lambda s, c: jax_cycle.run_cycle(s, c, now=1000)),
                (PORT, port_plugins, PScheduler, PProfile,
                 lambda s, c: port_cycle.run_cycle(s, c, now=1000,
                                                   device=CPU))):
            cluster = pkg.scenarios.metric_affinity_scenario(8, 16)
            cluster.add_pod(pkg.objects.Pod(
                name="impossible", creation_ms=10 ** 6,
                containers=[pkg.objects.Container(
                    requests={"cpu": 10 ** 9})]))
            sched = sched_cls(profile_cls(plugins=[getattr(plugins, n)()
                                                   for n in names]))
            report = run(sched, cluster)
            uids = list(report.bound) + list(report.failed)
            tables.append({uid: report.explain(uid) for uid in uids})
        assert tables[0] == tables[1]
        port = tables[1]
        assert "default/impossible" in port and len(port) == 17
        sysched = [c["scores"]["SySched"] for t in port.values()
                   for c in t["candidates"]]
        assert sysched and len(set(sysched)) > 1


# --- live weights ------------------------------------------------------------

LIVE_VECTORS = ([3, 1, 1], [1, 5, 2], [7, 1, 3])


class TestLiveWeights:
    @pytest.mark.parametrize("cluster", ["hetero", "gang_quota"])
    def test_live_solve_matches_jax(self, cluster):
        low = lowered(CLUSTERS[cluster])
        idx = list(range(len(low.ppend)))
        unit = low.ps.explain_rows(low.snap_p, idx, device=CPU)["columns"]
        # spread node sizes: the allocatable column is not all zero, so a
        # weight that failed to reach the fold would show
        assert unit[:, 0].max() > 0
        outs = []
        # one scoring plugin in the flagship: a positive weight scales its
        # column and leaves the argmax, so the placements stay the same
        for w in LIVE_VECTORS:
            low.js.set_live_weights(w)
            low.ps.set_live_weights(w)
            assert low.ps.weights_key() == low.js.weights_key()
            assert list(low.ps.live_weights) == w
            res_j = low.js.solve(low.snap_j)
            res_p = low.ps.solve(low.snap_p, device=CPU)
            for k in ("assignment", "admitted", "wait", "failed_plugin"):
                np.testing.assert_array_equal(
                    getattr(res_p, k).numpy(), np.asarray(getattr(res_j, k)),
                    err_msg=f"{w} {k}")
            np.testing.assert_array_equal(res_p.state.free.numpy(),
                                          np.asarray(res_j.state.free))
            outs.append(res_p.assignment.numpy())
            # the explain fold under the same vector: JAX's columns, each
            # the unit-weight column times its weight
            cols = low.ps.explain_rows(low.snap_p, idx, device=CPU)["columns"]
            np.testing.assert_array_equal(
                cols, np.asarray(low.js.explain_rows(low.snap_j,
                                                     idx)["columns"]),
                err_msg=f"{w} columns")
            np.testing.assert_array_equal(
                cols, np.asarray(w, np.int64)[None, :, None] * unit,
                err_msg=f"{w} columns != weight * unit columns")
        # a static profile built with the last vector solves the same
        static = lowered(CLUSTERS[cluster])
        for plugin, w in zip(static.ps.profile.plugins, LIVE_VECTORS[-1]):
            plugin.weight = w
        np.testing.assert_array_equal(
            static.ps.solve(static.snap_p, device=CPU).assignment.numpy(),
            outs[-1])

    def test_live_weights_move_a_two_scorer_solve(self):
        """Two scoring plugins that rank the nodes in opposite orders
        (allocatable Least and Most): the live vector decides which one
        wins, so the placements move with it, and each equals JAX's."""
        low = lowered(hetero_cluster)

        def two_scorers(plugins):
            return [plugins.NodeResourcesAllocatable(mode="Least"),
                    plugins.NodeResourcesAllocatable(mode="Most")]

        js = JScheduler(JProfile(plugins=two_scorers(jax_plugins)))
        ps = PScheduler(PProfile(plugins=two_scorers(port_plugins)))
        js.prepare(low.meta_j)
        ps.prepare(low.meta_p)
        outs = []
        for w in ([3, 1], [1, 3]):
            js.set_live_weights(w)
            ps.set_live_weights(w)
            res_j = js.solve(low.snap_j)
            res_p = ps.solve(low.snap_p, device=CPU)
            for k in ("assignment", "admitted", "wait", "failed_plugin"):
                np.testing.assert_array_equal(
                    getattr(res_p, k).numpy(), np.asarray(getattr(res_j, k)),
                    err_msg=f"{w} {k}")
            outs.append(res_p.assignment.numpy())
        assert (outs[0] != outs[1]).any()

    def test_validation_revert_and_key(self):
        js, ps = schedulers()
        for bad, match in (([1, 2], "shape"), ([1, 0, 1], "positive")):
            with pytest.raises(ValueError, match=match) as got:
                ps.set_live_weights(bad)
            with pytest.raises(ValueError, match=match) as want:
                js.set_live_weights(bad)
            assert str(got.value) == str(want.value)
        assert ps.weights_key() == js.weights_key() == ("weights", 1, 1, 1)
        for s in (js, ps):
            s.set_live_weights([4, 2, 1])
            s.set_live_weights(None)
        assert ps.live_weights is None and js.live_weights is None
        # the ints are not restored
        assert ps.weights_key() == js.weights_key() == ("weights", 4, 2, 1)

    def test_none_revert_solves_like_jax(self):
        """After `None` both packages solve with the ints the last vector
        left (JAX's static program traced after the swap). On the
        flagship one scoring plugin hides which ints a solve uses; on
        TLP + LVRB (`trimaran_scenario(32, 96)`) `[3, 1]` and `[1, 3]`
        place pods differently, so the revert shows it: the port, and a
        JAX scheduler whose static program is traced after the swap,
        place as `[1, 3]` does, while JAX's static program traced BEFORE
        the swap still multiplies by the `[1, 1]` it baked in (its cache
        key holds no weights), as ROADMAP Queue 3 records."""
        low = lowered(hetero_cluster)
        for s in (low.js, low.ps):
            s.set_live_weights([5, 1, 1])
            s.set_live_weights(None)
        np.testing.assert_array_equal(
            low.ps.solve(low.snap_p, device=CPU).assignment.numpy(),
            np.asarray(low.js.solve(low.snap_j).assignment))

        tri = lowered(lambda pkg: pkg.scenarios.trimaran_scenario(32, 96),
                      names=("TargetLoadPacking",
                             "LoadVariationRiskBalancing"))
        traced_before = np.asarray(tri.js.solve(tri.snap_j).assignment)
        placed = {}
        for w in ([3, 1], [1, 3]):
            for s in (tri.js, tri.ps):
                s.set_live_weights(w)
            placed[tuple(w)] = tri.ps.solve(tri.snap_p,
                                            device=CPU).assignment.numpy()
            np.testing.assert_array_equal(
                placed[tuple(w)],
                np.asarray(tri.js.solve(tri.snap_j).assignment),
                err_msg=f"{w}")
        assert (placed[(3, 1)] != placed[(1, 3)]).any()
        for s in (tri.js, tri.ps):
            s.set_live_weights(None)
        reverted = tri.ps.solve(tri.snap_p, device=CPU).assignment.numpy()
        np.testing.assert_array_equal(reverted, placed[(1, 3)])
        fresh, _ = schedulers(("TargetLoadPacking",
                               "LoadVariationRiskBalancing"))
        for plugin, w in zip(fresh.profile.plugins, (1, 3)):
            plugin.weight = w
        fresh.prepare(tri.meta_j, None)
        np.testing.assert_array_equal(
            reverted, np.asarray(fresh.solve(tri.snap_j).assignment))
        # the reference's stale program: what it was traced with
        stale = np.asarray(tri.js.solve(tri.snap_j).assignment)
        np.testing.assert_array_equal(stale, traced_before)
        assert (stale != reverted).any()

    def test_columns_scale_with_the_weight(self):
        low = lowered(hetero_cluster)
        low.ps.set_live_weights([3, 1, 1])
        low.js.set_live_weights([3, 1, 1])
        rows = low.ps.explain_rows(low.snap_p, [0], device=CPU)
        want = low.js.explain_rows(low.snap_j, [0])
        np.testing.assert_array_equal(rows["columns"], want["columns"])
        totals, _ = profile_initial_scores(low.ps, low.snap_p, device=CPU)
        np.testing.assert_array_equal(rows["columns"][0].sum(axis=0),
                                      totals[0].numpy())
        col = rows["columns"][0][0]
        assert col.max() > 0
        np.testing.assert_array_equal(col, (col // 3) * 3)
