"""The port's network-aware slice (`scheduler_plugins_tpu_torch.ops.network`,
`.plugins.networkaware`, the snapshot's region / zone codes and network
table, the store's AppGroup / NetworkTopology CRs, the `net_placed` carry
and the post-eviction re-filter of preemption) against the JAX package.

Ops: seeded (W, D, N, ZC, RC) problems (unlabelled, region-only and
zoned nodes, masked dependency slots, missing cost pairs, repeated
placements) go through JAX `dependency_tallies` (vmapped over the class
rows), JAX `class_dependency_tallies` and the port's two; `placed_commit`
against JAX's. Tolerance 0: every tally is an integer count or cost, and
both packages contract exactly (JAX in float32 at HIGHEST precision, the
port in float64, which TF32 settings never touch: `TestExactness` turns
TF32 and "medium" matmul precision on and checks every contraction's
dtype).

The decision tables of `tests/test_networkaware_tables.py` and
`tests/test_networkaware.py` run again with the JAX names they call
swapped for the port's. `Scheduler.solve` and `profile_batch_solve` are
held bit for bit on each `torch_network_cases` case (assignment,
admitted, wait, failed_plugin, every final carry, `net_placed`
included, the wave stats), as are the plugin's hooks, the explain rows,
QueueSort's order, the post-eviction tables and `run_cycle` cycle by
cycle on `network_cycle_script`, whose third cycle's preemption turns on
the post-eviction re-filter.

The `cuda`-marked test runs on a card only (`python -m pytest
tests/test_torch_network.py -m cuda`); it needs no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.ops import network as t_net
from scheduler_plugins_tpu_torch.ops.normalize import peaks_normalize
from scheduler_plugins_tpu_torch.parallel.solver import (
    batch_explain_rows,
    profile_batch_solve,
)
from scheduler_plugins_tpu_torch.plugins import (
    NetworkOverhead,
    TopologicalSort,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_network_cases import (
    CASES,
    dependency_violations,
    network_case,
    network_cycle_script,
)
from torch_numa_cases import solve_inputs
from torch_parity_cases import parity_outputs

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.ops.network as j_net
    import tests.test_networkaware as jax_cluster_tables
    import tests.test_networkaware_tables as jax_tables
    from scheduler_plugins_tpu.framework import Scheduler as JScheduler
    from scheduler_plugins_tpu.parallel.solver import (
        batch_explain_rows as jax_batch_explain_rows,
        profile_batch_solve as jax_profile_batch_solve,
    )
    from tests.test_torch_cycle import run_script
    from tests.test_torch_numa import _CPUCluster
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


def t(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


def assert_same(port_value, jax_value, msg=""):
    got = port_value.cpu().numpy()
    want = np.asarray(jax_value)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


# --- seeded tally problems -----------------------------------------------------

def tally_inputs(seed: int, scale: int = 4):
    """A random tally problem: W classes of D dependency slots (some
    masked, some pointing at -1), N nodes mixing zoned, region-only and
    unlocated ones, ZC zones (some of unknown region), RC regions, cost
    matrices with missing (-1) pairs, and placed counts below `scale`."""
    rng = np.random.default_rng(seed)
    W = int(rng.integers(1, 7))
    D = int(rng.integers(1, 4))
    N = int(rng.integers(4, 40))
    ZC = int(rng.integers(1, 7))
    RC = int(rng.integers(1, 4))
    node_zone = rng.integers(-1, ZC, N).astype(np.int32)
    return SimpleNamespace(
        zone_region=rng.integers(-1, RC, ZC).astype(np.int32),
        zone_cost=rng.integers(-1, 30, (ZC, ZC)).astype(np.int64),
        region_cost=rng.integers(-1, 60, (RC, RC)).astype(np.int64),
        node_zone=node_zone,
        node_region=np.where(rng.random(N) < 0.2, -1,
                             rng.integers(0, RC, N)).astype(np.int32),
        placed=rng.integers(0, scale, (W, N)).astype(np.int32),
        dep_workload=rng.integers(-1, W, (W, D)).astype(np.int32),
        dep_max_cost=rng.integers(0, 60, (W, D)).astype(np.int64),
        dep_mask=rng.random((W, D)) < 0.7,
    )


def node_args(x, conv):
    return (conv(x.placed), conv(x.node_zone), conv(x.node_region),
            conv(x.zone_region), conv(x.zone_cost), conv(x.region_cost))


def jax_per_class(x):
    args = node_args(x, jnp.asarray)
    return jax.vmap(lambda dw, mc, dm: j_net.dependency_tallies(
        dw, mc, dm, *args))(jnp.asarray(x.dep_workload),
                            jnp.asarray(x.dep_max_cost),
                            jnp.asarray(x.dep_mask))


class TestOps:
    @pytest.mark.parametrize("seed", range(3))
    def test_dependency_tallies(self, seed):
        """Each class row through the port's per-pod tallies equals JAX's
        (int64), with the pair tables built per call and hoisted."""
        x = tally_inputs(seed)
        want = jax_per_class(x)
        args = node_args(x, t)
        tables = t_net.pair_tables(*args[1:])
        for w in range(x.dep_workload.shape[0]):
            row = (t(x.dep_workload[w]), t(x.dep_max_cost[w]),
                   t(x.dep_mask[w]))
            for kw in ({}, {"tables": tables}):
                got = t_net.dependency_tallies(*row, *args, **kw)
                for k in range(3):
                    assert_same(got[k], want[k][w], f"row {w} out {k} {kw}")

    @pytest.mark.parametrize("seed", range(4))
    def test_class_tallies(self, seed):
        """The port's class tallies (int32) equal JAX's class tallies and
        the vmapped per-pod ones; the counts-only form equals their
        satisfied / violated half."""
        x = tally_inputs(seed)
        args_j = node_args(x, jnp.asarray)
        want = j_net.class_dependency_tallies(
            jnp.asarray(x.dep_workload), jnp.asarray(x.dep_max_cost),
            jnp.asarray(x.dep_mask), *args_j)
        got = t_net.class_dependency_tallies(
            t(x.dep_workload), t(x.dep_max_cost), t(x.dep_mask),
            *node_args(x, t))
        counts = t_net.class_dependency_counts(
            t(x.dep_workload), t(x.dep_max_cost), t(x.dep_mask),
            *node_args(x, t))
        per_class = jax_per_class(x)
        for k in range(3):
            assert_same(got[k], want[k], f"out {k}")
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(per_class[k]))
        for k in range(2):
            assert_same(counts[k], want[k], f"counts {k}")

    @pytest.mark.parametrize("seed", range(4))
    def test_placed_commit(self, seed):
        rng = np.random.default_rng(seed)
        W, N, P = 5, 12, 40
        placed = rng.integers(0, 3, (W, N)).astype(np.int32)
        workload = rng.integers(-1, W, P).astype(np.int32)
        choice = rng.integers(-1, N, P).astype(np.int32)
        want = j_net.placed_commit(jnp.asarray(placed), jnp.asarray(workload),
                                   jnp.asarray(choice))
        base = t(placed)
        got = t_net.placed_commit(base, t(workload), t(choice))
        assert_same(got, want)
        assert torch.equal(base, t(placed))  # a new tensor, input intact
        one = t_net.placed_commit(base, t(workload[:1]), t(choice[:1]))
        assert_same(one, j_net.placed_commit(
            jnp.asarray(placed), jnp.asarray(workload[0]),
            jnp.asarray(choice[0])))


class TestExactness:
    """The tallies feed hard Filter verdicts, so no matmul precision
    setting may round them: the contractions run in float64."""

    @pytest.fixture
    def fast_matmul(self):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        precision = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        yield
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)

    def test_large_counts_exact_with_tf32_on(self, fast_matmul):
        """Counts past 2^11 (where TF32's 10-bit mantissa and bfloat16
        round) still equal JAX's exact tallies, and every contraction
        the two tally forms make is float64."""
        x = tally_inputs(3, scale=1 << 13)
        dtypes = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.__name__.split(".")[0] in ("mm", "bmm", "addmm",
                                                   "mv", "dot", "matmul"):
                    dtypes.append(args[0].dtype)
                return func(*args, **(kwargs or {}))

        with Log():
            got = t_net.class_dependency_tallies(
                t(x.dep_workload), t(x.dep_max_cost), t(x.dep_mask),
                *node_args(x, t))
            per = t_net.dependency_tallies(
                t(x.dep_workload[0]), t(x.dep_max_cost[0]),
                t(x.dep_mask[0]), *node_args(x, t))
        want = jax_per_class(x)
        for k in range(3):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(per[k].numpy(),
                                          np.asarray(want[k][0]))
        assert int(np.asarray(want[2]).max()) > (1 << 12)
        assert dtypes and set(dtypes) == {torch.float64}


# --- the JAX decision tables against the port ------------------------------------

def _port_call(fn):
    """`fn` of the port on the JAX tables' arguments (JAX arrays) as
    tensors, returning numpy."""
    def call(*args, **kwargs):
        out = fn(*[a if isinstance(a, (int, float)) else t(a)
                   for a in args], **kwargs)
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()

    return call


def _tables(modules):
    if JAX is None:
        return []
    out = []
    for module in modules:
        for cls_name, cls in sorted(vars(module).items()):
            if not (cls_name.startswith("Test") and isinstance(cls, type)):
                continue
            for name in sorted(vars(cls)):
                fn = getattr(cls, name)
                marks = getattr(fn, "pytestmark", [])
                if name.startswith("test_") and not any(
                        m.name == "slow" for m in marks):
                    out.append(pytest.param(
                        cls, name, id=f"{cls_name}.{name}"))
    return out


@pytest.mark.parametrize("cls,method",
                         _tables([jax_tables] if JAX is not None else []))
def test_tally_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_networkaware_tables.py` (the reference's
    score goldens, filter verdicts, edge semantics and commits) on the
    port's ops."""
    monkeypatch.setattr(jax_tables, "dependency_tallies",
                        _port_call(t_net.dependency_tallies))
    monkeypatch.setattr(jax_tables, "placed_commit",
                        _port_call(t_net.placed_commit))
    monkeypatch.setattr(jax_tables, "peaks_normalize",
                        _port_call(peaks_normalize))
    monkeypatch.setattr(jax_tables, "MAX_COST", t_net.MAX_COST)
    getattr(cls(), method)()


@pytest.mark.parametrize(
    "cls,method", _tables([jax_cluster_tables] if JAX is not None else []))
def test_cluster_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_networkaware.py` (placement preference,
    region filtering, label-less dependencies, in-cycle visibility,
    topological queue order) through the port's store, scheduler and
    cycle."""
    for name in ("AppGroup", "AppGroupDependency", "AppGroupWorkload",
                 "Container", "NetworkTopology", "Node", "Pod"):
        monkeypatch.setattr(jax_cluster_tables, name,
                            getattr(port_objects, name))
    monkeypatch.setattr(jax_cluster_tables, "Cluster", _CPUCluster)
    monkeypatch.setattr(jax_cluster_tables, "Scheduler", Scheduler)
    monkeypatch.setattr(jax_cluster_tables, "Profile", Profile)
    monkeypatch.setattr(jax_cluster_tables, "NetworkOverhead",
                        NetworkOverhead)
    monkeypatch.setattr(jax_cluster_tables, "TopologicalSort",
                        TopologicalSort)
    monkeypatch.setattr(
        jax_cluster_tables, "run_cycle",
        lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now=now, device="cpu", **kw))
    getattr(cls(), method)()


# --- the parity path --------------------------------------------------------------

@pytest.fixture(scope="module")
def solved():
    cache = {}

    def get(name):
        if name not in cache:
            (jc, config), (pc, _) = (network_case(name, JAX),
                                     network_case(name, PORT))
            js = JScheduler(jax_config.load_profile(config))
            ps = Scheduler(port_config.load_profile(config))
            jpend, snap_j, meta_j = solve_inputs(js, jc)
            ppend, snap_p, meta_p = solve_inputs(ps, pc, device="cpu")
            state_j = js.initial_state(snap_j)
            snap_c = snapshot_from_numpy(jax_snapshot_tree(snap_j),
                                         device="cpu")
            state_c = state_from_numpy(numpy_tree(state_j), device="cpu")
            cache[name] = SimpleNamespace(
                config=config, jc=jc, pc=pc, js=js, ps=ps, jpend=jpend,
                ppend=ppend, snap_j=snap_j, meta_j=meta_j, snap_p=snap_p,
                meta_p=meta_p, snap_c=snap_c, state_j=state_j,
                state_c=state_c,
                res_j=js.solve(snap_j, state_j),
                res_c=ps.solve(snap_c, state_c, device="cpu"),
                res_p=ps.solve(snap_p, device="cpu"))
        return cache[name]

    return get


def _plugin(sched):
    return next(p for p in sched.profile.plugins
                if p.name == "NetworkOverhead")


class TestSolveParity:
    @pytest.mark.parametrize("name", CASES)
    def test_lowering_equals_jax(self, solved, name):
        """The port lowers the cluster to JAX's tensors (region / zone
        codes, the network table) with JAX's codes, in JAX's queue order
        (TopologicalSort's pairwise comparator)."""
        s = solved(name)
        assert [p.uid for p in s.ppend] == [p.uid for p in s.jpend]
        for attr in ("regions", "zones", "workloads", "node_names"):
            assert getattr(s.meta_p, attr) == getattr(s.meta_j, attr), attr
        want, got = s.snap_c.numpy(), s.snap_p.numpy()
        assert got.keys() == want.keys() and "network" in got
        for table in got:
            for field, value in got[table].items():
                np.testing.assert_array_equal(
                    value, want[table][field], err_msg=f"{table}.{field}")
                assert value.dtype == want[table][field].dtype
        jp, pp = _plugin(s.js), _plugin(s.ps)
        assert_same(pp._zone_cost, jp._zone_cost)
        assert_same(pp._region_cost, jp._region_cost)

    @pytest.mark.parametrize("name", CASES)
    def test_carried_inputs_equal_jax_solve(self, solved, name):
        s = solved(name)
        assert_result_equal(s.res_c, s.res_j)

    @pytest.mark.parametrize("name", CASES)
    def test_own_lowering_equals_jax_solve(self, solved, name):
        s = solved(name)
        assert_result_equal(s.res_p, s.res_j)
        assert (s.res_p.assignment >= 0).any()
        assert s.res_p.state.net_placed is not None

    def test_the_cases_reach_their_branches(self, solved):
        """Pods the network Filter rejects (failed_plugin names it),
        pods that capacity rejects, and placements the carry counts."""
        codes = {}
        for name in CASES:
            s = solved(name)
            index = 1 + [type(p) for p in s.ps.profile.plugins].index(
                NetworkOverhead)
            codes[name] = (s.res_p.failed_plugin == index).sum().item()
            placed = (s.res_p.assignment >= 0).sum().item()
            gained = (s.res_p.state.net_placed.sum()
                      - s.snap_p.network.placed_node.sum()).item()
            assert gained <= placed
        assert codes["placed_mesh"] > 0 and codes["labels"] > 0
        assert (solved("placed_mesh").res_p.failed_plugin == 0).any()

    @pytest.mark.parametrize("name", CASES)
    def test_no_dependency_violations(self, solved, name):
        """The host oracle replays the placements: no placed pod broke
        its dependency threshold."""
        s = solved(name)
        plugin = _plugin(s.ps)
        assert dependency_violations(
            s.pc, s.ppend, s.res_p.assignment.numpy(), s.meta_p.node_names,
            plugin.weights_name, plugin.network_topology_name) == 0

    def test_oracle_sees_a_violation(self, solved):
        """The oracle is not blind: a pod the network Filter rejected,
        placed anyway on some node, is a violation there."""
        s = solved("placed_mesh")
        plugin = _plugin(s.ps)
        index = 1 + [type(p) for p in s.ps.profile.plugins].index(
            NetworkOverhead)
        p = int(np.nonzero(s.res_p.failed_plugin.numpy() == index)[0][0])
        found = 0
        for n in range(len(s.meta_p.node_names)):
            bad = s.res_p.assignment.numpy().copy()
            bad[p] = n
            found += dependency_violations(
                s.pc, s.ppend, bad, s.meta_p.node_names, plugin.weights_name,
                plugin.network_topology_name)
        assert found >= 1


class TestHooks:
    @pytest.mark.parametrize("name", CASES)
    def test_per_pod_and_batch_rows_equal_jax(self, solved, name):
        """filter / score for every pod against the cycle-initial state
        and against one with seeded in-cycle placements, and the
        class-collapsed `batch_rows`, equal JAX's; the batch rows equal
        the per-pod ones, and `filter_batch` / `score_batch` each equal
        their half."""
        s = solved(name)
        jp, pp = _plugin(s.js), _plugin(s.ps)
        rng = np.random.default_rng(1)
        placed0 = np.asarray(s.state_j.net_placed)
        placed1 = placed0 + rng.integers(0, 3, placed0.shape).astype(
            placed0.dtype)
        pp.bind_presolve(pp.prepare_solve(s.snap_p))
        jp.bind_aux(jp.aux())
        jfilter = jax.jit(lambda st, sn, p: jp.filter(st, sn, p))
        jscore = jax.jit(lambda st, sn, p: jp.score(st, sn, p))
        for placed in (placed0, placed1):
            sj = s.state_j.replace(net_placed=jnp.asarray(placed))
            sp = s.ps.initial_state(s.snap_p).replace(net_placed=t(placed))
            fb, sb = pp.batch_rows(sp, s.snap_p)
            jfb, jsb = jp.batch_rows(sj, s.snap_j)
            assert_same(fb, jfb, "filter_batch")
            assert_same(sb, jsb, "score_batch")
            assert torch.equal(pp.filter_batch(sp, s.snap_p), fb)
            assert torch.equal(pp.score_batch(sp, s.snap_p), sb)
            for p in range(0, len(s.ppend), 3):
                f = pp.filter(sp, s.snap_p, p)
                sc = pp.score(sp, s.snap_p, p)
                assert_same(f, jfilter(sj, s.snap_j, p), f"filter {p}")
                assert_same(sc, jscore(sj, s.snap_j, p), f"score {p}")
                assert torch.equal(fb[p], f)
                assert torch.equal(sb[p].long(), sc)

    def test_commit_batch_equals_commits(self, solved):
        s = solved("placed_mesh")
        pp = _plugin(s.ps)
        state = s.ps.initial_state(s.snap_p)
        choice = s.res_p.assignment
        batched = pp.commit_batch(state, s.snap_p, choice >= 0, choice)
        one = state
        for p in range(s.snap_p.num_pods):
            one = pp.commit(one, s.snap_p, p, choice[p:p + 1])
        assert torch.equal(batched.net_placed, one.net_placed)
        assert torch.equal(batched.net_placed, s.res_p.state.net_placed)
        # the snapshot's table is never written
        assert torch.equal(state.net_placed, s.snap_p.network.placed_node)
        assert not torch.equal(batched.net_placed, state.net_placed)


class TestBatchSolve:
    @pytest.mark.parametrize("name", CASES)
    def test_equals_jax(self, solved, name):
        """`profile_batch_solve(collect_stats=True)`: assignment,
        admitted, wait and the wave stats equal JAX's; the snapshot's
        placement table is untouched; no placed pod breaks its dependency
        threshold in the waves' commit order."""
        s = solved(name)
        before = s.snap_p.network.placed_node.clone()
        got = profile_batch_solve(s.ps, s.snap_p, collect_stats=True,
                                  device="cpu")
        want = jax_profile_batch_solve(s.js, s.snap_j, collect_stats=True)
        for k in range(3):
            assert_same(got[k], want[k], f"output {k}")
        assert got[3]["waves"] == int(want[3]["waves"])
        np.testing.assert_array_equal(got[3]["occupancy"].numpy(),
                                      np.asarray(want[3]["occupancy"]))
        assert torch.equal(s.snap_p.network.placed_node, before)
        plugin = _plugin(s.ps)
        assert dependency_violations(
            s.pc, s.ppend, got[0].numpy(), s.meta_p.node_names,
            plugin.weights_name, plugin.network_topology_name,
            wave_of=got[3]["wave_of"].numpy()) == 0


class TestExplain:
    @pytest.mark.parametrize("name", ["placed_mesh", "custom_topology"])
    def test_rows_equal_jax(self, solved, name):
        """`Scheduler.explain_rows` and `batch_explain_rows` (through the
        class rows) equal JAX's, field by field."""
        s = solved(name)
        idx = [0, 1, 7, len(s.ppend) // 2, len(s.ppend) - 1]
        for port_fn, jax_fn in (
                (s.ps.explain_rows, s.js.explain_rows),
                (lambda snap, i, **kw: batch_explain_rows(s.ps, snap, i,
                                                          **kw),
                 lambda snap, i: jax_batch_explain_rows(s.js, snap, i))):
            want = jax_fn(s.snap_j, idx)
            got = port_fn(s.snap_p, idx, device="cpu")
            for field in want:
                np.testing.assert_array_equal(
                    got[field], np.asarray(want[field]), err_msg=field)


class TestQueueSort:
    @pytest.mark.parametrize("name", CASES)
    def test_order_equals_jax(self, name):
        """TopologicalSort's order equals JAX `sort_pending`'s on each
        case, from the store's order and from a shuffled one."""
        (jc, config), (pc, _) = network_case(name, JAX), network_case(
            name, PORT)
        js = JScheduler(jax_config.load_profile(config))
        ps = Scheduler(port_config.load_profile(config))
        rng = np.random.default_rng(5)
        jpods, ppods = jc.pending_pods(), pc.pending_pods()
        perm = rng.permutation(len(jpods))
        for order in (np.arange(len(jpods)), perm):
            want = [p.uid for p in js.sort_pending(
                [jpods[i] for i in order], jc)]
            got = [p.uid for p in ps.sort_pending(
                [ppods[i] for i in order], pc)]
            assert got == want


class TestPreemption:
    def test_post_eviction_tables_equal_jax(self, solved):
        """`Cluster.post_eviction_tables` decrements the evicted pods'
        placements as JAX's does, and shares every other table."""
        s = solved("labels")
        bound = [p.uid for p in s.pc.pods.values()
                 if p.node_name is not None][:9]
        got = s.pc.post_eviction_tables(s.snap_p, s.meta_p, bound)
        want = s.jc.post_eviction_tables(s.snap_j, s.meta_j, bound)
        assert_same(got.network.placed_node, want.network.placed_node)
        assert not torch.equal(got.network.placed_node,
                               s.snap_p.network.placed_node)
        assert got.nodes is s.snap_p.nodes and got.numa is s.snap_p.numa

    def test_cycle_script_matches_jax(self):
        """`network_cycle_script` cycle by cycle: reports and store equal
        JAX's; cycle 2 binds web-0 through cycle 1's bind; cycle 3's
        nomination is nb2 with its fillers as victims, as JAX chooses."""
        _, reports = run_script(network_cycle_script)
        r1, r2, r3, r4 = reports
        assert r1.bound == {"default/db-near": "nb1"}
        assert r2.bound == {"default/web-0": "nb1"}
        node, victims = r3.preempted["default/web-hi"]
        assert node == "nb2"
        assert sorted(victims) == ["default/fill-b2-1", "default/fill-b2-2"]
        assert r4.bound == {"default/web-hi": "nb2"}

    def test_refilter_flips_the_candidate(self):
        """What the post-eviction re-filter decides in the script's third
        cycle: nb1 passes the Filter as the store stands, and fails once
        db-near (among its victims) is evicted."""
        from tests.test_torch_cycle import PORT as CPORT

        c, s, steps = network_cycle_script(CPORT)
        for now, mutate in steps[:2]:
            if mutate is not None:
                mutate(CPORT, c)
            CPORT.run(s, c, now)
        steps[2][1](CPORT, c)
        pending = s.sort_pending(c.pending_pods(), c)
        snap, meta = c.snapshot(pending, device="cpu")
        s.prepare(meta, c)
        p = meta.pod_names.index("default/web-hi")
        nb1 = meta.node_names.index("nb1")
        assert s.filter_verdicts(snap, p)[nb1]
        hyp = c.post_eviction_tables(snap, meta, {"default/db-near"})
        assert not s.filter_verdicts(hyp, p)[nb1]


class TestStepIssuesNoHostRead:
    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    @pytest.mark.parametrize("name", ["config5_small", "labels"])
    def test_no_host_reads(self, solved, name):
        """The network solve reads nothing on the host, so on the card it
        never waits."""
        s = solved(name)
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        with Log():
            s.ps.solve(s.snap_c, s.state_c, device="cpu")
        assert ops
        assert not [op for op in ops if op.split(".")[0] in self.HOST_READS]


class TestScenario:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_same_cluster_as_jax(self, seed):
        """`network_scenario` draws what JAX's draws: nodes and labels,
        the AppGroup, the topology weights, the pods."""
        jc = JAX.scenarios.network_scenario(24, 60, seed=seed)
        pc = port_scenarios.network_scenario(24, 60, seed=seed)
        assert [(n.name, dict(n.labels), dict(n.allocatable))
                for n in pc.nodes.values()] == [
            (n.name, dict(n.labels), dict(n.allocatable))
            for n in jc.nodes.values()]
        assert [(p.uid, dict(p.labels), p.effective_request())
                for p in pc.pods.values()] == [
            (p.uid, dict(p.labels), p.effective_request())
            for p in jc.pods.values()]
        ag_j, ag_p = jc.app_groups["default/mesh"], pc.app_groups[
            "default/mesh"]
        assert [(w.selector, [(d.workload_selector, d.max_network_cost)
                              for d in w.dependencies])
                for w in ag_p.workloads] == [
            (w.selector, [(d.workload_selector, d.max_network_cost)
                          for d in w.dependencies])
            for w in ag_j.workloads]
        assert ag_p.topology_order == ag_j.topology_order
        nt_j, nt_p = (c.network_topologies["default/nt-default"]
                      for c in (jc, pc))
        assert nt_p.weights == nt_j.weights
        assert pc.event_last.keys() == jc.event_last.keys()


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

    @pytest.mark.parametrize("name", CASES)
    def test_card_equals_cpu(self, card, name):
        """Each case solved on the card with TF32 on, where a host read in
        the step raises (sync-debug "error"), and batched, equals the
        CPU's: every output and final carry, tolerance 0."""
        pkg = SimpleNamespace(objects=port_objects, Cluster=PCluster,
                              scenarios=port_scenarios)
        outs = []
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            for device in (card, CPU):
                cluster, config = network_case(name, pkg)
                sched = Scheduler(port_config.load_profile(config))
                _, snap, _ = solve_inputs(sched, cluster, device=device)
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    result = sched.solve(snap, device=device)
                finally:
                    if device.type == "cuda":
                        torch.cuda.set_sync_debug_mode("default")
                batch = profile_batch_solve(sched, snap, device=device)
                out = {k: None if v is None else v.cpu()
                       for k, v in parity_outputs(result).items()}
                out.update({f"batch{k}": v.cpu() for k, v in
                            enumerate(batch)})
                outs.append(out)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        for k in outs[1]:
            assert (outs[0][k] is None) == (outs[1][k] is None), k
            if outs[1][k] is not None:
                assert torch.equal(outs[0][k], outs[1][k]), k
