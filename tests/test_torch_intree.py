"""The port's in-tree slice (`scheduler_plugins_tpu_torch.plugins.intree`,
`.ops.selectors`, `.state.scheduling`, the selector carries of the solve,
the batched solve's validator branch, the scheduling half of the
post-eviction tables and `mixed_scenario`) against the JAX package.

The decision tables of `tests/test_intree.py`, `tests/test_intree_policies.py`,
`tests/test_preemption_filters.py` and the in-tree rows of
`tests/test_attribution.py` run again with every JAX name they call
(objects, store, scheduler, cycle, plugins, the batched solve, the table
builder, the profile loader) swapped for the port's. Left out:
`TestNativeStoreGate` (the JAX store's native mirror, not ported).

On the seeded cases of `tests/torch_intree_cases.py` (the full-roster
mixed profile and the in-tree roster, reduced, and a tight variant, each
at three seeds): the lowered scheduling tables, `commit_tracks` on seeded
commits, each plugin's filter / score / validate_at against the
cycle-initial carry and a seeded in-cycle one (and the whole-batch rows
against the per-pod ones), `Scheduler.solve` (assignment, admitted, wait,
failed_plugin, every final carry), `profile_batch_solve` with its wave
stats, the explain rows and two `run_cycle`s cycle by cycle, all equal to
JAX's with tolerance 0 (every compared quantity is an integer or a
boolean). The host oracle (`intree_violations`) finds no violated hard
constraint in any solve and does find a planted one. The preemption
script's nominations turn on the post-eviction re-filter.

The `cuda`-marked test runs on a card only (`python -m pytest
tests/test_torch_intree.py -m cuda`); it needs no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.config as port_config
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework as port_framework
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.framework.preemption as port_preemption
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.state.scheduling as port_scheduling
from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.ops import selectors as t_sel
from scheduler_plugins_tpu_torch.parallel.solver import (
    batch_explain_rows,
    profile_batch_solve,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_intree_cases import (
    CASES,
    intree_case,
    intree_preemption_script,
    intree_violations,
)
from torch_numa_cases import solve_inputs
from torch_parity_cases import parity_outputs

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework as jax_framework
    import scheduler_plugins_tpu.ops.selectors as j_sel
    import scheduler_plugins_tpu.parallel.solver as jax_solver
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.state.scheduling as jax_scheduling
    import tests.test_attribution as jax_attribution
    import tests.test_intree as jax_intree
    import tests.test_intree_policies as jax_policies
    import tests.test_preemption_filters as jax_pre_filters
    from scheduler_plugins_tpu.framework import Scheduler as JScheduler
    from scheduler_plugins_tpu.parallel.solver import (
        batch_explain_rows as jax_batch_explain_rows,
        profile_batch_solve as jax_profile_batch_solve,
    )
    from tests.test_torch_cycle import run_script
    from tests.test_torch_numa import _CPUCluster, _CPUScheduler
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
SEEDS = (0, 1, 2)
PORT_PKG = SimpleNamespace(objects=port_objects, Cluster=PCluster,
                           scenarios=port_scenarios)


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
    np.testing.assert_array_equal(got, want, err_msg=msg)


# --- the JAX decision tables against the port -----------------------------------

def _cpu_batch_solve(*args, **kwargs):
    return profile_batch_solve(*args, **{"device": "cpu", **kwargs})


def _cpu_run_cycle(s, c, now=None, **kw):
    return port_cycle.run_cycle(s, c, now=now, device="cpu", **kw)


def _swap_in_port(monkeypatch, module):
    """Every JAX name the table module `module` calls, at its module level
    and in the JAX modules its tests import from inside their bodies,
    replaced by the port's (the store and the scheduler solving on the
    CPU)."""
    special = {"Cluster": _CPUCluster, "Scheduler": _CPUScheduler,
               "run_cycle": _cpu_run_cycle,
               "profile_batch_solve": _cpu_batch_solve}
    ported = {}
    for source in (port_objects, port_plugins):
        ported.update({k: v for k, v in vars(source).items()
                       if isinstance(v, type)})
    ported.update(Profile=Profile,
                  PreemptionEngine=port_preemption.PreemptionEngine,
                  PreemptionMode=port_preemption.PreemptionMode,
                  BUILTIN_FIT=port_framework.runtime.BUILTIN_FIT,
                  build_scheduling=port_scheduling.build_scheduling,
                  load_profile=port_config.load_profile, **special)
    for name, value in vars(module).items():
        if name in ported and getattr(value, "__module__", "").startswith(
                "scheduler_plugins_tpu."):
            monkeypatch.setattr(module, name, ported[name])
        elif name in special:
            monkeypatch.setattr(module, name, special[name])
    for jax_module in (jax_objects, jax_plugins, jax_framework, jax_solver,
                       jax_scheduling, jax_config):
        for name in vars(jax_module):
            if name in ported:
                monkeypatch.setattr(jax_module, name, ported[name])


def _tables(module, skip=()):
    if JAX is None:
        return []
    out = []
    for cls_name, cls in sorted(vars(module).items()):
        if not (cls_name.startswith("Test") and isinstance(cls, type)
                and cls.__module__ == module.__name__) or cls_name in skip:
            continue
        for name in sorted(vars(cls)):
            if name.startswith("test_"):
                out.append(pytest.param(module, cls, name,
                                        id=f"{cls_name}.{name}"))
    return out


TABLES = [] if JAX is None else (
    _tables(jax_intree, skip=("TestNativeStoreGate",))
    + _tables(jax_policies) + _tables(jax_pre_filters))


@pytest.mark.parametrize("module,cls,method", TABLES)
def test_decision_table_against_port(module, cls, method, monkeypatch):
    """Each case of the JAX in-tree decision tables (node selectors and
    affinity, taints, spec interning, topology spread with its policies,
    inter-pod (anti-)affinity with namespace scopes and the symmetric
    score, addedAffinity, the batched solve's validators, the
    post-eviction Filter view of preemption) on the port."""
    _swap_in_port(monkeypatch, module)
    getattr(cls(), method)()


INTREE_ATTRIBUTION = ("_node_affinity_case", "_taint_case", "_spread_case",
                      "_inter_pod_affinity_case")


@pytest.mark.parametrize("method", [
    "test_sequential_cycle_names_responsible_plugin",
    "test_batched_reduction_matches_sequential"])
@pytest.mark.parametrize("case", INTREE_ATTRIBUTION)
def test_attribution_rows_against_port(case, method, monkeypatch):
    """The in-tree rows of `tests/test_attribution.py`: the cycle names
    the plugin that emptied the feasible set, and the batched reduction
    (`Scheduler.attribution_codes`) decodes to the same one."""
    _swap_in_port(monkeypatch, jax_attribution)
    table = jax_attribution.TestFailedByDecisionTable()
    getattr(table, method)(getattr(jax_attribution, case))


# --- the seeded cases --------------------------------------------------------------

@pytest.fixture(scope="module")
def solved():
    cache = {}

    def get(name, seed=0):
        if (name, seed) not in cache:
            (jc, config), (pc, _) = (intree_case(name, JAX, seed),
                                     intree_case(name, PORT, seed))
            js = JScheduler(jax_config.load_profile(config))
            ps = Scheduler(port_config.load_profile(config))
            for sched, cluster in ((js, jc), (ps, pc)):
                for plugin in sched.profile.plugins:
                    plugin.configure_cluster(cluster)
            jpend, snap_j, meta_j = solve_inputs(js, jc)
            ppend, snap_p, meta_p = solve_inputs(ps, pc, device="cpu")
            state_j = js.initial_state(snap_j)
            snap_c = snapshot_from_numpy(jax_snapshot_tree(snap_j),
                                         device="cpu")
            state_c = state_from_numpy(numpy_tree(state_j), device="cpu")
            cache[(name, seed)] = SimpleNamespace(
                config=config, jc=jc, pc=pc, js=js, ps=ps, jpend=jpend,
                ppend=ppend, snap_j=snap_j, meta_j=meta_j, snap_p=snap_p,
                meta_p=meta_p, snap_c=snap_c, state_j=state_j,
                state_c=state_c,
                res_j=js.solve(snap_j, state_j),
                res_c=ps.solve(snap_c, state_c, device="cpu"),
                res_p=ps.solve(snap_p, device="cpu"))
        return cache[(name, seed)]

    return get


def _arrays(tree):
    """The array fields of a table's `numpy()` dict (host statics such as
    `spread_needs_node_counts` and `pack_scales` left out)."""
    return {k: v for k, v in tree.items() if isinstance(v, np.ndarray)}


class TestSolveParity:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("name", CASES)
    def test_lowering_equals_jax(self, solved, name, seed):
        """The port lowers each table JAX lowers, the in-tree scheduling
        tables included (int64 where JAX's index tables are int32, the
        same values), in JAX's queue order."""
        s = solved(name, seed)
        assert [p.uid for p in s.ppend] == [p.uid for p in s.jpend]
        want, got = s.snap_c.numpy(), s.snap_p.numpy()
        assert got.keys() == want.keys() and "scheduling" in got
        for table in got:
            for field, value in _arrays(got[table]).items():
                np.testing.assert_array_equal(
                    value, want[table][field], err_msg=f"{table}.{field}")
                assert value.dtype == want[table][field].dtype
        assert (got["scheduling"]["spread_needs_node_counts"]
                == s.snap_j.scheduling.spread_needs_node_counts)

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("name", CASES)
    def test_solve_equals_jax(self, solved, name, seed):
        """`Scheduler.solve` on JAX's carried inputs and on the port's
        own lowering: assignment, admitted, wait, failed_plugin and every
        final carry (the four selector carries included) equal JAX's."""
        s = solved(name, seed)
        assert_result_equal(s.res_c, s.res_j)
        assert_result_equal(s.res_p, s.res_j)
        assert s.res_p.state.sel_dom_counts is not None

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("name", CASES)
    def test_no_violations(self, solved, name, seed):
        s = solved(name, seed)
        viol = intree_violations(s.pc, s.ppend, s.res_p.assignment.numpy(),
                                 s.meta_p.node_names)
        assert not any(viol.values()), viol

    def test_the_cases_reach_their_branches(self, solved):
        """The node-level spread carry (a taints-Honor policy excluding
        nodes) and the domain mirror both run; the four carries and the
        fail codes of the plugins and the built-in fit all appear."""
        tight = solved("intree_tight")
        assert tight.snap_p.scheduling.spread_needs_node_counts
        assert not solved("mixed_small").snap_p.scheduling \
            .spread_needs_node_counts
        small = solved("intree_small")
        for carry in ("sel_counts", "sel_dom_counts", "anti_domains",
                      "sym_counts"):
            assert getattr(small.res_p.state, carry) is not None, carry
        codes = set()
        for seed in SEEDS:
            codes |= set(solved("intree_tight", seed).res_p.failed_plugin
                         .tolist())
        # built-in fit, NodeAffinity, TaintToleration and InterPodAffinity
        assert {0, 2, 3, 5} <= codes
        assert (small.res_p.state.sel_dom_counts
                != small.snap_p.scheduling.track_base).any()

    def test_oracle_sees_a_violation(self, solved):
        """The oracle is not blind: a pod the Filters rejected, placed
        anyway on each node in turn, is a violation on some of them, and
        a placed pod moved onto a tainted node it does not tolerate is
        one too."""
        s = solved("intree_tight")
        a = s.res_p.assignment.numpy()
        failed = np.nonzero(s.res_p.failed_plugin.numpy() >= 2)[0]
        found = 0
        for n in range(len(s.meta_p.node_names)):
            bad = a.copy()
            bad[failed[0]] = n
            found += sum(intree_violations(
                s.pc, s.ppend, bad, s.meta_p.node_names).values())
        assert found >= 1


def _jax_state(state_j, carries):
    return state_j.replace(**{k: jnp.asarray(v) for k, v in carries.items()})


def _port_state(sched, snap, carries):
    return sched.initial_state(snap).replace(
        **{k: t(v) for k, v in carries.items()})


def _seeded_carries(s):
    """The final carries of the JAX solve: a state mid-cycle, with many
    in-cycle placements counted."""
    return {k: np.asarray(getattr(s.res_j.state, k))
            for k in ("sel_counts", "sel_dom_counts", "anti_domains",
                      "sym_counts")
            if getattr(s.res_j.state, k) is not None}


class TestHooks:
    @pytest.mark.parametrize("name", CASES)
    def test_per_pod_rows_and_validators_equal_jax(self, solved, name):
        """Each in-tree plugin's filter and score, for every third pod,
        against the cycle-initial carry and the seeded one, equal JAX's;
        the whole-batch rows (`filter_batch`, `filter_rows`,
        `score_batch`) equal the per-pod hooks; `validate_at` at seeded
        (pod, node) pairs equals JAX's and the filter's verdict there."""
        s = solved(name)
        rng = np.random.default_rng(3)
        names = ("NodeAffinity", "TaintToleration", "PodTopologySpread",
                 "InterPodAffinity")
        pairs = [(pp, jp) for pp, jp in zip(s.ps.profile.plugins,
                                            s.js.profile.plugins)
                 if pp.name in names]
        assert pairs
        for carries in ({}, _seeded_carries(s)):
            sj = _jax_state(s.state_j, carries)
            sp = _port_state(s.ps, s.snap_p, carries)
            for pp, jp in pairs:
                jp.bind_aux(jp.aux())
                jp.bind_presolve(jp.prepare_solve(s.snap_j))
                pp.bind_presolve(pp.prepare_solve(s.snap_p))
                jfilter = jax.jit(lambda st, sn, p, _jp=jp: _jp.filter(
                    st, sn, p))
                jscore = jax.jit(lambda st, sn, p, _jp=jp: _jp.score(
                    st, sn, p))
                fb = pp.filter_batch(sp, s.snap_p)
                sb = pp.score_batch(sp, s.snap_p)
                idx = torch.arange(1, s.snap_p.num_pods, 5)
                fr = pp.filter_rows(sp, s.snap_p, idx)
                for p in range(0, len(s.ppend), 3):
                    f = pp.filter(sp, s.snap_p, p)
                    sc = pp.score(sp, s.snap_p, p)
                    if f is not None:
                        assert_same(f, jfilter(sj, s.snap_j, p),
                                    f"{pp.name} filter {p}")
                        assert torch.equal(fb[p], f)
                    if sc is not None:
                        assert_same(sc, jscore(sj, s.snap_j, p),
                                    f"{pp.name} score {p}")
                        assert torch.equal(sb[p], sc)
                if fr is not None:
                    assert torch.equal(fr, fb[idx])
                if pp.validate_at is None:
                    continue
                jval = jax.jit(lambda st, sn, p, n, _jp=jp: _jp.validate_at(
                    st, sn, p, n))
                for _ in range(24):
                    p = int(rng.integers(0, len(s.ppend)))
                    n = int(rng.integers(0, len(s.meta_p.node_names)))
                    got = pp.validate_at(sp, s.snap_p, torch.tensor([p]),
                                         torch.tensor([n]))
                    assert got.shape == (1,)
                    want = bool(jval(sj, s.snap_j, jnp.int32(p),
                                     jnp.int32(n)))
                    assert bool(got) == want, (pp.name, p, n)
                    f = pp.filter(sp, s.snap_p, p)
                    assert bool(f[n]) == want, (pp.name, p, n)

    @pytest.mark.parametrize("name", ["intree_small", "intree_tight",
                                      "mixed_small"])
    def test_commit_tracks_equals_jax(self, solved, name):
        """`commit_tracks` folding a seeded sequence of placements (some
        unplaced, every pod index reachable; host-int and (1,) tensor pod
        indices alike) equals JAX's `commit_tracks`, carry by carry, and
        never writes the snapshot's tables."""
        s = solved(name)
        rng = np.random.default_rng(7)
        sj = s.state_j
        sp = s.ps.initial_state(s.snap_p)
        before = {k: v.clone() for k, v in vars(s.snap_p.scheduling).items()
                  if isinstance(v, torch.Tensor)}
        commit = jax.jit(j_sel.commit_tracks)
        N = len(s.meta_p.node_names)
        for k in range(60):
            p = int(rng.integers(0, len(s.ppend)))
            n = int(rng.integers(-1, N))
            sj = commit(sj, s.snap_j.scheduling, jnp.int32(p), jnp.int32(n))
            p_arg = p if k % 2 else torch.tensor([p])
            sp = t_sel.commit_tracks(sp, s.snap_p.scheduling, p_arg,
                                     torch.tensor([n], dtype=torch.int32))
        for carry in ("sel_counts", "sel_dom_counts", "anti_domains",
                      "sym_counts"):
            got, want = getattr(sp, carry), getattr(sj, carry)
            assert (got is None) == (want is None), carry
            if got is not None:
                assert_same(got, want, carry)
        for k, v in before.items():
            assert torch.equal(getattr(s.snap_p.scheduling, k), v), k


class TestBatchSolve:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("name", CASES)
    def test_equals_jax(self, solved, name, seed):
        """`profile_batch_solve(collect_stats=True)` through the validator
        branch: assignment, admitted, wait and the wave stats equal JAX's;
        no hard constraint broken in the order the waves committed (each
        wave's winners in queue order)."""
        s = solved(name, seed)
        got = profile_batch_solve(s.ps, s.snap_p, collect_stats=True,
                                  device="cpu")
        want = jax_profile_batch_solve(s.js, s.snap_j, collect_stats=True)
        for k in range(3):
            assert_same(got[k], want[k], f"output {k}")
        assert got[3]["waves"] == int(want[3]["waves"])
        np.testing.assert_array_equal(got[3]["occupancy"].numpy(),
                                      np.asarray(want[3]["occupancy"]))
        viol = intree_violations(s.pc, s.ppend, got[0].numpy(),
                                 s.meta_p.node_names,
                                 wave_of=got[3]["wave_of"].numpy())
        assert not any(viol.values()), viol

    def test_validators_walk_each_wave(self, solved, monkeypatch):
        """The spread and inter-pod affinity validators are called with
        (1,) device indices once a row a wave, and a demoted winner
        retries: some wave after the first admits pods."""
        s = solved("intree_small")
        calls = []
        for plugin in s.ps.profile.plugins:
            if plugin.validate_at is None:
                continue
            real = plugin.validate_at

            def spy(state, snap, p, node, _real=real, _name=plugin.name):
                calls.append((_name, tuple(p.shape), tuple(node.shape)))
                return _real(state, snap, p, node)

            monkeypatch.setattr(plugin, "validate_at", spy)
        _, _, _, stats = profile_batch_solve(s.ps, s.snap_p,
                                             collect_stats=True, device="cpu")
        assert {c[0] for c in calls} == {"PodTopologySpread",
                                         "InterPodAffinity"}
        assert {c[1:] for c in calls} == {((1,), (1,))}
        assert stats["occupancy"][1:].sum() > 0


class TestExplain:
    @pytest.mark.parametrize("name", ["intree_small", "intree_args"])
    def test_rows_equal_jax(self, solved, name):
        """`Scheduler.explain_rows` and `batch_explain_rows` (through the
        whole-batch rows) equal JAX's, field by field."""
        s = solved(name)
        idx = [0, 1, 2, 3, 7, len(s.ppend) // 2, len(s.ppend) - 1]
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


def _two_cycles(name, seed):
    """A two-cycle script of a case: cycle 1 over the case's cluster;
    then a namespace (labelled tier=prod: an InterPodAffinity event),
    more pods of the case's kinds and, for the in-tree cases, a bound pod
    deleted; cycle 2 one second later."""

    def script(pkg):
        cases_pkg = SimpleNamespace(objects=pkg.o, Cluster=pkg.Cluster,
                                    scenarios=(JAX if pkg.o is jax_objects
                                               else PORT).scenarios)
        cluster, config = intree_case(name, cases_pkg, seed)
        loader = jax_config if pkg.o is jax_objects else port_config
        sched = pkg.Scheduler(loader.load_profile(config))

        def more(pkg, c):
            c.add_namespace(pkg.o.Namespace(name="prod-c",
                                            labels={"tier": "prod"}))
            extra, _ = intree_case(name, cases_pkg, seed + 10)
            for pod in list(extra.pods.values())[-24:]:
                if pod.node_name is None:
                    pod.name = f"late-{pod.name}"
                    pod.uid = f"{pod.namespace}/{pod.name}"
                    pod.creation_ms += 1000
                    c.add_pod(pod)
            bound = [u for u, p in c.pods.items() if p.node_name is not None]
            if bound:
                c.remove_pod(bound[0])

        return cluster, sched, [(1000, None), (2000, more)]

    script.__name__ = f"{name}_{seed}"
    return script


class TestCycles:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("name", ["mixed_small", "intree_small",
                                      "intree_tight"])
    def test_two_cycles_match_jax(self, name, seed):
        """Two `run_cycle`s: reports (bindings, failures and their
        plugins, skipped pods, preemptions) and the store's bookkeeping
        equal JAX's after each."""
        _, reports = run_script(_two_cycles(name, seed))
        assert reports[0].bound

    def test_preemption_script_matches_jax(self):
        """`intree_preemption_script` cycle by cycle: cycle 1 nominates n0
        with db-0 as the victim (its eviction frees the anti-affinity
        domain, where the post-eviction re-filter passes); the claimant
        binds to n0; db-1's preemption evicts the claimant, the carrier
        of the anti term that blocks it."""
        _, reports = run_script(intree_preemption_script)
        r1, r2, r3 = reports
        assert r1.preempted["default/claimant"] == ("n0", ["default/db-0"])
        assert r2.bound == {"default/claimant": "n0"}
        assert r3.failed_by["default/db-1"] == "InterPodAffinity"
        assert r3.preempted["default/db-1"] == ("n0", ["default/claimant"])

    def test_post_eviction_tables_equal_jax(self, solved):
        """`Cluster.post_eviction_tables` rebuilds the scheduling tables
        without the evicted pods as JAX's does, and shares every other
        table."""
        s = solved("intree_small")
        bound = [p.uid for p in s.pc.pods.values()
                 if p.node_name is not None][:9]
        got = s.pc.post_eviction_tables(s.snap_p, s.meta_p, bound)
        want = s.jc.post_eviction_tables(s.snap_j, s.meta_j, bound)
        tree = snapshot_from_numpy(jax_snapshot_tree(want), device="cpu")
        for field, value in _arrays(
                got.scheduling.numpy()).items():
            np.testing.assert_array_equal(
                value, tree.scheduling.numpy()[field], err_msg=field)
        assert not torch.equal(got.scheduling.track_base,
                               s.snap_p.scheduling.track_base)
        assert got.nodes is s.snap_p.nodes and got.pods is s.snap_p.pods

    def test_refilter_sees_the_eviction(self):
        """What the script's first preemption decides: the claimant fails
        InterPodAffinity's Filter on both nodes as the store stands, and
        passes on n0 (not n1) once db-0 is evicted."""
        from tests.test_torch_cycle import PORT as CPORT

        c, sched, _ = intree_preemption_script(CPORT)
        pending = sched.sort_pending(c.pending_pods(), c)
        snap, meta = c.snapshot(pending, device="cpu")
        sched.prepare(meta, c)
        p = meta.pod_names.index("default/claimant")
        n0, n1 = meta.node_names.index("n0"), meta.node_names.index("n1")
        assert not sched.filter_verdicts(snap, p)[[n0, n1]].any()
        hyp = c.post_eviction_tables(snap, meta, {"default/db-0"})
        verdicts = sched.filter_verdicts(hyp, p)
        assert verdicts[n0] and verdicts[n1]
        hyp = c.post_eviction_tables(snap, meta, {"default/fill-1"})
        assert not sched.filter_verdicts(hyp, p)[[n0, n1]].any()


class TestStepIssuesNoHostRead:
    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    @pytest.mark.parametrize("name", ["intree_tight", "mixed_small"])
    def test_no_host_reads(self, solved, name):
        """The in-tree solve reads nothing on the host (so on the card it
        never waits), nor does the batched solve's validator walk."""
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
        plugins = [p for p in s.ps.profile.plugins
                   if p.validate_at is not None]
        state = s.ps.initial_state(s.snap_p)
        ops.clear()
        rows = [(torch.tensor([p]), torch.tensor([p % 3])) for p in range(4)]
        with Log():
            for q, node in rows:
                for plugin in plugins:
                    plugin.validate_at(state, s.snap_p, q, node)
                state = t_sel.commit_tracks(state, s.snap_p.scheduling, q,
                                            node)
        assert ops
        assert not [op for op in ops if op.split(".")[0] in self.HOST_READS]


class TestScenario:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_mixed_scenario_same_cluster_as_jax(self, seed):
        """`mixed_scenario` draws what JAX's draws: nodes, labels, NRTs,
        the AppGroup, the pods with their spread constraints."""
        jc = JAX.scenarios.mixed_scenario(24, 60, seed=seed)
        pc = port_scenarios.mixed_scenario(24, 60, seed=seed)

        def pods(c):
            return [(p.uid, dict(p.labels), p.effective_request(),
                     [(tsc.max_skew, tsc.topology_key,
                       tsc.when_unsatisfiable,
                       dict(tsc.label_selector.match_labels))
                      for tsc in p.topology_spread])
                    for p in c.pods.values()]

        assert [(n.name, dict(n.labels), dict(n.allocatable))
                for n in pc.nodes.values()] == [
            (n.name, dict(n.labels), dict(n.allocatable))
            for n in jc.nodes.values()]
        assert pods(pc) == pods(jc)
        assert [[(z.numa_id, dict(z.available)) for z in t.zones]
                for t in pc.nrts.values()] == [
            [(z.numa_id, dict(z.available)) for z in t.zones]
            for t in jc.nrts.values()]
        assert pc.event_last.keys() == jc.event_last.keys()

    def test_namespace_event(self):
        """`Cluster.add_namespace` notes Namespace/Add, then /Update, as
        JAX's store does."""
        for pkg in (JAX, PORT):
            c = pkg.Cluster()
            c.add_namespace(pkg.objects.Namespace(name="a"))
            c.add_namespace(pkg.objects.Namespace(name="a",
                                                  labels={"x": "y"}))
            assert c.event_last == {"Namespace/Add": 1,
                                    "Namespace/Update": 2}
            assert c.namespaces["a"].labels == {"x": "y"}


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
        outs = []
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            for device in (card, CPU):
                cluster, config = intree_case(name, PORT_PKG)
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
