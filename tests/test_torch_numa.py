"""The port's NUMA slice (`scheduler_plugins_tpu_torch.ops.numa`,
`.plugins.noderesourcetopology`, the snapshot's zone tables and container
rows, the store's NRT CRs) against the JAX package.

Ops: seeded numpy zone tables (negative live capacities, unreported
resources, phantom zones, absent node resources) go through each JAX
function (vmapped over nodes, as the JAX plugin runs it) and its port
(over the node axis), in the packed float32 domain and in float64.
Tolerance 0 everywhere: the fit verdicts are boolean; the Least/Most
scores are exact floor divisions of integers exactly representable in the
working dtype; the LeastNUMANodes subset sums are exact integer sums in
float64; the BalancedAllocation mean and variance do round, and the port
adds the resources one at a time in index order, XLA's order for a short
row, so the same IEEE-754 operations run in the same order.

The plugin's hooks are held against JAX's on each `torch_numa_cases`
problem, against the cycle-initial state and against one with seeded
in-cycle deductions: `filter`, `score` (per pod, all four strategies),
`commit`, `filter_batch`, `filter_rows`, `score_batch`, `commit_batch`,
`wave_capacity`, and the batched `wave_guard_rows` against JAX's vmapped
`wave_guard`.

The decision tables of `tests/test_numa.py` run again with the JAX
names they call (objects, store, scheduler, cycle, plugin, `numa_ops`)
replaced by the port's; `TestNumaBatchedRows` (which jits JAX code) is
mirrored on the port. `Scheduler.solve` is held bit for bit (assignment,
admitted, wait, failed_plugin, the final zone carry) on each case, the
explain rows (sequential and batched) equal JAX's, and `run_cycle` runs
cycle by cycle on `numa_cycle_script`.

The `cuda`-marked test runs on a card only (`python -m pytest
tests/test_torch_numa.py -m cuda`); it needs no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.api.resources import ResourceIndex
from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.ops import numa as t_numa
from scheduler_plugins_tpu_torch.parallel.solver import batch_explain_rows
from scheduler_plugins_tpu_torch.plugins import NodeResourceTopologyMatch
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_numa_cases import CASES, numa_case, numa_cycle_script, solve_inputs
from torch_parity_cases import parity_outputs

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.ops.numa as j_numa
    import tests.conftest as jax_conftest
    import tests.test_numa as jax_tables
    from scheduler_plugins_tpu.framework import Scheduler as JScheduler
    from scheduler_plugins_tpu.parallel.solver import (
        batch_explain_rows as jax_batch_explain_rows,
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

GIB = 1 << 30
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def t(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


def j(x):
    return jnp.asarray(np.asarray(x))


def assert_same(port_value, jax_value, msg=""):
    got = port_value.cpu().numpy()
    want = np.asarray(jax_value)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


# --- seeded zone tables -------------------------------------------------------

def zone_inputs(seed: int, packed: bool, N=12, Z=4, R=4, P=10, C=3):
    """Zone tables of N nodes and requests of P pods, as the plugin hands
    them to the ops: float32 availability and requests when `packed`
    (values below 2^16, so value * 100 is exact), else float64
    availability up to 2^40 and int64 requests. Some live capacities are
    negative (pessimistic deductions), some zero; some resources go
    unreported, some zones are phantom padding, some nodes lack a
    resource."""
    rng = np.random.default_rng(seed)
    hi = (1 << 16) if packed else (1 << 40)
    fdt = np.float32 if packed else np.float64
    avail = rng.integers(-hi // 8, hi, (N, Z, R)).astype(fdt)
    avail[rng.random((N, Z, R)) < 0.15] = 0
    reqs = rng.integers(0, hi // 4, (P, R))
    reqs[rng.random((P, R)) < 0.3] = 0
    creq = rng.integers(0, hi // 8, (P, C, R))
    creq[rng.random((P, C, R)) < 0.3] = 0
    alloc = rng.integers(1, 4, (N, R)) * hi
    alloc[rng.random((N, R)) < 0.1] = 0
    dist = rng.integers(11, 40, (N, Z, Z)).astype(np.int32)
    dist = np.minimum(dist, dist.transpose(0, 2, 1))
    dist[:, np.arange(Z), np.arange(Z)] = 10
    return SimpleNamespace(
        avail=avail,
        reported=rng.random((N, Z, R)) < 0.8,
        zmask=rng.random((N, Z)) < 0.85,
        alloc=alloc,
        reqs=reqs.astype(fdt) if packed else reqs,
        creq=creq.astype(fdt) if packed else creq,
        guaranteed=rng.random(P) < 0.6,
        is_init=rng.random((P, C)) < 0.3,
        cmask=rng.random((P, C)) < 0.8,
        affine=np.array([True, True, False, False])[:R],
        host_level=np.array([False, False, True, False])[:R],
        weights=rng.integers(1, 4, R).astype(np.int64),
        dist=dist,
        max_numa=rng.choice(np.array([2, 4, 8], np.int32), N),
    )


def vmap_nodes(fn, *node_args):
    """JAX `fn` vmapped over the node axis of `node_args`."""
    return jax.vmap(fn)(*[j(a) for a in node_args])


PACKED = [pytest.param(True, id="f32"), pytest.param(False, id="f64")]
STRATS = [t_numa.LEAST_ALLOCATED, t_numa.MOST_ALLOCATED,
          t_numa.BALANCED_ALLOCATION]


class TestOps:
    def test_resource_masks(self):
        names = ["cpu", "memory", "hugepages-2Mi", "ephemeral-storage",
                 "storage", "vendor.com/nic", "pods"]
        index = ResourceIndex.union({n: 1 for n in names})
        from scheduler_plugins_tpu.api.resources import (
            ResourceIndex as JIndex,
        )
        jindex = JIndex.union({n: 1 for n in names})
        assert index.names == jindex.names
        for fn in ("numa_affine_mask", "host_level_mask"):
            np.testing.assert_array_equal(getattr(t_numa, fn)(index),
                                          getattr(j_numa, fn)(jindex))

    @pytest.mark.parametrize("Z", [1, 2, 3, 5, 8])
    def test_subset_masks(self, Z):
        for got, want in zip(t_numa.subset_masks(Z), j_numa.subset_masks(Z)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype

    @pytest.mark.parametrize("scales", [None, (1, 1 << 20, 4, 1)])
    def test_live_avail_and_scale_qty(self, scales):
        rng = np.random.default_rng(3)
        avail = rng.integers(0, 1 << 10, (6, 3, 4)) << 20
        vec = rng.integers(0, 1 << 10, (5, 2, 4)) << 20
        jn = SimpleNamespace(available=j(avail), pack_scales=scales)
        tn = SimpleNamespace(available=t(avail), pack_scales=scales)
        assert_same(t_numa.live_avail_init(tn), j_numa.live_avail_init(jn))
        assert_same(t_numa.scale_qty(tn, t(vec)),
                    j_numa.scale_qty(jn, j(vec)))

    @pytest.mark.parametrize("packed", PACKED)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_feasible_zones(self, packed, seed):
        z = zone_inputs(seed, packed)
        for p in range(z.reqs.shape[0]):
            g = bool(z.guaranteed[p])
            want = vmap_nodes(
                lambda a, rep, zm, al: j_numa.feasible_zones(
                    a, rep, zm, al, jnp.bool_(g), j(z.reqs[p]), j(z.affine),
                    j(z.host_level)),
                z.avail, z.reported, z.zmask, z.alloc)
            got = t_numa.feasible_zones(
                t(z.avail), t(z.reported), t(z.zmask), t(z.alloc),
                torch.tensor(g), t(z.reqs[p]), t(z.affine), t(z.host_level))
            for a, b in zip(got, want):
                assert_same(a, b, p)
            suit = z.avail >= z.reqs[p][None, None, :]
            want = vmap_nodes(
                lambda s, rep, zm, al: j_numa.feasible_zones_from_suitable(
                    s, rep, zm, al, jnp.bool_(g), j(z.reqs[p]), j(z.affine),
                    j(z.host_level)),
                suit, z.reported, z.zmask, z.alloc)
            got = t_numa.feasible_zones_from_suitable(
                t(suit), t(z.reported), t(z.zmask), t(z.alloc),
                torch.tensor(g), t(z.reqs[p]), t(z.affine), t(z.host_level))
            for a, b in zip(got, want):
                assert_same(a, b, p)

    @pytest.mark.parametrize("packed", PACKED)
    def test_batch_request_fit(self, packed):
        z = zone_inputs(2, packed, P=24)
        args = (z.avail, z.reported, z.zmask, z.alloc, z.guaranteed, z.reqs,
                z.affine, z.host_level)
        assert_same(t_numa.batch_request_fit(*[t(a) for a in args]),
                    j_numa.batch_request_fit(*[j(a) for a in args]))

    @pytest.mark.parametrize("packed", PACKED)
    @pytest.mark.parametrize("seed", [0, 4])
    def test_single_numa_fit(self, packed, seed):
        z = zone_inputs(seed, packed)
        for p in range(z.reqs.shape[0]):
            g = bool(z.guaranteed[p])
            want = vmap_nodes(
                lambda a, rep, zm, al: j_numa.single_numa_fit(
                    a, rep, zm, al, jnp.bool_(g), j(z.creq[p]),
                    j(z.is_init[p]), j(z.cmask[p]), j(z.affine),
                    j(z.host_level)),
                z.avail, z.reported, z.zmask, z.alloc)
            got = t_numa.single_numa_fit(
                t(z.avail), t(z.reported), t(z.zmask), t(z.alloc),
                torch.tensor(g), t(z.creq[p]), t(z.is_init[p]),
                t(z.cmask[p]), t(z.affine), t(z.host_level))
            assert_same(got, want, p)

    @pytest.mark.parametrize("packed", PACKED)
    def test_precompute_zone_scales(self, packed):
        z = zone_inputs(5, packed)
        for a, b in zip(t_numa.precompute_zone_scales(t(z.avail)),
                        j_numa.precompute_zone_scales(j(z.avail))):
            assert_same(a, b)

    @pytest.mark.parametrize("packed", PACKED)
    @pytest.mark.parametrize("strategy", STRATS)
    def test_zone_strategy_scores(self, packed, strategy):
        z = zone_inputs(6, packed)
        for p in range(z.reqs.shape[0]):
            r = z.reqs[p]
            want = vmap_nodes(
                lambda a, zm: j_numa.min_over_zones(j_numa.zone_strategy_scores(
                    strategy, j(r), a, zm, j(r > 0), j(z.weights)), zm),
                z.avail, z.zmask)
            zs = t_numa.zone_strategy_scores(
                strategy, t(r), t(z.avail), t(z.zmask), t(r > 0),
                t(z.weights))
            want_zs = vmap_nodes(
                lambda a, zm: j_numa.zone_strategy_scores(
                    strategy, j(r), a, zm, j(r > 0), j(z.weights)),
                z.avail, z.zmask)
            assert_same(zs, want_zs, p)
            assert_same(t_numa.min_over_zones(zs, t(z.zmask)), want, p)

    @pytest.mark.parametrize("packed", PACKED)
    @pytest.mark.parametrize("strategy", STRATS)
    def test_batch_strategy_node_scores(self, packed, strategy):
        z = zone_inputs(7, packed, P=16)
        args = (z.reqs, z.avail, z.zmask, z.weights)
        assert_same(
            t_numa.batch_strategy_node_scores(strategy,
                                              *[t(a) for a in args]),
            j_numa.batch_strategy_node_scores(strategy,
                                              *[j(a) for a in args]))

    @pytest.mark.parametrize("Z", [2, 4])
    def test_subset_distances(self, Z):
        z = zone_inputs(8, False, Z=Z)
        masks, sizes = t_numa.subset_masks(Z)
        want = vmap_nodes(
            lambda d: j_numa._subset_distances(d, j(masks), j(sizes)),
            z.dist)
        assert_same(t_numa._subset_distances(t(z.dist), t(masks), t(sizes)),
                    want)

    @pytest.mark.parametrize("packed", PACKED)
    @pytest.mark.parametrize("Z", [2, 4])
    def test_least_numa_required(self, packed, Z):
        z = zone_inputs(9, packed, Z=Z)
        masks, sizes = t_numa.subset_masks(Z)
        for p in range(z.reqs.shape[0]):
            g, r = bool(z.guaranteed[p]), z.reqs[p]
            want = vmap_nodes(
                lambda a, rep, zm, d: j_numa.least_numa_required(
                    a, rep, zm, d, jnp.bool_(g), j(r), j(z.affine),
                    j(masks), j(sizes)),
                z.avail, z.reported, z.zmask, z.dist)
            got = t_numa.least_numa_required(
                t(z.avail), t(z.reported), t(z.zmask), t(z.dist),
                torch.tensor(g), t(r), t(z.affine), t(masks), t(sizes))
            for a, b in zip(got, want):
                assert_same(a, b, p)
            assert_same(
                t_numa.only_non_numa(t(z.reported), t(z.zmask), t(r)),
                vmap_nodes(lambda rep, zm: j_numa.only_non_numa(
                    rep, zm, j(r)), z.reported, z.zmask), p)
            assert_same(
                t_numa.least_numa_normalize(got[0], got[1], t(z.max_numa)),
                j_numa.least_numa_normalize(want[0], want[1],
                                            j(z.max_numa)), p)


# --- the plugin's hooks ---------------------------------------------------------

HOOK_CASES = ("config3_small", "mixed_scope", "multi_container",
              "best_effort", "least_numa", "float64")


def deducted(state, snap, seed, plugin):
    """`state` after `commit_batch` of a seeded third of the pods onto
    seeded nodes: live capacities shrink, some go negative."""
    rng = np.random.default_rng(seed)
    P, N = snap.num_pods, snap.num_nodes
    placed = rng.random(P) < 0.33
    choice = rng.integers(0, N, P).astype(np.int32)
    return placed, choice


@pytest.fixture(scope="module")
def hooked():
    """Per case: both packages' lowered problem, their plugins bound as
    the solves bind them, and each plugin's hook outputs against the
    cycle-initial state and against seeded deductions (JAX's jitted and
    vmapped over pods as its batched solve runs them)."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        (jc, config), (pc, _) = numa_case(name, JAX), numa_case(name, PORT)
        js = JScheduler(jax_config.load_profile(config))
        ps = Scheduler(port_config.load_profile(config))
        _, snap_j, _ = solve_inputs(js, jc)
        _, snap_p, _ = solve_inputs(ps, pc, device="cpu")
        jp, pp = js.profile.plugins[0], ps.profile.plugins[0]
        placed, choice = deducted(None, snap_p, 11, pp)
        P, N = snap_p.num_pods, snap_p.num_nodes
        rng = np.random.default_rng(12)
        pods = rng.integers(0, P, 3 * P)
        nodes = rng.integers(0, N, 3 * P)
        R = snap_p.num_resources
        prefix = rng.integers(0, 3, (3 * P, R)).astype(np.float64) * (
            np.asarray(pp.prepare_solve(snap_p)["req"]).max(axis=0) / 2)
        prefix = np.floor(prefix)
        idx = np.arange(1, P, 3)
        active = rng.random(P) < 0.7

        commit_nodes = np.where(np.arange(8) % 4 == 3, -1,
                                nodes[:8]).astype(np.int32)

        def jax_rows(snap, state0, aux, placed, choice, idx, active, pods,
                     nodes, prefix, commit_nodes):
            # every input an argument, as in JAX's own solves: a constant
            # would let XLA fold it (a division by a constant becomes a
            # reciprocal multiply, which rounds differently)
            jp.bind_aux(aux)
            jp.bind_presolve(jp.prepare_solve(snap))
            out = {}
            for k, state in enumerate((state0, jp.commit_batch(
                    state0, snap, placed, choice))):
                ar = jnp.arange(P)
                out[k] = dict(
                    state=state.numa_avail,
                    filter=jax.vmap(lambda p: jp.filter(state, snap, p))(ar),
                    score=jax.vmap(lambda p: jp.score(state, snap, p))(ar),
                    filter_batch=jp.filter_batch(state, snap),
                    filter_rows=jp.filter_rows(state, snap, idx),
                    score_batch=jp.score_batch(state, snap),
                    wave_capacity=jp.wave_capacity(state, snap, active),
                    guard=jax.vmap(lambda p, n, pre: jp.wave_guard(
                        state, snap, p, n, pre))(pods, nodes, prefix),
                    commit=jax.vmap(lambda p, n: jp.commit(
                        state, snap, p, n).numa_avail)(pods[:8],
                                                       commit_nodes),
                )
            return out

        want = jax.jit(jax_rows)(
            snap_j, js.initial_state(snap_j), jp.aux(), *[
                jnp.asarray(a) for a in (placed, choice, idx, active, pods,
                                         nodes, prefix, commit_nodes)])
        pp.bind_presolve(pp.prepare_solve(snap_p))
        got = {}
        state0 = ps.initial_state(snap_p)
        for k, state in enumerate((state0, pp.commit_batch(
                state0, snap_p, t(placed), t(choice)))):
            got[k] = dict(
                state=state.numa_avail,
                filter=torch.stack([pp.filter(state, snap_p, p)
                                    for p in range(P)]),
                score=torch.stack([pp.score(state, snap_p, p)
                                   for p in range(P)]),
                filter_batch=pp.filter_batch(state, snap_p),
                filter_rows=pp.filter_rows(state, snap_p, t(idx)),
                score_batch=pp.score_batch(state, snap_p),
                wave_capacity=pp.wave_capacity(state, snap_p, t(active)),
                guard=pp.wave_guard_rows(state, snap_p, t(pods), t(nodes),
                                         t(prefix)),
                commit=torch.stack([pp.commit(
                    state, snap_p, int(p),
                    torch.tensor([-1 if i % 4 == 3 else int(nodes[i])],
                                 dtype=torch.int32)).numa_avail
                    for i, p in enumerate(pods[:8])]),
            )
        cache[name] = SimpleNamespace(got=got, want=want, snap_p=snap_p,
                                      plugin=pp, idx=idx)
        return cache[name]

    return get


HOOKS = ("state", "filter", "score", "filter_batch", "filter_rows",
         "score_batch", "wave_capacity", "guard", "commit")


class TestPluginHooks:
    @pytest.mark.parametrize("name", HOOK_CASES)
    def test_hooks_equal_jax(self, hooked, name):
        """Every hook, against the cycle-initial state and after seeded
        deductions, equals JAX's: values and dtype (None where JAX's is
        None: the whole-batch hooks' per-pod fallbacks)."""
        h = hooked(name)
        for k in (0, 1):
            for hook in HOOKS:
                got, want = h.got[k][hook], h.want[k][hook]
                assert (got is None) == (want is None), (k, hook)
                if got is not None:
                    assert_same(got, want, f"{name} state {k} {hook}")

    @pytest.mark.parametrize("name", HOOK_CASES)
    def test_batched_rows_equal_per_pod(self, hooked, name):
        """Where the whole-batch rows exist they equal the per-pod hooks
        (scores in value: the batch is int32)."""
        h = hooked(name)
        for k in (0, 1):
            g = h.got[k]
            if g["filter_batch"] is not None:
                assert torch.equal(g["filter_batch"], g["filter"])
                assert torch.equal(g["filter_rows"],
                                   g["filter"][torch.as_tensor(h.idx)])
            if g["score_batch"] is not None:
                assert torch.equal(g["score_batch"].long(),
                                   g["score"].long())

    def test_the_cases_reach_their_branches(self, hooked):
        """What each problem is there for: the per-pod fallbacks (mixed
        scopes, several containers, LeastNUMANodes), the float64 path,
        deductions driving capacities negative, a guard that rejects."""
        assert hooked("mixed_scope").got[0]["filter_batch"] is None
        assert hooked("multi_container").got[0]["filter_batch"] is None
        assert hooked("least_numa").got[0]["score_batch"] is None
        assert hooked("config3_small").got[0]["score_batch"] is not None
        assert hooked("float64").snap_p.numa.pack_scales is None
        assert hooked("config3_small").snap_p.numa.pack_scales is not None
        assert (hooked("best_effort").got[1]["state"] < 0).any()
        assert not hooked("config3_small").got[1]["guard"].all()
        assert hooked("mixed_scope").snap_p.pods.container_mask.sum(1).max() >= 3


# --- the JAX decision tables against the port -----------------------------------

class _CPUCluster(PCluster):
    def snapshot(self, pending, now_ms=0, device="cpu", **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


class _CPUScheduler(Scheduler):
    def solve(self, snap, state0=None, *, device="cpu"):
        return super().solve(snap, state0, device=device)


def _to_torch(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.array(x))


def _port_call(fn):
    """`fn` of the port called with the JAX tables' arguments (JAX arrays
    and numbers) as tensors, returning numpy."""
    def call(*args):
        out = fn(*[a if isinstance(a, (int, float)) else _to_torch(a)
                   for a in args])
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()

    return call


def _port_eval(cluster, sched, pod, method):
    """tests/conftest.py `_eval_plugin` on the port."""
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0)
    sched.prepare(meta, cluster)
    plugin = sched.profile.plugins[0]
    plugin.bind_presolve(plugin.prepare_solve(snap))
    state = sched.initial_state(snap)
    i = meta.pod_names.index(pod.uid)
    return getattr(plugin, method)(state, snap, i).numpy(), meta


def _tables():
    if JAX is None:
        return []
    classes = [jax_tables.TestNumaFilter, jax_tables.TestNumaScore,
               jax_tables.TestLeastNumaOps, jax_tables.TestF32Packing,
               jax_tables.TestReferenceScoreGoldens,
               jax_tables.TestReferenceFilterVectors]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_")]


@pytest.mark.parametrize("cls,method", _tables())
def test_reference_table_against_port(cls, method, monkeypatch):
    """Each case of the JAX decision tables, with every JAX name the table
    calls swapped for the port's."""
    for name in ("Container", "Node", "NodeResourceTopology", "NUMAZone",
                 "Pod", "TopologyManagerPolicy", "TopologyManagerScope"):
        monkeypatch.setattr(jax_tables, name, getattr(port_objects, name))
    monkeypatch.setattr(jax_tables, "ResourceIndex", ResourceIndex)
    monkeypatch.setattr(jax_tables, "Cluster", _CPUCluster)
    monkeypatch.setattr(jax_tables, "Scheduler", _CPUScheduler)
    monkeypatch.setattr(jax_tables, "Profile", Profile)
    monkeypatch.setattr(jax_tables, "NodeResourceTopologyMatch",
                        NodeResourceTopologyMatch)
    monkeypatch.setattr(
        jax_tables, "run_cycle",
        lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now=now, device="cpu", **kw))
    monkeypatch.setattr(jax_tables, "numa_ops", SimpleNamespace(
        subset_masks=t_numa.subset_masks,
        least_numa_required=_port_call(t_numa.least_numa_required),
        least_numa_normalize=_port_call(t_numa.least_numa_normalize),
    ))
    monkeypatch.setattr(
        jax_conftest, "raw_plugin_scores",
        lambda c, s, pod: _port_eval(c, s, pod, "score"))
    monkeypatch.setattr(
        jax_conftest, "raw_plugin_filter",
        lambda c, s, pod: _port_eval(c, s, pod, "filter"))
    getattr(cls(), method)()


class TestNumaBatchedRows:
    """`tests/test_numa.py` TestNumaBatchedRows on the port (the JAX class
    jits JAX code): the whole-batch rows equal the per-pod hooks across
    strategies and QoS mixes, and LeastNUMANodes falls back to the per-pod
    path."""

    def _problem(self, strategy, seed=0, n_nodes=24, n_pods=40, zones=4):
        rng = np.random.default_rng(seed)
        cluster = port_scenarios.numa_scenario(
            n_nodes=n_nodes, n_pods=n_pods, zones=zones, seed=seed)
        for i in range(8):
            cluster.add_pod(port_objects.Pod(
                name=f"burst-{i}", creation_ms=10_000 + i,
                containers=[port_objects.Container(requests={
                    "cpu": int(rng.integers(100, 900)), "memory": 1 * GIB})],
            ))
        plugin = NodeResourceTopologyMatch(scoring_strategy=strategy)
        sched = Scheduler(Profile(plugins=[plugin]))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        state0 = sched.initial_state(snap)
        plugin.bind_presolve(plugin.prepare_solve(snap))
        f_b = plugin.filter_batch(state0, snap)
        s_b = plugin.score_batch(state0, snap)
        f_p = torch.stack([plugin.filter(state0, snap, p)
                           for p in range(snap.num_pods)])
        s_p = torch.stack([plugin.score(state0, snap, p)
                           for p in range(snap.num_pods)])
        idx = torch.arange(1, snap.num_pods, 3)
        return f_b, s_b, f_p, s_p, plugin.filter_rows(state0, snap, idx), idx

    @pytest.mark.parametrize("strategy", STRATS)
    def test_batched_rows_bit_identical(self, strategy):
        f_b, s_b, f_p, s_p, f_r, idx = self._problem(strategy)
        assert torch.equal(f_b, f_p)
        assert torch.equal(s_b.long(), s_p)
        assert torch.equal(f_r, f_b[idx])

    def test_least_numa_falls_back_to_per_pod(self):
        cluster = port_scenarios.numa_scenario(n_nodes=8, n_pods=8, zones=2)
        plugin = NodeResourceTopologyMatch(
            scoring_strategy=t_numa.LEAST_NUMA_NODES)
        sched = Scheduler(Profile(plugins=[plugin]))
        _, snap, _ = solve_inputs(sched, cluster, device="cpu")
        state0 = sched.initial_state(snap)
        plugin.bind_presolve(None)
        assert plugin.score_batch(state0, snap) is None


# --- the parity path ------------------------------------------------------------

@pytest.fixture(scope="module")
def solved():
    cache = {}

    def get(name):
        if name not in cache:
            (jc, config), (pc, _) = numa_case(name, JAX), numa_case(name, PORT)
            js = JScheduler(jax_config.load_profile(config))
            ps = Scheduler(port_config.load_profile(config))
            jpend, snap_j, _ = solve_inputs(js, jc)
            ppend, snap_p, _ = solve_inputs(ps, pc, device="cpu")
            state_j = js.initial_state(snap_j)
            snap_c = snapshot_from_numpy(jax_snapshot_tree(snap_j),
                                         device="cpu")
            state_c = state_from_numpy(numpy_tree(state_j), device="cpu")
            cache[name] = SimpleNamespace(
                js=js, snap_j=snap_j,
                ps=ps, jpend=jpend, ppend=ppend, snap_p=snap_p,
                snap_c=snap_c, state_c=state_c,
                res_j=js.solve(snap_j, state_j),
                res_c=ps.solve(snap_c, state_c, device="cpu"),
                res_p=ps.solve(snap_p, device="cpu"))
        return cache[name]

    return get


class TestSolveParity:
    @pytest.mark.parametrize("name", CASES)
    def test_lowering_equals_jax(self, solved, name):
        """The port lowers the cluster to JAX's tensors (zone tables,
        container rows, QoS classes and pack scales included), in JAX's
        queue order."""
        s = solved(name)
        assert [p.uid for p in s.ppend] == [p.uid for p in s.jpend]
        want, got = s.snap_c.numpy(), s.snap_p.numpy()
        assert got.keys() == want.keys()
        for table in got:
            for field, value in got[table].items():
                if field == "pack_scales":
                    assert value == want[table][field]
                    continue
                np.testing.assert_array_equal(
                    value, want[table][field], err_msg=f"{table}.{field}")
                assert value.dtype == want[table][field].dtype

    @pytest.mark.parametrize("name", CASES)
    def test_carried_inputs_equal_jax_solve(self, solved, name):
        s = solved(name)
        assert_result_equal(s.res_c, s.res_j)

    @pytest.mark.parametrize("name", CASES)
    def test_own_lowering_equals_jax_solve(self, solved, name):
        s = solved(name)
        assert_result_equal(s.res_p, s.res_j)
        assert (s.res_p.assignment >= 0).any()

    def test_the_cases_reach_their_branches(self, solved):
        """Pods the NUMA filter rejects, and failed_plugin naming it."""
        for name in ("mixed_scope", "multi_container"):
            codes = solved(name).res_p.failed_plugin
            assert (codes == 1).any(), name
        qos = solved("mixed_scope").snap_p.pods.qos
        assert {0, 1, 2} <= set(qos.tolist())


class TestExplain:
    @pytest.mark.parametrize("name", ["config3_small", "mixed_scope",
                                      "least_numa"])
    def test_rows_equal_jax(self, solved, name):
        """`Scheduler.explain_rows` and the batched `batch_explain_rows`
        (through the plugin's whole-batch rows where it has them) equal
        JAX's, field by field."""
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


class TestStepIssuesNoHostRead:
    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    @pytest.mark.parametrize("name", ["config3_small", "mixed_scope",
                                      "least_numa"])
    def test_no_host_reads(self, solved, name):
        """The NUMA solve reads nothing on the host, so on the card it
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


def test_cycle_matches_jax_with_nrt_events():
    """`run_cycle` cycle by cycle on `numa_cycle_script`: reports and store
    equal JAX's after every cycle; cycle 1 parks pods on the NUMA filter,
    the NRT update lets cycle 2 retry and bind some of them."""
    _, reports = run_script(numa_cycle_script)
    first, second, _ = reports
    assert first.failed and set(first.failed_by.values()) == {
        "NodeResourceTopologyMatch"}
    assert set(first.failed) & set(second.bound)


class TestGuards:
    def test_cache_arguments_build_a_cache(self):
        """Invalid arguments raise as JAX's constructor raises them; the
        cache arguments themselves build the cache tier
        (`tests/test_torch_nrt_cache.py` holds it against JAX)."""
        for kw in ({"cache_resync_period_seconds": 5},
                   {"discard_reserved_nodes": True}, {"cache": {}}):
            assert NodeResourceTopologyMatch(**kw)._cache_args_given
        with pytest.raises(ValueError, match=">= 0"):
            NodeResourceTopologyMatch(cache_resync_period_seconds=-1)
        with pytest.raises(ValueError, match="illegal"):
            NodeResourceTopologyMatch(scoring_strategy="Nope")
        with pytest.raises(ValueError, match="informerMode"):
            port_config.load_profile({
                "plugins": ["NodeResourceTopologyMatch"],
                "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                                  "args": {"cacheResyncPeriodSeconds": 5,
                                           "cache": {"informerMode": "x"}}}]})

    def test_snapshot_reads_the_cache_view(self):
        """A store with a cache snapshots the cache's view: a reserved
        pod's request leaves every zone of its node, and a stale node is
        not fresh."""
        from scheduler_plugins_tpu_torch.state.nrt_cache import (
            OverReserveCache,
        )

        cluster, _ = numa_case("config3_small", PORT)
        plain, _ = cluster.snapshot(cluster.pending_pods(), device="cpu")
        cache = OverReserveCache()
        for t in cluster.nrts.values():
            cache.update_nrt(t)
        cluster.nrt_cache = cache
        pod = cluster.pending_pods()[0]
        cluster.reserve(pod.uid, "node-00003")
        cache.foreign.add("node-00005")
        snap, meta = cluster.snapshot(cluster.pending_pods(), device="cpu")
        n3 = meta.node_names.index("node-00003")
        n5 = meta.node_names.index("node-00005")
        cpu = meta.index.position("cpu")
        want = plain.numa.available[n3, :, cpu] - pod.effective_request()[
            "cpu"]
        assert torch.equal(snap.numa.available[n3, :, cpu], want)
        assert not snap.numa.fresh[n5] and snap.numa.fresh.sum() == (
            plain.numa.fresh.sum() - 1)

    def test_profile_spec_round_trip(self):
        """The port exports what JAX's `profile_spec` exports, the
        plugin's default cache arguments (cacheResyncPeriodSeconds 0,
        discardReservedNodes False) included, so a reload of the spec
        counts them as given and installs the passthrough cache in both
        packages."""
        config = {"plugins": ["NodeResourceTopologyMatch"],
                  "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                                    "args": {
                                        "scoringStrategy": "MostAllocated",
                                        "resources": [["cpu", 3]]}}]}
        spec = port_config.profile_spec(port_config.load_profile(config))
        want = jax_config.profile_spec(jax_config.load_profile(config))
        assert spec == want
        again = port_config.load_profile(spec).plugins[0]
        assert again.strategy == "MostAllocated"
        assert [tuple(r) for r in again.resources] == [("cpu", 3)]
        assert again._cache_args_given and not port_config.load_profile(
            config).plugins[0]._cache_args_given
        jagain = jax_config.load_profile(want).plugins[0]
        assert type(again.make_cache()).__name__ == type(
            jagain.make_cache()).__name__ == "PassthroughCache"


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
        """Each case solved on the card, where a host read in the step
        raises (sync-debug "error"), equals the CPU's solve: every output
        and final carry, tolerance 0."""
        pkg = SimpleNamespace(objects=port_objects, Cluster=PCluster,
                              scenarios=port_scenarios)
        outs = []
        for device in (card, CPU):
            cluster, config = numa_case(name, pkg)
            sched = Scheduler(port_config.load_profile(config))
            _, snap, _ = solve_inputs(sched, cluster, device=device)
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                result = sched.solve(snap, device=device)
            finally:
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            outs.append({k: None if v is None else v.cpu()
                         for k, v in parity_outputs(result).items()})
        for k in outs[1]:
            assert (outs[0][k] is None) == (outs[1][k] is None), k
            if outs[1][k] is not None:
                assert torch.equal(outs[0][k], outs[1][k]), k
