"""The port's sequential parity solve (`scheduler_plugins_tpu_torch
.framework`, `.plugins` and the ops it runs) against the JAX package.

Per module, seeded numpy inputs go through the JAX function and its port;
for the solve as a whole, both packages build the same cluster, QueueSort
it, lower it and solve it with the flagship profile (NodeResourcesAllocatable
+ Coscheduling + CapacityScheduling). The port solves the JAX snapshot and
the JAX initial state carried across by `convert.py` and its own lowering
of the cluster; assignment, admitted, wait, failed_plugin and every final
carry must equal JAX `Scheduler.solve` bit for bit. Every quantity is an
exact integer: tolerance 0 throughout. For an allocatable-only profile
the numpy `resilience.hostsolve.host_sequential_solve` is a third oracle.

The `cuda`-marked test runs on a card only (`python -m pytest
tests/test_torch_parity_solve.py -m cuda`); it needs no JAX."""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.framework import (
    Profile,
    Scheduler,
    SolverState,
)
from scheduler_plugins_tpu_torch.framework import runtime as t_runtime
from scheduler_plugins_tpu_torch.models import allocatable_scenario
from scheduler_plugins_tpu_torch.ops import fit as t_fit
from scheduler_plugins_tpu_torch.ops import gang as t_gang
from scheduler_plugins_tpu_torch.ops import normalize as t_norm
from scheduler_plugins_tpu_torch.ops import quota as t_quota
from scheduler_plugins_tpu_torch.plugins import (
    CapacityScheduling,
    Coscheduling,
    NodeResourcesAllocatable,
)
from scheduler_plugins_tpu_torch.utils import intmath as t_intmath
from torch_parity_cases import nominee_cluster

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.plugins as j_plugins
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.framework import runtime as j_runtime
    from scheduler_plugins_tpu.ops import fit as j_fit
    from scheduler_plugins_tpu.ops import gang as j_gang
    from scheduler_plugins_tpu.ops import normalize as j_norm
    from scheduler_plugins_tpu.ops import quota as j_quota
    from scheduler_plugins_tpu.resilience.hostsolve import (
        host_sequential_solve,
        supports,
    )
    from scheduler_plugins_tpu.utils import intmath as j_intmath
    from tests.test_intmath_properties import (
        FLOORDIV_CASES,
        GO_DIV_CASES,
        ROUND_CASES,
        go_div_oracle,
        round_oracle,
    )
    from tests.test_torch_snapshot import JAX, PORT, mixed_cluster
except ImportError:
    # a card machine may lack the JAX package's own dependencies; only the
    # differential tests need it, never the cuda-marked one
    JAX = None
    GO_DIV_CASES = ROUND_CASES = FLOORDIV_CASES = []

GIB = 1 << 30
CPU = torch.device("cpu")
FLAGSHIP = ("NodeResourcesAllocatable", "Coscheduling", "CapacityScheduling")
PORT_PLUGINS = {
    "NodeResourcesAllocatable": NodeResourcesAllocatable,
    "Coscheduling": Coscheduling,
    "CapacityScheduling": CapacityScheduling,
}
STATE_FIELDS = [f.name for f in fields(SolverState)]


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def same(port_value, jax_value):
    """Exact equality of a port tensor and a JAX array: shape, dtype and
    values."""
    got = port_value.cpu().numpy()
    want = np.asarray(jax_value)
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(got, want))


# --- clusters, built identically by either package ------------------------

def gang_quota_cluster(pkg):
    """`gang_quota_scenario(6, 16, 9)` with two faults: team-2's quota Max
    lets only 5 of its gang's 16 members in (the rest fail on
    CapacityScheduling, the 5 placed wait on quorum), and a gang of big
    members outside any quota whose MinMember the cluster cannot hold
    (placed members wait, the rest fail on fit)."""
    o = pkg.objects
    cluster = pkg.scenarios.gang_quota_scenario(6, 16, 9)
    cluster.quotas["team-2"].max = {"cpu": 5000, "memory": 1024 * GIB}
    cluster.add_pod_group(o.PodGroup(name="big", namespace="default",
                                     min_member=12))
    for m in range(14):
        cluster.add_pod(o.Pod(
            name=f"big-m{m:02d}", namespace="default", creation_ms=50_000 + m,
            containers=[o.Container(requests={"cpu": 40_000,
                                              "memory": 8 * GIB})],
            labels={o.POD_GROUP_LABEL: "big"},
        ))
    return cluster


def cordon_nofit_cluster(pkg):
    """`mixed_cluster` with two cordoned nodes and a pod that fits nowhere."""
    o = pkg.objects
    cluster = mixed_cluster(pkg, 0, cordon=(3, 7))
    cluster.add_pod(o.Pod(
        name="huge", creation_ms=40, priority=2,
        containers=[o.Container(requests={"cpu": 10 ** 7, "memory": GIB})],
    ))
    return cluster


def entry_cluster(pkg):
    """The `entry()` problem's cluster (`__graft_entry__.py:49`)."""
    return pkg.scenarios.allocatable_scenario(n_nodes=16, n_pods=32)


CLUSTERS = {
    "entry": entry_cluster,
    "gang_quota": gang_quota_cluster,
    "cordon_nofit": cordon_nofit_cluster,
    "nominees": lambda pkg: nominee_cluster(pkg.objects, pkg.Cluster),
    "mixed_gangs": lambda pkg: mixed_cluster(pkg, 1, gangs=True),
}


def schedulers(names=FLAGSHIP):
    j = JScheduler(JProfile(plugins=[getattr(j_plugins, n)() for n in names]))
    p = Scheduler(Profile(plugins=[PORT_PLUGINS[n]() for n in names]))
    return j, p


def numpy_tree(obj) -> dict:
    """A JAX struct (snapshot table or SolverState) as a dict of numpy
    arrays, None for absent fields."""
    return {
        f.name: None if getattr(obj, f.name) is None
        else np.asarray(getattr(obj, f.name))
        for f in fields(obj)
    }


def jax_snapshot_tree(snap_j) -> dict:
    return {
        name: None if getattr(snap_j, name) is None
        else numpy_tree(getattr(snap_j, name))
        for name in ("nodes", "pods", "gangs", "quota", "nominees",
                     "metrics", "numa", "network", "syscalls", "scheduling")
    }


def lowered(build, names=FLAGSHIP):
    """Both packages' schedulers, QueueSorted batches and snapshots of the
    cluster `build(pkg)` makes."""
    jc, pc = build(JAX), build(PORT)
    js, ps = schedulers(names)
    jpend = js.sort_pending(jc.pending_pods(), jc)
    ppend = ps.sort_pending(pc.pending_pods(), pc)
    snap_j, meta_j = jc.snapshot(jpend, now_ms=0)
    snap_p, meta_p = pc.snapshot(ppend, now_ms=0, device="cpu")
    js.prepare(meta_j, jc)
    ps.prepare(meta_p, pc)
    return SimpleNamespace(js=js, ps=ps, jpend=jpend, ppend=ppend,
                           snap_j=snap_j, snap_p=snap_p)


def assert_result_equal(res_p, res_j):
    for k in ("assignment", "admitted", "wait", "failed_plugin"):
        assert same(getattr(res_p, k), getattr(res_j, k)), k
    for k in STATE_FIELDS:
        got, want = getattr(res_p.state, k), getattr(res_j.state, k)
        assert (got is None) == (want is None), k
        if got is not None:
            assert same(got, want), k


@pytest.fixture(scope="module")
def solved():
    """Per cluster: the lowered pair, the JAX result, and the port's
    results on the carried JAX inputs and on its own lowering."""
    cache = {}

    def get(case):
        if case not in cache:
            lo = lowered(CLUSTERS[case])
            state_j = lo.js.initial_state(lo.snap_j)
            snap_c = snapshot_from_numpy(jax_snapshot_tree(lo.snap_j),
                                         device="cpu")
            state_c = state_from_numpy(numpy_tree(state_j), device="cpu")
            res_j = lo.js.solve(lo.snap_j, state_j)
            res_c = lo.ps.solve(snap_c, state_c, device="cpu")
            res_p = lo.ps.solve(lo.snap_p, device="cpu")
            cache[case] = SimpleNamespace(lo=lo, res_j=res_j, res_c=res_c,
                                          res_p=res_p, state_c=state_c,
                                          snap_c=snap_c)
        return cache[case]

    return get


# --- the solve as a whole -------------------------------------------------

class TestSolveParity:
    @pytest.mark.parametrize("case", sorted(CLUSTERS))
    def test_queue_order_equals_jax(self, solved, case):
        lo = solved(case).lo
        assert [p.uid for p in lo.ppend] == [p.uid for p in lo.jpend]

    @pytest.mark.parametrize("case", sorted(CLUSTERS))
    def test_carried_inputs_equal_jax_solve(self, solved, case):
        s = solved(case)
        assert_result_equal(s.res_c, s.res_j)

    @pytest.mark.parametrize("case", sorted(CLUSTERS))
    def test_own_lowering_equals_jax_solve(self, solved, case):
        s = solved(case)
        assert_result_equal(s.res_p, s.res_j)
        # the port's initial state is JAX's
        state_p = s.lo.ps.initial_state(s.lo.snap_p)
        for k in STATE_FIELDS:
            got, want = getattr(state_p, k), getattr(s.state_c, k)
            assert (got is None) == (want is None), k
            if got is not None:
                assert torch.equal(got, want), k

    def test_the_cases_reach_every_outcome(self, solved):
        """What each problem is there for: waits, each attribution code,
        a never-chosen cordoned node, nominee tables in and out of the
        batch."""
        names = Scheduler(Profile(plugins=[
            PORT_PLUGINS[n]() for n in FLAGSHIP])).fail_plugin_names()
        assert names == ["NodeResourcesFit", *FLAGSHIP]
        gq = solved("gang_quota").res_p
        codes = set(gq.failed_plugin.tolist())
        assert {-1, 0, 3} <= codes and gq.wait.sum() > 0
        cn = solved("cordon_nofit")
        a = cn.res_p.assignment.numpy()
        assert not np.isin(a, [3, 7]).any()
        huge = [p.name for p in cn.lo.ppend].index("huge")
        assert a[huge] == -1 and cn.res_p.failed_plugin[huge] == 0
        nm = solved("nominees").snap_c.nominees
        assert (nm.batch_idx < 0).sum() == 4 and (nm.batch_idx >= 0).sum() > 4
        mg = set(solved("mixed_gangs").res_p.failed_plugin.tolist())
        assert {2, 3} <= mg

    def test_inputs_are_not_modified(self, solved):
        s = solved("gang_quota")
        before = {k: v.clone() for k, v in vars(s.state_c).items()
                  if v is not None}
        s.lo.ps.solve(s.snap_c, s.state_c, device="cpu")
        for k, v in before.items():
            assert torch.equal(getattr(s.state_c, k), v), k


class TestHostSolveOracle:
    @pytest.mark.parametrize("cordon", [(), (3, 11)])
    def test_allocatable_only_equals_host_and_jax(self, cordon):
        def build(pkg):
            cluster = pkg.scenarios.allocatable_scenario(24, 96, seed=3)
            for i in cordon:
                cluster.nodes[f"node-{i:05d}"].unschedulable = True
            cluster.add_pod(pkg.objects.Pod(
                name="huge", creation_ms=7, containers=[pkg.objects.Container(
                    requests={"cpu": 10 ** 6})]))
            return cluster

        lo = lowered(build, names=("NodeResourcesAllocatable",))
        assert supports(lo.js, lo.snap_j)
        res_p = lo.ps.solve(lo.snap_p, device="cpu")
        assert_result_equal(res_p, lo.js.solve(lo.snap_j))
        a, admitted, wait, failed = host_sequential_solve(lo.js, lo.snap_j)
        assert np.array_equal(res_p.assignment.numpy(), a)
        assert np.array_equal(res_p.admitted.numpy(), admitted)
        assert np.array_equal(res_p.wait.numpy(), wait)
        assert np.array_equal(res_p.failed_plugin.numpy(), failed)
        assert not np.isin(a, cordon).any() and (a == -1).any()


class TestStepIssuesNoHostRead:
    """The loop over the pods never reads a tensor on the host: no `.item()`
    (`_local_scalar_dense`), no `nonzero`, no boolean-mask indexing; nor
    does it make a tensor from host data (`lift_fresh`: `torch.tensor`, or
    item assignment of a Python number), a copy from the host. On the card
    each would wait for the device; here the dispatched ops say so."""

    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    def test_no_host_reads(self, solved):
        s = solved("mixed_gangs")
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        with Log():
            s.lo.ps.solve(s.snap_c, s.state_c, device="cpu")
        assert ops
        assert not [op for op in ops
                    if op.split(".")[0] in self.HOST_READS]


# --- per module -----------------------------------------------------------

class TestIntmath:
    @pytest.mark.parametrize("a,b", GO_DIV_CASES)
    def test_go_div_corpus(self, a, b):
        got = t_intmath.go_div(torch.tensor(a, dtype=torch.int64), b)
        assert int(got) == go_div_oracle(a, b)

    @pytest.mark.parametrize("x", ROUND_CASES)
    def test_round_half_away_corpus(self, x):
        got = t_intmath.round_half_away(torch.tensor(x, dtype=torch.float64))
        assert got.dtype == torch.int64 and int(got) == round_oracle(x)

    @pytest.mark.parametrize("a,b", FLOORDIV_CASES)
    def test_floordiv_exact_corpus(self, a, b):
        got = t_intmath.floordiv_exact(
            torch.tensor(float(a), dtype=torch.float64), float(b))
        assert int(got) == a // b

    def test_sweeps_equal_jax(self):
        rng = np.random.default_rng(20260803)
        xs = (10.0 ** rng.uniform(-3, 15, 400)) * rng.choice([-1.0, 1.0], 400)
        xs[:100] = rng.integers(0, 2 ** 51, 100) + 0.5
        assert same(t_intmath.round_half_away(t(xs)),
                    j_intmath.round_half_away(jnp.asarray(xs)))
        a = rng.integers(-(2 ** 53 - 1), 2 ** 53 - 1, 400).astype(np.float64)
        b = rng.integers(1, 2 ** 31, 400).astype(np.float64)
        assert same(t_intmath.floordiv_exact(t(a), t(b)),
                    j_intmath.floordiv_exact(jnp.asarray(a), jnp.asarray(b)))


def score_rows(rng, n=64, rows=6):
    """(rows, n) int64 raw scores in the allocatable range (negative,
    Least mode) with the row edges: all equal, and one row of ties."""
    scores = rng.integers(-(1 << 40), 1 << 20, (rows, n))
    scores[1] = -123_456
    scores[2, ::2] = scores[2, 0]
    return scores


MASKS = {
    "all": lambda rng, shape: np.ones(shape, bool),
    "empty": lambda rng, shape: np.zeros(shape, bool),
    "partial": lambda rng, shape: rng.random(shape) < 0.3,
    "single": lambda rng, shape: np.eye(shape[0], shape[1], 5, dtype=bool),
}


class TestNormalize:
    @pytest.mark.parametrize("mask", sorted(MASKS))
    @pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
    def test_masked_min_max(self, mask, dtype):
        rng = np.random.default_rng(1)
        scores = score_rows(rng).astype(dtype)
        m = MASKS[mask](rng, scores.shape)
        for name in ("masked_min", "masked_max"):
            for keepdim in (False, True):
                got = getattr(t_intmath, name)(t(scores), t(m),
                                               keepdim=keepdim)
                want = getattr(j_intmath, name)(
                    jnp.asarray(scores), jnp.asarray(m), keepdims=keepdim)
                assert same(got, want), (name, keepdim)

    @pytest.mark.parametrize("mask", sorted(MASKS))
    def test_minmax_normalize(self, mask):
        rng = np.random.default_rng(2)
        scores = score_rows(rng)
        m = MASKS[mask](rng, scores.shape)
        got = t_norm.minmax_normalize(t(scores), t(m))
        assert same(got, j_norm.minmax_normalize(jnp.asarray(scores),
                                                 jnp.asarray(m)))
        assert ((got >= 0) & (got <= 100)).all()
        # one row, as the solve step calls it
        got1 = t_norm.minmax_normalize(t(scores[3]), t(m[3]))
        assert same(got1, j_norm.minmax_normalize(jnp.asarray(scores[3]),
                                                  jnp.asarray(m[3])))


@pytest.fixture(scope="module")
def gang_pair():
    """The gang + quota + nominee cluster lowered by both packages, and the
    free capacity of each."""
    lo = lowered(CLUSTERS["mixed_gangs"])
    free_j = lo.snap_j.nodes.alloc - lo.snap_j.nodes.requested
    free_p = t_fit.free_capacity(lo.snap_p.nodes.alloc,
                                 lo.snap_p.nodes.requested)
    return lo.snap_j, lo.snap_p, free_j, free_p


class TestOps:
    def test_fits_one_and_fits(self, gang_pair):
        snap_j, snap_p, free_j, free_p = gang_pair
        mask_j, mask_p = snap_j.nodes.mask, snap_p.nodes.mask
        for p in range(snap_p.num_pods):
            for nm in (None, "mask"):
                got = t_fit.fits_one(snap_p.pods.req[p], free_p,
                                     mask_p if nm else None)
                want = j_fit.fits_one(snap_j.pods.req[p], free_j,
                                      mask_j if nm else None)
                assert same(got, want), (p, nm)
        got = t_fit.fits(snap_p.pods.req, free_p, snap_p.pods.mask, mask_p)
        assert same(got, j_fit.fits(snap_j.pods.req, free_j,
                                    snap_j.pods.mask, mask_j))
        assert got.any() and not got.all()

    @pytest.mark.parametrize("with_inflight", [False, True])
    def test_gang_admit(self, gang_pair, with_inflight):
        snap_j, snap_p, free_j, free_p = gang_pair
        G, R = snap_p.gangs.min_member.shape[0], snap_p.num_resources
        rng = np.random.default_rng(3)
        inflight = rng.integers(0, 1 << 36, (G, R)) if with_inflight else None
        want = jax.vmap(lambda g: j_gang.gang_admit(
            snap_j.gangs, free_j, g,
            None if inflight is None else jnp.asarray(inflight),
        ))(snap_j.pods.gang)
        got = t_gang.gang_admit(
            snap_p.gangs, free_p, snap_p.pods.gang,
            None if inflight is None else t(inflight),
        )
        assert same(got, want)
        # one pod at a time, as the solve step calls it
        for p in range(snap_p.num_pods):
            one = t_gang.gang_admit(
                snap_p.gangs, free_p, snap_p.pods.gang[p:p + 1],
                None if inflight is None else t(inflight),
            )
            assert one.shape == (1,) and bool(one[0]) == bool(want[p])

    def test_gang_admit_inflight_adds_back(self, gang_pair):
        # the MinResources gang passes once enough demand is added back
        snap_j, snap_p, free_j, free_p = gang_pair
        g = int(np.flatnonzero(snap_p.gangs.has_min_resources.numpy())[0])
        gid = torch.tensor([g], dtype=torch.int32)
        inflight = torch.zeros_like(snap_p.gangs.min_resources)
        assert not t_gang.gang_admit(snap_p.gangs, free_p, gid, inflight)[0]
        inflight[g] = snap_p.gangs.min_resources[g]
        assert t_gang.gang_admit(snap_p.gangs, free_p, gid, inflight)[0]

    def test_gang_commits(self, gang_pair):
        snap_j, snap_p, _, _ = gang_pair
        G, R = snap_p.gangs.min_member.shape[0], snap_p.num_resources
        rng = np.random.default_rng(4)
        sched_j, sched_p = jnp.zeros(G, jnp.int32), torch.zeros(G, dtype=torch.int32)
        infl_j, infl_p = jnp.zeros((G, R), jnp.int64), torch.zeros((G, R), dtype=torch.int64)
        demand = rng.integers(0, 1 << 30, (snap_p.num_pods, R))
        placed = rng.random(snap_p.num_pods) < 0.6
        gang = snap_p.pods.gang.numpy()
        for p in range(snap_p.num_pods):
            sched_j = j_gang.gang_commit(sched_j, jnp.int32(gang[p]),
                                         jnp.bool_(placed[p]))
            infl_j = j_gang.gang_inflight_commit(
                infl_j, jnp.int32(gang[p]), jnp.asarray(demand[p]),
                jnp.bool_(placed[p]))
            sched_p = t_gang.gang_commit(sched_p, t(gang[p:p + 1]),
                                         t(placed[p:p + 1]))
            infl_p = t_gang.gang_inflight_commit(
                infl_p, t(gang[p:p + 1]), t(demand[p:p + 1]),
                t(placed[p:p + 1]))
        assert same(sched_p, sched_j) and same(infl_p, infl_j)
        assert sched_p.sum() > 0
        # the batch form folds the same sums
        assert torch.equal(
            t_gang.gang_commit(torch.zeros(G, dtype=torch.int32), t(gang),
                               t(placed)), sched_p)

    def test_scalar_quota_admit_and_commit(self, gang_pair):
        snap_j, snap_p, _, _ = gang_pair
        q_j, q_p = snap_j.quota, snap_p.quota
        rng = np.random.default_rng(5)
        R = snap_p.num_resources
        used_j, used_p = q_j.used, q_p.used.clone()
        for p in range(snap_p.num_pods):
            in_eq = rng.integers(0, 1 << 32, R)
            total = in_eq + rng.integers(0, 1 << 32, R)
            want = j_quota.quota_admit(
                used_j, q_j.min, q_j.max, q_j.has_quota, snap_j.pods.ns[p],
                snap_j.pods.req[p], jnp.asarray(in_eq), jnp.asarray(total))
            for ns, req in ((snap_p.pods.ns[p], snap_p.pods.req[p]),
                            (snap_p.pods.ns[p:p + 1], snap_p.pods.req[p:p + 1])):
                got = t_quota.quota_admit(
                    used_p, q_p.min, q_p.max, q_p.has_quota, ns, req,
                    t(in_eq), t(total))
                assert got.dtype == torch.bool
                assert bool(got.reshape(())) == bool(want), p
            placed = bool(rng.random() < 0.7)
            used_j = j_quota.quota_commit(
                used_j, q_j.has_quota, snap_j.pods.ns[p], snap_j.pods.req[p],
                jnp.bool_(placed))
            used_p = t_quota.quota_commit(
                used_p, q_p.has_quota, snap_p.pods.ns[p:p + 1],
                snap_p.pods.req[p:p + 1], torch.tensor([placed]))
            assert same(used_p, used_j), p
        assert not torch.equal(used_p, q_p.used)


class TestNominees:
    @pytest.mark.parametrize("case", ["nominees", "mixed_gangs",
                                      "cordon_nofit", "entry"])
    def test_lowering_equals_jax(self, solved, case):
        lo = solved(case).lo
        nm_j, nm_p = lo.snap_j.nominees, lo.snap_p.nominees
        assert (nm_j is None) == (nm_p is None)
        if nm_p is not None:
            for f in fields(nm_p):
                assert same(getattr(nm_p, f.name), getattr(nm_j, f.name)), f.name

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_free_with_nominee_holds(self, solved, seed):
        s = solved("nominees")
        snap_j, snap_c = s.lo.snap_j, s.snap_c
        rng = np.random.default_rng(seed)
        placed = rng.random(snap_c.num_pods) < 0.5
        state_j = s.lo.js.initial_state(snap_j).replace(
            placed_mask=jnp.asarray(placed))
        state_p = s.state_c.replace(placed_mask=t(placed))
        for p in range(snap_c.num_pods):
            got = t_runtime._free_with_nominee_holds(state_p, snap_c, p)
            want = j_runtime._free_with_nominee_holds(state_j, snap_j, p)
            assert same(got, want), p
        assert not torch.equal(got, state_p.free)  # the holds bite


class TestFramework:
    def test_profile_modes_and_queue_sort(self):
        plugins = [PORT_PLUGINS[n]() for n in FLAGSHIP]
        assert Profile(plugins=plugins).queue_sort is plugins[1]
        assert Profile(plugins=plugins[:1]).queue_sort is None
        assert Profile(plugins=plugins,
                       solve_mode="packing").solve_mode == "packing"
        with pytest.raises(ValueError, match="unknown solve mode"):
            Profile(plugins=plugins, solve_mode="annealing")

    def test_plugin_arguments_validated_as_jax(self):
        for kwargs in ({"min_candidate_nodes_percentage": 101},
                       {"min_candidate_nodes_absolute": -1},
                       {"min_candidate_nodes_percentage": 0,
                        "min_candidate_nodes_absolute": 0}):
            with pytest.raises(ValueError):
                j_plugins.CapacityScheduling(**kwargs)
            with pytest.raises(ValueError):
                CapacityScheduling(**kwargs)
        with pytest.raises(ValueError):
            NodeResourcesAllocatable(mode="Sideways")
        with pytest.raises(ValueError):
            Coscheduling(reject_percentage=101)
        for name in FLAGSHIP:
            assert (PORT_PLUGINS[name]().events_to_register()
                    == getattr(j_plugins, name)().events_to_register())

    def test_gang_sort_time_follows_last_failure(self):
        jc, pc = gang_quota_cluster(JAX), gang_quota_cluster(PORT)
        for cluster in (jc, pc):
            cluster.gang_last_failure_ms["team-0/gang-0000"] = 10 ** 9
        js, ps = schedulers()
        order_j = [p.uid for p in js.sort_pending(jc.pending_pods(), jc)]
        order_p = [p.uid for p in ps.sort_pending(pc.pending_pods(), pc)]
        assert order_p == order_j
        assert order_p[-1].startswith("team-0/gang-0000")

    def test_solve_output_anomaly(self, solved):
        s = solved("gang_quota")
        r = s.res_p
        N = s.snap_c.num_nodes
        assert t_runtime.solve_output_anomaly(r.assignment, r.admitted,
                                              r.wait, N) is None
        bad = r.assignment.clone()
        bad[0] = N
        for args in ((bad, r.admitted, r.wait), (r.assignment,
                                                 r.admitted[:-1], r.wait)):
            got = t_runtime.solve_output_anomaly(*args, N)
            assert got == j_runtime.solve_output_anomaly(
                *(a.numpy() for a in args), N) and got is not None


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

    def test_entry_problem_card_equals_cpu(self, card):
        cluster = allocatable_scenario(n_nodes=16, n_pods=32)
        results = {}
        for device in (card, CPU):
            sched = Scheduler(Profile(plugins=[PORT_PLUGINS[n]()
                                               for n in FLAGSHIP]))
            pending = sched.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = cluster.snapshot(pending, now_ms=0, device=device)
            sched.prepare(meta, cluster)
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                results[device.type] = sched.solve(snap, device=device)
            finally:
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
        assert_result_equal(results["cuda"], results["cpu"])
