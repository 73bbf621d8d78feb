"""The port's packing solve mode (`ops/packing.py`, `parallel/solver.py`
`packing_solve` / `packing_profile_solve`, `Scheduler.solve(mode=)`, the
`solveMode` / `packingConfig` surface and `run_cycle` with a packing
profile) against the JAX package, on `tests/test_packing.py`'s 24-node
problem (`bench.packing_problem` and the port's `packing_scenario`, the
same draws):

- `packing_refine` on the same numpy inputs: the port's (on torch) ==
  JAX's (jitted) == the JAX numpy twin == the port's numpy twin, on the
  assignment, the free rows and the round / move / emptied counts, over
  the seven-case knob matrix (a fractional budget among them);
- `packing_solve` == JAX at budgets 0, 4 and 24 (budget 0 also ==
  `batch_solve`), the `tuning.gates` oracles clean, the placed set kept;
- the config round trip == JAX's `profile_spec`, every refusal with
  JAX's exception and message;
- the packing profile through `Scheduler.solve` and `run_cycle`: the
  report and the store == JAX's, the cycle binds the direct solve's
  placements;
- `packing_refine` issues no op that reads a tensor on the host.

Every quantity compared is an integer or boolean: tolerance 0. The quality
gauges come from float64 sums of exact integers, compared bit for bit."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.framework import (
    PackingConfig,
    Profile,
    Scheduler,
    run_cycle,
)
from scheduler_plugins_tpu_torch.models import packing_scenario
from scheduler_plugins_tpu_torch.ops import CPU_I, MEMORY_I, PODS_I
from scheduler_plugins_tpu_torch.ops import packing as t_packing
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from scheduler_plugins_tpu_torch.plugins import (
    NodeResourcesAllocatable,
    TaintToleration,
)
from scheduler_plugins_tpu_torch.tuning import gates as t_gates
from scheduler_plugins_tpu_torch.tuning import quality as t_quality

try:
    import jax
    import jax.numpy as jnp

    import bench
    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.framework as jax_framework
    import scheduler_plugins_tpu.ops.packing as j_packing
    import scheduler_plugins_tpu.parallel.solver as j_solver
    from scheduler_plugins_tpu.ops.allocatable import (
        MODE_LEAST,
        allocatable_scores,
        demote_scores_int32,
    )
    from scheduler_plugins_tpu.ops.assign import waterfill_assign_targeted
    from scheduler_plugins_tpu.ops.fit import free_capacity
    from scheduler_plugins_tpu.tuning import gates as j_gates
    from scheduler_plugins_tpu.tuning import quality as j_quality
    from tests.test_torch_cycle import report_diff, store_diff
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    jax = None

#: the problem every case here runs (`tests/test_packing.py` `_SHAPE`)
_SHAPE = dict(n_nodes=24, demand_frac=0.85, empty_frac=0.15, seed=0)
#: (budget, price weight, temperature, decay), `tests/test_packing.py`'s
KNOBS = [
    (0, 4.0, 0.0, 0.5),
    (1, 4.0, 0.0, 0.5),
    (6, 4.0, 0.0, 0.5),
    (17, 4.0, 0.25, 0.5),
    (40, 0.0, 0.0, 1.0),
    (40, 8.0, 0.1, 0.9),
    (2.5, 4.0, 0.0, 0.5),
]
#: the mover window of the refine cases: smaller than a donor's batch
#: pods, so a donor drains over several rounds
MOVER_CAP = 32
STATS = ("rounds", "moves", "emptied")
PACKING_SPEC = {
    "profileName": "pack",
    "plugins": ["NodeResourcesAllocatable"],
    "solveMode": "packing",
    "packingConfig": {"iterations": 12, "priceWeight": 2.5,
                      "temperature": 0.1, "decay": 0.75, "moverCap": 64},
}
CYCLE_SPEC = {
    "profileName": "pack",
    "plugins": ["NodeResourcesAllocatable"],
    "solveMode": "packing",
    "packingConfig": {"iterations": 8},
}
#: the ops that read a tensor on the host (on the card: a sync)
HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
              "masked_select", "equal", "lift_fresh")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if jax is None:
        pytest.skip("the JAX package is not importable here")


def t(x):
    return torch.as_tensor(np.array(x))


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def problem():
    """Both packages' packing problem: (cluster, snap, meta, weights)
    each, the same cluster from the same seed."""
    j = bench.packing_problem(**_SHAPE)
    p = packing_scenario(**_SHAPE, device="cpu")
    for a, b in ((j[1].nodes.alloc, p[1].nodes.alloc),
                 (j[1].nodes.requested, p[1].nodes.requested),
                 (j[1].nodes.mask, p[1].nodes.mask),
                 (j[1].pods.req, p[1].pods.req),
                 (j[1].pods.mask, p[1].pods.mask),
                 (j[3], p[3])):
        assert np.array_equal(np.asarray(a), host(b))
    return SimpleNamespace(j=j, p=p)


@pytest.fixture(scope="module")
def wave_inputs(problem):
    """The refinement's inputs as numpy arrays, staged as JAX's
    `packing_solve` stages them: (raw, req, admitted, alloc, node_mask,
    free after the wave, wave assignment)."""
    _, snap, _, weights = problem.j
    free0 = free_capacity(snap.nodes.alloc, snap.nodes.requested)
    admitted = j_solver.batch_admission(snap, free0)
    raw = demote_scores_int32(
        allocatable_scores(snap.nodes.alloc, weights, MODE_LEAST)
    ).astype(jnp.int64)
    solve_free0 = jnp.where(snap.nodes.mask[:, None], free0, 0)
    a_w, f_w = waterfill_assign_targeted(raw, snap.pods.req, admitted,
                                         solve_free0)
    return tuple(np.asarray(x) for x in (
        raw, snap.pods.req, admitted, snap.nodes.alloc, snap.nodes.mask,
        f_w, a_w))


_JIT_REFINE = None


def jax_refine(*xs):
    """One jitted JAX refine for the whole knob matrix (the knobs are
    traced, so every case shares the compile)."""
    global _JIT_REFINE
    if _JIT_REFINE is None:
        _JIT_REFINE = jax.jit(lambda *a: j_packing.packing_refine(
            *a, mover_cap=MOVER_CAP))
    return _JIT_REFINE(*xs)


class TestPackingDifferential:
    @pytest.mark.parametrize("budget,price,temp,decay", KNOBS)
    def test_refine_matches_jax_and_twins(self, wave_inputs, budget, price,
                                          temp, decay):
        raw, req, adm, alloc, mask, free_w, a_w = wave_inputs
        args = (raw, req, adm, alloc, mask, free_w, a_w)
        aj, fj, sj = jax_refine(*args, j_packing.pack_aux_vector(
            budget, price, temp, decay))
        an, fn, sn = j_packing.packing_refine_np(
            *args, j_packing.pack_aux_vector(budget, price, temp, decay),
            mover_cap=MOVER_CAP)
        aux = t_packing.pack_aux_vector(budget, price, temp, decay)
        assert np.array_equal(aux, np.asarray(
            j_packing.pack_aux_vector(budget, price, temp, decay)))
        ap, fp, sp = t_packing.packing_refine(
            *(t(x) for x in args), aux, mover_cap=MOVER_CAP)
        apn, fpn, spn = t_packing.packing_refine_np(*args, aux,
                                                    mover_cap=MOVER_CAP)
        assert ap.dtype == torch.int32 and fp.dtype == torch.int64
        for a, f in ((np.asarray(aj), np.asarray(fj)), (an, fn),
                     (apn, fpn)):
            assert np.array_equal(ap.numpy(), a)
            assert np.array_equal(fp.numpy(), f)
        for k in STATS:
            assert int(sp[k]) == int(sj[k]) == sn[k] == spn[k], k
            assert sp[k].dtype == torch.int32
        if budget >= 6:
            assert int(sp["moves"]) > 0

    def test_budget_zero_is_identity(self, wave_inputs):
        raw, req, adm, alloc, mask, free_w, a_w = wave_inputs
        ap, fp, sp = t_packing.packing_refine(
            t(raw), t(req), t(adm), t(alloc), t(mask), t(free_w), t(a_w),
            t_packing.pack_aux_vector(0, 4.0, 0.0, 0.5))
        assert np.array_equal(ap.numpy(), a_w)
        assert np.array_equal(fp.numpy(), free_w)
        assert [int(sp[k]) for k in STATS] == [0, 0, 0]

    def test_ties_go_to_the_lowest_index(self):
        """Five identical nodes, one pod on each of nodes 1, 2 and 3: the
        donor is node 1 (the first of the emptiest), and its pod moves to
        node 2, the first of the equal bids of nodes 2 and 3 (nodes 0 and
        4 are empty, never targets)."""
        N = 5
        alloc = np.zeros((N, 4), np.int64)
        alloc[:, CPU_I] = alloc[:, MEMORY_I] = 1000
        alloc[:, PODS_I] = 10
        req = np.zeros((3, 4), np.int64)
        req[:, CPU_I] = req[:, MEMORY_I] = 100
        a0 = np.array([1, 2, 3], np.int32)
        free = alloc.copy()
        for p, node in enumerate(a0):
            free[node] -= req[p]
            free[node, PODS_I] -= 1
        args = (np.zeros(N, np.int64), req, np.ones(3, bool), alloc,
                np.ones(N, bool), free, a0)
        aux = t_packing.pack_aux_vector(1, 4.0, 0.0, 0.5)
        ap, _, _ = t_packing.packing_refine(*(t(x) for x in args), aux)
        aj, _, _ = j_packing.packing_refine(*(jnp.asarray(x) for x in args),
                                            jnp.asarray(aux))
        assert ap.tolist() == np.asarray(aj).tolist() == [2, 2, 3]


class TestPackingSolve:
    @pytest.mark.parametrize("budget", [0, 4, 24])
    def test_matches_jax(self, problem, budget):
        _, snap_j, _, w_j = problem.j
        _, snap_p, _, w_p = problem.p
        aux = (budget, 4.0, 0.0, 0.5)
        aj, admj, wj, sj = j_solver.packing_solve(
            snap_j, w_j, j_packing.pack_aux_vector(*aux), collect_stats=True)
        ap, admp, wp, sp = t_solver.packing_solve(
            snap_p, w_p, t_packing.pack_aux_vector(*aux), collect_stats=True)
        assert np.array_equal(ap.numpy(), np.asarray(aj))
        assert np.array_equal(admp.numpy(), np.asarray(admj))
        assert np.array_equal(wp.numpy(), np.asarray(wj))
        assert sp["waves"] == int(sj["waves"])
        assert sp["occupancy"] == np.asarray(
            sj["occupancy"])[:sp["waves"]].tolist()
        for k in STATS:
            assert int(sp["packing"][k]) == int(sj["packing"][k]), k
        assert int(sp["packing"]["rounds"]) == budget

    def test_budget_zero_bit_matches_wave_path(self, problem):
        _, snap, _, weights = problem.p
        ref = t_solver.batch_solve(snap, weights)
        got = t_solver.packing_solve(
            snap, weights, t_packing.pack_aux_vector(0, 4.0, 0.0, 0.5))
        for a, b in zip(ref, got):
            assert torch.equal(a, b)

    def test_oracles_clean_and_placed_set_preserved(self, problem):
        _, snap, _, weights = problem.p
        a_w = t_solver.batch_solve(snap, weights)[0]
        for budget in (4, 24):
            a, _, wait = t_solver.packing_solve(
                snap, weights, t_packing.pack_aux_vector(budget, 4.0, 0.0,
                                                         0.5))
            verdict = t_gates.hard_violations(snap, a, wait)
            assert verdict["total"] == 0, verdict
            assert verdict == j_gates.hard_violations(
                problem.j[1], a.numpy(), wait.numpy())
            # refinement moves placements, never unplaces them
            assert torch.equal(a >= 0, a_w >= 0)

    def test_refinement_improves_packing_objectives(self, problem):
        _, snap, _, weights = problem.p
        a_w, _, wait_w = t_solver.batch_solve(snap, weights)
        a_p, _, wait_p = t_solver.packing_solve(
            snap, weights, t_packing.pack_aux_vector(24, 4.0, 0.0, 0.5))
        qw = t_quality.cycle_quality(snap, a_w, None, wait_w)
        qp = t_quality.cycle_quality(snap, a_p, None, wait_p)
        assert qp["packed_utilization"] > qw["packed_utilization"]
        assert qp["fragmentation"] <= qw["fragmentation"]
        assert qp == j_quality.cycle_quality(problem.j[1], a_p.numpy(),
                                             None, wait_p.numpy())


def _error(load, config):
    """(exception type, message) of `load(config)`."""
    with pytest.raises((ValueError, TypeError)) as info:
        load(config)
    return type(info.value), str(info.value)


class TestPackingConfigSurface:
    def test_round_trip_matches_jax(self):
        profile = port_config.load_profile(PACKING_SPEC)
        assert profile.solve_mode == "packing"
        assert profile.packing == PackingConfig(
            iterations=12, price_weight=2.5, temperature=0.1, decay=0.75,
            mover_cap=64)
        spec = port_config.profile_spec(profile)
        assert spec == jax_config.profile_spec(
            jax_config.load_profile(PACKING_SPEC))
        assert spec["packingConfig"] == PACKING_SPEC["packingConfig"]
        again = port_config.load_profile(spec)
        assert again.packing == profile.packing
        assert port_config.profile_spec(again) == spec
        assert np.array_equal(
            profile.packing.aux(),
            np.asarray(jax_config.load_profile(PACKING_SPEC).packing.aux()))

    @pytest.mark.parametrize("config", [
        {"plugins": ["NodeResourcesAllocatable"]},
        {"plugins": ["NodeResourcesAllocatable"], "solveMode": "packing"},
        {"plugins": ["NodeResourcesAllocatable"], "solveMode": "packing",
         "packingConfig": {"iterations": 32, "decay": 0.5}},
        {"plugins": ["NodeResourcesAllocatable"], "weights": [3],
         "solveMode": "packing", "packingConfig": {"moverCap": 7}},
        {"plugins": ["NodeResourcesAllocatable"], "solveMode": "sequential",
         "packingConfig": {"iterations": 3}},
    ], ids=["sequential", "defaults", "default_knobs", "weights",
            "sequential_knobs"])
    def test_spec_matches_jax(self, config):
        spec = port_config.profile_spec(port_config.load_profile(config))
        assert spec == jax_config.profile_spec(jax_config.load_profile(config))
        assert port_config.profile_spec(port_config.load_profile(spec)) == spec

    @pytest.mark.parametrize("extra", [
        {"solveMode": "annealing"},
        {"solveMode": "packing", "packingConfig": {"budget": 3}},
        {"solveMode": "packing", "packingConfig": {"decay": 0.0}},
        {"solveMode": "packing", "packingConfig": {"decay": 1.5}},
        {"solveMode": "packing", "packingConfig": {"iterations": -1}},
        {"solveMode": "packing", "packingConfig": {"iterations": 1.5}},
        {"solveMode": "packing", "packingConfig": {"priceWeight": -1.0}},
        {"solveMode": "packing", "packingConfig": {"temperature": -0.5}},
        {"solveMode": "packing", "packingConfig": {"moverCap": 0}},
        {"solveMode": "packing",
         "plugins": ["NodeResourcesAllocatable", "TaintToleration"]},
        {"solveMode": "packing", "plugins": ["Coscheduling"]},
        {"solveMode": "packing", "weights": [1, 1], "plugins": [
            "NodeResourcesAllocatable", "NodeResourcesAllocatable"]},
    ], ids=["mode", "arg", "decay0", "decay_big", "negative", "fractional",
            "price", "temperature", "mover_cap", "filter", "no_scorer",
            "two_scorers"])
    def test_refusals_match_jax(self, extra):
        config = {"plugins": ["NodeResourcesAllocatable"], **extra}
        want = _error(jax_config.load_profile, config)
        assert _error(port_config.load_profile, config) == want

    def test_profile_constructor_modes(self):
        assert Profile(solve_mode="packing").packing == PackingConfig()
        with pytest.raises(ValueError) as port:
            Profile(solve_mode="annealing")
        with pytest.raises(ValueError) as jx:
            jax_framework.Profile(solve_mode="annealing")
        assert str(port.value) == str(jx.value)

    def test_solve_refuses_what_jax_refuses(self, problem):
        cluster, snap, meta, _ = problem.p
        sched = Scheduler(port_config.load_profile(PACKING_SPEC))
        jsched = jax_framework.Scheduler(
            jax_config.load_profile(PACKING_SPEC))
        snap_j = problem.j[1]
        with pytest.raises(ValueError) as port:
            sched.solve(snap, sched.initial_state(snap), device="cpu")
        with pytest.raises(ValueError) as jx:
            jsched.solve(snap_j, state0=jsched.initial_state(snap_j))
        assert str(port.value) == str(jx.value)
        sched.set_live_weights([2])
        jsched.set_live_weights([2])
        with pytest.raises(ValueError) as port:
            sched.solve(snap, device="cpu")
        with pytest.raises(ValueError) as jx:
            jsched.solve(snap_j)
        assert str(port.value) == str(jx.value)
        sched.set_live_weights(None)
        sched.prepare(meta, cluster)
        with pytest.raises(ValueError, match="unknown solve mode"):
            sched.solve(snap, device="cpu", mode="annealing")
        # mode="sequential" overrides the profile's packing mode
        sequential = sched.solve(snap, device="cpu", mode="sequential")
        assert not isinstance(sequential, t_solver.PackingSolveView)

    def test_off_fast_path_profile_raises_type_error(self, problem):
        _, snap, _, _ = problem.p
        sched = Scheduler(Profile(
            plugins=[NodeResourcesAllocatable(), TaintToleration()],
            solve_mode="packing"))
        with pytest.raises(TypeError, match="fast path"):
            sched.solve(snap, device="cpu")


def _profile_inputs(pkg_sched, cluster, snapshot):
    pending = pkg_sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = snapshot(cluster, pending)
    pkg_sched.prepare(meta, cluster)
    return pending, snap, meta


class TestPackingCycle:
    def _solves(self, spec=CYCLE_SPEC):
        jc = bench.packing_problem(**_SHAPE)[0]
        pc = packing_scenario(**_SHAPE, device="cpu")[0]
        js = jax_framework.Scheduler(jax_config.load_profile(spec))
        ps = Scheduler(port_config.load_profile(spec))
        _, snap_j, _ = _profile_inputs(
            js, jc, lambda c, pend: c.snapshot(pend, now_ms=0))
        pending, snap_p, meta = _profile_inputs(
            ps, pc, lambda c, pend: c.snapshot(pend, now_ms=0,
                                               device="cpu"))
        return js.solve(snap_j), ps.solve(snap_p, device="cpu"), pending, meta

    def test_profile_solve_matches_jax(self):
        vj, vp, _, _ = self._solves()
        assert isinstance(vp, t_solver.PackingSolveView)
        assert vp.failed_plugin is None
        for k in ("assignment", "admitted", "wait"):
            assert np.array_equal(host(getattr(vp, k)),
                                  np.asarray(getattr(vj, k))), k
        assert vp.stats == vj.stats
        assert vp.stats["rounds"] == 8 and vp.stats["moves"] > 0

    def test_certification_runs_the_oracles(self, monkeypatch):
        monkeypatch.setenv("SPT_PACK_CERTIFY", "1")
        self._solves()  # clean: no raise
        monkeypatch.setattr(t_gates, "hard_violations",
                            lambda *a: {"total": 1})
        with pytest.raises(AssertionError, match="hard constraints"):
            self._solves()

    def test_run_cycle_matches_jax(self):
        jc = bench.packing_problem(**_SHAPE)[0]
        pc = packing_scenario(**_SHAPE, device="cpu")[0]
        rj = jax_framework.run_cycle(
            jax_framework.Scheduler(jax_config.load_profile(CYCLE_SPEC)),
            jc, now=1000)
        rp = run_cycle(Scheduler(port_config.load_profile(CYCLE_SPEC)), pc,
                       now=1000, device="cpu")
        assert rp.bound and "packed_utilization" in rp.quality
        assert report_diff(rj, rp) == []
        assert store_diff(jc, pc) == []

    def test_cycle_binds_the_direct_solve(self):
        _, view, pending, meta = self._solves()
        report = run_cycle(
            Scheduler(port_config.load_profile(CYCLE_SPEC)),
            packing_scenario(**_SHAPE, device="cpu")[0], now=1000,
            device="cpu")
        a = view.assignment.numpy()
        assert report.bound == {
            pending[i].uid: meta.node_names[int(a[i])]
            for i in range(len(pending)) if a[i] >= 0
        }


class TestRefineIssuesNoHostRead:
    def test_no_host_reads(self, wave_inputs):
        """The rounds read nothing on the host, so on the card they never
        wait: every op is device work."""
        args = [t(x) for x in wave_inputs]
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        with Log():
            out = t_packing.packing_refine(
                *args, t_packing.pack_aux_vector(6, 4.0, 0.0, 0.5),
                mover_cap=MOVER_CAP)
        assert int(out[2]["moves"]) > 0
        assert ops
        assert not [op for op in ops if op.split(".")[0] in HOST_READS]


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

    def test_card_equals_cpu_without_host_reads(self, card):
        """`packing_solve` at budgets 0 and 24 on the card equals the CPU's,
        and the refinement's rounds run under sync-debug "error"."""
        _, snap, _, weights = packing_scenario(**_SHAPE, device="cpu")
        snap_d, weights_d = snap.to(card), weights.to(card)
        for budget in (0, 24):
            aux = t_packing.pack_aux_vector(budget, 4.0, 0.0, 0.5)
            want = t_solver.packing_solve(snap, weights, aux,
                                          collect_stats=True)
            got = t_solver.packing_solve(snap_d, weights_d, aux,
                                         collect_stats=True)
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a.cpu(), b)
            for k in STATS:
                assert int(got[3]["packing"][k]) == int(want[3]["packing"][k])
        free0, admitted, raw = t_solver._solve_head(snap_d, weights_d)
        a_w, f_w, _ = t_solver.waterfill_assign_targeted(
            raw, snap_d.pods.req, admitted,
            torch.where(snap_d.nodes.mask[:, None], free0, 0))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = t_packing.packing_refine(
                raw, snap_d.pods.req, admitted, snap_d.nodes.alloc,
                snap_d.nodes.mask, f_w, a_w,
                t_packing.pack_aux_vector(24, 4.0, 0.0, 0.5))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(out[0].cpu(), want[0])
