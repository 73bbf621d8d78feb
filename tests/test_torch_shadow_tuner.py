"""The port's shadow lane and promotion gate (`tuning/shadow.py`,
`tuning/promotion.py`, `run_cycle(tuner=)`, `tools/tune.py`, the replay
tool's `quality` and `timeline`) against the JAX package's, on the CPU.

- The JAX decision tables of `tests/test_shadow_tuner.py`
  (TestPromotionGateBody, TestRollbackDecisionTables with its scripted
  probe, TestTunerFaultSites, TestTunerRequiresSequentialMode,
  TestStatePersistence, TestLiveWeightsSeam) run again on the port, every
  JAX name they call swapped for the port's. The live-swap case that
  counts JAX's recompiles stays JAX's; `TestLiveSwap` is its counterpart.
- `evaluate_candidates` on one corpus that JAX recorded: the verdict, the
  order, the violations and the anchor mismatches exact, the objectives
  within 1e-12 relative.
- Bench config 14's drifting mix at the chaos check's 32-node shape
  (with a regression phase) on both packages: the same promotions,
  weights by cycle, injected cycle and rollback, every cycle's
  placements equal, the quality stamps within 1e-12 relative.
- A tuner state file written by JAX restores in the port, and the
  reverse.
- The tuner chaos check and the observe-only pairs on the port: every
  tuner fault and the observe-only lane leave the live placements equal
  to the control's.

Integer decisions: tolerance 0. Floats that sum non-integers
(`util_imbalance`, the corpus means) depend on the reduction order (XLA's
and torch's differ): 1e-12 relative."""

import functools
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.framework.runtime as port_runtime
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.tools.tune as port_tune
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.resilience import faults as port_faults
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.tools import replay as port_replay
from scheduler_plugins_tpu_torch.tuning import promotion as t_promotion
from scheduler_plugins_tpu_torch.tuning import quality as t_quality
from scheduler_plugins_tpu_torch.tuning import shadow as t_shadow
from scheduler_plugins_tpu_torch.tuning import sweep as t_sweep
from scheduler_plugins_tpu_torch.utils import flightrec as port_flightrec
from torch_tune_cases import (
    CHAOS_TUNE_SHAPE,
    run_drift_arm,
    tune_overhead_pct,
    tuner_chaos_check,
)

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.models as j_models
    import scheduler_plugins_tpu.plugins as jax_plugins
    import tests.test_shadow_tuner as jax_tables
    import tools
    import tools.tune as jax_tune
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
        run_cycle as j_run_cycle,
    )
    from scheduler_plugins_tpu.resilience import faults as j_faults
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    from scheduler_plugins_tpu.tuning import promotion as j_promotion
    from scheduler_plugins_tpu.tuning import quality as j_quality
    from scheduler_plugins_tpu.tuning.shadow import (
        ShadowTuner as JShadowTuner,
    )
    from scheduler_plugins_tpu.utils import flightrec as j_flightrec
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    jax_objects = None

CPU = "cpu"

PORT = SimpleNamespace(
    objects=port_objects, Cluster=PCluster, plugins=port_plugins,
    Profile=PProfile, Scheduler=PScheduler,
    ShadowTuner=functools.partial(t_shadow.ShadowTuner, device=CPU),
    run=lambda s, c, now, tuner: port_cycle.run_cycle(
        s, c, now=now, tuner=tuner, device=CPU),
    flightrec=port_flightrec, faults=port_faults, SENSE=t_quality.SENSE,
)
JAX = None if jax_objects is None else SimpleNamespace(
    objects=jax_objects, Cluster=JCluster, plugins=jax_plugins,
    Profile=JProfile, Scheduler=JScheduler, ShadowTuner=JShadowTuner,
    run=lambda s, c, now, tuner: j_run_cycle(s, c, now=now, tuner=tuner),
    flightrec=j_flightrec, faults=j_faults, SENSE=j_quality.SENSE,
)


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


@pytest.fixture(autouse=True)
def recorders_off():
    """Each test starts and ends with both packages' recorders off."""
    yield
    port_flightrec.recorder.stop()
    if JAX is not None:
        j_flightrec.recorder.stop()


# --- the JAX decision tables on the port --------------------------------------

class _CPUCluster(PCluster):
    def snapshot(self, pending, now_ms=0, device=CPU, **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


class _CPUScheduler(PScheduler):
    def solve(self, snap, state0=None, *, device=CPU, mode=None):
        return super().solve(snap, state0, device=device, mode=mode)


#: the JAX tables' case that stays JAX's: it counts JAX's recompiles
JAX_ONLY = {"test_live_swap_parity_and_zero_recompiles"}


def _tables():
    if JAX is None:
        return []
    classes = [jax_tables.TestPromotionGateBody,
               jax_tables.TestRollbackDecisionTables,
               jax_tables.TestTunerFaultSites,
               jax_tables.TestTunerRequiresSequentialMode,
               jax_tables.TestStatePersistence,
               jax_tables.TestLiveWeightsSeam]
    cases = []
    for cls in classes:
        for name in sorted(vars(cls)):
            if not name.startswith("test_") or name in JAX_ONLY:
                continue
            marks = [m for m in getattr(getattr(cls, name), "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                cases.append(pytest.param(cls, name, {},
                                          id=f"{cls.__name__}.{name}"))
                continue
            arg, values = marks[0].args
            cases += [pytest.param(cls, name, {arg: v},
                                   id=f"{cls.__name__}.{name}[{v}]")
                      for v in values]
    return cases


@pytest.mark.parametrize("cls,method,kwargs", _tables())
def test_decision_table_against_port(cls, method, kwargs, monkeypatch):
    """Each case of `tests/test_shadow_tuner.py`'s tables (but
    `JAX_ONLY`), with every JAX name it calls, at module level and in its
    bodies' imports, swapped for the port's on the CPU."""
    swaps = {
        "Profile": PProfile, "Scheduler": _CPUScheduler,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "faults": port_faults, "promotion": t_promotion,
        "ShadowTuner": PORT.ShadowTuner,
        "PROBATION_OBJECTIVES": t_shadow.PROBATION_OBJECTIVES,
    }
    for name, value in swaps.items():
        monkeypatch.setattr(jax_tables, name, value)
    monkeypatch.setattr(port_scenarios, "Cluster", _CPUCluster)
    monkeypatch.setattr(j_models, "trimaran_scenario",
                        port_scenarios.trimaran_scenario)
    for name in ("TargetLoadPacking", "LoadVariationRiskBalancing"):
        monkeypatch.setattr(jax_plugins, name, getattr(port_plugins, name))
    monkeypatch.setitem(sys.modules, "tools.tune", port_tune)
    monkeypatch.setattr(tools, "tune", port_tune)
    getattr(cls(), method)(**kwargs)


class TestLiveSwap:
    """The counterpart of the JAX table's recompile count: a live swap is
    the statically weighted solve, JAX's too, and a rollback is the
    incumbent's."""

    def _solve(self, pkg, scheduler, seed=3):
        cluster = (port_scenarios.trimaran_scenario if pkg is PORT
                   else j_models.trimaran_scenario)(n_nodes=16, n_pods=24,
                                                    seed=seed)
        pending = scheduler.sort_pending(cluster.pending_pods(), cluster)
        if pkg is PORT:
            snap, meta = cluster.snapshot(pending, now_ms=0, device=CPU)
            scheduler.prepare(meta, cluster)
            return scheduler.solve(snap, device=CPU).assignment.numpy()
        snap, meta = cluster.snapshot(pending, now_ms=0)
        scheduler.prepare(meta, cluster)
        return np.asarray(scheduler.solve(snap).assignment)

    def _sched(self, pkg, w):
        sched = pkg.Scheduler(pkg.Profile(plugins=[
            pkg.plugins.TargetLoadPacking(),
            pkg.plugins.LoadVariationRiskBalancing()]))
        for plugin, wi in zip(sched.profile.plugins, w):
            plugin.weight = wi
        return sched

    def test_live_swap_equals_static_and_jax(self, jax_package):
        want = self._solve(JAX, self._sched(JAX, [3, 7]))
        np.testing.assert_array_equal(
            self._solve(PORT, self._sched(PORT, [3, 7])), want)
        live = self._sched(PORT, [1, 1])
        base = self._solve(PORT, live)
        live.set_live_weights([3, 7])
        got = self._solve(PORT, live)
        np.testing.assert_array_equal(got, want)
        assert (got != base).any()
        live.set_live_weights([1, 1])
        np.testing.assert_array_equal(self._solve(PORT, live), base)
        assert [p.weight for p in live.profile.plugins] == [1, 1]


# --- the promotion gate on one recorded corpus -------------------------------

@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """A bundle of two trimaran cycles recorded by JAX's `run_cycle`."""
    if JAX is None:
        pytest.skip("the JAX package is not importable here")
    out = str(tmp_path_factory.mktemp("tune") / "bundle")
    sched = JScheduler(JProfile(plugins=[
        jax_plugins.TargetLoadPacking(),
        jax_plugins.LoadVariationRiskBalancing()]))
    j_flightrec.recorder.start(capacity=4)
    try:
        for seed in range(2):
            j_run_cycle(sched, j_models.trimaran_scenario(
                n_nodes=24, n_pods=32, seed=seed), now=1000 + seed)
        j_flightrec.recorder.save(out)
    finally:
        j_flightrec.recorder.stop()
    return out


@pytest.mark.parametrize("lane", ["offline", "shadow"])
def test_evaluate_candidates_equals_jax(jax_corpus, lane):
    """The shared gate body on JAX's recorded corpus, with the offline
    tuner's defaults and with the shadow lane's ranking (the probation
    objectives, drift a rail): the integer fields exact, the objectives
    and rank scores within 1e-12 relative."""
    kw = {} if lane == "offline" else dict(
        rank_objectives=t_shadow.PROBATION_OBJECTIVES,
        tolerances={"drift": 0.10})
    W = t_sweep.candidate_weights([1, 1], 12, seed=5)
    want = j_promotion.evaluate_candidates(
        jax_tune._promotion_corpus(jax_tune._load_corpus(jax_corpus)), W,
        0.05, **kw)
    got = t_promotion.evaluate_candidates(
        port_tune._promotion_corpus(port_tune._load_corpus(jax_corpus, CPU)),
        W, 0.05, device=CPU, **kw)
    np.testing.assert_array_equal(got.violations, want.violations)
    np.testing.assert_array_equal(got.order, want.order)
    assert (got.best, got.improved, got.accepted, got.anchor_mismatches) == (
        want.best, want.improved, want.accepted, want.anchor_mismatches)
    assert got.disqualified == want.disqualified
    assert set(got.objectives) == set(want.objectives)
    for name in want.objectives:
        np.testing.assert_allclose(got.objectives[name],
                                   want.objectives[name], rtol=1e-12,
                                   atol=1e-15)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-12, atol=1e-15)
    assert got.anchor_mismatches == 0 and np.isfinite(got.score).any()


def test_tune_and_quality_tools_on_jax_corpus(jax_corpus, capsys):
    """`tools/tune.py tune` and `tools/replay.py quality` on JAX's corpus:
    the tune line's weights, verdict and K-independent sweep ops, and
    every recorded quality stamp recomputed equal (1e-9, JAX's own
    tolerance) and equal to JAX's `bundle_quality`."""
    rc = port_tune.main(["tune", jax_corpus, "--candidates", "12",
                         "--seed", "5", "--tolerance", "0.05",
                         "--device", CPU])
    line = json.loads(capsys.readouterr().out)
    ops = line["sweep_ops"]
    assert ops["k1"] == ops["k12"] > 0
    assert rc == (0 if line["accepted"] else 1)
    assert line["candidates"] == 12 and line["anchor_mismatches"] == 0
    assert port_replay.main(["quality", jax_corpus, "--device", CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    want = jax_tune.bundle_quality(jax_corpus)
    assert [r["cycle"] for r in got["cycles"]] == [
        r["cycle"] for r in want["cycles"]]
    for g, w in zip(got["cycles"], want["cycles"]):
        assert g["matches_recorded"] is True
        assert g["quality"] == w["quality"]


def test_timeline_reads_the_ledger_segment(tmp_path, capsys):
    """`timeline` on a port bundle saved with the pod-lifecycle ledger
    on: the pod list, then one pod's events and exact decomposition; a
    bundle without the segment is rc 1."""
    from scheduler_plugins_tpu_torch.obs import ledger as podledger

    led = podledger.Ledger().start()
    prev = podledger.use(led)
    sched = PScheduler(PProfile(plugins=[
        port_plugins.NodeResourcesAllocatable()]))
    port_flightrec.recorder.start(capacity=2)
    try:
        cluster = port_scenarios.allocatable_scenario(8, 6)
        port_cycle.run_cycle(sched, cluster, now=1000, device=CPU)
        port_flightrec.recorder.save(str(tmp_path / "b"))
    finally:
        port_flightrec.recorder.stop()
        podledger.use(prev)
    assert port_replay.main(["timeline", str(tmp_path / "b")]) == 0
    listing = json.loads(capsys.readouterr().out)
    assert len(listing["pods"]) == 6
    uid = listing["pods"][0]["uid"]
    assert port_replay.main(["timeline", str(tmp_path / "b"),
                             "--uid", uid]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["uid"] == uid and rec["cycles"]
    assert rec["decomposition_exact"] is True
    (tmp_path / "b" / "ledger.json").unlink()
    assert port_replay.main(["timeline", str(tmp_path / "b")]) == 1


# --- config 14 at the chaos check's shape on both packages -------------------

#: the chaos check's 32-node shape with a regression phase, so the
#: injected promotion and its rollback happen
DRIFT_SHAPE = dict(CHAOS_TUNE_SHAPE, regression_cycles=8)


def test_drift_run_equals_jax(jax_package):
    """The tuned drifting mix through `run_cycle(tuner=)` on both
    packages: the same promotions (cycle and weights), weights by cycle,
    injected cycle, rollback and final tuner status, every cycle's
    placements equal, the quality stamps within 1e-12 relative; and the
    run promotes, injects and rolls back."""
    got = run_drift_arm(PORT, DRIFT_SHAPE, tuned=True)
    want = run_drift_arm(JAX, DRIFT_SHAPE, tuned=True)
    for key in ("promotions", "weights_by_cycle", "injected_at", "rollback",
                "regress_seen_at", "bound", "decided", "tuner"):
        assert got[key] == want[key], key
    for g, w in zip(got["quality"], want["quality"]):
        assert set(g) == set(w)
        for name in g:
            assert g[name] == pytest.approx(w[name], rel=1e-12, abs=1e-15)
    assert len(got["promotions"]) == 2 and got["rollback"] is not None
    assert got["violations"] == 0
    assert got["tuner"]["sweeps"] > 0 and got["tuner"]["sweep_failures"] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_file_crosses_packages(jax_package, writer):
    """A tuner state file (format 1) written by one package, through JSON,
    restores in the other: the weights, the open probation window and
    the blocked set, and the restored window still rolls back."""
    def tuner(pkg):
        sched = pkg.Scheduler(pkg.Profile(plugins=[
            pkg.plugins.NodeResourcesAllocatable() for _ in range(2)]))
        return pkg.ShadowTuner(sched, probation_cycles=6, baseline_min=1,
                               hysteresis=0.01, regress_cycles=2,
                               cooldown_cycles=4, sync=True)

    src_pkg, dst_pkg = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    src = tuner(src_pkg)
    src.begin_cycle()
    src.observe_report(jax_tables.report(quality=jax_tables.flat_quality()))
    src.blocked.add((9, 9))
    src.inject_promotion((4, 6))
    src.begin_cycle()
    assert src.state == "probation"
    state = json.loads(json.dumps(src.state_dict()))
    dst = tuner(dst_pkg)
    assert dst.restore_state(state)
    assert dst.state_dict() == state
    assert [int(w) for w in dst.active] == [4, 6]
    assert [p.weight for p in dst.scheduler.profile.plugins] == [4, 6]
    assert dst.status()["active_digest"] == src.status()["active_digest"]
    dst.begin_cycle()
    dst.observe_report(jax_tables.report(
        quality=jax_tables.flat_quality(), degraded=True))
    assert dst.rollbacks == src.rollbacks + 1
    assert [int(w) for w in dst.active] == [1, 1]


# --- the robustness contract on the port --------------------------------------

def test_tuner_chaos_keeps_placements():
    """The chaos check's tuner faults (garbage sweep output, a sweep hang
    past a lowered deadline, a crash on every promotion) leave every
    cycle's placements equal to the no-tuner control's; the tuner never
    promotes and keeps the static weights."""
    line = tuner_chaos_check(PORT, hang_seconds=2.0, hang_deadline_s=0.8)
    assert line["ok"], line
    assert line["sweep_failures"] >= 2 and line["promote_crashes"] >= 1


def test_observe_only_lane_keeps_placements():
    """The observe-only lane with its background sweep worker, interleaved
    with a lane-off arm: every cycle's placements equal."""
    _pct, _floor, match, overlap = tune_overhead_pct(PORT,
                                                     CHAOS_TUNE_SHAPE)
    assert match
    assert set(overlap) == {"busy_pairs", "busy_pct", "idle_pct"}


def test_sweep_step_reads_weights_tensor_only_under_the_sweep():
    """The parity solve without a weight tensor reads the plugins' ints
    (a solve's ATen ops unchanged); `weights=` replaces them."""
    sched = PScheduler(PProfile(plugins=[
        port_plugins.TargetLoadPacking(),
        port_plugins.LoadVariationRiskBalancing()]))
    cluster = port_scenarios.trimaran_scenario(n_nodes=12, n_pods=10,
                                               seed=2)
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0, device=CPU)
    sched.prepare(meta, cluster)
    plugins = tuple(sched.profile.plugins)
    for w in ([1, 1], [5, 2], [1, 64]):
        for plugin, wi in zip(plugins, w):
            plugin.weight = wi
        static = port_runtime.sequential_solve_body(
            plugins, snap, sched.initial_state(snap))
        for plugin in plugins:
            plugin.weight = 1
        swept = port_runtime.sequential_solve_body(
            plugins, snap, sched.initial_state(snap),
            weights=torch.tensor(w, dtype=torch.int64))
        for field in ("assignment", "admitted", "wait", "failed_plugin"):
            assert torch.equal(getattr(static, field),
                               getattr(swept, field)), (w, field)
