"""The port's rank-aware gang engine (`scheduler_plugins_tpu_torch.gangs`:
the topology-block waterfill on tensors and its numpy twin, the wave
solve, the elastic shrink selection, `GangPhase` through
`run_cycle(gangs=)`) against the JAX package, on the same numpy-made
inputs. Integer outputs with tolerance 0.

- The JAX decision tables of `tests/test_gangs.py` (TestTopologyDecision
  Tables, TestGangPhaseCycle, TestServingSeam, TestReviewRegressions) run
  again on the port, every JAX name they call swapped for the port's;
  their numpy twin calls run the port's device solve on the CPU beside
  the port's twin and require the two equal. TestFlightRecorderSeam runs
  the same way in `tests/test_torch_flightrec.py`.
- The seeds of `tests/test_differential.py` TestRankGangDifferential and
  TestWaveGangDifferential: `gang_solve` equal to JAX's jitted
  `gang_solve_body` and to both twins on every output and final carry,
  `wave_gang_solve` at W in {1, 2, 4, 64} equal to the twin with the JAX
  wave solve's statistics, and `shrink_select` equal to JAX's.
- `rank_gang_scenario` builds JAX's store; bench config 10 at the bench's
  reduced shape cycle by cycle (both arms, the elastic transitions, the
  bench line); config 12 cut to 512 nodes x 64 gangs through every
  solver; the gang step reads nothing on the host."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.gangs as port_gangs
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.tuning.quality as port_quality
from scheduler_plugins_tpu_torch.convert import rank_gang_state_from_numpy
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.gangs import elastic as p_elastic
from scheduler_plugins_tpu_torch.gangs import phase as p_phase
from scheduler_plugins_tpu_torch.gangs import topology as p_topology
from scheduler_plugins_tpu_torch.gangs import waves as p_waves
from scheduler_plugins_tpu_torch.models import (
    rank_gang_scenario as p_rank_gang_scenario,
)
from scheduler_plugins_tpu_torch.serving import ServeEngine as PServeEngine
from torch_gang_cases import (
    GANG_SMOKE_SHAPE,
    cut_mega_shape,
    mega_gang_problem,
    mega_gang_violations,
    rank_gangs,
    store_state,
)

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.gangs as jax_gangs
    import scheduler_plugins_tpu.gangs.phase as j_phase
    import scheduler_plugins_tpu.gangs.topology as j_topology
    import scheduler_plugins_tpu.gangs.waves as j_waves
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.serving as jax_serving
    import scheduler_plugins_tpu.tuning.quality as jax_quality
    import tests.test_differential as jax_differential
    import tests.test_gangs as jax_tables
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
        run_cycle as j_run_cycle,
    )
    from scheduler_plugins_tpu.framework.plugin import (
        SolverState as JSolverState,
    )
    from scheduler_plugins_tpu.models import (
        rank_gang_scenario as j_rank_gang_scenario,
    )
except ImportError:
    jax_objects = None

CPU = "cpu"
NAMES = ("rank_nodes", "admitted", "placed_new", "free", "eq_used")

PORT = SimpleNamespace(
    name="port", rank_gang_scenario=p_rank_gang_scenario,
    Scheduler=PScheduler, Profile=PProfile, plugins=port_plugins,
    run=lambda s, c, now, phase: port_cycle.run_cycle(
        s, c, now=now, gangs=phase, device=CPU),
    GangPhase=port_gangs.GangPhase,
    elastic_bounds=p_elastic.elastic_bounds,
    block_cost_view=p_phase.block_cost_view,
    gang_cost_stats=p_topology.gang_cost_stats,
    rank_gang_quality=port_quality.rank_gang_quality,
    elastic_satisfaction_quality=port_quality.elastic_satisfaction_quality,
    RankGangState=p_topology.RankGangState,
)
JAX = None if jax_objects is None else SimpleNamespace(
    name="jax", rank_gang_scenario=j_rank_gang_scenario,
    Scheduler=JScheduler, Profile=JProfile, plugins=jax_plugins,
    run=lambda s, c, now, phase: j_run_cycle(s, c, now=now, gangs=phase),
    GangPhase=jax_gangs.GangPhase,
    elastic_bounds=jax_gangs.elastic_bounds,
    block_cost_view=j_phase.block_cost_view,
    gang_cost_stats=j_topology.gang_cost_stats,
    rank_gang_quality=jax_quality.rank_gang_quality,
    elastic_satisfaction_quality=jax_quality.elastic_satisfaction_quality,
    RankGangState=j_topology.RankGangState,
)


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def _fields(gangs) -> dict:
    return {f.name: np.asarray(getattr(gangs, f.name))
            for f in dataclasses.fields(gangs)}


def port_device_solve(gangs_np, free0, eq_used0, node_mask):
    """The port's `gang_solve` on the CPU, outputs as numpy in the twin's
    contract."""
    gangs = rank_gang_state_from_numpy(_fields(gangs_np), device=CPU)
    state0 = p_topology.initial_state(gangs, free0, eq_used0, device=CPU)
    rank_nodes, admitted, placed_new, state = p_topology.gang_solve(
        gangs, state0, torch.from_numpy(np.asarray(node_mask)), device=CPU)
    return tuple(x.numpy() for x in (rank_nodes, admitted, placed_new,
                                     state.free, state.eq_used))


def jax_device_solve(gangs_np, free0, eq_used0, node_mask):
    """JAX's jitted `gang_solve_body`, outputs as numpy."""
    state0 = JSolverState(
        free=jnp.asarray(free0), eq_used=jnp.asarray(eq_used0),
        rank_nodes=jnp.asarray(gangs_np.prev_assigned),
    )
    rn, adm, new, state = j_topology.gang_solve_fn()(
        jax.tree.map(jnp.asarray, gangs_np), state0, jnp.asarray(node_mask))
    return tuple(np.asarray(x) for x in (rn, adm, new, state.free,
                                         state.eq_used))


def assert_outputs_equal(got, want, label):
    for g, w, name in zip(got, want, NAMES):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and (g == w).all(), f"{label}: {name}"


# --- the JAX decision tables on the port -----------------------------------

def _port_gang_solve_np(gangs, free0, eq_used0, node_mask):
    """The tables' twin call: the port's twin, held equal to the port's
    device solve on the CPU."""
    port_gangs_np = p_topology.RankGangState(**_fields(gangs))
    twin = p_topology.gang_solve_np(port_gangs_np, free0, eq_used0,
                                    node_mask)
    assert_outputs_equal(port_device_solve(port_gangs_np, free0, eq_used0,
                                           node_mask), twin, "device")
    return twin


def _port_shrink_select_np(rank_nodes, live, node_block, block_cost,
                           n_release):
    twin = p_elastic.shrink_select_np(rank_nodes, live, node_block,
                                      block_cost, n_release)
    dev = p_elastic.shrink_select(*(torch.from_numpy(np.asarray(x)) for x in (
        rank_nodes, live, node_block, block_cost, n_release)))
    assert (dev.numpy() == twin).all()
    return twin


class _CPUEngine(PServeEngine):
    def refresh(self, cluster, pending, now_ms=0, *, device=CPU):
        return super().refresh(cluster, pending, now_ms, device=device)


def _tables():
    if JAX is None:
        return []
    classes = [jax_tables.TestTopologyDecisionTables,
               jax_tables.TestGangPhaseCycle, jax_tables.TestServingSeam,
               jax_tables.TestReviewRegressions]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_")]


@pytest.mark.parametrize("cls,method", _tables())
def test_decision_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_gangs.py`'s tables (but the flight
    recorder's), with every JAX name it calls, at module level and in its
    body's imports, swapped for the port's."""
    swaps = {
        "RankGangState": p_topology.RankGangState,
        "gang_solve_np": _port_gang_solve_np,
        "gang_cost_stats": p_topology.gang_cost_stats,
        "shrink_select_np": _port_shrink_select_np,
        "GangPhase": port_gangs.GangPhase,
        "rank_gang_scenario": p_rank_gang_scenario,
        "Scheduler": PScheduler,
        "Profile": PProfile,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "run_cycle": lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now=now, device=CPU, **kw),
    }
    for name, value in swaps.items():
        monkeypatch.setattr(jax_tables, name, value)
    for name in ("Node", "NodeResourceTopology", "Container", "Pod",
                 "PodGroup", "POD_GROUP_LABEL", "NetworkTopology"):
        monkeypatch.setattr(jax_objects, name, getattr(port_objects, name))
    monkeypatch.setattr(jax_serving, "ServeEngine", _CPUEngine)
    monkeypatch.setattr(jax_gangs, "elastic_bounds", p_elastic.elastic_bounds)
    getattr(cls(), method)()


# --- the differential seeds -------------------------------------------------

def _random_problem(seed):
    return jax_differential.TestRankGangDifferential()._random_problem(seed)


class TestRankGangDifferential:
    @pytest.mark.parametrize("seed", [1000, 1001, 1002])
    def test_device_equals_jax_and_twins(self, jax_package, seed):
        gangs, free0, eq_used0, node_mask = _random_problem(seed)
        port_np = p_topology.RankGangState(**_fields(gangs))
        want = jax_device_solve(gangs, free0, eq_used0, node_mask)
        assert_outputs_equal(
            port_device_solve(port_np, free0, eq_used0, node_mask), want,
            f"seed {seed} port device")
        assert_outputs_equal(
            p_topology.gang_solve_np(port_np, free0, eq_used0, node_mask),
            want, f"seed {seed} port twin")
        assert_outputs_equal(
            j_topology.gang_solve_np(gangs, free0, eq_used0, node_mask),
            want, f"seed {seed} jax twin")
        jax_differential.TestRankGangDifferential()._replay_oracle(
            gangs, free0, eq_used0, node_mask, *want[:3])

    @pytest.mark.parametrize("seed", [2000, 2001, 2002])
    def test_shrink_select_equals_jax(self, jax_package, seed):
        gangs, free0, _, _ = _random_problem(seed)
        rng = np.random.default_rng(seed - 2000)
        G, M = gangs.rank_mask.shape
        N = free0.shape[0]
        rank_nodes = np.where(
            gangs.rank_mask, rng.integers(0, N, size=(G, M)), -1
        ).astype(np.int32)
        live = rank_nodes >= 0
        n_release = rng.integers(0, 3, size=G).astype(np.int32)
        args = (rank_nodes, live, gangs.node_block, gangs.block_cost,
                n_release)
        want = np.asarray(jax.jit(jax_gangs.shrink_select)(*args))
        got = p_elastic.shrink_select(
            *(torch.from_numpy(np.asarray(a)) for a in args)).numpy()
        assert (got == want).all()
        assert (p_elastic.shrink_select_np(*args) == want).all()
        assert (
            got.sum(axis=1) == np.minimum(n_release, live.sum(axis=1))
        ).all()

    def test_pair_costs_and_quality_equal_jax(self, jax_package):
        gangs, free0, eq_used0, node_mask = _random_problem(1001)
        rn = j_topology.gang_solve_np(gangs, free0, eq_used0, node_mask)[0]
        args = (rn, gangs.rank_mask, gangs.node_block, gangs.block_cost)
        assert (p_topology.pair_costs(*args)
                == j_topology.pair_costs(*args)).all()
        for a, b in zip(p_topology.gang_cost_stats(*args),
                        j_topology.gang_cost_stats(*args)):
            assert (a == b).all()
        assert (port_quality.rank_gang_quality(*args)
                == jax_quality.rank_gang_quality(*args))
        counts = ([3, 1, 4], [4, 2, 0])
        assert (port_quality.elastic_satisfaction_quality(counts)
                == jax_quality.elastic_satisfaction_quality(counts))


class TestWaveGangDifferential:
    @pytest.mark.parametrize("seed", [1000, 1001, 1002])
    @pytest.mark.parametrize("wave", [1, 2, 4, 64])
    def test_wave_equals_twin_and_jax_stats(self, jax_package, seed, wave):
        gangs, free0, eq_used0, node_mask = _random_problem(seed)
        port_np = p_topology.RankGangState(**_fields(gangs))
        ref = p_topology.gang_solve_np(port_np, free0, eq_used0, node_mask)
        stats, jstats = {}, {}
        out = p_waves.wave_gang_solve(port_np, free0, eq_used0, node_mask,
                                      wave=wave, stats=stats, device=CPU)
        assert_outputs_equal(out, ref, f"seed {seed} wave {wave}")
        j_waves.wave_gang_solve(gangs, free0, eq_used0, node_mask,
                                wave=wave, stats=jstats)
        assert stats == jstats

    def test_mesh_names_the_multi_gpu_slice(self):
        """`mesh=` takes a ("gangs",) rank mesh; a single process is its
        one rank and solves every lane (the ranks' own cases are
        `tests/test_torch_ranks.py`)."""
        from scheduler_plugins_tpu_torch.parallel.mesh import (
            GANGS_AXIS,
            make_axis_mesh,
        )

        gangs, free0, eq_used0, node_mask = mega_problem_small(8, 4)
        mesh = make_axis_mesh(GANGS_AXIS)
        assert mesh.shape == {GANGS_AXIS: 1}
        stats, ref_stats = {}, {}
        got = p_waves.wave_gang_solve(gangs, free0, eq_used0, node_mask,
                                      wave=2, mesh=mesh, stats=stats,
                                      device=CPU)
        ref = p_waves.wave_gang_solve(gangs, free0, eq_used0, node_mask,
                                      wave=2, stats=ref_stats, device=CPU)
        assert_outputs_equal(got, ref, "one-rank mesh")
        assert stats == ref_stats and stats["waves"] == 2


def mega_problem_small(n_nodes, n_gangs):
    problem = mega_gang_problem(cut_mega_shape(n_nodes, n_gangs),
                                p_topology.RankGangState)
    return (problem["gangs"], problem["free0"], problem["eq_used0"],
            problem["node_mask"])


# --- the scenario and bench configs 10 and 12 -------------------------------

def scenario_store(pkg, seed):
    c = pkg.rank_gang_scenario(seed=seed, **GANG_SMOKE_SHAPE)
    return {
        "nodes": [(n.name, dict(n.labels), dict(n.allocatable))
                  for n in c.nodes.values()],
        "pods": [(p.uid, dict(p.labels), p.effective_request(),
                  p.creation_ms) for p in c.pods.values()],
        "groups": [(pg.full_name, pg.min_member, pg.creation_ms,
                    pg.rank_aware, pg.desired_replicas, pg.max_replicas)
                   for pg in c.pod_groups.values()],
        "quotas": [(q.namespace, dict(q.min), dict(q.max))
                   for q in c.quotas.values()],
        "topology": [(nt.name, {w: {k: dict(v) for k, v in t.items()}
                                for w, t in nt.weights.items()})
                     for nt in c.network_topologies.values()],
        "events": dict(c.event_last),
    }


def config10_record(pkg, wave):
    phase = pkg.GangPhase(check_twin=True, wave=wave,
                          wave_width=4 if wave else None)
    out = rank_gangs(pkg, GANG_SMOKE_SHAPE, phase)
    line = dict(out["line"])
    return {
        "line": line,
        "rank_reports": out["rank"]["reports"],
        "transitions": out["transitions"],
        "base_reports": out["base"]["reports"],
        "rank_store": store_state(out["rank"]["cluster"]),
        "base_store": store_state(out["base"]["cluster"]),
        "latencies": out["rank"]["latencies"],
        "resident": {k: dict(v) for k, v in phase.resident.items()},
    }


class TestBenchConfigs:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_rank_gang_scenario_store_equals_jax(self, jax_package, seed):
        assert scenario_store(PORT, seed) == scenario_store(JAX, seed)

    def test_config10_smoke_shape_equals_jax(self, jax_package):
        port = config10_record(PORT, wave=False)
        assert port == config10_record(JAX, wave=False)
        line = port["line"]
        assert line["twin_drift"] == 0.0
        assert line["violations"] == {"capacity": 0, "quota": 0,
                                      "quorum": 0}
        assert line["gangs_admitted"] == line["gangs"]
        assert line["elastic_grow_convergence_cycles"] <= 2
        assert line["elastic_shrink_convergence_cycles"] <= 2
        assert (line["max_inter_rank_cost"]
                <= line["baseline_max_inter_rank_cost"])
        # the wave solve places identically
        wave = config10_record(PORT, wave=True)
        assert wave["rank_store"] == port["rank_store"]
        assert wave["line"]["twin_drift"] == 0.0

    def test_config12_cut_through_every_solver(self, jax_package):
        problem = mega_gang_problem(cut_mega_shape(512, 64),
                                    j_topology.RankGangState)
        gangs = problem["gangs"]
        args = (gangs, problem["free0"], problem["eq_used0"],
                problem["node_mask"])
        want = jax_device_solve(*args)
        port_np = p_topology.RankGangState(**_fields(gangs))
        port_args = (port_np,) + args[1:]
        assert_outputs_equal(port_device_solve(*port_args), want, "device")
        assert_outputs_equal(p_topology.gang_solve_np(*port_args), want,
                             "twin")
        stats, jstats = {}, {}
        assert_outputs_equal(
            p_waves.wave_gang_solve(*port_args, wave=64, stats=stats,
                                    device=CPU), want, "wave")
        j_waves.wave_gang_solve(*args, wave=64, stats=jstats)
        assert stats == jstats and stats["waves"] == 1
        viol = mega_gang_violations(problem, *want[:3])
        assert viol == {"fit": 0, "quota": 0, "quorum": 0}
        assert want[2].sum() > 0 and want[1].any()


# --- the gang step reads nothing on the host ---------------------------------

HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
              "masked_select", "equal", "lift_fresh")


class TestStepIssuesNoHostRead:
    @pytest.mark.parametrize("kind", ["sequential", "wave"])
    def test_no_host_reads(self, kind):
        """The sequential gang solve and the wave body read nothing on the
        host (on the card neither waits inside a step)."""
        gangs_np, free0, eq_used0, node_mask = mega_problem_small(64, 8)
        gangs = gangs_np.to(CPU)
        mask = torch.from_numpy(node_mask)
        state0 = p_topology.initial_state(gangs, free0, eq_used0,
                                          device=CPU)
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        ids = torch.arange(8)
        with Log():
            if kind == "sequential":
                p_topology.gang_solve(gangs, state0, mask, device=CPU)
            else:
                p_waves.wave_solve_body(gangs, state0.free, state0.eq_used,
                                        mask, ids)
        assert ops
        assert not [op for op in ops if op.split(".")[0] in HOST_READS]

    def test_solve_writes_no_input(self):
        gangs_np, free0, eq_used0, node_mask = mega_problem_small(64, 8)
        gangs = gangs_np.to(CPU)
        state0 = p_topology.initial_state(gangs, free0, eq_used0,
                                          device=CPU)
        before = [t.clone() for t in (state0.free, state0.eq_used,
                                      state0.rank_nodes, gangs.prev_assigned)]
        p_topology.gang_solve(gangs, state0, torch.from_numpy(node_mask),
                              device=CPU)
        after = (state0.free, state0.eq_used, state0.rank_nodes,
                 gangs.prev_assigned)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
