"""The port's streamed chunk pipeline (`scheduler_plugins_tpu_torch.parallel
.pipeline`, with the batched PreFilter `Plugin.admit_rows`, the fast-path
head of `parallel/solver.py` and `Scheduler.attribution_codes`) against
the JAX package.

Per module, the same stamps, chunk inputs and clusters go through the JAX
function and its port; the streamed solve as a whole must equal JAX
`streamed_profile_solve` bit for bit. Every quantity is an exact integer
or the same float arithmetic: tolerance 0 throughout. The scripts of
`tests/test_torch_cycle.py` that `tests/test_torch_stream_cycle.py` does
not stream run streamed here (`test_streamed_cycle_matches_jax`)."""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
from scheduler_plugins_tpu_torch.framework import Plugin
from scheduler_plugins_tpu_torch.ops.assign import waterfill_assign_targeted
from scheduler_plugins_tpu_torch.parallel import pipeline as t_pipeline
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from test_torch_cycle import (
    PORT as CYCLE_PORT,
    SCRIPTS,
    attribution_builtin_fit,
    attribution_capacity,
    attribution_coscheduling,
    basic_binds_pending,
    gang_gated_blocks_quorum,
    gang_min_resources_check,
    quota_over_max_rejected,
)
from test_torch_stream_cycle import STREAMED_HERE, run_streamed
from torch_parity_cases import nominee_cluster

try:
    import jax
    import jax.numpy as jnp

    from scheduler_plugins_tpu.ops.assign import (
        waterfill_assign_targeted as j_waterfill,
    )
    from scheduler_plugins_tpu.parallel import pipeline as j_pipeline
    from scheduler_plugins_tpu.parallel import solver as j_solver
    from test_torch_cycle import JAX as CYCLE_JAX
    from test_torch_parity_solve import (
        cordon_nofit_cluster,
        gang_quota_cluster,
        lowered,
        same,
        schedulers,
    )
    from test_torch_snapshot import JAX, PORT, mixed_cluster
except ImportError:
    JAX = None

GIB = 1 << 30
CPU = "cpu"
FLAGSHIP = ("NodeResourcesAllocatable", "Coscheduling", "CapacityScheduling")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


# --- PipelineTimeline -------------------------------------------------------

def both_timelines(n_chunks, stamps, close):
    """The same stamps in the port's and JAX's PipelineTimeline."""
    out = []
    for cls in (t_pipeline.PipelineTimeline, j_pipeline.PipelineTimeline):
        tl = cls(n_chunks=n_chunks)
        tl.open(0.0)
        for stamp in stamps:
            tl.add(*stamp)
        tl.close(close)
        out.append(tl)
    return out


class TestPipelineTimeline:
    """JAX `tests/test_pipeline.py` TestPipelineTimeline's tracer-free
    cases, each summary also equal to JAX's."""

    def test_bubble_and_overlap_from_stamps(self):
        tl, jtl = both_timelines(2, [
            ("h2d", 0, 0.0, 0.010), ("dispatch", 0, 0.010, 0.011),
            ("h2d", 1, 0.011, 0.021), ("d2h", 0, 0.021, 0.050),
            ("dispatch", 1, 0.050, 0.051), ("d2h", 1, 0.051, 0.090),
        ], 0.090)
        s = tl.summary(solve_ms=60.0)
        assert s == jtl.summary(solve_ms=60.0)
        assert s["elapsed_ms"] == 90.0
        assert s["h2d_ms"] == 20.0 and s["dispatch_ms"] == 2.0
        assert s["d2h_ms"] == 68.0
        assert s["pipeline_bubble_ms"] == 30.0
        assert s["overlap_efficiency"] == round(60.0 / 90.0, 4)
        assert s["h2d_overlap_efficiency"] == round(1 - 30.0 / 90.0, 4)
        assert s["d2h_overlap_efficiency"] == round(1 - 30.0 / 90.0, 4)

    def test_fully_overlapped_run_reports_zero_bubble(self):
        tl, jtl = both_timelines(1, [
            ("dispatch", 0, 0.0, 0.001), ("d2h", 0, 0.001, 0.100),
        ], 0.100)
        s = tl.summary(solve_ms=100.0)
        assert s == jtl.summary(solve_ms=100.0)
        assert s["pipeline_bubble_ms"] == 0.0
        assert s["overlap_efficiency"] == 1.0
        assert s["h2d_overlap_efficiency"] == 1.0

    def test_without_solve_estimate_only_stage_totals(self):
        tl, jtl = both_timelines(1, [("d2h", 0, 0.0, 0.010)], 0.010)
        s = tl.summary()
        assert s == jtl.summary()
        assert s["d2h_ms"] == 10.0
        assert s["pipeline_bubble_ms"] is None
        assert s["overlap_efficiency"] is None


# --- run_chunk_pipeline -----------------------------------------------------

def chunk_problem(n_nodes=24, n_pods=128, chunk=32, seed=3):
    """JAX TestRunChunkPipeline's problem, in numpy, on the canonical
    (cpu, memory, ephemeral-storage, pods) axis."""
    rng = np.random.default_rng(seed)
    free0 = np.stack([
        rng.integers(4000, 32000, n_nodes),
        rng.integers(8, 64, n_nodes) * GIB,
        np.full(n_nodes, 100 * GIB),
        np.full(n_nodes, 110),
    ], axis=1).astype(np.int64)
    req = np.stack([
        rng.integers(100, 2500, n_pods),
        rng.integers(1, 4, n_pods) * GIB,
        np.zeros(n_pods),
        np.zeros(n_pods),
    ], axis=1).astype(np.int64)
    raw = rng.integers(0, 1000, n_nodes).astype(np.int64)
    mask = np.ones(n_pods, bool)
    chunks = [(req[lo:lo + chunk], mask[lo:lo + chunk])
              for lo in range(0, n_pods, chunk)]
    return raw, free0, chunks


def port_solve(raw, req, mask, free):
    a, free, _ = waterfill_assign_targeted(raw, req, mask, free, max_waves=8)
    return a, free


def jax_solver():
    def solve(raw, req, mask, free):
        return j_waterfill(raw, req, mask, free, max_waves=8)

    return j_pipeline.donated_chunk_solver(solve, carry_argnum=3)


def counter_clock():
    ticks = iter(range(10 ** 6))
    return lambda: float(next(ticks))


class TestRunChunkPipeline:
    def test_matches_synchronous_chunk_loop(self):
        raw, free0, chunks = chunk_problem()
        raw_t = torch.from_numpy(raw)
        free = torch.from_numpy(free0)
        sync_parts = []
        for req_c, mask_c in chunks:
            a, free = port_solve(raw_t, torch.from_numpy(req_c),
                                 torch.from_numpy(mask_c), free)
            sync_parts.append(a.numpy())
        parts, pipe_free, done_s, timeline = t_pipeline.run_chunk_pipeline(
            port_solve, (raw_t,), chunks, torch.from_numpy(free0),
            device=CPU,
        )
        assert timeline.n_chunks == len(parts) == len(done_s) == len(chunks)
        assert all(isinstance(p, np.ndarray) for p in parts)
        assert all(b >= a for a, b in zip(done_s, done_s[1:]))
        assert np.array_equal(np.concatenate(sync_parts),
                              np.concatenate(parts))
        assert torch.equal(free, pipe_free)
        assert torch.equal(torch.from_numpy(free0),
                           torch.from_numpy(chunk_problem()[1]))
        # and the same as the JAX pipeline over the JAX waterfill
        jparts, jfree, _, _ = j_pipeline.run_chunk_pipeline(
            jax_solver(), (jnp.asarray(raw),), chunks, jnp.asarray(free0)
        )
        assert np.array_equal(np.concatenate(parts).astype(np.int32),
                              np.concatenate(jparts))
        assert np.array_equal(pipe_free.numpy(), np.asarray(jfree))

    def test_numpy_and_tensor_inputs(self):
        raw, free0, chunks = chunk_problem(n_pods=96)
        tensors = [tuple(torch.from_numpy(x) for x in c) for c in chunks]
        runs = [t_pipeline.run_chunk_pipeline(
            port_solve, (torch.from_numpy(raw),), inputs,
            torch.from_numpy(free0), device=CPU,
        ) for inputs in (chunks, tensors)]
        (p1, f1, _, _), (p2, f2, _, _) = runs
        assert all(np.array_equal(a, b) for a, b in zip(p1, p2))
        assert torch.equal(f1, f2)

    def test_lag1_stamps_with_injected_clock(self):
        raw, free0, chunks = chunk_problem()
        _, _, done_s, tl = t_pipeline.run_chunk_pipeline(
            port_solve, (torch.from_numpy(raw),), chunks,
            torch.from_numpy(free0), clock=counter_clock(), device=CPU,
        )
        order = [(e["stage"], e["chunk"]) for e in tl.events]
        want = [("h2d", 0), ("dispatch", 0), ("h2d", 1)]
        for k in range(1, len(chunks)):
            want += [("dispatch", k)]
            if k + 1 < len(chunks):
                want += [("h2d", k + 1)]
            want += [("d2h", k - 1)]
        want += [("d2h", len(chunks) - 1)]
        assert order == want
        assert all(b > a for a, b in zip(done_s, done_s[1:]))
        # the JAX pipeline reads its clock at the same points
        _, _, j_done, jtl = j_pipeline.run_chunk_pipeline(
            jax_solver(), (jnp.asarray(raw),), chunks, jnp.asarray(free0),
            clock=counter_clock(),
        )
        assert tl.events == jtl.events
        assert done_s == j_done
        assert (tl.start_s, tl.end_s) == (jtl.start_s, jtl.end_s)
        assert tl.summary(solve_ms=5.0) == jtl.summary(solve_ms=5.0)

    def test_result_trees_come_back_as_numpy(self):
        raw, free0, chunks = chunk_problem(n_pods=64)

        def solve(raw, req, mask, free):
            a, free, stats = waterfill_assign_targeted(raw, req, mask, free)
            return (a, {"waves": stats["waves"], "mask": mask}), free

        results, _, _, _ = t_pipeline.run_chunk_pipeline(
            solve, (torch.from_numpy(raw),), chunks,
            torch.from_numpy(free0), device=CPU,
        )
        for (a, extra), (_, mask) in zip(results, chunks):
            assert isinstance(a, np.ndarray) and a.shape == mask.shape
            assert isinstance(extra["waves"], int)
            assert np.array_equal(extra["mask"], mask)

    def test_empty_input(self):
        free0 = torch.ones(3, 2, dtype=torch.int64)
        results, carry, done_s, tl = t_pipeline.run_chunk_pipeline(
            port_solve, (), [], free0, device=CPU
        )
        assert results == [] and done_s == [] and carry is free0
        assert tl.events == [] and tl.n_chunks == 0

    def test_fetch_deadline_raises(self):
        raw, free0, chunks = chunk_problem(n_pods=32)
        with pytest.raises(NotImplementedError, match="resilience"):
            t_pipeline.run_chunk_pipeline(
                port_solve, (torch.from_numpy(raw),), chunks,
                torch.from_numpy(free0), fetch_deadline_s=1.0, device=CPU,
            )

    def test_entry_points_default_to_the_card(self, monkeypatch):
        raw, free0, chunks = chunk_problem(n_pods=32)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            t_pipeline.run_chunk_pipeline(
                port_solve, (torch.from_numpy(raw),), chunks,
                torch.from_numpy(free0),
            )
        lo = lowered(lambda pkg: pkg.scenarios.allocatable_scenario(4, 8))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            t_pipeline.streamed_profile_solve(lo.ps, lo.snap_p, chunk=4)


# --- admit_rows --------------------------------------------------------------

def backed_off_cluster(pkg):
    """`mixed_cluster` with gangs, its admitted gang backed off."""
    cluster = mixed_cluster(pkg, 1, gangs=True)
    cluster.gang_backoff_until_ms["team-0/g-ok"] = 10 ** 12
    return cluster


def lowered_with_gated(build):
    """`lowered` (flagship profile), with the cluster's scheduling-gated
    pods put into the batch as gated rows (the queue leaves them out)."""
    out = SimpleNamespace()
    for pkg, sched, kw, tag in zip((JAX, PORT), schedulers(),
                                   ({}, {"device": CPU}), "jp"):
        cluster = build(pkg)
        pending = sched.sort_pending(
            cluster.pending_pods() + cluster.gated_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, **kw)
        sched.prepare(meta, cluster)
        setattr(out, f"{tag}s", sched)
        setattr(out, f"snap_{tag}", snap)
        setattr(out, f"{tag}pend", pending)
    return out


ADMIT_CLUSTERS = {
    "gang_quota": gang_quota_cluster,
    "nominees": lambda pkg: nominee_cluster(pkg.objects, pkg.Cluster),
    "mixed_gangs": lambda pkg: mixed_cluster(pkg, 1, gangs=True),
    "backed_off_gang": backed_off_cluster,
}


def bind_presolves(plugins, snap, j=False):
    for plugin in plugins:
        if j:
            plugin.bind_aux(plugin.aux())
        plugin.bind_presolve(plugin.prepare_solve(snap))


class TestAdmitRows:
    @pytest.mark.parametrize("case", sorted(ADMIT_CLUSTERS) + ["gated"])
    def test_equals_per_pod_admit_and_jax(self, case):
        if case == "gated":
            lo = lowered_with_gated(ADMIT_CLUSTERS["mixed_gangs"])
            assert lo.snap_p.pods.gated.any()
        else:
            lo = lowered(ADMIT_CLUSTERS[case])
        snap, jsnap = lo.snap_p, lo.snap_j
        P = snap.num_pods
        state, jstate = lo.ps.initial_state(snap), lo.js.initial_state(jsnap)
        pplugins, jplugins = lo.ps.profile.plugins, lo.js.profile.plugins
        bind_presolves(pplugins, snap)
        bind_presolves(jplugins, jsnap, j=True)
        rows = torch.arange(P)
        checked = 0
        for pp, jp in zip(pplugins, jplugins):
            got = pp.admit_rows(state, snap, rows)
            if got is None:
                assert pp.admit(state, snap, 0) is None
                assert jp.admit(jstate, jsnap, 0) is None
                continue
            per_pod = torch.cat([pp.admit(state, snap, p) for p in range(P)])
            want = jax.vmap(lambda p: jp.admit(jstate, jsnap, p))(
                jnp.arange(P))
            assert torch.equal(got, per_pod), pp.name
            assert same(got, want), pp.name
            checked += 1
            if case == "backed_off_gang" and pp.name == "Coscheduling":
                g = snap.pods.gang
                backed_off = (g >= 0) & snap.gangs.backed_off[g.clamp(min=0)]
                assert backed_off.any() and not got[backed_off].any()
        assert checked == (snap.gangs is not None) + (snap.quota is not None)

    def test_carried_state_equals_per_pod_admit(self):
        lo = lowered_with_gated(ADMIT_CLUSTERS["mixed_gangs"])
        snap = lo.snap_p
        rng = np.random.default_rng(5)
        state = lo.ps.initial_state(snap)
        state = state.replace(
            placed_mask=torch.from_numpy(rng.random(snap.num_pods) < 0.5),
            gang_inflight=torch.from_numpy(rng.integers(
                0, 4000, state.gang_inflight.shape)),
            eq_used=state.eq_used + torch.from_numpy(rng.integers(
                0, 3000, state.eq_used.shape)),
            free=state.free - torch.from_numpy(rng.integers(
                0, 2000, state.free.shape)),
        )
        bind_presolves(lo.ps.profile.plugins, snap)
        rows = torch.from_numpy(rng.permutation(snap.num_pods)[:40])
        for plugin in lo.ps.profile.plugins:
            got = plugin.admit_rows(state, snap, rows)
            if got is not None:
                want = torch.cat([plugin.admit(state, snap, int(p))
                                  for p in rows])
                assert torch.equal(got, want), plugin.name

    def test_base_class_requires_admit_rows(self):
        class PerPodOnly(Plugin):
            def admit(self, state, snap, p):
                return torch.ones(1, dtype=torch.bool)

        class NoPreFilter(Plugin):
            pass

        with pytest.raises(NotImplementedError, match="admit_rows"):
            PerPodOnly().admit_rows(None, None, torch.arange(3))
        assert NoPreFilter().admit_rows(None, None, torch.arange(3)) is None


# --- fast_path_scoring / fast_solve_head -----------------------------------

class TestFastPathHead:
    @pytest.mark.parametrize("names,zero_weight,want", [
        (FLAGSHIP, False, "NodeResourcesAllocatable"),
        (("NodeResourcesAllocatable",), False, "NodeResourcesAllocatable"),
        (("Coscheduling",), False, None),
        (FLAGSHIP, True, None),
    ])
    def test_gate_equals_jax(self, names, zero_weight, want):
        lo = lowered(lambda pkg: pkg.scenarios.allocatable_scenario(4, 8),
                     names)
        if zero_weight:
            lo.ps.profile.plugins[0].weight = 0
            lo.js.profile.plugins[0].weight = 0
        got = t_solver.fast_path_scoring(lo.ps.profile.plugins)
        jgot = j_solver.fast_path_scoring(lo.js.profile.plugins)
        assert (None if got is None else got.name) == want
        assert (None if jgot is None else jgot.name) == want
        served = t_pipeline.streamed_profile_solve(lo.ps, lo.snap_p, chunk=4,
                                                   device=CPU)
        assert (served is None) == (want is None)

    @pytest.mark.parametrize("case", ["gang_quota", "nominees",
                                      "mixed_gangs", "cordon_nofit"])
    def test_head_equals_jax(self, case):
        build = {**ADMIT_CLUSTERS, "cordon_nofit": cordon_nofit_cluster}
        lo = lowered(build[case])
        pplugins = tuple(lo.ps.profile.plugins)
        jplugins = tuple(lo.js.profile.plugins)
        got = t_solver.fast_solve_head(
            pplugins, t_solver.fast_path_scoring(pplugins), lo.snap_p,
            lo.ps.initial_state(lo.snap_p),
        )
        want = j_solver.fast_solve_head(
            jplugins, j_solver.fast_path_scoring(jplugins), lo.snap_j,
            lo.js.initial_state(lo.snap_j),
            tuple(p.aux() for p in jplugins),
        )
        for name, g, w in zip(("admitted", "raw", "free0"), got, want):
            assert same(g, w), name
        assert got[1].dtype == torch.int64


# --- streamed_profile_solve --------------------------------------------------

STREAM_PROBLEMS = {
    # 8 chunks, lite and rescue waves
    "alloc_256x4096": (
        lambda pkg: pkg.scenarios.allocatable_scenario(256, 4096), 512),
    # quota prefix and quorum tail
    "gang_quota_8x16x64": (
        lambda pkg: pkg.scenarios.gang_quota_scenario(8, 16, 64), 32),
    # hopeless pods
    "tight_40x3000": (
        lambda pkg: pkg.scenarios.allocatable_scenario(40, 3000), 1024),
    # cordoned nodes and a pod that fits nowhere
    "cordon_nofit": (cordon_nofit_cluster, 64),
}


@pytest.fixture(scope="module")
def streamed():
    cache = {}

    def get(case):
        if case not in cache:
            build, chunk = STREAM_PROBLEMS[case]
            lo = lowered(build)
            got = t_pipeline.streamed_profile_solve(lo.ps, lo.snap_p,
                                                    chunk=chunk, device=CPU)
            want = j_pipeline.streamed_profile_solve(lo.js, lo.snap_j,
                                                     chunk=chunk)
            cache[case] = (lo, chunk, got, want)
        return cache[case]

    return get


class TestStreamedProfileSolve:
    @pytest.mark.parametrize("case", sorted(STREAM_PROBLEMS))
    def test_equals_jax(self, streamed, case):
        lo, chunk, got, want = streamed(case)
        assert got is not None and want is not None
        for name, g, w in zip(("assignment", "admitted", "wait"), got, want):
            assert same(g, w), name
        assert lo.snap_p.num_pods // chunk >= 3

    def test_problems_reach_their_outcomes(self, streamed):
        _, _, (a, _, _), _ = streamed("tight_40x3000")
        assert (a[:3000] < 0).any() and (a >= 0).sum() > 0
        _, _, (a, adm, wait), _ = streamed("gang_quota_8x16x64")
        assert (adm & (a >= 0)).sum() > 0
        lo, _, (a, adm, _), _ = streamed("cordon_nofit")
        cordoned = torch.nonzero(~lo.snap_p.nodes.mask[:19]).flatten()
        assert len(cordoned) == 2 and not torch.isin(a, cordoned).any()
        assert ((a < 0) & adm).any()

    def test_returns_none_like_jax(self):
        lo = lowered(lambda pkg: pkg.scenarios.allocatable_scenario(8, 32))
        assert lo.snap_p.num_pods == 32
        # 32 pod rows are not a multiple of 12
        assert t_pipeline.streamed_profile_solve(
            lo.ps, lo.snap_p, chunk=12, device=CPU) is None
        assert j_pipeline.streamed_profile_solve(lo.js, lo.snap_j,
                                                 chunk=12) is None
        # a chunk above the rows is one chunk
        got = t_pipeline.streamed_profile_solve(lo.ps, lo.snap_p, chunk=64,
                                                device=CPU)
        want = j_pipeline.streamed_profile_solve(lo.js, lo.snap_j, chunk=64)
        assert all(same(g, w) for g, w in zip(got, want))
        lo = lowered(lambda pkg: pkg.scenarios.gang_quota_scenario(2, 4, 4),
                     ("Coscheduling", "CapacityScheduling"))
        assert t_pipeline.streamed_profile_solve(
            lo.ps, lo.snap_p, chunk=4, device=CPU) is None
        assert j_pipeline.streamed_profile_solve(lo.js, lo.snap_j,
                                                 chunk=4) is None

    def test_wave_settings_are_jax_defaults(self):
        params = inspect.signature(j_pipeline.streamed_profile_solve).parameters
        assert params["max_waves"].default == t_pipeline.STREAM_MAX_WAVES
        assert (params["rescue_window"].default
                == t_pipeline.STREAM_RESCUE_WINDOW)


# --- attribution_codes -------------------------------------------------------

ATTRIBUTION_CASES = {
    # (script, pod uid, plugin name its code decodes to)
    "fit_nowhere": (attribution_builtin_fit, "default/huge",
                    "NodeResourcesFit"),
    "gang_min_resources": (gang_min_resources_check, "default/m0",
                           "Coscheduling"),
    "gang_below_min_member": (attribution_coscheduling, "default/p",
                              "Coscheduling"),
    "quota_over_max": (quota_over_max_rejected, "a/a1",
                       "CapacityScheduling"),
    "quota_over_max_flagship": (attribution_capacity, "a/a1",
                                "CapacityScheduling"),
    "gated_sibling": (gang_gated_blocks_quorum, "default/m0",
                      "Coscheduling"),
}


class TestAttributionCodes:
    @pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
    def test_equals_jax(self, case):
        script, uid, name = ATTRIBUTION_CASES[case]
        codes = []
        for pkg, kw in ((CYCLE_JAX, {}), (CYCLE_PORT, {"device": CPU})):
            cluster, sched, _ = script(pkg)
            pending = sched.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = cluster.snapshot(pending, now_ms=1000, **kw)
            sched.prepare(meta, cluster)
            codes.append(sched.attribution_codes(snap, range(len(pending))))
        got, want = codes
        assert got.dtype == np.int32 and np.array_equal(got, want)
        row = meta.pod_names.index(uid)
        names = sched.fail_plugin_names()
        assert names[max(int(got[row]), 0)] == name

    def test_gated_pod_and_flagship_rows(self):
        lo = lowered_with_gated(ADMIT_CLUSTERS["mixed_gangs"])
        rows = list(range(len(lo.ppend)))[::-1]
        got = lo.ps.attribution_codes(lo.snap_p, rows)
        want = lo.js.attribution_codes(lo.snap_j, rows)
        assert np.array_equal(got, want)
        gated = lo.snap_p.pods.gated.numpy()[rows]
        assert gated.any() and (got[gated] == 0).all()
        # g-short, g-gated and g-minres fail Coscheduling cycle-initially
        assert (got == 2).sum() >= 13
        assert lo.ps.attribution_codes(lo.snap_p, []).shape == (0,)


# --- run_cycle(stream_chunk=) ------------------------------------------------

class TestCycleSignature:
    def test_positional_stream_chunk_streams(self, monkeypatch):
        chunks = []
        real = port_cycle.streamed_profile_solve

        def spy(scheduler, snap, chunk, **kw):
            chunks.append(chunk)
            return real(scheduler, snap, chunk=chunk, **kw)

        monkeypatch.setattr(port_cycle, "streamed_profile_solve", spy)
        c, s, _ = basic_binds_pending(CYCLE_PORT)
        report = port_cycle.run_cycle(s, c, 0, 4, device=CPU)
        assert chunks == [4] and len(report.bound) == 3

    def test_device_is_keyword_only(self):
        c, s, _ = basic_binds_pending(CYCLE_PORT)
        with pytest.raises(TypeError):
            port_cycle.run_cycle(s, c, 0, None, None, None, None, None, CPU)
        pending = s.sort_pending(c.pending_pods(), c)
        snap, meta = c.snapshot(pending, now_ms=0, device=CPU)
        s.prepare(meta, c)
        with pytest.raises(TypeError):
            s.solve(snap, None, CPU)
        assert all(p.node_name is None for p in c.pods.values())


@pytest.mark.parametrize(
    "script", [s for s in SCRIPTS if s.__name__ not in STREAMED_HERE],
    ids=lambda s: s.__name__,
)
def test_streamed_cycle_matches_jax(script, monkeypatch):
    run_streamed(script, monkeypatch)
