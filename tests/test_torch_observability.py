"""The port's observability core (`scheduler_plugins_tpu_torch.utils
.observability`) and the cycle's instrumentation, against the JAX
package's.

- `Metrics`: the cases of `tests/test_observability.py` and
  `tests/test_prometheus.py` whose subject the port has (counters,
  labelled histograms, gauges, the legacy summary keys, the strict 0.0.4
  exposition parse, label and HELP escaping, the JSON / text parity), and
  the same script of calls giving byte-identical `prometheus_text()` and
  equal `snapshot()` / `histograms()` in both packages.
- `Tracer`, `extension_span` and `flow`: span pairing, thread-name rows,
  Perfetto-valid export (`tools/trace_smoke.validate_trace`), FlowBegin /
  FlowEnd lines.
- The cycle: a traced `run_cycle` emits the JAX package's span names
  (QueueSort, Prepare, Solve, Snapshot, Bind, Permit, PostFilter,
  Attribution, ...) and the port's own (`PORT_ONLY_SPANS`: the stages,
  the snapshot's and the parity solve's parts), a traced serve cycle the
  engine's `ServeRefresh/*` rows, a traced chunk pipeline its replayed
  rows; after
  `tests/torch_cycle_scripts.py`'s script (plain and served) the cycle
  counters and gauges equal JAX's. Counters compare with tolerance 0;
  left out are the JAX-only compile-watch families (`scheduler_jit_*`,
  which the port's registry does not declare) and the wall-time sums and
  maxima of the duration histograms.
"""

import json
import logging
import math
import re
from types import SimpleNamespace

import numpy as np
import pytest

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.utils.observability as obs
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.serving import ServeEngine as PServeEngine
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.utils.observability import (
    HIST_BUCKETS_MS,
    Metrics,
)
from tools.trace_smoke import validate_trace
from torch_cycle_scripts import SCRIPT_COSCHED, cycle_script

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.utils.observability as jax_obs
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.serving import ServeEngine as JServeEngine
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
except ImportError:
    jax_objects = None

GIB = 1 << 30

PORT = SimpleNamespace(
    o=port_objects, Cluster=PCluster, Profile=PProfile, Scheduler=PScheduler,
    plugins=port_plugins, Engine=PServeEngine, obs=obs,
    run=lambda s, c, now, e=None: port_cycle.run_cycle(
        s, c, now=now, serve=e, device="cpu"),
)
JAX = None if jax_objects is None else SimpleNamespace(
    o=jax_objects, Cluster=JCluster, Profile=JProfile, Scheduler=JScheduler,
    plugins=jax_plugins, Engine=JServeEngine, obs=jax_obs,
    run=lambda s, c, now, e=None: jax_cycle.run_cycle(s, c, now=now,
                                                      serve=e),
)


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    obs.tracer.stop()
    if JAX is not None:
        jax_obs.tracer.stop()


def small_cluster(pkg):
    c = pkg.Cluster()
    c.add_node(pkg.o.Node(name="n0", allocatable={
        "cpu": 8000, "memory": 32 * GIB, "pods": 110}))
    c.add_pod(pkg.o.Pod(name="ok", creation_ms=1, containers=[
        pkg.o.Container(requests={"cpu": 100})]))
    c.add_pod(pkg.o.Pod(name="huge", creation_ms=2, containers=[
        pkg.o.Container(requests={"cpu": 99_000})]))
    return c


def alloc_scheduler(pkg):
    return pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourcesAllocatable()]))


# --- Metrics ---------------------------------------------------------------

class TestMetrics:
    def test_cycle_counters(self):
        scope = obs.metrics.scoped()
        PORT.run(alloc_scheduler(PORT), small_cluster(PORT), 1000)
        assert scope.get(obs.SCHEDULING_CYCLES) == 1
        assert scope.get(obs.PODS_BOUND) == 1
        assert scope.get(obs.PODS_FAILED) == 1
        assert scope.get(obs.UNSCHEDULABLE_BY_PLUGIN,
                         plugin="NodeResourcesFit") == 1

    def test_flow_markers_emitted(self, caplog):
        with caplog.at_level(logging.DEBUG,
                             logger="scheduler_plugins_tpu_torch"):
            with obs.flow("cycle", generation=7, pending=3):
                pass
        text = caplog.text
        assert "FlowBegin" in text and "FlowEnd" in text
        assert "generation=7" in text and "durationMs" in text
        assert "status=ok" in text

    def test_flow_failure_marked_on_flow_end(self, caplog):
        with caplog.at_level(logging.DEBUG,
                             logger="scheduler_plugins_tpu_torch"):
            with pytest.raises(ValueError):
                with obs.flow("resync", generation=3):
                    raise ValueError("boom")
        end_line = next(r.getMessage() for r in caplog.records
                        if obs.FLOW_END in r.getMessage())
        assert "status=error" in end_line
        assert "error=ValueError" in end_line


class TestHistograms:
    def test_observe_keeps_legacy_summary_keys(self):
        m = Metrics()
        m.observe_ms("scheduler_cycle", 12.4)
        m.observe_ms("scheduler_cycle", 3.2)
        snap = m.snapshot()
        assert snap["scheduler_cycle_ms_total"] == 15
        assert snap["scheduler_cycle_count"] == 2
        assert snap["scheduler_cycle_ms_max"] == 12

    def test_bucket_counts_cumulative_in_text(self):
        m = Metrics()
        for ms in (0.5, 3.0, 30.0, 20_000.0):
            m.observe_ms("lat", ms)
        samples = dict(line.rsplit(" ", 1)
                       for line in m.prometheus_text().splitlines()
                       if line and not line.startswith("#"))
        assert samples['lat_bucket{le="1"}'] == "1"
        assert samples['lat_bucket{le="5"}'] == "2"
        assert samples['lat_bucket{le="50"}'] == "3"
        assert samples['lat_bucket{le="10000"}'] == "3"
        assert samples['lat_bucket{le="+Inf"}'] == "4"
        assert samples["lat_count"] == "4"
        assert float(samples["lat_sum"]) == pytest.approx(20_033.5)

    def test_labeled_histograms_and_counters(self):
        m = Metrics()
        m.observe_ms(obs.PLUGIN_EXECUTION, 7.0, plugin="Coscheduling",
                     extension_point="QueueSort")
        m.inc(obs.UNSCHEDULABLE_BY_PLUGIN, plugin="NodeAffinity")
        m.inc(obs.UNSCHEDULABLE_BY_PLUGIN, plugin="NodeAffinity")
        assert m.get(obs.UNSCHEDULABLE_BY_PLUGIN, plugin="NodeAffinity") == 2
        text = m.prometheus_text()
        assert ('scheduler_unschedulable_by_plugin_total'
                '{plugin="NodeAffinity"} 2') in text
        assert ('scheduler_plugin_execution_ms_bucket{extension_point='
                '"QueueSort",plugin="Coscheduling",le="10"} 1') in text

    def test_label_values_escaped(self):
        m = Metrics()
        m.inc("weird_total", plugin='a"b\\c')
        assert '{plugin="a\\"b\\\\c"}' in m.prometheus_text()

    def test_counter_type_lines(self):
        m = Metrics()
        m.inc("x_total", 3)
        text = m.prometheus_text()
        assert "# TYPE x_total counter" in text and "x_total 3" in text

    def test_no_duplicate_samples_for_observed_names(self):
        m = Metrics()
        m.observe_ms("scheduler_cycle", 4.2)
        m.inc("scheduler_pods_bound_total", 2)
        keys = [line.rsplit(" ", 1)[0]
                for line in m.prometheus_text().splitlines()
                if line and not line.startswith("#")]
        assert len(keys) == len(set(keys)), keys
        assert keys.count("scheduler_cycle_count") == 1
        assert m.snapshot()["scheduler_cycle_count"] == 1

    def test_scoped_delta_and_reset(self):
        m = Metrics()
        m.inc("a_total", 2)
        m.observe_ms("h", 3.0)
        scope = m.scoped()
        m.inc("a_total", 5)
        m.observe_ms("h", 4.0)
        assert scope.get("a_total") == 5
        assert scope.hist_count("h") == 1 and scope.hist_sum("h") == 4.0
        assert scope.delta() == {"a_total": 5, "h_ms_total": 4,
                                 "h_count": 1, "h_ms_max": 1}
        m.reset()
        assert m.snapshot() == {} and m.histograms() == {}


def metrics_script(m, o):
    """One script of registry calls, for either package's `Metrics`."""
    m.inc(o.PODS_BOUND, 7)
    m.inc(o.UNSCHEDULABLE_BY_PLUGIN, plugin="Coscheduling")
    m.inc(o.UNSCHEDULABLE_BY_PLUGIN, 3, plugin='a"b\\c\nd')
    m.set_gauge("scheduler_resident_generation", 42)
    m.set_gauge(o.PLACEMENT_QUALITY, 0.25, objective="fragmentation")
    for v, prio in ((3.0, "0"), (30.0, "0"), (7.5, "10"), (0.001, "0"),
                    (99_999.0, "10")):
        m.observe_ms(o.E2E_SCHEDULING_MS, v, priority=prio)
    m.observe_ms(o.POD_SCHEDULING_SLI_MS, 1.5, stage="queue_wait")
    m.observe_ms("scheduler_binding_ms", 4.0)
    m.observe_ms("scheduler_binding_ms", 2500.0)
    m.inc("scheduler_help_escape_probe_total")
    m._set_max("scheduler_max_probe", 9)


#: the JAX package's compile-watch families: eager PyTorch keeps no jit
#: cache, so the port's registry does not declare them
JAX_ONLY_FAMILIES = ("JIT_COMPILE", "JIT_CACHE_MISS")


class TestParityWithJax:
    def test_same_calls_same_exposition(self, jax_package):
        pm, jm = Metrics(), jax_obs.Metrics()
        metrics_script(pm, obs)
        metrics_script(jm, jax_obs)
        assert pm.prometheus_text() == jm.prometheus_text()
        assert pm.snapshot() == jm.snapshot()
        assert pm.histograms() == jm.histograms()

    def test_names_and_help_equal_jax(self, jax_package):
        names = {n for n in dir(jax_obs)
                 if n.isupper() and isinstance(getattr(jax_obs, n), str)}
        for n in names - set(JAX_ONLY_FAMILIES):
            assert getattr(obs, n) == getattr(jax_obs, n), n
        jax_only = {getattr(jax_obs, n) for n in JAX_ONLY_FAMILIES}
        assert not any(hasattr(obs, n) for n in JAX_ONLY_FAMILIES)
        assert obs.HELP == {k: v for k, v in jax_obs.HELP.items()
                            if k not in jax_only}
        assert jax_only <= jax_obs.HELP.keys()
        assert obs.HIST_BUCKETS_MS == jax_obs.HIST_BUCKETS_MS


# --- prometheus 0.0.4 conformance (`tests/test_prometheus.py`) -------------

_SAMPLE = re.compile(r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
                     r'(?:\{(?P<labels>.*)\})? (?P<value>\S+)$')
_LABEL = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"')


def parse_exposition(text: str):
    """Strict 0.0.4 parse: (samples, types, helps), or an assertion."""
    samples, types, helps = [], {}, {}
    assert text.endswith("\n")
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# HELP "):
            name, _, help_text = ln[len("# HELP "):].partition(" ")
            assert name not in helps
            helps[name] = help_text
            continue
        if ln.startswith("# TYPE "):
            name, _, kind = ln[len("# TYPE "):].partition(" ")
            assert name not in types and name in helps
            assert kind in ("counter", "gauge", "histogram", "summary")
            types[name] = kind
            continue
        assert not ln.startswith("#"), ln
        m = _SAMPLE.match(ln)
        assert m, ln
        raw, labels = m.group("labels"), []
        if raw:
            assert _LABEL.sub("", raw).replace(",", "") == "", ln
            labels = [(lm.group("k"), lm.group("v"))
                      for lm in _LABEL.finditer(raw)]
        value = float(m.group("value").replace("+Inf", "inf"))
        samples.append((m.group("name"), tuple(labels), value))
    for name, _labels, _v in samples:
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in types or family in types, name
    assert len(set(samples)) == len(samples)
    return samples, types, helps


@pytest.fixture
def registry():
    m = Metrics()
    m.inc(obs.PODS_BOUND, 7)
    m.inc(obs.UNSCHEDULABLE_BY_PLUGIN, plugin="Coscheduling")
    m.set_gauge("scheduler_resident_generation", 42)
    m.observe_ms(obs.E2E_SCHEDULING_MS, 3.0, priority="0")
    m.observe_ms(obs.E2E_SCHEDULING_MS, 30.0, priority="0")
    m.observe_ms(obs.E2E_SCHEDULING_MS, 7.5, priority="10")
    m.observe_ms(obs.POD_SCHEDULING_SLI_MS, 1.5, stage="queue_wait")
    m.observe_ms("scheduler_binding_ms", 4.0)
    return m


class TestConformance:
    def test_parses_strictly_and_types(self, registry):
        samples, types, helps = parse_exposition(registry.prometheus_text())
        assert samples and set(types) == set(helps)
        assert "upstream" in helps[obs.E2E_SCHEDULING_MS]
        assert types[obs.PODS_BOUND] == "counter"
        assert types["scheduler_resident_generation"] == "gauge"
        assert types[obs.E2E_SCHEDULING_MS] == "histogram"

    def test_histogram_renders_full_cumulative_ladder(self, registry):
        samples, _t, _h = parse_exposition(registry.prometheus_text())
        name = obs.E2E_SCHEDULING_MS
        for prio, want_count, want_sum in (("0", 2, 33.0), ("10", 1, 7.5)):
            buckets = [(dict(ls)["le"], v) for n, ls, v in samples
                       if n == f"{name}_bucket"
                       and dict(ls)["priority"] == prio]
            assert [b for b, _ in buckets] == (
                [f"{b:g}" for b in HIST_BUCKETS_MS] + ["+Inf"])
            counts = [v for _b, v in buckets]
            assert counts == sorted(counts) and counts[-1] == want_count
            (total,) = [v for n, ls, v in samples if n == f"{name}_count"
                        and dict(ls)["priority"] == prio]
            (ssum,) = [v for n, ls, v in samples if n == f"{name}_sum"
                       and dict(ls)["priority"] == prio]
            assert total == want_count and ssum == want_sum

    def test_label_and_help_escaping(self):
        m = Metrics()
        hostile = 'a"b\\c\nd'
        m.inc(obs.UNSCHEDULABLE_BY_PLUGIN, plugin=hostile)
        m.inc("scheduler_help_escape_probe_total")
        try:
            obs.HELP["scheduler_help_escape_probe_total"] = "line\nbreak\\x"
            text = m.prometheus_text()
        finally:
            obs.HELP.pop("scheduler_help_escape_probe_total", None)
        samples, _t, _h = parse_exposition(text)
        (sample,) = [s for s in samples if s[0] == obs.UNSCHEDULABLE_BY_PLUGIN]
        raw = dict(sample[1])["plugin"]
        assert raw.replace("\\n", "\n").replace('\\"', '"').replace(
            "\\\\", "\\") == hostile
        (help_line,) = [ln for ln in text.splitlines() if ln.startswith(
            "# HELP scheduler_help_escape_probe_total")]
        assert "\\n" in help_line

    def test_json_and_text_views_agree(self, registry):
        samples, _t, _h = parse_exposition(registry.prometheus_text())
        rendered = {(n, ls): v for n, ls, v in samples
                    if not n.endswith(("_bucket", "_sum"))}
        for key, value in registry.snapshot().items():
            name = key.split("{")[0]
            labels = tuple(_LABEL.findall(key[len(name):].strip("{}")))
            assert rendered[(name, labels)] == value, key
        for key, h in registry.histograms().items():
            name = key.split("{")[0]
            labels = tuple(_LABEL.findall(key[len(name):].strip("{}")))
            (ssum,) = [v for n, ls, v in samples
                       if n == f"{name}_sum" and ls == labels]
            assert math.isclose(ssum, h["sum"])

    def test_global_registry_scrape_stays_parseable(self):
        PORT.run(alloc_scheduler(PORT), small_cluster(PORT), 1000)
        samples, _t, _h = parse_exposition(obs.metrics.prometheus_text())
        assert len(samples) >= len(obs.metrics.snapshot()) - len(
            obs.metrics.histograms())


# --- the tracer ------------------------------------------------------------

class TestTracer:
    def test_disabled_tracer_records_nothing(self):
        t = obs.Tracer()
        with t.span("work", tid="row"):
            pass
        t.complete("late", 0, 10)
        assert t.export()["traceEvents"] == []

    def test_span_records_complete_event_with_thread_name(self):
        t = obs.Tracer()
        t.start()
        with t.span("solve", tid="cycle", pods=3):
            pass
        t.stop()
        events = t.export()["traceEvents"]
        xs = [e for e in events if e["ph"] == "X"]
        ms = [e for e in events if e["ph"] == "M"]
        assert len(xs) == 1 and xs[0]["name"] == "solve"
        assert xs[0]["args"] == {"pods": 3}
        assert ms[0]["args"]["name"] == "cycle" and ms[0]["tid"] == xs[0]["tid"]

    def test_start_clears_previous_run(self):
        t = obs.Tracer()
        t.start()
        with t.span("old"):
            pass
        t.start()
        t.stop()
        assert t.export()["traceEvents"] == []

    def test_export_is_perfetto_valid_and_written_atomically(self, tmp_path):
        t = obs.Tracer()
        t.start()
        with t.span("outer", tid="cycle"):
            with t.span("inner", tid="cycle"):
                pass
        with t.span("other-row", tid="pipeline/h2d/buf0"):
            pass
        t.stop()
        assert validate_trace(t.export()) == []
        out = tmp_path / "t.json"
        t.write(str(out))
        assert json.loads(out.read_text()) == t.export()
        assert [p.name for p in tmp_path.iterdir()] == ["t.json"]

    def test_extension_span_observes_histogram(self):
        scope = obs.metrics.scoped()
        with obs.extension_span("Score", "Probe"):
            pass
        assert scope.hist_count(obs.PLUGIN_EXECUTION, plugin="Probe",
                                extension_point="Score") == 1


#: the spans the port traces and the JAX package does not: the cycle's
#: stages, the snapshot's and the parity solve's parts
PORT_ONLY_SPANS = (
    "Cycle/open", "Cycle/pending", "Cycle/snapshot", "Cycle/solve",
    "Cycle/fence", "Cycle/bind", "Cycle/postbind", "Cycle/finalize",
    "Snapshot/binding_cache", "Snapshot/assigned", "Snapshot/lower",
    "Snapshot/scheduling_tables", "Solve/presolve", "Solve/steps",
)

CYCLE_SPANS = ("ExpireGangs", "NRTResync", "Collectors", "Requeue",
               "QueueSort/PrioritySort", "Snapshot",
               "Prepare/NodeResourcesAllocatable", "Solve/tpu-scheduler",
               "Bind", "Permit", "PostFilter/none", "Attribution")


def traced(pkg, fn):
    pkg.obs.tracer.start()
    try:
        fn()
    finally:
        pkg.obs.tracer.stop()
    trace = pkg.obs.tracer.export()
    assert validate_trace(trace) == []
    return trace


def span_names(trace) -> set:
    return {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}


class TestCycleTrace:
    def test_traced_cycle_exports_loadable_timeline(self, tmp_path):
        trace = traced(PORT, lambda: PORT.run(
            alloc_scheduler(PORT), small_cluster(PORT), 1000))
        out = tmp_path / "cycle.json"
        obs.tracer.write(str(out))
        assert validate_trace(json.loads(out.read_text())) == []
        assert {e["ph"] for e in trace["traceEvents"]} <= {"X", "M"}
        assert set(CYCLE_SPANS) <= span_names(trace)
        by_tid = {}
        for e in trace["traceEvents"]:
            if e["ph"] == "X":
                by_tid.setdefault(e["tid"], []).append(e["ts"] + e["dur"])
        for ends in by_tid.values():
            assert all(b >= a for a, b in zip(ends, ends[1:]))

    def test_span_names_equal_jax(self, jax_package):
        port, jax = (span_names(traced(pkg, lambda: pkg.run(
            alloc_scheduler(pkg), small_cluster(pkg), 1000)))
            for pkg in (PORT, JAX))
        assert not jax & set(PORT_ONLY_SPANS)
        assert port == jax | set(PORT_ONLY_SPANS)

    def test_untraced_cycle_is_silent(self):
        before = len(obs.tracer.export()["traceEvents"])
        PORT.run(alloc_scheduler(PORT), small_cluster(PORT), 1000)
        assert len(obs.tracer.export()["traceEvents"]) == before

    def test_serve_refresh_stage_spans(self, jax_package):
        """A traced serve cycle puts the engine's stages on a "serve"
        row, with the JAX package's names."""
        def serve_cycles(pkg):
            c = pkg.Cluster()
            for i in range(4):
                c.add_node(pkg.o.Node(name=f"n{i}", allocatable={
                    "cpu": 8000, "memory": 32 * GIB, "pods": 110}))
            for p in range(6):
                c.add_pod(pkg.o.Pod(name=f"p{p}", creation_ms=p, containers=[
                    pkg.o.Container(requests={"cpu": 100})]))
            engine = pkg.Engine().attach(c)
            sched = alloc_scheduler(pkg)
            pkg.run(sched, c, 1000, engine)
            c.add_pod(pkg.o.Pod(name="late", creation_ms=99, containers=[
                pkg.o.Container(requests={"cpu": 100})]))
            pkg.run(sched, c, 2000, engine)

        names = []
        for pkg in (PORT, JAX):
            trace = traced(pkg, lambda: serve_cycles(pkg))
            rows = {e["args"]["name"] for e in trace["traceEvents"]
                    if e["ph"] == "M"}
            assert "serve" in rows
            names.append(span_names(trace))
        for expected in ("ServeRefresh/drain", "ServeRefresh/classify",
                         "ServeRefresh/rebase", "ServeRefresh/apply",
                         "ServeRefresh/assemble"):
            assert expected in names[0], expected
        assert not names[1] & set(PORT_ONLY_SPANS)
        assert names[0] == names[1] | set(PORT_ONLY_SPANS)

    def test_pipeline_rows_replayed(self):
        """`run_chunk_pipeline` replays its timeline as Perfetto rows
        (`PipelineTimeline.emit_trace`)."""
        import torch

        from scheduler_plugins_tpu_torch.parallel.pipeline import (
            run_chunk_pipeline,
        )

        def solve_chunk(x, carry):
            return x + carry, carry + 1

        chunks = [(np.arange(4),) for _ in range(3)]
        trace = traced(PORT, lambda: run_chunk_pipeline(
            solve_chunk, (), chunks, torch.zeros(4, dtype=torch.int64),
            device="cpu"))
        rows = {e["args"]["name"] for e in trace["traceEvents"]
                if e["ph"] == "M"}
        assert {"pipeline/dispatch/buf0", "pipeline/d2h/buf1",
                "pipeline/solve/buf0"} <= rows
        assert "solve chunk 2" in span_names(trace)


# --- the cycle counters against JAX ----------------------------------------

def flagship(pkg):
    P = pkg.plugins
    return pkg.Scheduler(pkg.Profile(plugins=[
        P.NodeResourcesAllocatable(), P.Coscheduling(**SCRIPT_COSCHED),
        P.CapacityScheduling()]))


def script_counters(pkg, serve: bool) -> dict:
    """`cycle_script` at 16 nodes through `run_cycle` (served or plain)
    with the registry reset first; the counters and gauges after it, and
    the histograms' names and counts. Left out: the JAX-only
    compile-watch families (`scheduler_jit_*`) and the wall-time sums and
    maxima of the duration histograms (`<name>_ms_total`,
    `<name>_ms_max`)."""
    cluster, steps = cycle_script(pkg.o, pkg.Cluster, 16)
    sched = flagship(pkg)
    engine = pkg.Engine().attach(cluster) if serve else None
    pkg.obs.metrics.reset()
    for now, mutate in steps:
        if mutate is not None:
            mutate(pkg.o, cluster)
        pkg.run(sched, cluster, now, engine)
    hists = {k: h["count"] for k, h in pkg.obs.metrics.histograms().items()
             if not k.startswith("scheduler_jit_")}
    timed = {f"{k}{suffix}" for k in hists for suffix in ("_ms_total",
                                                          "_ms_max")}
    counters = {k: v for k, v in pkg.obs.metrics.snapshot().items()
                if not k.startswith("scheduler_jit_") and k not in timed}
    return {"counters": counters, "histogram_counts": hists}


class TestCycleCounters:
    @pytest.mark.parametrize("serve", [False, True])
    def test_script_counters_equal_jax(self, jax_package, serve):
        port = script_counters(PORT, serve)
        jax = script_counters(JAX, serve)
        assert port == jax
        assert port["counters"][obs.SCHEDULING_CYCLES] > 0
        assert port["counters"][obs.PREEMPTION_ATTEMPTS] > 0
        assert any(k.startswith(obs.UNSCHEDULABLE_BY_PLUGIN)
                   for k in port["counters"])
        if serve:
            assert port["counters"][obs.SERVE_REBASES] >= 1
            assert port["histogram_counts"][obs.SERVE_DECISION_LATENCY] > 0

    def test_nrt_cache_flush_counter(self):
        from scheduler_plugins_tpu_torch.state.nrt_cache import (
            OverReserveCache,
        )

        cache = OverReserveCache()
        cache.foreign.add("n0")
        node = port_objects.NodeResourceTopology(node_name="n0", zones=[])
        node.pod_fingerprint = "fp"
        cache.pending["n0"] = node
        cache.attr_changed.add("n0")
        scope = obs.metrics.scoped()
        assert cache.resync({}) == ["n0"]
        assert scope.get(obs.CACHE_RESYNC_FLUSHES) == 1
