"""The port's tracer on the profiler's clock, its counters, and the spans
and counters inside the cycle (`scheduler_plugins_tpu_torch.utils
.observability.Tracer`).

- Clock: a span converted through the export's `origin_profiler_ns`
  lands where `torch.profiler` stamps a `record_function` range around
  the same block (on the CPU within 200 us; on the card, `-m cuda`, with
  a synchronised kernel inside, within 50 us).
- Spans: a traced `run_cycle` emits the `Cycle/*` stage spans, the
  snapshot's `Snapshot/*` and the parity solve's `Solve/*`, each nested
  in its stage, the timeline Perfetto-valid; the stage spans and
  `timings` come from the same clock reads.
- Counts: `Snapshot/binding_cache`'s `entries` is the binding cache's
  length before its GC walk, `Solve/steps`' `steps` the snapshot's pods,
  the store counters the mutator calls made.
- Off: untraced cycles and mutations leave no events and no counters.
"""

import gc
import time

import pytest
import torch

import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.utils.observability as obs
from scheduler_plugins_tpu_torch.api.objects import Container, Node, Pod
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.plugins import NodeResourcesAllocatable
from scheduler_plugins_tpu_torch.serving import ServeEngine
from scheduler_plugins_tpu_torch.state.cluster import Cluster
from tools.trace_smoke import validate_trace

GIB = 1 << 30

#: the stage spans `run_cycle` puts on the "cycle" row, in order
CYCLE_STAGES = ("open", "pending", "snapshot", "solve", "fence", "bind",
                "postbind", "finalize")
SNAPSHOT_SPANS = ("Snapshot/binding_cache", "Snapshot/assigned",
                  "Snapshot/lower", "Snapshot/scheduling_tables")
SOLVE_SPANS = ("Solve/presolve", "Solve/steps")


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    obs.tracer.stop()


def cluster_of(nodes: int = 3, pods: int = 5, bound: int = 2) -> Cluster:
    c = Cluster()
    for i in range(nodes):
        c.add_node(Node(name=f"n{i}", allocatable={
            "cpu": 4000, "memory": 32 * GIB, "pods": 110}))
    for p in range(bound + pods):
        c.add_pod(Pod(name=f"p{p}", creation_ms=p, containers=[
            Container(requests={"cpu": 100, "memory": GIB})]))
    for p in range(bound):
        c.bind(f"default/p{p}", f"n{p % nodes}", now_ms=p)
    return c


def scheduler() -> Scheduler:
    return Scheduler(Profile(plugins=[NodeResourcesAllocatable()]))


def traced(fn):
    obs.tracer.start()
    try:
        fn()
    finally:
        obs.tracer.stop()
    trace = obs.tracer.export()
    assert validate_trace(trace) == []
    return trace


def spans(trace, name=None) -> list:
    return [e for e in trace["traceEvents"]
            if e["ph"] == "X" and (name is None or e["name"] == name)]


def inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


# --- the profiler's clock --------------------------------------------------

def span_against_range(device: str, block, tries: int = 7) -> tuple:
    """(start, end) differences in ns between the tracer's span, converted
    through the anchor, and the profiler's range around the same block:
    the closest of `tries` profiles, the collector paused (a collection
    or a thread descheduled between the two stamps parts them by its
    wait, and nothing pulls them closer)."""
    gc.disable()
    try:
        return min((one_span_against_range(device, block)
                    for _ in range(tries)),
                   key=lambda d: max(abs(d[0]), abs(d[1])))
    finally:
        gc.enable()


def one_span_against_range(device: str, block) -> tuple:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    block()  # warm: the first call pays for allocation and launch setup
    obs.tracer.start()
    with profile(activities=activities) as prof:
        # a profile's first range pays its set-up after its start stamp
        with record_function("tracing.warm"):
            pass
        # the span outside: a range stamps its end only after its exit's
        # own dispatch, which can take a tenth of a millisecond
        with obs.tracer.span("tracing.probe", tid="probe"):
            with record_function("tracing.probe"):
                block()
    obs.tracer.stop()
    trace = obs.tracer.export()
    (span,) = spans(trace, "tracing.probe")
    start = trace["otherData"]["origin_profiler_ns"] + span["ts"] * 1e3
    end = start + span["dur"] * 1e3
    (rng,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "tracing.probe"
              and e.device_type() != DeviceType.CUDA]
    return start - rng.start_ns(), end - rng.end_ns()


def test_span_on_profiler_clock_cpu():
    def block():
        x = torch.ones(256, 256)
        for _ in range(20):
            x = x @ x / 256
        time.sleep(0.002)

    d_start, d_end = span_against_range("cpu", block)
    assert abs(d_start) < 200_000, d_start
    assert abs(d_end) < 200_000, d_end


@pytest.mark.cuda
def test_span_on_profiler_clock_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.randn(2048, 2048, device="cuda")

    def block():
        y = x
        for _ in range(8):
            y = y @ x / 2048
        torch.cuda.synchronize()

    d_start, d_end = span_against_range("cuda", block)
    assert abs(d_start) < 50_000, d_start
    assert abs(d_end) < 50_000, d_end


# --- spans inside the cycle ------------------------------------------------

class TestCycleSpans:
    def test_stage_snapshot_and_solve_spans_nest(self):
        c = cluster_of()
        trace = traced(lambda: port_cycle.run_cycle(
            scheduler(), c, now=1000, device="cpu"))
        stage = {}
        for name in CYCLE_STAGES:
            (stage[name],) = spans(trace, f"Cycle/{name}")
        rows = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
                if e["ph"] == "M"}
        assert {s["tid"] for s in stage.values()} == {rows["cycle"]}
        order = [stage[n] for n in CYCLE_STAGES]
        for a, b in zip(order, order[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        for name in SNAPSHOT_SPANS:
            (span,) = spans(trace, name)
            assert span["tid"] == rows["cycle"]
            assert inside(span, stage["snapshot"]), name
        (lower,) = spans(trace, "Snapshot/lower")
        (tables,) = spans(trace, "Snapshot/scheduling_tables")
        assert inside(tables, lower)
        for name in SOLVE_SPANS:
            (span,) = spans(trace, name)
            assert inside(span, stage["solve"]), name

    def test_timings_are_the_stage_spans(self):
        timings = {}
        trace = traced(lambda: port_cycle.run_cycle(
            scheduler(), cluster_of(), now=1000, device="cpu",
            timings=timings))
        for name in CYCLE_STAGES:
            (span,) = spans(trace, f"Cycle/{name}")
            assert timings[name] == pytest.approx(span["dur"] / 1e6,
                                                  abs=1e-9), name
        (tables,) = spans(trace, "Snapshot/scheduling_tables")
        assert timings["scheduling_tables"] == pytest.approx(
            tables["dur"] / 1e6, abs=1e-9)

    def test_served_verify_holds_a_fresh_lowering(self):
        c = cluster_of(nodes=4, pods=6, bound=0)
        engine = ServeEngine().attach(c)
        engine.verify_every = 1
        sched = scheduler()
        port_cycle.run_cycle(sched, c, now=1000, serve=engine, device="cpu")
        c.add_pod(Pod(name="late", creation_ms=99, containers=[
            Container(requests={"cpu": 100})]))
        trace = traced(lambda: port_cycle.run_cycle(
            sched, c, now=2000, serve=engine, device="cpu"))
        verify = spans(trace, "ServeRefresh/verify")
        assert verify
        (lower,) = spans(trace, "Snapshot/lower")
        assert any(inside(lower, v) for v in verify)


# --- exact counts ------------------------------------------------------------

class TestCounts:
    def test_binding_cache_entries_before_the_walk(self):
        c = cluster_of(nodes=3, pods=2, bound=6)
        now = Cluster.BINDING_CACHE_GC_MS + 3
        # binds at 0..5 ms: those older than the GC horizon leave
        before = len(c.recent_bindings)
        trace = traced(lambda: c.snapshot(c.pending_pods(), now_ms=now,
                                          device="cpu"))
        (span,) = spans(trace, "Snapshot/binding_cache")
        assert span["args"]["entries"] == before == 6
        assert len(c.recent_bindings) == 3
        (assigned,) = spans(trace, "Snapshot/assigned")
        assert assigned["args"]["pods"] == 6

    def test_steps_are_the_snapshots_pods(self):
        c = cluster_of(pods=7)
        snap, meta = c.snapshot(c.pending_pods(), now_ms=0, device="cpu")
        sched = scheduler()
        sched.prepare(meta, c)
        trace = traced(lambda: sched.solve(snap, device="cpu"))
        (steps,) = spans(trace, "Solve/steps")
        assert steps["args"]["steps"] == snap.num_pods >= 7

    def test_store_counters_count_the_calls(self):
        c = cluster_of(pods=0, bound=0)
        pods = [Pod(name=f"q{i}", creation_ms=i, containers=[
            Container(requests={"cpu": 10})]) for i in range(40)]

        def mutate():
            for pod in pods:
                c.add_pod(pod)
            c.add_pod(pods[0])  # an upsert is a call too
            for pod in pods[:15]:
                c.remove_pod(pod.uid)
            c.remove_pod("default/absent")

        trace = traced(mutate)
        counters = trace["otherData"]["counters"]
        assert counters["store.add_pod"]["count"] == 41
        assert counters["store.remove_pod"]["count"] == 16
        assert counters["store.add_pod"]["ns"] > 0
        assert counters["store.remove_pod"]["ns"] > 0
        assert spans(trace) == []


# --- the counters and the anchor --------------------------------------------

class TestTracerApi:
    def test_counters_total_and_clear(self):
        t = obs.Tracer()
        t.count("a")
        t.add_ns("a", 5)
        assert t.counters() == {}
        t.start()
        t.count("a")
        t.count("a", 4)
        t.add_ns("a", 7)
        t.add_ns("b", 3)
        t.add_ns("b", 4)
        assert t.counters() == {"a": {"count": 6, "ns": 7},
                                "b": {"count": 2, "ns": 7}}
        assert t.export()["otherData"]["counters"] == t.counters()
        t.start()
        assert t.counters() == {}

    def test_anchor_is_read_with_the_origin(self):
        t = obs.Tracer()
        before = time.time_ns()
        t.start()
        after = time.time_ns()
        origin = t.export()["otherData"]["origin_profiler_ns"]
        assert before <= origin <= after

    def test_disabled_span_is_one_shared_no_op(self):
        t = obs.Tracer()
        assert t.span("a") is t.span("b", tid="x", k=1)
        with t.span("a") as span:
            assert span is None
        assert t.export()["traceEvents"] == []


def test_untraced_cycle_and_mutations_leave_nothing():
    obs.tracer.start()
    obs.tracer.stop()
    c = cluster_of(bound=0)
    port_cycle.run_cycle(scheduler(), c, now=1000, device="cpu",
                         timings={})
    for i in range(1000):
        c.add_pod(Pod(name=f"u{i}", creation_ms=i, containers=[
            Container(requests={"cpu": 10})]))
    for i in range(10):
        c.remove_pod(f"default/u{i}")
    trace = obs.tracer.export()
    assert trace["traceEvents"] == []
    assert trace["otherData"]["counters"] == {}
