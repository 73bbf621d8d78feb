"""The port's pod-lifecycle ledger (`scheduler_plugins_tpu_torch.obs.ledger`,
with the store's and the cycle's hooks) against the JAX package.

- The decision tables of `tests/test_ledger.py` (the stub-clock
  decomposition, the engine decomposition, the backoff window table, the
  gang spans, the serial vs pipelined sequence identity and the disabled
  ledger) run again on the port, every JAX name they call swapped for the
  port's. The gang-span case keeps JAX's `gang_admission_latency` (the
  port has no copy yet): it reads only the corpus built from the port
  ledger's events.
- One event stream, the flagship profile's thirty churn cycles with
  gangs, a quota and preemption nominations (`tests/torch_churn_cases.py`
  `flagship_churn`), fed to JAX's ledger and the port's: `sequence()`
  equal with tolerance 0, no decomposition error on either side, and the
  SLI summaries' counts equal.
- `Metrics.observe_batch` feeds the histograms as JAX's does."""

import inspect
import threading
from types import SimpleNamespace

import pytest

import scheduler_plugins_tpu_torch.api.events as port_events
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.framework import (
    PipelinedCycle as PPipelinedCycle,
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.obs import ledger as port_ledger
from scheduler_plugins_tpu_torch.state import cluster as port_store
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.utils import observability as port_obs
from torch_churn_cases import flagship_churn

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    import tests.test_ledger as jax_tables
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.obs import ledger as jax_ledger
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    from scheduler_plugins_tpu.utils import observability as jax_obs
except ImportError:
    jax_objects = None

CPU = "cpu"


@pytest.fixture
def jax_package():
    if jax_objects is None:
        pytest.skip("the JAX package is not importable here")


class _CPUCluster(PCluster):
    """The port's store on the CPU. The backoff settings, fields of the
    JAX store, are the port's module constants."""

    backoff_initial_ms = port_store.BACKOFF_INITIAL_MS
    backoff_max_ms = port_store.BACKOFF_MAX_MS

    def snapshot(self, pending, now_ms=0, device=CPU, **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


def _port_stub_led():
    """`tests/test_ledger.py`'s `stub_led` fixture on the port's ledger."""
    led = port_ledger.Ledger().start()
    clock = {"t": 0}
    led._now = lambda: clock["t"]
    return led, clock


def _tables():
    if jax_objects is None:
        return []
    classes = [jax_tables.TestStubClockDecomposition,
               jax_tables.TestEngineDecomposition,
               jax_tables.TestBackoffWindowTable,
               jax_tables.TestGangSpans,
               jax_tables.TestEngineSequenceIdentity]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_")]


@pytest.mark.parametrize("cls,method", _tables())
def test_decision_table_against_port(cls, method, monkeypatch):
    """Each case of `tests/test_ledger.py`'s tables with every JAX name
    it calls swapped for the port's: the objects, the store, the
    scheduler and its plugins, `run_cycle` and `PipelinedCycle` on the
    CPU, the ledger module and its classes, and the metrics."""
    swaps = {
        "ev": port_events,
        "Container": port_objects.Container,
        "Node": port_objects.Node,
        "Pod": port_objects.Pod,
        "PodGroup": port_objects.PodGroup,
        "POD_GROUP_LABEL": port_objects.POD_GROUP_LABEL,
        "PipelinedCycle": lambda s, c, **kw: PPipelinedCycle(
            s, c, device=CPU, **kw),
        "Profile": PProfile,
        "Scheduler": PScheduler,
        "run_cycle": lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now=now, device=CPU, **kw),
        "podledger": port_ledger,
        "Ledger": port_ledger.Ledger,
        "LedgerCycle": port_ledger.LedgerCycle,
        "STAGES": port_ledger.STAGES,
        "Coscheduling": port_plugins.Coscheduling,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "Cluster": _CPUCluster,
        "obs": port_obs,
    }
    for name, value in swaps.items():
        assert hasattr(jax_tables, name), name
        monkeypatch.setattr(jax_tables, name, value)
    bound = getattr(cls(), method)
    params = inspect.signature(bound).parameters
    kwargs = {"stub_led": _port_stub_led()} if "stub_led" in params else {}
    bound(**kwargs)


def test_tables_cover_every_class(jax_package):
    """Every test class of `tests/test_ledger.py` is in the swapped run."""
    classes = {p.values[0].__name__ for p in _tables()}
    want = {name for name, value in vars(jax_tables).items()
            if name.startswith("Test") and inspect.isclass(value)}
    assert classes == want


def _ledger_run(pkg, run, led_module):
    """`flagship_churn` with a fresh ledger of `led_module` installed."""
    led = led_module.Ledger().start()
    prev = led_module.use(led)
    try:
        out = flagship_churn(pkg, run)
    finally:
        led_module.use(prev)
    return led, out


class TestSequenceAgainstJax:
    def test_flagship_churn_sequence_equals_jax(self, jax_package):
        """One event stream (thirty churn cycles and ten drains with
        gangs, a quota, backoff waits and CAPACITY preemption
        nominations) through JAX's ledger and the port's: the engine
        sequences equal exactly."""
        jpkg = SimpleNamespace(o=jax_objects, Cluster=JCluster,
                               Profile=JProfile, Scheduler=JScheduler,
                               plugins=jax_plugins)
        ppkg = SimpleNamespace(o=port_objects, Cluster=_CPUCluster,
                               Profile=PProfile, Scheduler=PScheduler,
                               plugins=port_plugins)
        jled, jout = _ledger_run(
            jpkg, lambda s, c, now, e: jax_cycle.run_cycle(s, c, now=now),
            jax_ledger)
        pled, pout = _ledger_run(
            ppkg, lambda s, c, now, e: port_cycle.run_cycle(
                s, c, now=now, device=CPU), port_ledger)
        assert pout["reports"] == jout["reports"]
        want, got = jled.sequence(), pled.sequence()
        assert len(want) > 200
        kinds = {row[4] for row in want}
        for kind in ("PodLifecycle/FirstSeen", "PodLifecycle/Unschedulable",
                     "PodLifecycle/Bound", "PodLifecycle/Wait",
                     "PodLifecycle/Nominated",
                     "PodLifecycle/NominationCleared"):
            assert kind in kinds, kind
        assert got == want
        assert jled.decomposition_errors() == []
        assert pled.decomposition_errors() == []
        js, ps = jled.sli_summary(), pled.sli_summary()
        for key in ("pods_bound", "pods_deleted", "pods_pending"):
            assert ps[key] == js[key], key
        assert ps["e2e_ms"]["n"] == js["e2e_ms"]["n"]
        assert ps["attempts_mean"] == js["attempts_mean"]

    def test_disabled_ledger_costs_one_branch(self):
        """An off ledger records nothing through a whole served
        pipelined run, and opens no cycle."""
        led = port_ledger.Ledger()
        prev = port_ledger.use(led)
        try:
            ppkg = SimpleNamespace(o=port_objects, Cluster=_CPUCluster,
                                   Profile=PProfile, Scheduler=PScheduler,
                                   plugins=port_plugins)
            flagship_churn(ppkg, lambda s, c, now, e: port_cycle.run_cycle(
                s, c, now=now, device=CPU))
        finally:
            port_ledger.use(prev)
        assert led.sequence() == [] and led._cycles == 0

    def test_scope_stacks_are_per_thread(self):
        """A scope pushed on one thread never attributes another thread's
        events: the pipelined engine's flusher pushes lane 1 while the
        tick thread holds lane 0."""
        led = port_ledger.Ledger().start()
        cyc = led.cycle_open(1000)
        led.push_scope(cyc, 0)
        seen = []
        t = threading.Thread(target=lambda: seen.append(led._coords()),
                             name="ledger-scope-probe", daemon=False)
        t.start()
        t.join()
        assert led._coords()[:2] == (1, 0)
        # ambient attribution on the other thread: the last cycle, lane 0,
        # the global counter
        assert seen == [(1, 0, 0)]
        led.pop_scope(cyc)


class TestPrologueRaise:
    @pytest.mark.parametrize("entry", ["run_cycle", "pipelined"])
    def test_raise_in_prologue_pops_scope(self, entry, monkeypatch):
        """A raise in the cycle prologue (after the lane-0 scope is
        pushed, before the caller's finally is entered) leaves no scope on
        the thread, so later events fall back to ambient attribution."""
        led = port_ledger.Ledger().start()
        prev = port_ledger.use(led)
        c = _CPUCluster()
        c.add_node(port_objects.Node(name="n0", allocatable={
            "cpu": 4000, "memory": 8 << 30, "pods": 10}))
        c.add_pod(port_objects.Pod(name="p0", containers=[
            port_objects.Container(requests={"cpu": 100})]))
        sched = PScheduler(PProfile(
            plugins=[port_plugins.NodeResourcesAllocatable()]))

        def boom(*a, **kw):
            raise RuntimeError("prologue")

        pipe = PPipelinedCycle(sched, c, device=CPU) \
            if entry == "pipelined" else None
        try:
            with monkeypatch.context() as m:
                m.setattr(port_cycle, "_expire_gangs", boom)
                with pytest.raises(RuntimeError, match="prologue"):
                    if pipe is not None:
                        pipe.tick(1000)
                    else:
                        port_cycle.run_cycle(sched, c, now=1000, device=CPU)
            assert getattr(led._scopes, "stack", []) == []
            # the next cycle runs and binds under its own scope
            report = (pipe.tick(2000) if pipe is not None else
                      port_cycle.run_cycle(sched, c, now=2000, device=CPU))
            if pipe is not None:
                pipe.close()
            assert report.bound == {"default/p0": "n0"}
            assert getattr(led._scopes, "stack", []) == []
        finally:
            port_ledger.use(prev)


class TestObserveBatch:
    def test_histograms_equal_jax(self, jax_package):
        feed = [("h_one", 2.0, ()), ("h_one", 7.5, ()),
                ("h_two", 3.0, (("stage", "solve"),))]
        pm, jm = port_obs.Metrics(), jax_obs.Metrics()
        pm.observe_batch(feed)
        jm.observe_batch(feed)
        assert pm.histograms() == jm.histograms()
        # histogram-only: no legacy summary counters
        assert pm.snapshot() == {} == jm.snapshot()
