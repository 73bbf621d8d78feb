"""The port's metrics collectors (`scheduler_plugins_tpu_torch.state
.collector`, a copy of the JAX package's host module) against JAX's, the
metrics providers faked at the HTTP boundary on 127.0.0.1 by the JAX
package's own test servers (tests/test_collector.py), as the reference's
trimaran tests fake them with httptest (collector_test.go:86).

Each JAX test class has its counterpart here: the port's client fetches
from the same fake server and payload, and what it parses must equal what
JAX's parses (exact: the values are the payload's floats and integer
quantities). The cycle integration runs the port's `run_cycle` and JAX's
side by side on one fake watcher."""

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.state.collector as port_collector
from scheduler_plugins_tpu_torch.api import objects as port_objects
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster

try:
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.state.collector as jax_collector
    import tests.test_collector as jax_tests
    from scheduler_plugins_tpu.api import objects as jax_objects
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    jax_collector = None

GIB = 1 << 30


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if jax_collector is None:
        pytest.skip("the JAX package is not importable here")


#: the payloads of tests/test_collector.py TestParse
def _payloads():
    if jax_collector is None:
        return []
    return [
        jax_tests.WATCHER_JSON,
        {"Data": {"NodeMetricsMap": {"n": {"Metrics": [
            {"Type": "CPU", "Operator": "Average", "Value": 40.0},
            {"Type": "CPU", "Operator": "Latest", "Value": 99.0},
        ]}}}},
        {"Data": {"NodeMetricsMap": {"n": {"Metrics": [
            {"Type": "CPU", "Operator": "Latest", "Value": 80.0},
            {"Type": "CPU", "Operator": "Average", "Value": 30.0},
        ]}}}},
        {"Data": {"NodeMetricsMap": {"m": {"Metrics": [
            {"Type": "Memory", "Operator": "Latest", "Value": 20.0},
            {"Type": "Memory", "Operator": "Average", "Value": 25.0},
            {"Type": "Memory", "Operator": "Std", "Value": 3.0},
            {"Type": "CPU", "Operator": "Std", "Value": 7.0},
        ]}, "empty": {"Metrics": []}}}},
        {},
    ]


class TestParse:
    @pytest.mark.parametrize("payload", _payloads(),
                             ids=["watcher", "avg_latest", "latest_avg",
                                  "memory_std", "empty"])
    def test_parse_equals_jax(self, payload):
        assert (port_collector.parse_watcher_metrics(payload)
                == jax_collector.parse_watcher_metrics(payload))

    def test_operator_selection_rules(self):
        metrics = port_collector.parse_watcher_metrics(jax_tests.WATCHER_JSON)
        assert metrics["hot"] == {
            "cpu_avg": 70.0, "cpu_tlp": 70.0, "cpu_peaks": 70.0,
            "cpu_std": 8.0, "mem_avg": 55.0,
        }


def two_nodes(objects, cluster_cls):
    cluster = cluster_cls()
    for name in ("hot", "cold"):
        cluster.add_node(objects.Node(name=name, allocatable={
            "cpu": 10_000, "memory": 32 * GIB, "pods": 110}))
    return cluster


class TestHTTPCollector:
    def test_fetch_and_schedule_through_http_boundary(self):
        server, addr = jax_tests.serve()
        try:
            cluster = two_nodes(port_objects, PCluster)
            cluster.add_pod(port_objects.Pod(name="p", containers=[
                port_objects.Container(requests={"cpu": 1000})]))
            collector = port_collector.LoadWatcherCollector(addr)
            metrics = collector.refresh(cluster)
            assert metrics == jax_collector.LoadWatcherCollector(addr).fetch()
            assert collector.last_payload == jax_tests.WATCHER_JSON
            report = port_cycle.run_cycle(
                PScheduler(PProfile(plugins=[
                    port_plugins.TargetLoadPacking()])),
                cluster, now=1000, device="cpu")
            assert report.bound["default/p"] == "cold"
        finally:
            server.shutdown()

    def test_fetch_failure_keeps_cached_metrics(self):
        for collector_mod, cluster_cls in ((port_collector, PCluster),
                                           (jax_collector, JCluster)):
            cluster = cluster_cls()
            cluster.node_metrics = {"n": {"cpu_avg": 5.0}}
            collector = collector_mod.LoadWatcherCollector(
                "http://127.0.0.1:1")  # a closed port
            assert collector.refresh(cluster) == {"n": {"cpu_avg": 5.0}}
            assert cluster.node_metrics == {"n": {"cpu_avg": 5.0}}


class TestCycleIntegration:
    def test_watcher_address_drives_the_cycle_like_jax(self):
        """The WatcherAddress arg: both packages' cycles start the async
        fetch, install its metrics the next cycle, keep the 30 s cadence,
        and bind alike."""
        server, addr = jax_tests.serve()
        try:
            arms = []
            for objects, cluster_cls, plugins, profile, scheduler, run in (
                    (jax_objects, JCluster, jax_plugins, JProfile,
                     JScheduler, jax_cycle.run_cycle),
                    (port_objects, PCluster, port_plugins, PProfile,
                     PScheduler,
                     lambda s, c, now: port_cycle.run_cycle(
                         s, c, now, device="cpu"))):
                arms.append((objects, two_nodes(objects, cluster_cls),
                             scheduler(profile(plugins=[
                                 plugins.TargetLoadPacking(
                                     watcher_address=addr)])), run))
            seen = []
            for now in (1_000, 2_000, 10_000, 40_000):
                step = []
                for objects, cluster, sched, run in arms:
                    if now == 2_000:
                        # the first fetch has landed before the next cycle
                        sched._collectors[addr].thread.join(timeout=5)
                        cluster.add_pod(objects.Pod(name="p", containers=[
                            objects.Container(requests={"cpu": 1000})]))
                    report = run(sched, cluster, now)
                    step.append((report.bound, cluster.node_metrics,
                                 sched._collectors[addr].last_ms))
                assert step[0] == step[1], now
                seen.append(step[1])
            assert seen[1][0] == {"default/p": "cold"}
            assert seen[1][1]["hot"]["cpu_avg"] == 70.0
            # within the cadence no new fetch; past it, another
            assert seen[2][2] == seen[1][2] and seen[3][2] == 40_000
        finally:
            server.shutdown()

    def test_unusable_source_degrades_to_no_metrics(self):
        """A provider whose client cannot be built caches None: no metrics
        from it, and no error each cycle (JAX's rule)."""
        sched = PScheduler(PProfile(plugins=[port_plugins.Peaks()]))
        sched.profile.plugins[0].metric_provider = {"type": "Bogus"}
        cluster = two_nodes(port_objects, PCluster)
        port_cycle.run_cycle(sched, cluster, 1000, device="cpu")
        assert list(sched._collectors.values()) == [None]
        assert cluster.node_metrics is None


class TestAsyncCollector:
    def test_source_eviction_on_replacement(self):
        stores = []
        for collector_mod, cluster_cls in ((port_collector, PCluster),
                                           (jax_collector, JCluster)):
            cluster = cluster_cls()
            cluster.node_metrics = {"other": {"cpu_avg": 1.0}}
            col = collector_mod.AsyncLoadWatcherCollector("http://unused:1")
            col.latest = {"n1": {"cpu_avg": 50.0}, "n2": {"cpu_avg": 60.0}}
            col.last_ms = 0
            col.tick(cluster, now_ms=1)
            first = dict(cluster.node_metrics)
            col.latest = {"n1": {"cpu_avg": 55.0}}
            col.tick(cluster, now_ms=2)
            stores.append((first, cluster.node_metrics, col.my_nodes))
        assert stores[0] == stores[1]
        assert set(stores[0][1]) == {"other", "n1"}


class TestPrometheusCollector:
    def test_fetch_equals_jax(self):
        server, handler, addr = (
            jax_tests.TestPrometheusCollector()._serve_prom())
        try:
            got = port_collector.PrometheusCollector(addr, token="sekret")
            metrics = got.fetch()
            assert handler.last_auth == "Bearer sekret"
            assert metrics == jax_collector.PrometheusCollector(
                addr, token="sekret").fetch()
            assert metrics["node-a"]["cpu_peaks"] == 42.5
        finally:
            server.shutdown()

    def test_factory_selection(self):
        make = port_collector.make_metrics_client
        assert isinstance(make("http://watcher:2020"),
                          port_collector.LoadWatcherCollector)
        assert isinstance(make(None, {"type": "Prometheus",
                                      "address": "http://prom:9090"}),
                          port_collector.PrometheusCollector)
        for bad in ({"type": "Bogus", "address": "x"},
                    {"type": "Prometheus"}, {"type": "SignalFx"}):
            with pytest.raises(ValueError):
                make(None, bad)


class TestMetricsServerCollector:
    def test_fetch_equals_jax(self):
        server, handler, addr = (
            jax_tests.TestMetricsServerCollector()._serve())
        try:
            metrics = port_collector.KubernetesMetricsServerCollector(
                addr, token="sekret").fetch()
            assert handler.last_auth == "Bearer sekret"
            assert metrics == jax_collector.KubernetesMetricsServerCollector(
                addr, token="sekret").fetch()
            assert metrics["node-b"]["mem_avg"] == 12.5
            assert "ghost" not in metrics
        finally:
            server.shutdown()

    @pytest.mark.parametrize("text", [
        "250m", "236786820n", "1500u", "2", "1Ki", "1Mi", "1G", "1.5Gi",
        "3T", "0.5", " 7 ", "2Ei"])
    def test_quantity_parsing_equals_jax(self, text):
        assert (port_collector.parse_quantity_millis(text)
                == jax_collector.parse_quantity_millis(text))

    def test_factory_selects_metrics_server(self):
        assert isinstance(
            port_collector.make_metrics_client(None, {
                "type": "KubernetesMetricsServer",
                "address": "http://apiserver:6443"}),
            port_collector.KubernetesMetricsServerCollector)


class TestSignalFxCollector:
    def test_fetch_equals_jax_with_the_same_requests(self):
        """Both clients, each against its own fake server: the same
        metrics, and the same requests (bulk host resolution, one
        per-series fallback, then only the two window queries once the
        hosts are cached)."""
        runs = []
        for collector_mod in (port_collector, jax_collector):
            server, handler, addr = (
                jax_tests.TestSignalFxCollector()._serve())
            try:
                c = collector_mod.SignalFxCollector(addr, token="sfx-token")
                first = c.fetch()
                before = len(handler.requests)
                second = c.fetch()
                runs.append((first, second, handler.last_token,
                             [p.split("?")[0] for p in handler.requests],
                             len(handler.requests) - before))
            finally:
                server.shutdown()
        assert runs[0] == runs[1]
        assert runs[0][0]["node-a"]["cpu_avg"] == 40.0
        assert runs[0][4] == 2

    def test_factory_selects_signalfx(self):
        assert isinstance(
            port_collector.make_metrics_client(None, {
                "type": "SignalFx", "address": "http://sfx", "token": "t"}),
            port_collector.SignalFxCollector)


def test_collector_metrics_reach_the_snapshot():
    """Metrics a collector installs land in the port's snapshot as JAX's
    builder lowers them."""
    tables = []
    for collector_mod, objects, cluster_cls, kw in (
            (port_collector, port_objects, PCluster, {"device": "cpu"}),
            (jax_collector, jax_objects, JCluster, {})):
        cluster = two_nodes(objects, cluster_cls)
        cluster.node_metrics = collector_mod.parse_watcher_metrics(
            jax_tests.WATCHER_JSON)
        snap, _ = cluster.snapshot([], **kw)
        tables.append({k: v.numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)
                       for k, v in vars(snap.metrics).items()})
    for k in tables[1]:
        np.testing.assert_array_equal(tables[0][k], tables[1][k], err_msg=k)
