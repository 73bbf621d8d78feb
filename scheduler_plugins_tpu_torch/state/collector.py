"""Load-watcher metrics collector (port of
`scheduler_plugins_tpu.state.collector`, host Python, kept line for line).

Mirror of the Trimaran Collector (upstream pkg/trimaran/collector.go:
42-150): polls a load-watcher-compatible HTTP endpoint (`GET /watcher`) for
`WatcherMetrics` JSON —

    {"Window": {"Duration": "15m", "Start": ..., "End": ...},
     "Data": {"NodeMetricsMap": {
        "<node>": {"Metrics": [
            {"Type": "CPU"|"Memory", "Operator": "Latest"|"Average"|"Std",
             "Value": <float>, "Unit": ...}, ...]}}}}

— and folds it into the cluster store's `node_metrics` mapping (percent of
capacity, the exact GetResourceData selection rules: Average preferred,
Latest/empty operator as fallback, Std separate;
upstream pkg/trimaran/resourcestats.go:88-106). The reference refreshes
every 30 seconds in a goroutine; here `refresh()` is explicit and the caller
owns the cadence (a thread or the cycle loop). The library-mode clients
(Prometheus, the metrics server, SignalFx) are plain HTTP, no SDK.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

#: metric type / operator strings (load-watcher watcher package)
CPU = "CPU"
MEMORY = "Memory"
LATEST = "Latest"
AVERAGE = "Average"
STD = "Std"

DEFAULT_REFRESH_SECONDS = 30  # collector.go:33


def parse_watcher_metrics(payload: dict) -> dict[str, dict]:
    """WatcherMetrics JSON -> per-node metric dict for `Cluster.node_metrics`."""
    out: dict[str, dict] = {}
    node_map = (payload.get("Data") or {}).get("NodeMetricsMap") or {}
    for node, node_metrics in node_map.items():
        entry: dict = {}
        cpu_avg_found = mem_avg_found = False
        for metric in node_metrics.get("Metrics", []):
            mtype = metric.get("Type")
            op = metric.get("Operator", "")
            value = float(metric.get("Value", 0.0))
            if mtype == CPU:
                if op == AVERAGE:
                    entry["cpu_avg"] = value
                    cpu_avg_found = True
                elif op == STD:
                    entry["cpu_std"] = value
                elif op in ("", LATEST) and not cpu_avg_found:
                    entry["cpu_avg"] = value
                if op in (AVERAGE, LATEST):
                    # TargetLoadPacking's own selection lets a later
                    # Latest override Average (targetloadpacking.go:130-139)
                    entry["cpu_tlp"] = value
                    # Peaks breaks on the FIRST Average-or-Latest sample
                    # (peaks.go:118-131)
                    entry.setdefault("cpu_peaks", value)
            elif mtype == MEMORY:
                if op == AVERAGE:
                    entry["mem_avg"] = value
                    mem_avg_found = True
                elif op == STD:
                    entry["mem_std"] = value
                elif op in ("", LATEST) and not mem_avg_found:
                    entry["mem_avg"] = value
        if entry:
            out[node] = entry
    return out


class AsyncLoadWatcherCollector:
    """Cadence-owning collector: polls in a background thread so a slow or
    dead watcher never blocks the scheduling cycle (the reference polls in
    its own goroutine, collector.go:89-97). Completed fetches REPLACE this
    source's previous contribution in the store — nodes the watcher stopped
    reporting are evicted (falling back to the neutral no-metrics path), and
    other sources' nodes are untouched. Failures keep the previous data."""

    def __init__(self, client,
                 refresh_seconds: int = DEFAULT_REFRESH_SECONDS):
        # back-compat: a bare address selects the HTTP service client
        self.collector = (
            LoadWatcherCollector(client) if isinstance(client, str) else client
        )
        self.refresh_ms = refresh_seconds * 1000
        self.last_ms: Optional[int] = None
        self.latest: Optional[dict] = None
        self.my_nodes: set[str] = set()
        self.thread = None

    def tick(self, cluster, now_ms: int) -> None:
        """Install any completed fetch; start a new one when the cadence is
        due and none is in flight. Never blocks."""
        import threading

        latest = self.latest
        if latest is not None:
            current = cluster.node_metrics or {}
            merged = {
                node: m for node, m in current.items()
                if node not in self.my_nodes or node in latest
            }
            merged.update(latest)
            cluster.node_metrics = merged
            self.my_nodes = set(latest)
            self.latest = None
        due = self.last_ms is None or now_ms - self.last_ms >= self.refresh_ms
        in_flight = self.thread is not None and self.thread.is_alive()
        if not due or in_flight:
            return
        self.last_ms = now_ms

        def fetch():
            try:
                self.latest = self.collector.fetch()
            except Exception:
                # a failed fetch keeps the previous metrics window, as the
                # reference's cache does
                pass

        self.thread = threading.Thread(
            target=fetch, daemon=True, name="load-watcher",
        )
        self.thread.start()


class LoadWatcherCollector:
    """HTTP client against a load-watcher service (`WatcherAddress` arg,
    apis/config TrimaranSpec)."""

    def __init__(self, watcher_address: str, timeout_s: float = 5.0):
        self.watcher_address = watcher_address.rstrip("/")
        self.timeout_s = timeout_s
        self.last_payload: Optional[dict] = None

    def fetch(self) -> dict[str, dict]:
        with urllib.request.urlopen(
            f"{self.watcher_address}/watcher", timeout=self.timeout_s
        ) as resp:
            self.last_payload = json.loads(resp.read())
        return parse_watcher_metrics(self.last_payload)

    def refresh(self, cluster) -> dict[str, dict]:
        """One collector tick: fetch and install into the cluster store.
        On failure the previous metrics stay (the reference keeps serving the
        cached WatcherMetrics when a fetch errors)."""
        try:
            metrics = self.fetch()
        except Exception:
            return cluster.node_metrics or {}
        cluster.node_metrics = metrics
        return metrics


#: MetricProviderSpec.Type values (apis/config/types.go:73-79)
METRIC_PROVIDER_TYPES = (
    "KubernetesMetricsServer", "Prometheus", "SignalFx",
)


def _authed_get(address: str, path_and_query: str, token: str,
                insecure_skip_verify: bool, timeout_s: float,
                auth_header: str = "Authorization",
                auth_prefix: str = "Bearer ") -> dict:
    """One GET with optional token auth / unverified TLS — the HTTP
    plumbing all library-mode clients share (SignalFx overrides the header
    to X-SF-TOKEN)."""
    import ssl

    req = urllib.request.Request(address + path_and_query)
    if token:
        req.add_header(auth_header, f"{auth_prefix}{token}")
    ctx = None
    if insecure_skip_verify and address.startswith("https"):
        ctx = ssl._create_unverified_context()
    with urllib.request.urlopen(req, timeout=timeout_s, context=ctx) as resp:
        return json.loads(resp.read())


class PrometheusCollector:
    """Library-mode metrics client for `MetricProvider.Type: Prometheus` —
    the in-process equivalent of load-watcher's prometheus provider
    (upstream pkg/trimaran/collector.go:63-73 NewLibraryClient).
    Queries the Prometheus HTTP API for per-node cpu/memory utilisation
    percentages; samples land as Average metrics (the provider aggregates
    over its range window)."""

    CPU_QUERY = (
        '100 - (avg by (instance) '
        '(rate(node_cpu_seconds_total{mode="idle"}[15m])) * 100)'
    )
    MEM_QUERY = (
        "100 * (1 - avg_over_time(node_memory_MemAvailable_bytes[15m]) "
        "/ node_memory_MemTotal_bytes)"
    )

    def __init__(self, address: str, token: str = "",
                 insecure_skip_verify: bool = False, timeout_s: float = 5.0):
        if not address:
            raise ValueError("Prometheus metric provider requires an address")
        self.address = address.rstrip("/")
        self.token = token
        self.insecure_skip_verify = insecure_skip_verify
        self.timeout_s = timeout_s

    def _query(self, promql: str) -> dict[str, float]:
        import urllib.parse

        payload = _authed_get(
            self.address,
            f"/api/v1/query?query={urllib.parse.quote(promql)}",
            self.token, self.insecure_skip_verify, self.timeout_s,
        )
        out: dict[str, float] = {}
        for result in (payload.get("data") or {}).get("result", []):
            instance = (result.get("metric") or {}).get("instance", "")
            # instance labels commonly carry the scrape port
            node = instance.split(":")[0]
            try:
                out[node] = float(result["value"][1])
            except (KeyError, IndexError, TypeError, ValueError):
                continue
        return out

    def fetch(self) -> dict[str, dict]:
        cpu = self._query(self.CPU_QUERY)
        mem = self._query(self.MEM_QUERY)
        out: dict[str, dict] = {}
        for node, value in cpu.items():
            out.setdefault(node, {}).update(
                {"cpu_avg": value, "cpu_tlp": value, "cpu_peaks": value}
            )
        for node, value in mem.items():
            out.setdefault(node, {})["mem_avg"] = value
        return out


_QUANTITY_SUFFIXES = {
    # decimal (incl. the sub-unit suffixes metrics-server emits: real
    # node CPU usage comes back in nanocores, e.g. "236786820n")
    "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "E": 10**18,
    # binary
    "Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40,
    "Pi": 1 << 50, "Ei": 1 << 60,
}


def parse_quantity_millis(text: str) -> int:
    """resource.Quantity string -> integer MILLI-units ("250m" -> 250,
    "2" -> 2000, "236786820n" -> 236, "1Gi" -> 1024^3 * 1000). Shared by
    cpu (millicores) and memory (millibytes — the caller divides
    percentages, so the scale cancels)."""
    text = str(text).strip()
    for suffix, mult in sorted(
        _QUANTITY_SUFFIXES.items(), key=lambda kv: -len(kv[0])
    ):
        if text.endswith(suffix):
            return int(float(text[: -len(suffix)]) * mult * 1000)
    return int(float(text) * 1000)


class KubernetesMetricsServerCollector:
    """Library-mode client for `MetricProvider.Type: KubernetesMetricsServer`
    — the in-process equivalent of load-watcher's metrics-server provider
    (upstream pkg/trimaran/collector.go:63-73 NewLibraryClient).

    Plain HTTP against the aggregated metrics API (no SDK):
    `GET /apis/metrics.k8s.io/v1beta1/nodes` for usage and
    `GET /api/v1/nodes` for capacity, both on the apiserver `address`;
    utilisation lands as Average percentages like the other providers."""

    METRICS_PATH = "/apis/metrics.k8s.io/v1beta1/nodes"
    NODES_PATH = "/api/v1/nodes"

    def __init__(self, address: str, token: str = "",
                 insecure_skip_verify: bool = False, timeout_s: float = 5.0):
        if not address:
            raise ValueError(
                "KubernetesMetricsServer metric provider requires an address"
            )
        self.address = address.rstrip("/")
        self.token = token
        self.insecure_skip_verify = insecure_skip_verify
        self.timeout_s = timeout_s

    def _get(self, path: str) -> dict:
        return _authed_get(self.address, path, self.token,
                           self.insecure_skip_verify, self.timeout_s)

    def fetch(self) -> dict[str, dict]:
        usage = {
            item["metadata"]["name"]: item.get("usage", {})
            for item in self._get(self.METRICS_PATH).get("items", [])
        }
        capacity = {}
        for item in self._get(self.NODES_PATH).get("items", []):
            status = item.get("status", {})
            capacity[item["metadata"]["name"]] = (
                status.get("capacity") or status.get("allocatable") or {}
            )
        out: dict[str, dict] = {}
        for node, use in usage.items():
            cap = capacity.get(node)
            if not cap:
                continue
            entry: dict = {}
            for res, keys in (
                ("cpu", ("cpu_avg", "cpu_tlp", "cpu_peaks")),
                ("memory", ("mem_avg",)),
            ):
                if res not in use or res not in cap:
                    continue
                cap_m = parse_quantity_millis(cap[res])
                if cap_m <= 0:
                    continue
                pct = 100.0 * parse_quantity_millis(use[res]) / cap_m
                for key in keys:
                    entry[key] = pct
            if entry:
                out[node] = entry
        return out


class SignalFxCollector:
    """Library-mode client for `MetricProvider.Type: SignalFx` — the
    in-process equivalent of load-watcher's SignalFx provider selected by
    the reference's collector (upstream pkg/trimaran/collector.go:
    63-73 NewLibraryClient; type constant apis/config/types.go:77).

    Plain HTTP against the SignalFx REST API (no SDK, same pattern as the
    Prometheus / metrics-server clients):

    - `GET /v1/timeserieswindow?query=sf_metric:"cpu.utilization"` (and
      `memory.utilization`) with `X-SF-TOKEN` auth pulls the last window of
      samples for every reporting time series;
    - time-series ids resolve to their `host` dimension via ONE bulk
      metadata query per metric (`GET /v2/metrictimeseries?query=...`),
      falling back to per-tsid lookups only for ids the bulk result missed;
      the tsid->host map is cached across fetches (tsids are stable, so
      steady-state fetches cost two requests total).

    Window samples average into an Average-operator percentage like the
    other providers (cpu/memory utilization metrics are already percent of
    capacity)."""

    TIMESERIES_PATH = "/v1/timeserieswindow"
    METADATA_PATH = "/v2/metrictimeseries/"
    CPU_METRIC = "cpu.utilization"
    MEM_METRIC = "memory.utilization"
    WINDOW_MS = 10 * 60 * 1000

    def __init__(self, address: str, token: str = "",
                 insecure_skip_verify: bool = False, timeout_s: float = 5.0):
        if not address:
            raise ValueError("SignalFx metric provider requires an address")
        self.address = address.rstrip("/")
        self.token = token
        self.insecure_skip_verify = insecure_skip_verify
        self.timeout_s = timeout_s
        self._tsid_host: dict[str, str] = {}
        self.last_error: Optional[str] = None

    def _get(self, path_and_query: str) -> dict:
        """SignalFx auth rides the X-SF-TOKEN header, not a Bearer token."""
        return _authed_get(
            self.address, path_and_query, self.token,
            self.insecure_skip_verify, self.timeout_s,
            auth_header="X-SF-TOKEN", auth_prefix="",
        )

    def _warn_once(self, message: str) -> None:
        """Record the FIRST metadata-resolution failure of the current fetch
        in `last_error` and emit one warning for it; repeats within the same
        fetch are counted by the caller retrying next fetch, not re-warned
        (a bad address/token would otherwise flood — or, before this hook
        existed, read as silently-empty metrics)."""
        if self.last_error is None:
            import warnings

            warnings.warn(f"SignalFx collector: {message}", stacklevel=3)
        self.last_error = message

    @staticmethod
    def _meta_host(meta: dict) -> str:
        return str((meta.get("dimensions") or {}).get("host", "")
                   or meta.get("host", ""))

    def _resolve_hosts(self, tsids, metric: str) -> None:
        """Fill the tsid->host cache for any unresolved ids: one bulk
        metadata query for the metric, then per-tsid fallback for stragglers
        (avoids N serial lookups on a cold cache)."""
        import urllib.parse

        missing = [t for t in tsids if t not in self._tsid_host]
        if not missing:
            return
        query = urllib.parse.quote(f'sf_metric:"{metric}"')
        try:
            bulk = self._get(
                f"{self.METADATA_PATH.rstrip('/')}?query={query}"
                f"&limit={max(len(missing) * 2, 1000)}"
            )
            for item in bulk.get("results", []):
                tsid = str(item.get("id", ""))
                host = self._meta_host(item)
                # only cache RESOLVED hosts: a series whose metadata has no
                # host dimension yet (indexing lag) must retry next fetch,
                # not be suppressed forever
                if tsid and host:
                    self._tsid_host[tsid] = host
        except Exception as exc:
            # fall through to per-tsid lookups, but surface the failure: a
            # bad address/token would otherwise read as silently-empty
            # metrics (warn once per fetch, not once per tsid)
            self._warn_once(f"bulk metadata query failed: {exc!r}")
        for tsid in missing:
            if tsid in self._tsid_host:
                continue
            try:
                meta = self._get(self.METADATA_PATH + tsid)
            except Exception as exc:
                self._warn_once(f"metadata lookup for tsid {tsid} failed: "
                                f"{exc!r}")
                continue  # transient: retry next fetch, don't cache
            host = self._meta_host(meta)
            if host:
                self._tsid_host[tsid] = host

    def _metric_by_host(self, metric: str) -> dict[str, float]:
        import time as _time
        import urllib.parse

        end_ms = int(_time.time() * 1000)
        query = urllib.parse.quote(f'sf_metric:"{metric}"')
        payload = self._get(
            f"{self.TIMESERIES_PATH}?query={query}"
            f"&startMs={end_ms - self.WINDOW_MS}&endMs={end_ms}"
        )
        series = {
            tsid: [
                float(point[1]) for point in samples
                if isinstance(point, (list, tuple)) and len(point) >= 2
            ]
            for tsid, samples in (payload.get("data") or {}).items()
        }
        self._resolve_hosts([t for t, v in series.items() if v], metric)
        # multiple tsids can resolve to one host (agent restart leaves the
        # old and new series both inside the window) — pool their samples
        by_host: dict[str, list] = {}
        for tsid, values in series.items():
            if not values:
                continue
            host = self._tsid_host.get(tsid)
            if host:
                by_host.setdefault(host, []).extend(values)
        return {
            host: sum(values) / len(values)
            for host, values in by_host.items()
        }

    def fetch(self) -> dict[str, dict]:
        self.last_error = None
        cpu = self._metric_by_host(self.CPU_METRIC)
        mem = self._metric_by_host(self.MEM_METRIC)
        out: dict[str, dict] = {}
        for node, value in cpu.items():
            out.setdefault(node, {}).update(
                {"cpu_avg": value, "cpu_tlp": value, "cpu_peaks": value}
            )
        for node, value in mem.items():
            out.setdefault(node, {})["mem_avg"] = value
        return out


def make_metrics_client(watcher_address: Optional[str] = None,
                        metric_provider: Optional[dict] = None):
    """collector.go:60-73: a WatcherAddress selects the remote service
    client; otherwise the MetricProviderSpec selects an in-process library
    client (Prometheus, KubernetesMetricsServer and SignalFx all bundled as
    plain-HTTP clients)."""
    if watcher_address:
        return LoadWatcherCollector(watcher_address)
    mp = metric_provider or {}
    mtype = mp.get("type", "KubernetesMetricsServer")
    if mtype not in METRIC_PROVIDER_TYPES:
        raise ValueError(f"invalid metric provider type {mtype!r}")
    cls = {
        "Prometheus": PrometheusCollector,
        "KubernetesMetricsServer": KubernetesMetricsServerCollector,
        "SignalFx": SignalFxCollector,
    }[mtype]
    return cls(
        mp.get("address", ""),
        token=mp.get("token", ""),
        insecure_skip_verify=bool(mp.get("insecureSkipVerify", False)),
    )
