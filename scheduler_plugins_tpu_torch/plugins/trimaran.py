"""Trimaran, the load-aware Score plugin family (port of
`scheduler_plugins_tpu.plugins.trimaran`).

Upstream pkg/trimaran (a shared Collector, handler and resourcestats)
with four Score-only plugins: TargetLoadPacking,
LoadVariationRiskBalancing, LowRiskOverCommitment and Peaks.

The metrics path: load-watcher percentages land in the snapshot's
`MetricsState` (the store ingests them; the reference's 30 s collector
goroutine is the cycle's collector tick, `state.collector`), the
ScheduledPodsCache compensation is the per-node `missing_cpu_millis`
column, and each plugin's body is one curve of `ops.trimaran` over the
nodes, reading the pod's values through one-element slices.

Defaults (apis/config/v1/defaults.go:49-106): TLP target 40 %, request
multiplier 1.5, default request 1000m; LVRB margin 1, sensitivity 1;
LROC smoothing window 5, risk-limit weight 0.5 each.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import CPU
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops import CPU_I, MEMORY_I
from scheduler_plugins_tpu_torch.ops.normalize import peaks_normalize
from scheduler_plugins_tpu_torch.ops.trimaran import (
    lroc_score,
    lvrb_score,
    lvrb_score_batch,
    peaks_score,
    tlp_score,
    tlp_score_batch,
)
from scheduler_plugins_tpu_torch.state.collector import METRIC_PROVIDER_TYPES


def _validate_metric_provider(metric_provider: Optional[dict]):
    """MetricProviderSpec surface check (apis/config/types.go:73-110,
    validation_pluginargs.go ValidateTargetLoadPackingArgs): a config this
    build cannot honor fails at construction, not in `run_cycle`."""
    if metric_provider is None:
        return None
    mtype = metric_provider.get("type", "KubernetesMetricsServer")
    if mtype not in METRIC_PROVIDER_TYPES:
        raise ValueError(f"invalid metric provider type {mtype!r}")
    if mtype == "SignalFx":
        raise ValueError(
            f"metric provider type {mtype!r} needs an external SDK this "
            "build does not bundle; configure watcherAddress, Prometheus "
            "or KubernetesMetricsServer"
        )
    if not metric_provider.get("address"):
        raise ValueError(f"{mtype} metric provider requires an address")
    return dict(metric_provider)


class TargetLoadPacking(Plugin):
    """Best-fit bin packing around a target CPU utilisation
    (targetloadpacking.go:107-205)."""

    name = "TargetLoadPacking"

    def __init__(self, target_utilization_percent: int = 40,
                 watcher_address: Optional[str] = None,
                 metric_provider: Optional[dict] = None,
                 default_requests: Optional[dict] = None,
                 default_requests_multiplier="1.5"):
        if not 0 < target_utilization_percent <= 100:
            raise ValueError("target utilization must be in (0, 100]")
        self.target = float(target_utilization_percent)
        #: TrimaranSpec WatcherAddress: when set, the cycle polls this
        #: load-watcher endpoint on the collector cadence and installs the
        #: metrics into the store
        self.watcher_address = watcher_address
        #: TrimaranSpec MetricProvider: the library-mode client when no
        #: WatcherAddress is set (collector.go:60-73)
        self.metric_provider = _validate_metric_provider(metric_provider)
        #: DefaultRequests / DefaultRequestsMultiplier (defaults.go:76-90:
        #: 1000m cpu, "1.5"; the multiplier must parse as a float >= 1)
        reqs = dict(default_requests) if default_requests else {CPU: 1000}
        self.default_request_cpu_millis = int(reqs.get(CPU, 1000))
        try:
            self.default_requests_multiplier = float(
                default_requests_multiplier)
        except (TypeError, ValueError):
            raise ValueError(
                f"invalid defaultRequestsMultiplier "
                f"{default_requests_multiplier!r}"
            ) from None
        if self.default_requests_multiplier < 1:
            raise ValueError("defaultRequestsMultiplier must be >= 1")

    def configure_cluster(self, cluster):
        """Install this plugin's pod CPU-prediction parameters on the
        store: the snapshot and the missing-utilization compensation
        lower `tlp_predicted_cpu_millis` with them."""
        if cluster is not None:
            cluster.tlp_prediction = (
                self.default_requests_multiplier,
                self.default_request_cpu_millis,
            )

    def score(self, state, snap, p):
        if snap.metrics is None:
            return None
        return tlp_score(
            snap.metrics.cpu_tlp,
            snap.metrics.cpu_tlp_valid,
            snap.metrics.missing_cpu_millis,
            snap.nodes.capacity[:, CPU_I],
            snap.pods.predicted_cpu_millis[p:p + 1],
            self.target,
        )

    def score_batch(self, state, snap):
        """The batched curve (float32 broadcast stage: a score may be 1 off
        the per-pod path at a knife edge, see `ops.trimaran`)."""
        if snap.metrics is None:
            return None
        return tlp_score_batch(
            snap.metrics.cpu_tlp,
            snap.metrics.cpu_tlp_valid,
            snap.metrics.missing_cpu_millis,
            snap.nodes.capacity[:, CPU_I],
            snap.pods.predicted_cpu_millis,
            self.target,
        )


class LoadVariationRiskBalancing(Plugin):
    """Risk = (mu + margin * sigma^(1/sensitivity)) / 2 over cpu and memory
    (analysis.go:34-69)."""

    name = "LoadVariationRiskBalancing"

    def __init__(self, safe_variance_margin: float = 1.0,
                 safe_variance_sensitivity: float = 1.0,
                 watcher_address: Optional[str] = None,
                 metric_provider: Optional[dict] = None):
        if safe_variance_margin < 0 or safe_variance_sensitivity < 0:
            raise ValueError("margin/sensitivity must be non-negative")
        self.margin = safe_variance_margin
        self.sensitivity = safe_variance_sensitivity
        self.watcher_address = watcher_address
        self.metric_provider = _validate_metric_provider(metric_provider)

    def score(self, state, snap, p):
        if snap.metrics is None:
            return None
        # LVRB reads node allocatable as capacity (resourcestats.go:56-66)
        return lvrb_score(
            snap.metrics,
            snap.nodes.alloc[:, CPU_I],
            snap.nodes.alloc[:, MEMORY_I],
            snap.pods.req[p:p + 1, CPU_I],
            snap.pods.req[p:p + 1, MEMORY_I],
            self.margin,
            self.sensitivity,
        )

    def score_batch(self, state, snap):
        """The batched risk curve (float32 broadcast stage, as
        `TargetLoadPacking.score_batch`)."""
        if snap.metrics is None:
            return None
        return lvrb_score_batch(
            snap.metrics,
            snap.nodes.alloc[:, CPU_I],
            snap.nodes.alloc[:, MEMORY_I],
            snap.pods.req[:, CPU_I],
            snap.pods.req[:, MEMORY_I],
            self.margin,
            self.sensitivity,
        )


class LowRiskOverCommitment(Plugin):
    """Weighted overcommit potential plus measured overuse risk
    (lowriskovercommitment.go:157-256)."""

    name = "LowRiskOverCommitment"

    def __init__(self, smoothing_window_size: int = 5,
                 risk_limit_weights: Optional[Mapping[str, float]] = None,
                 watcher_address: Optional[str] = None,
                 metric_provider: Optional[dict] = None):
        self.smoothing_window = smoothing_window_size
        self.watcher_address = watcher_address
        self.metric_provider = _validate_metric_provider(metric_provider)
        weights = dict(risk_limit_weights or {})
        self.w_cpu = weights.get("cpu", 0.5)
        self.w_mem = weights.get("memory", 0.5)

    def score(self, state, snap, p):
        if snap.metrics is None:
            return None
        pods = snap.pods
        req_cpu = pods.req[p:p + 1, CPU_I]
        req_mem = pods.req[p:p + 1, MEMORY_I]
        lim_cpu = pods.limits[p:p + 1, CPU_I]
        lim_mem = pods.limits[p:p + 1, MEMORY_I]
        raw = lroc_score(
            snap.metrics,
            snap.nodes.alloc[:, CPU_I],
            snap.nodes.alloc[:, MEMORY_I],
            snap.nodes.requested[:, CPU_I],
            snap.nodes.requested[:, MEMORY_I],
            snap.nodes.limits[:, CPU_I],
            snap.nodes.limits[:, MEMORY_I],
            req_cpu, req_mem, lim_cpu, lim_mem,
            self.smoothing_window,
            self.w_cpu,
            self.w_mem,
        )
        # best-effort pods are not scored (lowriskovercommitment.go:
        # 122-129); nodes with no metrics at all score the minimum, but
        # partial (memory-only or cpu-only) metrics still rank
        best_effort = ((req_cpu == 0) & (req_mem == 0) & (lim_cpu == 0)
                       & (lim_mem == 0))
        no_metrics = ~(snap.metrics.cpu_valid | snap.metrics.mem_valid)
        return torch.where(best_effort | no_metrics, 0, raw)


class Peaks(Plugin):
    """Power-aware packing: minimize the cluster's power jump,
    Power = K0 + K1 * e^(K2 * util) (peaks.go:103-196, PeaksArgs power
    model apis/config/types.go:287-307)."""

    name = "Peaks"

    def __init__(self, node_power_model: Optional[Mapping[str, tuple]] = None,
                 watcher_address: Optional[str] = None,
                 metric_provider: Optional[dict] = None):
        self.watcher_address = watcher_address
        self.metric_provider = _validate_metric_provider(metric_provider)
        #: node name -> (K0, K1, K2); other nodes get (0, 0, 0). Without a
        #: model in the args, the NODE_POWER_MODEL environment variable
        #: names a JSON file {node: {"K0": ..., "K1": ..., "K2": ...}}
        #: (peaks.go:59-74)
        self.node_power_model = dict(node_power_model or {})
        if not self.node_power_model:
            self.node_power_model = self._load_env_model()
        self._k1 = None
        self._k2 = None

    @staticmethod
    def _load_env_model() -> dict:
        import json
        import os

        path = os.environ.get("NODE_POWER_MODEL")
        if not path:
            return {}
        # the reference fails plugin creation on read AND decode errors
        # (peaks.go:59-74)
        try:
            with open(path) as f:
                raw = json.load(f)
            return {
                node: (
                    float(model.get("K0", 0.0)),
                    float(model.get("K1", 0.0)),
                    float(model.get("K2", 0.0)),
                )
                for node, model in raw.items()
            }
        except (OSError, ValueError, TypeError, AttributeError) as exc:
            raise ValueError(
                f"invalid NODE_POWER_MODEL file {path!r}: {exc}"
            ) from exc

    def prepare(self, meta):
        """(n,) float64 K1 and K2 rows by node, on `meta.device`."""
        n = len(meta.node_names)
        k1 = np.zeros(max(n, 1), np.float64)
        k2 = np.zeros(max(n, 1), np.float64)
        for i, name in enumerate(meta.node_names):
            model = self.node_power_model.get(name)
            if model is not None:
                k1[i], k2[i] = float(model[1]), float(model[2])
        self._k1 = torch.tensor(k1, device=meta.device)
        self._k2 = torch.tensor(k2, device=meta.device)

    def aux(self):
        return (self._k1, self._k2)

    def bind_aux(self, aux):
        self._k1, self._k2 = aux

    def _padded(self, snap):
        """K1 and K2 zero-padded to the snapshot's N node rows, on its
        device (device work only)."""
        N = snap.num_nodes
        out = []
        for k in (self._k1, self._k2):
            row = torch.zeros(N, dtype=torch.float64, device=snap.device)
            row[:k.shape[0]] = k.to(snap.device)
            out.append(row)
        return tuple(out)

    def prepare_solve(self, snap):
        if snap.metrics is None or self._k1 is None:
            return None
        return self._padded(snap)

    def score(self, state, snap, p):
        if snap.metrics is None or self._k1 is None:
            return None
        k1, k2 = self._presolve or self._padded(snap)
        # Peaks needs an Average/Latest CPU sample and takes the FIRST in
        # report order (peaks.go:118-131): cpu_valid alone is satisfied by
        # a std-only report
        return peaks_score(
            snap.metrics.cpu_peaks,
            snap.metrics.cpu_tlp_valid,
            snap.nodes.capacity[:, CPU_I],
            snap.pods.req[p:p + 1, CPU_I],
            k1,
            k2,
        )

    def normalize(self, scores, feasible):
        # the lowest power jump wins (peaks.go:152-168)
        return peaks_normalize(scores, feasible)
