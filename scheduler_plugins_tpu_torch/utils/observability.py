"""Observability (port of `scheduler_plugins_tpu.utils.observability`):
flow logging, metrics with histograms, and a cycle tracer.

- contextual leveled logging with FlowBegin/FlowEnd markers, subsystem names
  and a cache GENERATION attached to every line, so a scheduling decision can
  be correlated with the resync that produced its data (upstream
  noderesourcetopology logging.go:30-56);
- prometheus-style counters, gauges and fixed-bucket histograms with
  labels (plugin execution latency per extension point, unschedulable
  attribution, the serving engine's gauges), rendered in the prometheus
  text format by `Metrics.prometheus_text`. The names, HELP lines and
  rendering are the JAX module's, byte for byte, so both packages'
  registries scrape alike;
- a `Tracer` recording host-side spans as Chrome-trace-event / Perfetto
  JSON ("traceEvents" with X complete events and M thread-name metadata),
  so one scheduling cycle or one chunk-pipeline run loads as a timeline in
  ui.perfetto.dev, and counters where a span per call would cost too
  much. Spans bracket host sync points only; device time comes from CUDA
  events or the profiler, never from a span. The export carries the
  profiler's clock at the tracer's origin, so the spans lay over a
  `torch.profiler` trace of the same run.

Everything here is host-side and cheap: the tracer is off by default, and
a disabled span or counter returns before taking a timestamp. The JAX
module's compile watch (`CompileWatch`, `compile_watch`) and its two
metric families have no counterpart: eager PyTorch keeps no jit cache.
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import threading
import time
from contextlib import contextmanager, nullcontext

logger = logging.getLogger("scheduler_plugins_tpu_torch")

FLOW_BEGIN = "FlowBegin"
FLOW_END = "FlowEnd"

#: fixed histogram buckets in milliseconds (upper bounds; +Inf implicit) —
#: the upstream scheduler-latency bucket ladder, in ms instead of seconds
HIST_BUCKETS_MS = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)


def _label_items(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _render_labels(items) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + inner + "}"


def atomic_write(path: str, data) -> None:
    """Write `data` (str or bytes) to `path` via a same-directory temp file
    + `os.replace`, fsync'd first — the crash-safe write discipline shared
    by `Tracer.write` and the flight-recorder bundle writers
    (utils.flightrec): a process killed mid-write leaves at worst a stray
    `.tmp.*` file, never a truncated artifact under the real name."""
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _Histogram:
    __slots__ = ("counts", "sum", "count", "max")

    def __init__(self):
        self.counts = [0] * (len(HIST_BUCKETS_MS) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, ms: float) -> None:
        self.counts[bisect.bisect_left(HIST_BUCKETS_MS, ms)] += 1
        self.sum += ms
        self.count += 1
        if ms > self.max:
            self.max = ms


class Metrics:
    """Process-wide scheduling counters + histograms (the scheduler_perf
    surface). Counters and histograms accept prometheus-style labels as
    keyword args: `metrics.inc(UNSCHEDULABLE_BY_PLUGIN, plugin="Coscheduling")`.

    `observe_ms` keeps the legacy `<name>_ms_total` / `<name>_count` /
    `<name>_ms_max` counter keys for UNLABELED names (existing tests and
    panels read them) while also feeding a fixed-bucket histogram
    (`HIST_BUCKETS_MS`) that `prometheus_text` renders as
    `_bucket{le=...}` / `_sum` / `_count` series."""

    def __init__(self):
        # (name, sorted label items) -> value; single source of truth
        self._counters: dict[tuple[str, tuple], int] = {}
        self._hists: dict[tuple[str, tuple], _Histogram] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, value: int = 1, **labels) -> None:
        key = (name, _label_items(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name: str, value, **labels) -> None:
        """Gauge semantics: last write wins (e.g. resident-state
        generation/staleness). Rendered as `# TYPE ... gauge` by
        `prometheus_text` — gauge names must not end in `_total`/`_count`
        (those suffixes type as counters)."""
        key = (name, _label_items(labels))
        with self._lock:
            self._counters[key] = value

    def _set_max(self, name: str, value: int, items: tuple = ()) -> None:
        key = (name, items)
        if value > self._counters.get(key, 0):
            self._counters[key] = value

    def observe_ms(self, name: str, ms: float, **labels) -> None:
        """Duration observation: fixed-bucket histogram plus (for unlabeled
        names) the legacy `_ms_total`/`_count`/`_ms_max` summary counters."""
        items = _label_items(labels)
        key = (name, items)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Histogram()
            hist.observe(ms)
            if not items:
                ms_int = int(ms)
                self._counters[(f"{name}_ms_total", ())] = (
                    self._counters.get((f"{name}_ms_total", ()), 0) + ms_int
                )
                self._counters[(f"{name}_count", ())] = (
                    self._counters.get((f"{name}_count", ()), 0) + 1
                )
                self._set_max(f"{name}_ms_max", ms_int)

    def observe_batch(self, observations) -> None:
        """Histogram-only batch feed under ONE lock acquisition:
        `observations` is an iterable of (name, value, items) with
        `items` pre-sorted label tuples (as `_label_items` returns).
        No legacy `_ms_total` mirrors — this path exists for hot
        per-pod feeds (the lifecycle ledger's bind-time SLI fan-out)
        where per-call lock round-trips and kwargs packing dominate,
        and for values that are not durations at all (attempt counts)."""
        with self._lock:
            for name, value, items in observations:
                key = (name, items)
                hist = self._hists.get(key)
                if hist is None:
                    hist = self._hists[key] = _Histogram()
                hist.observe(value)

    def get(self, name: str, **labels) -> int:
        return self._counters.get((name, _label_items(labels)), 0)

    def snapshot(self) -> dict[str, int]:
        """Flat debug map: rendered `name{k="v"}` keys -> counter values."""
        with self._lock:
            return {
                f"{name}{_render_labels(items)}": value
                for (name, items), value in self._counters.items()
            }

    def histograms(self) -> dict[str, dict]:
        """Rendered-key -> {buckets, counts, sum, count, max} debug view."""
        with self._lock:
            return {
                f"{name}{_render_labels(items)}": {
                    "buckets": list(HIST_BUCKETS_MS),
                    "counts": list(h.counts),
                    "sum": h.sum,
                    "count": h.count,
                    "max": h.max,
                }
                for (name, items), h in self._hists.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()

    def scoped(self) -> "ScopedMetrics":
        """A snapshot/diff view: reads return counts accumulated SINCE
        this call. Arm-vs-arm benches read per-arm deltas through one of
        these instead of the process-global totals."""
        return ScopedMetrics(self)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4: `# HELP` + `# TYPE`
        per family, counters as counters, histograms as cumulative
        `_bucket{le=...}` + `_sum` + `_count`.
        The legacy `<name>_count` summary counter `observe_ms` keeps for
        unlabeled names is the SAME sample the histogram's `_count` child
        renders — it is skipped here (the JSON snapshot still carries it)
        so a scrape never contains duplicate samples."""
        with self._lock:
            counters = sorted(self._counters.items())
            hists = sorted(self._hists.items(), key=lambda kv: kv[0])
        hist_count_names = {f"{name}_count" for (name, _), _h in hists}
        lines: list[str] = []
        typed: set[str] = set()

        def _head(name: str, kind: str) -> None:
            text = HELP.get(name, f"{name} (scheduler-plugins-tpu)")
            text = text.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {name} {text}")
            lines.append(f"# TYPE {name} {kind}")

        for (name, items), value in counters:
            if name in hist_count_names:
                continue  # rendered as the histogram's _count child below
            if name not in typed:
                typed.add(name)
                kind = "counter" if name.endswith(("_total", "_count")) else "gauge"
                _head(name, kind)
            lines.append(f"{name}{_render_labels(items)} {value}")
        for (name, items), hist in hists:
            if name not in typed:
                typed.add(name)
                _head(name, "histogram")
            cumulative = 0
            for bound, count in zip(HIST_BUCKETS_MS, hist.counts):
                cumulative += count
                le = _render_labels(items + (("le", f"{bound:g}"),))
                lines.append(f"{name}_bucket{le} {cumulative}")
            le = _render_labels(items + (("le", "+Inf"),))
            lines.append(f"{name}_bucket{le} {hist.count}")
            lines.append(f"{name}_sum{_render_labels(items)} {hist.sum:g}")
            lines.append(f"{name}_count{_render_labels(items)} {hist.count}")
        return "\n".join(lines) + "\n"


class ScopedMetrics:
    """Delta view over a `Metrics` registry: every read subtracts the
    counter/histogram state captured at construction, so two interleaved
    bench arms sharing the process-global registry each see only their
    own increments. Reads are as cheap as the underlying `get` — the
    base is a plain dict snapshot, never re-captured."""

    def __init__(self, metrics: Metrics):
        self._m = metrics
        with metrics._lock:
            self._base = dict(metrics._counters)
            self._hbase = {
                key: (h.count, h.sum)
                for key, h in metrics._hists.items()
            }

    def get(self, name: str, **labels) -> int:
        key = (name, _label_items(labels))
        return self._m._counters.get(key, 0) - self._base.get(key, 0)

    def hist_count(self, name: str, **labels) -> int:
        key = (name, _label_items(labels))
        h = self._m._hists.get(key)
        base = self._hbase.get(key, (0, 0.0))[0]
        return (h.count if h is not None else 0) - base

    def hist_sum(self, name: str, **labels) -> float:
        key = (name, _label_items(labels))
        h = self._m._hists.get(key)
        base = self._hbase.get(key, (0, 0.0))[1]
        return (h.sum if h is not None else 0.0) - base

    def delta(self) -> dict[str, int]:
        """Rendered-key -> delta for every counter that moved since the
        scope opened (the flat `snapshot()` shape, diffed)."""
        with self._m._lock:
            cur = dict(self._m._counters)
        out = {}
        for (name, items), value in cur.items():
            d = value - self._base.get((name, items), 0)
            if d:
                out[f"{name}{_render_labels(items)}"] = d
        return out


#: global registry, like the upstream prometheus default registry
metrics = Metrics()

# counter names (prometheus-style)
SCHEDULING_CYCLES = "scheduler_scheduling_cycles_total"
PODS_BOUND = "scheduler_pods_bound_total"
PODS_FAILED = "scheduler_pods_unschedulable_total"
PREEMPTION_ATTEMPTS = "scheduler_preemption_attempts_total"
PREEMPTION_VICTIMS = "scheduler_preemption_victims_total"
GANG_REJECTIONS = "scheduler_gang_rejections_total"
CACHE_RESYNC_FLUSHES = "scheduler_nrt_cache_flushes_total"
#: per-plugin attribution (labels: plugin) — the upstream
#: `UnschedulablePlugins` signal: which plugin made each pod unschedulable
UNSCHEDULABLE_BY_PLUGIN = "scheduler_unschedulable_by_plugin_total"
#: per-plugin, per-extension-point latency histogram (labels: plugin,
#: extension_point) — the upstream plugin_execution_duration_seconds shape
PLUGIN_EXECUTION = "scheduler_plugin_execution_ms"
#: cycles captured by the flight recorder (utils.flightrec)
FLIGHTREC_CYCLES = "scheduler_flightrec_cycles_total"
#: serve-mode decision latency histogram: wall ms from delta ingest to
#: host-visible bind decisions for one resident-state cycle
#: (framework.cycle.run_cycle(serve=...))
SERVE_DECISION_LATENCY = "scheduler_serve_decision_latency_ms"
#: gauge: resident-state generation (monotonic per applied delta batch /
#: rebase; serving.engine.ServeEngine)
SERVE_GENERATION = "scheduler_serve_state_generation"
#: gauge: delta events applied since the resident base was last rebuilt —
#: how long the replay chain from the base snapshot has grown
SERVE_STALENESS = "scheduler_serve_state_staleness_events"
#: gauge: delta events drained at the START of the current refresh (queue
#: depth the engine saw — sustained growth means ingest is falling behind)
SERVE_PENDING_DELTAS = "scheduler_serve_pending_deltas"
#: full re-snapshots the serving engine performed (node deletes, label
#: re-interning, extended resources)
SERVE_REBASES = "scheduler_serve_rebases_total"
#: serve refreshes that fell back to the full snapshot while the cluster
#: carried PodGroups. Gang/quota rosters serve from the resident side
#: tables, so on a compatible gang roster this stays 0
SERVE_GANG_FALLBACKS = "scheduler_serve_gang_fallbacks_total"
#: gauge (labels: objective): the latest cycle's placement-quality
#: objective values (tuning.quality — fragmentation, util_imbalance,
#: gang_wait_frac, unplaced_frac, preemptions, nominations), stamped by
#: `framework.cycle.run_cycle` on every solved cycle
PLACEMENT_QUALITY = "scheduler_placement_quality"
#: gauge: 1 while the process serves from the host-side parity solve
#: because the device backend failed past the watchdog's retry budget
#: (resilience.watchdog.Resilience); 0 on the fast path. Also surfaced
#: as `degraded` on the daemon's /healthz and every chaos bench line
DEGRADED = "scheduler_degraded"
#: watchdog retry attempts that failed (labels: label=solve|probe) —
#: each is one timeout/device-error/garbage-output before backoff
SOLVE_RETRIES = "scheduler_solve_retries_total"
#: fast-path -> degraded transitions (retry budget exhausted)
SOLVE_FAILOVERS = "scheduler_solve_failovers_total"
#: probation probes dispatched while degraded (successful ones restore
#: the fast path; `scheduler_degraded` returning to 0 is the signal)
PROBATION_PROBES = "scheduler_probation_probes_total"
#: watchdog workers orphaned inside a hung backend call (they cannot be
#: interrupted, only abandoned — a flapping backend shows up here)
SOLVE_WORKERS_ABANDONED = "scheduler_solve_workers_abandoned_total"
#: live threads whose names match no entry of the committed concurrency
#: manifest (docs/race_audit.json, tools/race_audit.py): a thread the
#: static lockset analysis never modeled — audited code but unaudited
#: topology. Counted per /healthz probe sighting.
THREAD_TOPOLOGY_DRIFT = "scheduler_thread_topology_drift_total"
#: anti-entropy digest checks of the resident serve state vs a freshly
#: built snapshot (serving.engine.ServeEngine.verify)
ANTIENTROPY_CHECKS = "scheduler_serve_antientropy_checks_total"
#: anti-entropy divergences detected (each forces a rebase — a corrupted
#: or dropped delta can poison at most one verification window)
ANTIENTROPY_DIVERGENCE = "scheduler_serve_antientropy_divergence_total"
#: unschedulable pods currently parked in a requeue backoff window
#: (upstream backoffQ semantics; framework.cycle._requeue_eligible)
REQUEUE_BACKOFF_SKIPS = "scheduler_requeue_backoff_skips_total"
#: fraction of the in-flight device-solve envelope the pipelined cycle
#: engine covered with useful host work (framework.pipeline_cycle;
#: 1.0 = the fence never waited on the device)
CYCLE_OVERLAP_EFFICIENCY = "scheduler_cycle_overlap_efficiency"
#: wall-clock ms the pipelined engine's fence idled waiting on the
#: in-flight device solve after the overlap work ran dry — the
#: per-cycle pipeline bubble the overlap exists to eliminate
CYCLE_PIPELINE_BUBBLE = "scheduler_cycle_pipeline_bubble_ms"
#: binds flushed by the pipelined engine's async flusher that landed
#: AFTER a later cycle's ingest boundary — each one reached the resident
#: serving state as an ordinary DeltaSink delta (the conflict-fence
#: taxonomy, docs/SERVING.md)
CYCLE_LATE_BINDS = "scheduler_cycle_late_binds_total"
#: live weight promotions applied by the online shadow tuner
#: (tuning.shadow.ShadowTuner — gated through the tuning.promotion
#: oracles, rolled out via the aux channel with zero recompiles)
TUNER_PROMOTIONS = "scheduler_tuner_promotions_total"
#: probation auto-rollbacks (quality-gauge regression or watchdog fault
#: within the probation window — the guarded-rollout guarantee)
TUNER_ROLLBACKS = "scheduler_tuner_rollbacks_total"
#: shadow-lane sweep evaluations completed (each one replays the ring
#: corpus under K candidate weight vectors off the cycle thread)
TUNER_SWEEPS = "scheduler_tuner_sweeps_total"
#: shadow-lane faults: sweep failures (deadline expiry, worker error)
#: AND promotion-apply crashes — every one degraded to "no tuning" with
#: the incumbent weights kept; repeated consecutive faults disable the
#: tuner (one counter on purpose: it feeds the one self-disable budget)
TUNER_SWEEP_FAILURES = "scheduler_tuner_sweep_failures_total"
#: gauge: the active per-plugin weight vector's content digest as an
#: integer (the first 48 bits of `tuning.promotion.weights_digest`,
#: exact in float64) — two processes serving the same promoted profile
#: show the same value; the hex string rides /healthz
TUNER_ACTIVE_WEIGHTS = "scheduler_tuner_active_weights_digest"
#: gauge: tuner controller state (0 idle, 1 probation, 2 cooldown,
#: 3 disabled)
TUNER_STATE = "scheduler_tuner_state"
#: conflict-fence rejections per lane (parallel.lanes.LaneSolver): pod p
#: of lane j failed the speculative-vs-committed step-signature check —
#: the whole remaining suffix re-resolves against committed state
LANE_CONFLICTS = "scheduler_lane_conflicts_total"
#: wall-clock ms of the host conflict fence per laned cycle (serial-order
#: validation walk + wait recomputation + any suffix repair dispatch)
LANE_COMMIT = "scheduler_lane_commit_ms"
#: pods re-resolved against committed state by the suffix repair solve
LANE_RERESOLVES = "scheduler_lane_reresolves_total"
#: laned cycles that fell back to the sequential parity solve because the
#: fence-exact gate rejected the profile/snapshot (side tables armed,
#: preemption nominees present, or an admit plugin without a host twin)
LANE_SERIAL_FALLBACKS = "scheduler_lane_serial_fallbacks_total"
#: per-pod e2e scheduling latency histogram (labels: priority) — the
#: upstream `scheduler_e2e_scheduling_duration_seconds` family in ms
#: (vendored registration: cmd/scheduler/main.go:23-24), fed by the
#: pod-lifecycle ledger (obs.ledger) when a pod retires bound
E2E_SCHEDULING_MS = "scheduler_e2e_scheduling_duration_ms"
#: scheduling attempts per successfully-scheduled pod (histogram) — the
#: upstream `scheduler_pod_scheduling_attempts` family
POD_SCHEDULING_ATTEMPTS = "scheduler_pod_scheduling_attempts"
#: per-stage share of the e2e latency (labels: stage ∈ obs.ledger.STAGES)
#: — the upstream `scheduler_pod_scheduling_sli_duration_seconds` shape,
#: decomposed into queue-wait / backoff-held / gang-wait / solve / fence /
#: bind-flush buckets that provably sum to e2e per pod
POD_SCHEDULING_SLI_MS = "scheduler_pod_scheduling_sli_duration_ms"
#: gauge: device-memory bytes currently allocated across local devices
#: (backend allocator stats, summed; absent on backends without stats —
#: the CPU fallback — so the gauge simply never appears there). Stamped
#: once per cycle by the daemon via obs.memory.stamp_device_memory.
DEVICE_BYTES_IN_USE = "scheduler_device_bytes_in_use"
#: gauge: device-memory high-water mark across local devices (allocator
#: peak_bytes_in_use, summed) — the runtime companion of the STATIC peak
#: in docs/cost_model.json: the committed manifest predicts, this gauge
#: measures
DEVICE_PEAK_BYTES = "scheduler_device_peak_bytes_in_use"

#: `# HELP` registry for `prometheus_text` (exposition format 0.0.4
#: requires families to be self-describing; families not listed here get
#: an auto-generated line). One copy, next to the name constants.
HELP: dict[str, str] = {
    SCHEDULING_CYCLES: "Scheduling cycles run.",
    PODS_BOUND: "Pods bound to a node.",
    PODS_FAILED: "Pods reported unschedulable.",
    PREEMPTION_ATTEMPTS: "Preemption attempts (upstream PreemptionAttempts).",
    PREEMPTION_VICTIMS: "Pods nominated for eviction by preemption.",
    GANG_REJECTIONS: "Whole-gang admission rejections.",
    CACHE_RESYNC_FLUSHES: "NRT cache resync flushes.",
    UNSCHEDULABLE_BY_PLUGIN:
        "Unschedulable verdicts attributed per plugin "
        "(upstream UnschedulablePlugins).",
    PLUGIN_EXECUTION:
        "Per-plugin, per-extension-point execution latency in ms.",
    FLIGHTREC_CYCLES: "Cycles captured by the flight recorder.",
    SERVE_DECISION_LATENCY:
        "Delta ingest to host-visible bind decisions, per cycle, in ms.",
    SERVE_GENERATION: "Resident-state generation (gauge).",
    SERVE_STALENESS:
        "Delta events applied since the resident base was rebuilt (gauge).",
    SERVE_PENDING_DELTAS:
        "Delta events drained at the start of the current refresh (gauge).",
    SERVE_REBASES: "Full re-snapshots performed by the serving engine.",
    SERVE_GANG_FALLBACKS:
        "Serve refreshes that fell back to a full snapshot on a gang "
        "roster.",
    PLACEMENT_QUALITY:
        "Latest cycle's placement-quality objective values (gauge).",
    DEGRADED: "1 while serving from the host-side parity solve (gauge).",
    SOLVE_RETRIES: "Failed watchdog retry attempts.",
    SOLVE_FAILOVERS: "Fast-path to degraded transitions.",
    PROBATION_PROBES: "Probation probes dispatched while degraded.",
    SOLVE_WORKERS_ABANDONED:
        "Watchdog workers orphaned inside a hung backend call.",
    THREAD_TOPOLOGY_DRIFT:
        "Live threads unknown to the committed concurrency manifest.",
    ANTIENTROPY_CHECKS: "Anti-entropy digest checks of resident state.",
    ANTIENTROPY_DIVERGENCE: "Anti-entropy divergences detected.",
    REQUEUE_BACKOFF_SKIPS:
        "Requeue attempts skipped inside a backoff window.",
    CYCLE_OVERLAP_EFFICIENCY:
        "Fraction of the in-flight solve envelope covered by host work "
        "(gauge).",
    CYCLE_PIPELINE_BUBBLE:
        "Wall ms the pipelined fence idled waiting on the device (gauge).",
    CYCLE_LATE_BINDS:
        "Async bind flushes that landed after a later ingest boundary.",
    TUNER_PROMOTIONS: "Live weight promotions applied by the shadow tuner.",
    TUNER_ROLLBACKS: "Probation auto-rollbacks.",
    TUNER_SWEEPS: "Shadow-lane sweep evaluations completed.",
    TUNER_SWEEP_FAILURES: "Shadow-lane sweep/promotion faults.",
    TUNER_ACTIVE_WEIGHTS:
        "Active weight vector content digest, first 48 bits (gauge).",
    TUNER_STATE:
        "Tuner controller state: 0 idle, 1 probation, 2 cooldown, "
        "3 disabled (gauge).",
    LANE_CONFLICTS: "Conflict-fence rejections per lane.",
    LANE_COMMIT: "Host conflict-fence wall ms per laned cycle.",
    LANE_RERESOLVES: "Pods re-resolved by the suffix repair solve.",
    LANE_SERIAL_FALLBACKS:
        "Laned cycles that fell back to the sequential parity solve.",
    E2E_SCHEDULING_MS:
        "Per-pod e2e scheduling latency in ms, labeled by priority "
        "(upstream scheduler_e2e_scheduling_duration_seconds, in ms).",
    POD_SCHEDULING_ATTEMPTS:
        "Scheduling attempts per scheduled pod "
        "(upstream scheduler_pod_scheduling_attempts).",
    POD_SCHEDULING_SLI_MS:
        "Per-stage share of pod scheduling latency in ms, labeled by "
        "stage (upstream scheduler_pod_scheduling_sli_duration_seconds, "
        "in ms, decomposed).",
    DEVICE_BYTES_IN_USE:
        "Device-memory bytes in use across local devices (gauge).",
    DEVICE_PEAK_BYTES:
        "Device-memory high-water mark across local devices (gauge).",
}


# ---------------------------------------------------------------------------
# Tracer: Chrome-trace-event / Perfetto JSON spans
# ---------------------------------------------------------------------------


class _Span:
    """One open span of an enabled tracer (`Tracer.span`)."""

    __slots__ = ("tracer", "name", "tid", "args", "start_ns")

    def __init__(self, tracer, name: str, tid: str, args: dict):
        self.tracer, self.name, self.tid, self.args = tracer, name, tid, args

    def __enter__(self):
        self.start_ns = self.tracer.now_ns()
        return self

    def __exit__(self, *exc):
        self.tracer.complete(self.name, self.start_ns,
                             self.tracer.now_ns() - self.start_ns,
                             tid=self.tid, args=self.args or None)
        return False


#: what `Tracer.span` returns while the tracer is off: one shared no-op
_OFF = nullcontext()


class Tracer:
    """Host-side span recorder exporting Chrome trace-event JSON (the
    "traceEvents" array Perfetto and chrome://tracing load).

    - Spans are complete "X" events: name, pid, tid, ts/dur in MICROSECONDS
      (trace-event convention) derived from `time.perf_counter_ns` relative
      to `start()`.
    - tids are logical row names ("cycle", "pipeline/h2d/buf0", ...) mapped
      to small ints, with "M" thread_name metadata events naming each row.
    - `start()` reads the profiler's clock right after its origin: the
      export's `otherData.origin_profiler_ns`. `torch.profiler`'s records
      stamp `time.time_ns()` (kineto's clock, on the CPU and the card
      alike), so a span starts at `origin_profiler_ns + 1000 * ts` there.
    - Counters (`count`, `add_ns`: a count and a time in ns) total what a
      span per call would cost too much to record, such as the store's
      mutators; they export under `otherData.counters` as
      {name: {"count", "ns"}}.
    - OFF by default; `span()`, `count()` and `add_ns()` return at once
      when disabled (no clock read; a span is one shared no-op context),
      so always-instrumented code paths stay within the ≤2% overhead
      budget.
    - Device work is never timed from a span: spans bracket host-sync
      points (a call returning, a staging copy enqueued, a fetch
      completing), the only clocks the host can read honestly.
    """

    def __init__(self):
        self._enabled = False
        self._events: list[dict] = []
        self._tids: dict[str, int] = {}
        self._counters: dict[str, list] = {}  # name -> [count, ns]
        self._lock = threading.Lock()
        self._origin_ns = 0
        self._origin_profiler_ns = 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    def start(self, clear: bool = True) -> None:
        with self._lock:
            if clear:
                self._events.clear()
                self._tids.clear()
                self._counters.clear()
            self._origin_ns = time.perf_counter_ns()
            self._origin_profiler_ns = time.time_ns()
            self._enabled = True

    def stop(self) -> None:
        self._enabled = False

    def now_ns(self) -> int:
        """Current timestamp on the tracer clock (ns since `start()`)."""
        return time.perf_counter_ns() - self._origin_ns

    def _tid(self, name: str) -> int:
        tid = self._tids.get(name)
        if tid is None:
            tid = self._tids[name] = len(self._tids) + 1
        return tid

    def complete(self, name: str, start_ns: int, dur_ns: int,
                 tid: str = "host", args: dict | None = None) -> None:
        """Record one complete ("X") event from explicit tracer-clock
        stamps (ns since `start()`), e.g. replayed pipeline timelines."""
        if not self._enabled:
            return
        event = {
            "name": name,
            "ph": "X",
            "ts": start_ns / 1000.0,
            "dur": max(dur_ns, 0) / 1000.0,
            "pid": os.getpid(),
        }
        if args:
            event["args"] = args
        with self._lock:
            event["tid"] = self._tid(tid)
            self._events.append(event)

    def span(self, name: str, tid: str = "host", **args):
        """A context manager recording one complete event on row `tid`
        around its block."""
        if not self._enabled:
            return _OFF
        return _Span(self, name, tid, args)

    def count(self, name: str, value: int = 1) -> None:
        """Add `value` to counter `name`'s count (while enabled)."""
        if self._enabled:
            self._add(name, value, 0)

    def add_ns(self, name: str, ns: int) -> None:
        """One timed occurrence of counter `name` (while enabled): its
        count goes up by one and its time by `ns` nanoseconds."""
        if self._enabled:
            self._add(name, 1, ns)

    def _add(self, name: str, count: int, ns: int) -> None:
        with self._lock:
            total = self._counters.get(name)
            if total is None:
                self._counters[name] = [count, ns]
            else:
                total[0] += count
                total[1] += ns

    def counters(self) -> dict:
        """{name: {"count", "ns"}}: the totals since `start()`."""
        with self._lock:
            return {name: {"count": count, "ns": ns}
                    for name, (count, ns) in sorted(self._counters.items())}

    def export(self) -> dict:
        """{"traceEvents": [...], "otherData": {...}}: X spans plus M
        thread_name metadata; the profiler clock at the origin and the
        counters."""
        counters = self.counters()
        with self._lock:
            events = list(self._events)
            tids = dict(self._tids)
        pid = os.getpid()
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": row},
            }
            for row, tid in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"origin_profiler_ns": self._origin_profiler_ns,
                              "counters": counters}}

    def write(self, path: str) -> None:
        """Export to `path` atomically (temp file + `os.replace`): a crash —
        or SIGKILL — mid-write can never leave a truncated, unparsable
        trace at the target path (the reader sees either the previous
        complete file or the new complete file)."""
        atomic_write(path, json.dumps(self.export()))


#: global tracer, off by default (`bench.py --trace out.json` and
#: `tools/trace_smoke.py` turn it on around their runs)
tracer = Tracer()


@contextmanager
def extension_span(extension_point: str, plugin: str, tid: str = "framework",
                   **args):
    """One extension-point execution: a tracer span on the "framework" row
    plus a `scheduler_plugin_execution_ms{plugin,extension_point}` histogram
    observation — the upstream per-plugin, per-extension-point latency
    metric (frameworkruntime plugin_execution_duration_seconds). `tid`
    overrides the row for stages the pipelined cycle engine runs off the
    main thread (per-tid spans must stay disjoint-or-nested for the
    Perfetto validity gate)."""
    with tracer.span(
        f"{extension_point}/{plugin}", tid=tid, **args
    ):
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            metrics.observe_ms(
                PLUGIN_EXECUTION,
                (time.perf_counter_ns() - start) / 1e6,
                plugin=plugin,
                extension_point=extension_point,
            )


@contextmanager
def flow(subsystem: str, generation: int | None = None, **ctx):
    """Flow-correlated log span: emits FlowBegin/FlowEnd with the subsystem,
    optional cache generation and contextual key/values, plus duration.
    An exception inside the span marks the FlowEnd line `status=error
    error=<ExceptionType>` (and re-raises) so a failed flow is
    distinguishable from a completed one in the log stream."""
    fields = " ".join(f"{k}={v}" for k, v in ctx.items())
    gen = f" generation={generation}" if generation is not None else ""
    logger.debug("%s subsystem=%s%s %s", FLOW_BEGIN, subsystem, gen, fields)
    start = time.perf_counter()
    try:
        yield
    except BaseException as exc:
        logger.debug(
            "%s subsystem=%s%s %s status=error error=%s durationMs=%.2f",
            FLOW_END, subsystem, gen, fields, type(exc).__name__,
            (time.perf_counter() - start) * 1000,
        )
        raise
    logger.debug(
        "%s subsystem=%s%s %s status=ok durationMs=%.2f",
        FLOW_END, subsystem, gen, fields,
        (time.perf_counter() - start) * 1000,
    )
