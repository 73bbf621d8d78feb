"""One full scheduling cycle (port of `scheduler_plugins_tpu.framework.cycle`):
queue -> snapshot -> solve on the card -> one host copy -> apply.

The host side reproduces the reference's Permit / PostFilter machinery
(coscheduling.go:162-274):

- assigned & quorum met        -> bind (Permit Success); also releases
  previously-waiting siblings (IterateOverWaitingPods...Allow).
- assigned & quorum unmet      -> reserve (Permit Wait) with a per-pod
  deadline: PodGroup.ScheduleTimeoutSeconds or the plugin's
  PermitWaitingTimeSeconds.
- unschedulable gang member    -> PostFilter: if the gang can still reach
  quorum within the reject-percentage slack, the rest retry; otherwise the
  whole gang is rejected (reservations released, failure time recorded for
  queue demotion, the group backed off).
- expired permit deadline      -> the same whole-gang rejection.
- still-failed pods            -> quota-aware preemption (the profile's
  engine, `framework.preemption`).

The solve's outputs stay on the card until `_cycle_solve_fence` copies
them, and the snapshot columns the quality stamp reads, to the host once;
every later stage reads those numpy copies.

`stream_chunk` runs the solve through the streamed chunk pipeline
(`parallel.pipeline.streamed_profile_solve`) when the profile qualifies;
its failures are attributed by `Scheduler.attribution_codes`.

`CycleReport.explain(uid)` gives the "why this node" table of any pod of
the cycle's batch (`utils.flightrec.explain_solver`), scored with the
plugins' configuration as the cycle saw it; only the most recent
`SPT_EXPLAIN_RETAIN` reports (default 8) keep their snapshot for it.

Before the batch the prologue runs each plugin's `configure_cluster`,
drives the NRT cache tier's resync on its period (`_resync_nrt_cache`) and
ticks the load-watcher collectors the Trimaran plugins configure
(`_refresh_metrics`), so the snapshot carries the latest zone view and
metrics. After the gang rejections, failures mark the cache's nodes with
assumed pods maybe-overreserved (`_mark_overreserved_on_failures`).

`serve` (a `serving.engine.ServeEngine` attached to the store) takes the
snapshot stage from the engine's resident node columns, refreshed with
O(changed) deltas; when the engine cannot own the state the cycle falls
back to `Cluster.snapshot`. The solve is the same, so served placements
equal a fresh-snapshot cycle's.

`resilience` (a `resilience.watchdog.Resilience`) routes the solve
through the solve watchdog: the dispatch and the host copy that waits for
the card run in a worker thread with a deadline, with seeded-jitter
retries and, on an exhausted budget, failover to the host parity solve
(`CycleReport.solve_path` "host", `degraded`).

`gangs` (a `gangs.phase.GangPhase`) runs the rank-aware gang phase after
QueueSort and before the snapshot: rank-aware PodGroups' members leave
the batch and are placed as whole gangs by the topology-block waterfill,
bound through the store, so the per-pod snapshot carries their usage.

The cycle counts and traces itself through `utils.observability`: the
cycle counters, the spans of each stage (the JAX package's names) and,
in serve mode, the decision-latency histogram.

Every stage feeds the pod-lifecycle ledger (`obs.ledger.LEDGER`) when it
is on: the cycle's scope and stamps, the batch, failure blame, requeue
waits and nominations; off, each hook costs one branch.

The stages are module functions (`_cycle_open` ... `_cycle_finalize`) so
the pipelined engine (`framework.pipeline_cycle.PipelinedCycle`) composes
the same ones with cycle N's solve in flight while cycle N-1's
report-only finalize runs; `run_cycle` runs them strictly in order.

The flight recorder (`utils.flightrec.recorder`) records a cycle when it
is on: the record opens before the snapshot, captures the inputs after
`prepare` (with the serving engine's and the gang phase's provenance),
the outputs after the fence (labelled "sequential", "streamed" or
"packing") and commits in the finalize; a gang-only cycle records the
gang solve alone. Under `SPT_SANITIZE=1` (`utils.sanitize`) the cycle
drains foreign reports before the snapshot and fills
`CycleReport.sanitize_errors` / `sanitize_checked` after the solve.

The online tuner (`tuner`, a `tuning.shadow.ShadowTuner`) swaps weights
only at `begin_cycle`, before the cycle reads the profile, and reads the
finished report's quality stamp in `observe_report`.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np

from scheduler_plugins_tpu_torch.api import events as ev_api
from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.framework.plugin import BUILTIN_EVENTS
from scheduler_plugins_tpu_torch.framework.preemption import (
    GATED,
    encode_demand,
    host_view,
)
from scheduler_plugins_tpu_torch.framework.runtime import (
    Scheduler,
    now_ms as _now_ms,
)
from scheduler_plugins_tpu_torch.obs import ledger as podledger
from scheduler_plugins_tpu_torch.parallel.pipeline import (
    streamed_profile_solve,
)
from scheduler_plugins_tpu_torch.parallel.solver import PackingSolveView
from scheduler_plugins_tpu_torch.plugins.coscheduling import Coscheduling
from scheduler_plugins_tpu_torch.resilience import faults
from scheduler_plugins_tpu_torch.state.cluster import Cluster
from scheduler_plugins_tpu_torch.state.collector import (
    AsyncLoadWatcherCollector,
    make_metrics_client,
)
from scheduler_plugins_tpu_torch.tuning.quality import cycle_quality_np
from scheduler_plugins_tpu_torch.utils import flightrec
from scheduler_plugins_tpu_torch.utils import observability as obs
from scheduler_plugins_tpu_torch.utils import sanitize
from scheduler_plugins_tpu_torch.utils.flightrec import explain_solver

@dataclass
class SolveResultView:
    """The (assignment, admitted, wait) triple the cycle consumes: what the
    streamed solve returns (no SolverState carry). `failed_plugin` stays
    None: the cycle attributes its failures from the cycle-initial
    per-plugin verdicts (`Scheduler.attribution_codes`)."""

    assignment: object
    admitted: object
    wait: object
    failed_plugin: object = None


@dataclass
class CycleReport:
    bound: dict[str, str] = field(default_factory=dict)  # uid -> node
    reserved: dict[str, str] = field(default_factory=dict)
    failed: list[str] = field(default_factory=list)
    #: uid -> plugin that made the pod unschedulable (the upstream
    #: `UnschedulablePlugins` signal): the first plugin in profile order
    #: whose PreFilter rejected it or whose Filter emptied the feasible
    #: set; "NodeResourcesFit" for built-in fit and capacity failures
    failed_by: dict[str, str] = field(default_factory=dict)
    #: pods parked unschedulable with no registered event since their last
    #: failure (EnqueueExtensions gating), left out of this cycle's batch
    skipped: list[str] = field(default_factory=list)
    rejected_gangs: list[str] = field(default_factory=list)
    expired_gangs: list[str] = field(default_factory=list)
    #: preemptor uid -> (nominated node, victim uids)
    preempted: dict[str, tuple[str, list[str]]] = field(default_factory=dict)
    #: placement-quality objectives of this cycle's solve
    #: (`tuning.quality.cycle_quality_np` plus the preemption and
    #: nomination counts); None when the cycle ran no solve
    quality: Optional[dict] = None
    #: which solve served this cycle when a `resilience` state machine is
    #: attached: "device" (the fast path) or "host" (degraded failover or
    #: a probation miss: `resilience.hostsolve`); None without one
    solve_path: Optional[str] = None
    #: True when the process served from the host parity path at the END
    #: of this cycle (the `scheduler_degraded` gauge's report twin)
    degraded: bool = False
    #: per-gang outcome of the rank-aware gang phase (`gangs.phase`):
    #: gang full_name -> {admitted, placed_new, resident, desired,
    #: max_cost, sum_cost}; empty without a gang phase or when no
    #: rank-aware gang had pending members
    rank_gangs: dict = field(default_factory=dict)
    #: lane attribution when the cycle ran under the K-lane engine
    #: (`framework.laned_cycle.LanedCycle`): k, path ("laned" / "serial"
    #: fallback), per-lane sizes / committed / conflicts, the re-resolve
    #: count and the solve / fence wall ms (`LaneStats.as_dict`); None for
    #: every other engine
    lanes: Optional[dict] = None
    #: the sanitizer's findings in this cycle's checked calls
    #: (`SPT_SANITIZE=1`, `utils.sanitize`). Read with `sanitize_checked`:
    #: no errors means "all checks passed" only when it is above 0
    sanitize_errors: list[dict] = field(default_factory=list)
    #: checked calls this cycle ran (None while the sanitizer is off; 0
    #: when the solve took no checked path, as the sequential solve)
    sanitize_checked: Optional[int] = None

    def explain(self, uid: str, top_k: int = 5) -> dict:
        """The "why this node" table for one pod of THIS cycle's pending
        batch (`utils.flightrec.explain_solver`): the top-k candidate
        nodes with per-plugin weighted normalized scores, the built-in fit
        margin and the gap to the winner, computed on the cycle's device
        with the plugins' configuration frozen at the cycle. Works for
        placed and failed pods. Raises KeyError for a uid outside the
        batch, and RuntimeError when the cycle ran no solve or its
        context was released (only the most recent SPT_EXPLAIN_RETAIN
        reports keep their snapshot)."""
        ctx = getattr(self, "_explain_ctx", None)
        if ctx is _CTX_RELEASED:
            raise RuntimeError(
                f"explain context released: only the most recent "
                f"{_explain_retain()} cycle reports keep their snapshot "
                "(SPT_EXPLAIN_RETAIN; 0 disables explain entirely)"
            )
        if ctx is None:
            raise RuntimeError(
                "this cycle ran no solve (empty pending batch): nothing "
                "to explain"
            )
        scheduler, snap, meta, assignment, auxes = ctx
        return explain_solver(scheduler, snap, meta, uid, top_k=top_k,
                              assignment=assignment, auxes=auxes,
                              device=snap.device)


#: sentinel on `CycleReport._explain_ctx`: released by the retention
#: window, as opposed to "this cycle never solved"
_CTX_RELEASED = object()

#: reports whose explain context (scheduler, snapshot, meta, assignment,
#: auxes) is still attached, most recent last: each pins a snapshot, so
#: a caller keeping every report must not keep every snapshot
_EXPLAIN_RING: deque = deque()


def _explain_retain() -> int:
    try:
        return int(os.environ.get("SPT_EXPLAIN_RETAIN", "8"))
    except ValueError:
        return 8


def _attach_explain_ctx(report: CycleReport, ctx: tuple) -> None:
    retain = _explain_retain()
    if retain <= 0:
        # explain disabled: pin nothing, not even this cycle's snapshot
        report._explain_ctx = _CTX_RELEASED
        return
    report._explain_ctx = ctx
    _EXPLAIN_RING.append(report)
    while len(_EXPLAIN_RING) > retain:
        _EXPLAIN_RING.popleft()._explain_ctx = _CTX_RELEASED


@dataclass
class CycleCtx:
    """Mutable state threaded through one cycle's stages. `run_cycle`
    runs the stages in order; `PipelinedCycle` runs the same ones with its
    bind stage on a flusher thread and the finalize deferred into the next
    cycle's overlap window."""

    scheduler: Scheduler
    cluster: Cluster
    now: int
    device: object
    report: CycleReport
    #: pods per chunk of the streamed solve; None = the sequential solve
    stream_chunk: Optional[int] = None
    #: the serving engine, or None
    serve: object = None
    #: the solve watchdog's state machine, or None
    resilience: object = None
    #: the rank-aware gang phase, or None
    gangs: object = None
    #: the engine assembled this cycle's snapshot
    served: bool = False
    #: host clock at the snapshot stage of a serve cycle (the decision
    #: latency's start)
    serve_t0: Optional[float] = None
    cosched: object = None
    pending: list = field(default_factory=list)
    snap: object = None
    meta: object = None
    result: object = None
    #: host (numpy) copies made by the fence
    assignment: object = None
    admitted: object = None
    wait: object = None
    failed_plugin: object = None
    #: host copies of the snapshot columns `cycle_quality_np` reads
    quality_view: object = None
    #: early return taken (empty batch)
    done: bool = False
    failed_idx: list = field(default_factory=list)
    failed_by_gang: dict = field(default_factory=dict)
    #: tracer row of the bind and post-bind stages: the pipelined engine
    #: runs them on its flusher thread, and spans of two threads on one
    #: row would overlap
    tid: str = "cycle"
    #: this cycle's ledger context (`obs.ledger.LedgerCycle`), None while
    #: the ledger is off
    led: object = None
    #: this cycle's flight record (`utils.flightrec.CycleRecord`), None
    #: while the recorder is off
    rec: object = None


def _cycle_open(scheduler, cluster, now, device, stream_chunk=None,
                serve=None, resilience=None, gangs=None) -> CycleCtx:
    """Cycle prologue: the cycle counter, the Coscheduling instance, each
    plugin's cluster wiring, permit expiry, the NRT cache resync and the
    collector ticks."""
    ctx = CycleCtx(scheduler=scheduler, cluster=cluster, now=now,
                   device=device, report=CycleReport(),
                   stream_chunk=stream_chunk, serve=serve,
                   resilience=resilience, gangs=gangs)
    # the ledger scope opens before the permit expiry, whose whole-gang
    # rejections are this cycle's decisions. Once this returns, the caller
    # (`run_cycle`, `PipelinedCycle.tick`) pops it in its finally; a raise
    # in the prologue pops it here. The stages push only nested scopes
    ctx.led = podledger.LEDGER.cycle_open(now)
    podledger.LEDGER.push_scope(ctx.led, 0)
    try:
        obs.metrics.inc(obs.SCHEDULING_CYCLES)
        ctx.cosched = next(
            (p for p in scheduler.profile.plugins
             if isinstance(p, Coscheduling)),
            None,
        )
        for plugin in scheduler.profile.plugins:
            plugin.configure_cluster(cluster)
        with obs.tracer.span("ExpireGangs", tid="cycle"):
            _expire_gangs(cluster, now, ctx.report)
        with obs.tracer.span("NRTResync", tid="cycle"):
            _resync_nrt_cache(cluster, now)
        with obs.tracer.span("Collectors", tid="cycle"):
            _refresh_metrics(scheduler, cluster, now)
    except BaseException:
        podledger.LEDGER.pop_scope(ctx.led)
        podledger.LEDGER.cycle_close(ctx.led)
        raise
    return ctx


def _cycle_pending(ctx: CycleCtx) -> None:
    """Pending batch: requeue gating, QueueSort, then the rank-gang
    phase. Sets `ctx.done` when the cycle ends here (an empty batch, or a
    batch the gang phase took whole)."""
    cluster, report, gangs = ctx.cluster, ctx.report, ctx.gangs
    with obs.tracer.span("Requeue", tid="cycle"):
        pending = _requeue_eligible(ctx.scheduler, cluster,
                                    cluster.pending_pods(), ctx.now,
                                    report, gang_phase=gangs is not None)
    if gangs is None and not pending:
        ctx.done = True
        return
    pending = ctx.scheduler.sort_pending(pending, cluster)
    if gangs is not None:
        # the phase runs even on an empty batch: the elastic reconcile
        # must see desired-width changes, and the clones it creates join
        # THIS cycle's batch
        with obs.extension_span("GangPhase", type(gangs).__name__,
                                pending=len(pending)):
            pending = gangs.run(ctx.scheduler, cluster, pending, ctx.now,
                                report, serve=ctx.serve, device=ctx.device)
        if not pending:
            # a gang-only cycle: every pending pod was a rank-gang member.
            # A serving engine still drains now (a refresh with an empty
            # batch), so the phase's binds reach its resident columns and
            # rank mirror
            if ctx.serve is not None:
                ctx.serve.refresh(cluster, [], now_ms=ctx.now,
                                  device=ctx.device)
            # still recorded: the gang capture alone replays through the
            # numpy twin
            rec = flightrec.recorder.begin(
                now_ms=ctx.now, profile=ctx.scheduler.profile.name)
            if rec is not None:
                gangs.annotate_record(rec)
                rec.commit(report)
            obs.metrics.inc(obs.PODS_BOUND, len(report.bound))
            obs.metrics.inc(obs.PODS_FAILED, len(report.failed))
            obs.metrics.inc(obs.GANG_REJECTIONS, len(report.rejected_gangs))
            ctx.done = True
            return
    ctx.pending = pending
    if ctx.led is not None:
        # the batch gates the per-attempt stage split: binds of pods
        # outside it (gang-phase binds, the permit fan-out of earlier
        # reservations) charge their whole interval to the wait-state
        ctx.led.batch = frozenset(p.uid for p in pending)


def _cycle_arm(ctx: CycleCtx) -> None:
    """Between the pending batch and the snapshot: drop the sanitizer
    reports of calls outside this cycle (warm-ups, other schedulers), so
    the post-solve drain counts only this cycle's, and open the flight
    record."""
    if sanitize.enabled():
        sanitize.drain()
    ctx.rec = flightrec.recorder.begin(now_ms=ctx.now,
                                       profile=ctx.scheduler.profile.name)


def _cycle_snapshot(ctx: CycleCtx) -> None:
    """The cycle's snapshot on its device, from the serving engine's
    resident columns when it can own the state, else lowered from the
    store; then the plugins' prepare and the flight record's inputs."""
    with obs.tracer.span("Snapshot", tid="cycle", pending=len(ctx.pending)):
        refreshed = None
        if ctx.serve is not None:
            refreshed = ctx.serve.refresh(ctx.cluster, ctx.pending,
                                          now_ms=ctx.now, device=ctx.device)
            ctx.served = refreshed is not None
        if refreshed is None:
            refreshed = ctx.cluster.snapshot(ctx.pending, now_ms=ctx.now,
                                             device=ctx.device)
    ctx.snap, ctx.meta = refreshed
    ctx.scheduler.prepare(ctx.meta, ctx.cluster)
    if ctx.rec is not None:
        # the inputs land in the ring BEFORE the solve: the cycle that
        # crashes the solve is the one worth replaying
        t0 = time.perf_counter()
        with obs.tracer.span("Record", tid="cycle"):
            ctx.rec.capture_inputs(
                ctx.snap, ctx.meta, ctx.scheduler,
                stream_chunk=ctx.stream_chunk,
                profile_config=flightrec.recorder.profile_config)
            if ctx.served:
                # the resident generation, the base digest and the packed
                # deltas that made this snapshot
                ctx.serve.annotate_record(ctx.rec)
            if ctx.gangs is not None:
                # the gang solve's inputs and outputs
                ctx.gangs.annotate_record(ctx.rec)
        ctx.rec.capture_s += time.perf_counter() - t0


def _cycle_solve_dispatch(ctx: CycleCtx) -> None:
    """The streamed solve when `stream_chunk` is set and the profile
    qualifies, else the profile's solve: the sequential solve (which on
    the card only enqueues work) or, under `solveMode: packing`, the
    packing solve's `PackingSolveView` (no failure codes: the failures
    are attributed from the cycle-initial verdicts). The outputs stay
    device tensors until the fence. Under `resilience` the watchdog runs
    the dispatch and the host copy in its worker (or serves the host
    solve), and the outputs come back as host arrays."""
    if ctx.led is not None:
        # dispatch entry: the in-batch wait ends when the solve starts
        ctx.led.t_solve = podledger.LEDGER._now()
    result = None
    if ctx.resilience is not None:
        (assignment, admitted, wait, codes_np,
         ctx.report.solve_path) = ctx.resilience.solve_cycle(
            ctx.scheduler, ctx.snap, stream_chunk=ctx.stream_chunk,
            device=ctx.device,
        )
        ctx.result = SolveResultView(assignment, admitted, wait,
                                     failed_plugin=codes_np)
        return
    if ctx.stream_chunk:
        streamed = streamed_profile_solve(
            ctx.scheduler, ctx.snap, chunk=ctx.stream_chunk,
            device=ctx.device,
        )
        if streamed is not None:
            result = SolveResultView(*streamed)
    if result is None:
        result = ctx.scheduler.solve(ctx.snap, device=ctx.device)
    ctx.result = result


def _cycle_solve_fence(ctx: CycleCtx) -> None:
    """The cycle's one host copy: assignment, admitted, wait and the
    failure codes, and the snapshot columns the quality stamp reads
    (`_quality_view`). The first copy waits for the card; every later
    stage reads only these, so a finalize deferred past the next cycle's
    refresh (which updates the resident columns in place) still reads
    this cycle's state."""
    if ctx.led is not None and ctx.led.t_fence0 is None:
        ctx.led.t_fence0 = podledger.LEDGER._now()
    result = ctx.result
    ctx.assignment = _host(result.assignment)
    ctx.admitted = _host(result.admitted)
    ctx.wait = _host(result.wait)
    if result.failed_plugin is not None:
        ctx.failed_plugin = _host(result.failed_plugin)
    if ctx.led is not None and ctx.led.t_fence1 is None:
        ctx.led.t_fence1 = podledger.LEDGER._now()
    ctx.quality_view = _quality_view(ctx.snap)


def _host(x) -> np.ndarray:
    """A host copy of `x`. The watchdog's outputs are host arrays already
    (its worker copied them). A CPU tensor is copied too: its numpy view
    would share memory with a resident column the next refresh adds
    into."""
    return x if isinstance(x, np.ndarray) else x.to("cpu", copy=True).numpy()


def _quality_view(snap):
    """Host copies of exactly the snapshot columns `cycle_quality_np`
    reads, in the same attribute shape."""
    return SimpleNamespace(
        nodes=SimpleNamespace(alloc=_host(snap.nodes.alloc),
                              requested=_host(snap.nodes.requested),
                              mask=_host(snap.nodes.mask)),
        pods=SimpleNamespace(req=_host(snap.pods.req),
                             mask=_host(snap.pods.mask)),
    )


def _cycle_post_solve(ctx: CycleCtx) -> None:
    """After the fence: the degraded flag, the flight record's outputs,
    the report's explain context, with the plugins' `aux()` frozen here
    (the preemption pass re-prepares the shared plugins for its own
    snapshot, and a later cycle for its own; a served cycle keeps none),
    and the sanitizer's reports of this cycle."""
    ctx.report.degraded = (ctx.resilience is not None
                           and ctx.resilience.degraded)
    if ctx.led is not None:
        ctx.led.degraded = ctx.report.degraded
        ctx.led.solve_path = ctx.report.solve_path
    if ctx.rec is not None:
        t0 = time.perf_counter()
        with obs.tracer.span("Record", tid="cycle"):
            ctx.rec.capture_outputs(
                _record_mode(ctx.result), ctx.assignment, ctx.admitted,
                ctx.wait, failed_plugin=ctx.failed_plugin)
        ctx.rec.capture_s += time.perf_counter() - t0
    if ctx.served:
        # a served snapshot's node columns are the engine's resident
        # tensors, which the next refresh updates in place: keep no
        # explain context (the flight recorder's host copies serve
        # postmortems there)
        ctx.report._explain_ctx = _CTX_RELEASED
    else:
        _attach_explain_ctx(ctx.report, (
            ctx.scheduler, ctx.snap, ctx.meta, ctx.assignment,
            tuple(p.aux() for p in ctx.scheduler.profile.plugins),
        ))
    if sanitize.enabled():
        # the checked-call count beside the errors: "no errors" must not
        # read as "checks ran" when the solve took an unchecked path
        reports = sanitize.drain()
        ctx.report.sanitize_checked = len(reports)
        ctx.report.sanitize_errors = [r for r in reports if not r["ok"]]


def _record_mode(result) -> str:
    """The flight record's output label: "packing" (replayed as evidence
    only: its soft order differs by design), "sequential" for a solve that
    carried per-pod codes (the parity solve, the laned solve and the host
    failover, which replay bit-identically), else "streamed"."""
    if isinstance(result, PackingSolveView):
        return "packing"
    if getattr(result, "failed_plugin", None) is not None:
        return "sequential"
    return "streamed"


def _cycle_bind(ctx: CycleCtx) -> None:
    """The bind stage: flush this cycle's decisions through the store's
    mutators (bind / reserve / mark_unschedulable). Every mutation carries
    THIS cycle's `now`: under the pipelined engine the flush may run while
    the next cycle ingests, and backoff windows are still charged to the
    cycle that observed the snapshot. The ledger scope follows the same
    rule (lane 1 on this thread), and the plugins' per-thread solve
    context is cleared here: on the pipelined engine's flusher thread it
    would still hold an earlier cycle's presolve. The post-bind readers
    bind their own (`Scheduler.attribution_codes` this cycle's presolve,
    the preemption dry run none)."""
    for plugin in ctx.scheduler.profile.plugins:
        plugin.bind_presolve(None)
        plugin._memo = None
    podledger.LEDGER.push_scope(ctx.led, 1)
    try:
        _bind_decisions(ctx)
    finally:
        podledger.LEDGER.pop_scope(ctx.led)


def _bind_decisions(ctx: CycleCtx) -> None:
    cluster, report, now = ctx.cluster, ctx.report, ctx.now
    meta, cosched = ctx.meta, ctx.cosched
    assignment, admitted, wait = ctx.assignment, ctx.admitted, ctx.wait
    with obs.tracer.span("Bind", tid=ctx.tid):
        for i, pod in enumerate(ctx.pending):
            node_idx = int(assignment[i])
            pg = cluster.pod_group_of(pod)
            if node_idx < 0 or not admitted[i]:
                report.failed.append(pod.uid)
                ctx.failed_idx.append((i, pod.uid))
                cluster.mark_unschedulable(pod.uid, now)
                if pg is not None:
                    ctx.failed_by_gang.setdefault(pg.full_name, []).append(
                        pod.uid
                    )
                continue
            node_name = meta.node_names[node_idx]
            if wait[i]:
                cluster.reserve(pod.uid, node_name)
                report.reserved[pod.uid] = node_name
                # per-POD waiting timer from THIS pod's reservation time
                # (upstream waitingPods, coscheduling.go:227-235;
                # GetWaitTimeDuration: ScheduleTimeoutSeconds else
                # PermitWaitingTimeSeconds)
                timeout_s = (pg.schedule_timeout_seconds if pg is not None
                             else None)
                if timeout_s is None and cosched is not None:
                    timeout_s = cosched.permit_waiting_seconds
                cluster.pod_deadline_ms[pod.uid] = (
                    now + 1000 * (timeout_s or 0))
            else:
                cluster.bind(pod.uid, node_name, now)
                report.bound[pod.uid] = node_name

    if ctx.serve_t0 is not None:
        # serve-mode decision latency: delta ingest through host-visible
        # bind decisions, observed on fallback cycles too
        obs.metrics.observe_ms(obs.SERVE_DECISION_LATENCY,
                               (time.perf_counter() - ctx.serve_t0) * 1000.0)

    if faults.ACTIVE is not None:
        # fault injection only: die after the bindings landed, the report
        # riding the exception
        if faults.ACTIVE.fire(faults.CRASH_POST_BIND) is not None:
            raise faults.CrashInjected(ctx.report)


def _cycle_postbind(ctx: CycleCtx, attribution: bool = True) -> None:
    """Post-bind store machinery, fenced to the cycle that observed the
    snapshot: failure attribution, Permit fan-out, whole-gang PostFilter
    rejection, over-reserve marks and preemption. The pipelined engine
    runs it before the next cycle's ingest boundary, so a nomination or a
    backoff never lands mid-overlap. `attribution=False` lets that engine
    defer the host-only failure decode to its overlap window when the
    per-pod codes came back with the solve."""
    podledger.LEDGER.push_scope(ctx.led, 1)
    try:
        _postbind_store(ctx, attribution)
    finally:
        podledger.LEDGER.pop_scope(ctx.led)


def _postbind_store(ctx: CycleCtx, attribution: bool) -> None:
    cluster, report, now = ctx.cluster, ctx.report, ctx.now
    cosched = ctx.cosched
    if attribution:
        _attribute_failures(ctx.scheduler, ctx.snap, ctx.failed_plugin,
                            ctx.failed_idx, report, tid=ctx.tid,
                            led=ctx.led)

    # Permit Allow fan-out: quorum reached this cycle releases waiting
    # siblings
    with obs.tracer.span("Permit", tid=ctx.tid):
        for pg in list(cluster.pod_groups.values()):
            _maybe_release_gang(cluster, pg, report, now)

    # PostFilter: whole-gang rejection (coscheduling.go:160-209)
    for gang_name in ctx.failed_by_gang:
        pg = cluster.pod_groups.get(gang_name)
        if pg is None:
            continue
        members = cluster.gang_members(pg)
        assigned = sum(
            1 for p in members
            if p.node_name is not None or p.uid in cluster.reserved
        )
        if assigned >= pg.min_member:
            continue  # quorum already met; stragglers can retry freely
        # tolerate a small quorum gap: (MinMember - assigned)/MinMember
        # <= rejectPercentage (coscheduling.go:180-185)
        reject_pct = cosched.reject_percentage if cosched else 10
        gap = (pg.min_member - assigned) / max(pg.min_member, 1)
        if gap <= reject_pct / 100:
            continue  # a later pod may still complete the quorum
        _reject_gang(cluster, pg, now, report, cosched, len(members))

    _mark_overreserved_on_failures(cluster, report)
    engine = ctx.scheduler.profile.preemption
    with obs.extension_span(
        "PostFilter", type(engine).__name__ if engine else "none",
        tid="framework" if ctx.tid == "cycle" else ctx.tid,
        failed=len(report.failed),
    ):
        _run_preemption(ctx.scheduler, cluster, ctx.pending, report, now,
                        ctx.device)
    obs.metrics.inc(obs.PODS_BOUND, len(report.bound))
    obs.metrics.inc(obs.PODS_FAILED, len(report.failed))
    obs.metrics.inc(obs.GANG_REJECTIONS, len(report.rejected_gangs))


def _cycle_finalize(ctx: CycleCtx, attribution: bool = False) -> None:
    """Report-only epilogue: the placement-quality stamp, and under the
    pipelined engine the deferred failure decode. It touches no store
    state and reads only the fence's host copies, so that engine runs it
    in the next cycle's overlap window."""
    if attribution:
        _attribute_failures(ctx.scheduler, ctx.snap, ctx.failed_plugin,
                            ctx.failed_idx, ctx.report, tid=ctx.tid,
                            led=ctx.led)
    _observe_quality(ctx.report, ctx.quality_view, ctx.assignment,
                     ctx.admitted, ctx.wait)
    if ctx.rec is not None:
        ctx.rec.commit(ctx.report)


def _cycle_fence_and_post(ctx: CycleCtx) -> None:
    _cycle_solve_fence(ctx)
    _cycle_post_solve(ctx)


#: `run_cycle`'s stages after the pending batch, in order, with the names
#: `timings` records them under
_STAGES = (
    ("snapshot", _cycle_snapshot),
    ("solve", _cycle_solve_dispatch),
    ("fence", _cycle_fence_and_post),
    ("bind", _cycle_bind),
    ("postbind", _cycle_postbind),
    ("finalize", _cycle_finalize),
)


def run_cycle(scheduler: Scheduler, cluster: Cluster,
              now: Optional[int] = None, stream_chunk: Optional[int] = None,
              serve=None, resilience=None, gangs=None, tuner=None, *,
              device=None, timings=None) -> CycleReport:
    """One scheduling cycle of `scheduler` over `cluster` at wall-clock
    `now` ms (None = the current time), its snapshot and solve on `device`
    (None = the CUDA card; the CPU only when asked for with "cpu"). The
    store is mutated in place; the report says what happened. The
    positional order is the JAX package's.

    `stream_chunk` streams the solve through the chunk pipeline in chunks
    of that many pods when the profile qualifies for the targeted fast
    path and the snapshot's pod rows are a multiple of it; otherwise the
    sequential solve runs. `serve`, a `serving.engine.ServeEngine`
    attached to `cluster`, assembles the snapshot from its resident node
    columns (falling back to `Cluster.snapshot` when it cannot own the
    state); a served cycle keeps no explain context. `timings`, a dict,
    receives each stage's wall seconds (`open`, `pending`, then `_STAGES`'
    names), and `scheduling_tables`: the host seconds of the in-tree
    scheduling tables (`state.scheduling.build_scheduling`) inside the
    snapshot stage. The same clock reads make the stages' `Cycle/<name>`
    spans on the tracer's "cycle" row.

    `resilience`, a `resilience.watchdog.Resilience`, routes the solve
    through the watchdog: retries, then failover to the host parity solve
    (`CycleReport.solve_path`, `degraded`). It raises
    `resilience.BackendUnavailable` only when the backend is gone AND the
    profile has no host fallback. `gangs`, a `gangs.phase.GangPhase`,
    places rank-aware gangs whole ahead of the per-pod solve
    (`CycleReport.rank_gangs`). `tuner`, a `tuning.shadow.ShadowTuner`,
    hooks the guarded-rollout controller in at its two seams:
    `begin_cycle` BEFORE anything reads the profile's weights (the one
    point a staged promotion or a rollback may swap them), and
    `observe_report` on the finished report, on both return paths."""
    device = resolve_device(device)
    if now is None:
        now = _now_ms()
    if tuner is not None:
        tuner.begin_cycle(now_ms=now)
    timed = timings is not None or obs.tracer.enabled
    t0 = obs.tracer.now_ns() if timed else None
    ctx = _cycle_open(scheduler, cluster, now, device, stream_chunk, serve,
                      resilience, gangs)
    try:
        report = _run_stages(ctx, t0, timings)
        if tuner is not None:
            tuner.observe_report(report)
        return report
    finally:
        # the lane-0 scope `_cycle_open` pushed: popped here so an early
        # return or a raise cannot leak it, and events between cycles fall
        # back to ambient attribution
        podledger.LEDGER.pop_scope(ctx.led)
        podledger.LEDGER.cycle_close(ctx.led)


def _stage_timed(timings, name: str, start_ns: int, end_ns: int) -> None:
    """One stage's `Cycle/<name>` span and its `timings` seconds, from the
    same two tracer-clock reads."""
    obs.tracer.complete(f"Cycle/{name}", start_ns, end_ns - start_ns,
                        tid="cycle")
    if timings is not None:
        timings[name] = (end_ns - start_ns) / 1e9


def _run_stages(ctx: CycleCtx, t0, timings) -> CycleReport:
    """The cycle after its prologue. `t0`, the tracer clock before
    `_cycle_open`, is None when neither `timings` nor the tracer wants
    the stages timed: then no clock is read."""
    clock = obs.tracer.now_ns
    if t0 is not None:
        # a read of its own for each end: spans that share a stamp can
        # round into a partial overlap in the export's microseconds
        _stage_timed(timings, "open", t0, clock())
        t1 = clock()
    _cycle_pending(ctx)
    if t0 is not None:
        _stage_timed(timings, "pending", t1, clock())
    if ctx.done:
        return ctx.report
    _cycle_arm(ctx)
    scheduler, cluster = ctx.scheduler, ctx.cluster
    stages = dict(_STAGES)

    def run(name):
        if t0 is None:
            stages[name](ctx)
            return
        start = clock()
        stages[name](ctx)
        _stage_timed(timings, name, start, clock())
        if timings is not None and name == "snapshot":
            timings["scheduling_tables"] = ctx.meta.scheduling_s

    if ctx.serve is not None:
        ctx.serve_t0 = time.perf_counter()
    with obs.flow("cycle",
                  generation=getattr(cluster.nrt_cache, "generation", None),
                  pending=len(ctx.pending)):
        run("snapshot")
        # the Solve span covers the dispatch and the fence's host copy
        with obs.extension_span("Solve", scheduler.profile.name,
                                pending=len(ctx.pending)):
            run("solve")
            run("fence")
    for name in ("bind", "postbind", "finalize"):
        run(name)
    return ctx.report


def _observe_quality(report, view, assignment, admitted, wait) -> None:
    """Stamp the cycle's placement-quality objectives on the report and
    export them as `scheduler_placement_quality{objective}` gauges."""
    q = cycle_quality_np(view, assignment, admitted, wait)
    q["nominations"] = float(len(report.preempted))
    q["preemptions"] = float(
        sum(len(v) for _, v in report.preempted.values())
    )
    report.quality = q
    for objective, value in q.items():
        obs.metrics.set_gauge(obs.PLACEMENT_QUALITY, value,
                              objective=objective)


def _attribute_failures(scheduler, snap, codes, failed_idx, report,
                        tid="cycle", led=None) -> None:
    """Fill `CycleReport.failed_by`: from the sequential solve's per-pod
    codes (`SolveResult.failed_plugin`, host copy) when it carried them,
    else from the failed rows' cycle-initial verdicts
    (`Scheduler.attribution_codes`). Codes <= 0 decode to the built-in
    fit ("NodeResourcesFit")."""
    if not failed_idx:
        return
    with obs.tracer.span("Attribution", tid=tid, failed=len(failed_idx)):
        if codes is not None:
            per_failure = [codes[i] for i, _ in failed_idx]
        else:
            per_failure = scheduler.attribution_codes(
                snap, [i for i, _ in failed_idx]
            )
        names = scheduler.fail_plugin_names()
        for (_, uid), code in zip(failed_idx, per_failure):
            code = int(code)
            name = names[code] if code > 0 else names[0]
            report.failed_by[uid] = name
            obs.metrics.inc(obs.UNSCHEDULABLE_BY_PLUGIN, plugin=name)
            if led is not None:
                # blame fills the observing cycle's Unschedulable event in
                # place: this decode may run in the next tick's overlap
                # window, where an appended event would order differently
                podledger.LEDGER.set_blame(uid, led.cid, name)


def _requeue_eligible(scheduler, cluster, pending, now, report,
                      gang_phase=False):
    """EnqueueExtensions gating (upstream scheduling-queue semantics): a pod
    parked unschedulable re-enters the batch only when

    - a cluster event registered by an enabled plugin (or the built-in
      resource fit's Node/Pod events) occurred after its last failure,
    - it holds a live nomination (nominated pods stay active),
    - its flush deadline passed (podMaxInUnschedulablePodsDuration), or
    - a gang sibling is eligible (upstream ActivateSiblings),

    and its requeue backoff window has expired (upstream backoffQ: an
    event moves a pod to the backoff queue, and it pops into the active
    queue only once its backoff completes). Nominated pods bypass the
    backoff as they bypass the event gate. Pods never parked always run.

    `gang_phase` registers `api.events.GANG_EVENTS` on top: a pod the
    rank-gang phase parked has no profile plugin to register its events."""
    if not cluster.unschedulable_since:
        return pending
    registered = set(BUILTIN_EVENTS)
    if gang_phase:
        registered.update(ev_api.GANG_EVENTS)
    for plugin in scheduler.profile.plugins:
        registered.update(plugin.events_to_register())
    led = podledger.LEDGER

    def eligible(pod):
        rec = cluster.unschedulable_since.get(pod.uid)
        if rec is None:
            return True
        seq, flush_at = rec
        if pod.nominated_node_name is not None:
            return True
        if now < cluster.pod_backoff_until_ms.get(pod.uid, 0):
            obs.metrics.inc(obs.REQUEUE_BACKOFF_SKIPS)
            if led.enabled:
                led.on_wait(pod.uid, "backoff_held")
            return False
        if now >= flush_at:
            return True
        if any(cluster.event_last.get(kind, 0) > seq for kind in registered):
            return True
        if led.enabled:
            # backoff expired with no registered event yet: the pod now
            # waits on the queue gate, not the backoff clock (one ledger
            # transition a park episode)
            led.on_wait(pod.uid, "queue_wait")
        return False

    keep = [pod for pod in pending if eligible(pod)]
    kept_uids = {p.uid for p in keep}
    # gang activation: one eligible member activates its whole group
    eligible_gangs = {
        pg.full_name for p in keep
        if (pg := cluster.pod_group_of(p)) is not None
    }
    for pod in pending:
        if pod.uid in kept_uids:
            continue
        pg = cluster.pod_group_of(pod)
        if pg is not None and pg.full_name in eligible_gangs:
            keep.append(pod)
            kept_uids.add(pod.uid)
    for pod in pending:
        if pod.uid not in kept_uids:
            report.skipped.append(pod.uid)
    return keep


def _run_preemption(scheduler, cluster, pending, report, now, device=None):
    """PostFilter preemption: for each still-failed pod in queue order, dry
    run victim removal across all nodes, nominate the best candidate, mark
    the victims terminating (the apiserver DELETE in the reference) and
    record the nomination (SURVEY.md §3.3).

    Runs against a FRESH snapshot (this cycle's binds count as node usage,
    or just-bound pods would double as victims), copied to the host once
    for the whole pass, and threads the pass's earlier nominations into
    each dry run so two preemptors cannot claim the same freed capacity."""
    engine = scheduler.profile.preemption
    if engine is None or not report.failed:
        return
    device = resolve_device(device)
    rejected = set(report.rejected_gangs)
    by_uid = {p.uid: p for p in pending}
    failed_pods = [by_uid[uid] for uid in report.failed if uid in by_uid]
    snap, meta = cluster.snapshot(failed_pods, now_ms=now, device=device)
    # re-prepare: the resource axis can differ from the cycle's snapshot
    scheduler.prepare(meta, cluster)
    view = host_view(snap)
    nominated_extra = np.zeros(
        (len(meta.node_names), len(meta.index)), np.int64
    )
    node_pos = {name: i for i, name in enumerate(meta.node_names)}
    # prior cycles' live nominations and nominations made earlier in this
    # loop hold capacity in the dry runs, but only against preemptors of
    # lower-or-equal priority (upstream AddNominatedPods); the capacity
    # in-flight terminations will free is credited to everyone. Each
    # preemptor's view is assembled fresh from the hold list, because the
    # queue order is not priority-descending under every QueueSort
    for pod in cluster.pods.values():
        if pod.terminating and pod.node_name in node_pos:
            nominated_extra[node_pos[pod.node_name]] -= encode_demand(
                meta.index, pod
            )
    holds = [
        (node_pos[pod.nominated_node_name], encode_demand(meta.index, pod),
         pod.priority, pod.uid)
        for pod in cluster.pods.values()
        if pod.node_name is None and not pod.terminating
        and pod.nominated_node_name in node_pos
    ]
    for pod in failed_pods:
        pg = cluster.pod_group_of(pod)
        if pg is not None and pg.full_name in rejected:
            continue  # the whole gang was rejected: no point preempting
        obs.metrics.inc(obs.PREEMPTION_ATTEMPTS)
        extra = nominated_extra.copy()
        for n_, demand_, prio_, uid_ in holds:
            if prio_ >= pod.priority and uid_ != pod.uid:
                extra[n_] += demand_
        result = engine.preempt(cluster, scheduler, pod, snap, meta, now,
                                extra_reserved=extra, view=view)
        if result is GATED:
            continue  # terminations in flight: the nomination (hold) stays
        # the pod's nomination now clears or moves: its old hold is dead
        holds = [h for h in holds if h[3] != pod.uid]
        if result is None:
            # the nomination did not help and nothing is terminating:
            # clear it (upstream clears NominatedNodeName)
            pod.nominated_node_name = None
            if cluster.delta_sink is not None:
                # an in-place change passes no store mutator: tell the
                # serving engine's gate
                cluster.delta_sink.note_nomination(pod)
            if podledger.LEDGER.enabled:
                podledger.LEDGER.on_nomination(pod.uid, None)
            continue
        obs.metrics.inc(obs.PREEMPTION_VICTIMS, len(result.victims))
        # nominate now, so later preemptors' live nominated aggregates see
        # this pod exactly once
        pod.nominated_node_name = result.nominated_node
        if cluster.delta_sink is not None:
            cluster.delta_sink.note_nomination(pod)
        if podledger.LEDGER.enabled:
            podledger.LEDGER.on_nomination(pod.uid, result.nominated_node)
        n = node_pos[result.nominated_node]
        demand = encode_demand(meta.index, pod)
        victim_freed = np.zeros(len(meta.index), np.int64)
        for victim_uid in result.victims:
            victim = cluster.pods.get(victim_uid)
            if victim is not None:
                cluster.mark_terminating(victim_uid, now)
                victim_freed += encode_demand(meta.index, victim)
        # the nominee holds its demand against later lower-or-equal
        # priority preemptors; what its victims free is credited to all
        holds.append((n, demand, pod.priority, pod.uid))
        nominated_extra[n] -= victim_freed
        report.preempted[pod.uid] = (result.nominated_node, result.victims)


def _refresh_metrics(scheduler, cluster: Cluster, now: int):
    """The collector pull loop: every distinct metrics source a Trimaran
    plugin configures (a WatcherAddress service or a MetricProvider
    library client, collector.go:60-73) gets an async collector, cached on
    the scheduler, ticked once a cycle (`state.collector
    .AsyncLoadWatcherCollector` owns the cadence and the thread)."""
    collectors = getattr(scheduler, "_collectors", None)
    for plugin in scheduler.profile.plugins:
        address = getattr(plugin, "watcher_address", None)
        provider = getattr(plugin, "metric_provider", None)
        if not address and not provider:
            continue
        key = address or tuple(sorted((provider or {}).items()))
        if collectors is None:
            collectors = scheduler._collectors = {}
        if key not in collectors:
            try:
                collectors[key] = AsyncLoadWatcherCollector(
                    make_metrics_client(address, provider)
                )
            except ValueError:
                # an unusable source: no metrics from it rather than a
                # failure every cycle (None stops re-construction)
                collectors[key] = None
        if collectors[key] is not None:
            collectors[key].tick(cluster, now)


def _resync_nrt_cache(cluster: Cluster, now: int = 0):
    """The over-reserve cache's resync loop (the reference's background
    `wait.Forever(Resync, period)`, pluginhelpers.go:73), run in the
    prologue: reconcile the dirty nodes against their latest agent
    reports, on the cache's `resync_period_ms` cadence when it has one.
    The fingerprints are computed over the pods the cache's informer mode
    lists (podprovider.go:37-93)."""
    cache = cluster.nrt_cache
    if cache is None or not hasattr(cache, "resync"):
        return
    period_ms = getattr(cache, "resync_period_ms", 0)
    if period_ms:
        last = getattr(cache, "_last_resync_ms", None)
        if last is not None and now - last < period_ms:
            return
        cache._last_resync_ms = now
    if not cache.desynced_nodes():
        return
    node_pods: dict[str, list] = {}
    relevant = getattr(cache, "pod_relevant", lambda pod: True)
    for pod in cluster.pods.values():
        if pod.node_name is not None and relevant(pod):
            node_pods.setdefault(pod.node_name, []).append(pod)
    cache.resync(node_pods)


def _mark_overreserved_on_failures(cluster: Cluster, report: CycleReport):
    """A Filter failure on a cached view may mean a stale deduction
    (filter.go:219-223 NodeMaybeOverReserved): mark every node carrying
    assumed pods dirty, so the next resync reconciles it."""
    cache = cluster.nrt_cache
    if not report.failed or cache is None:
        return
    if not (hasattr(cache, "mark_maybe_overreserved")
            and hasattr(cache, "assumed")):
        return
    for node, assumed in cache.assumed.items():
        if assumed:
            cache.mark_maybe_overreserved(node)


def _maybe_release_gang(cluster: Cluster, pg, report: CycleReport,
                        now: int = 0):
    reserved = cluster.gang_reservations(pg)
    if not reserved:
        return
    bound = sum(
        1 for p in cluster.gang_members(pg) if p.node_name is not None
    )
    if bound + len(reserved) >= pg.min_member:
        for uid in reserved:
            node = cluster.reserved[uid]
            cluster.bind(uid, node, now)  # clears the pod's permit timer
            report.bound[uid] = node
            report.reserved.pop(uid, None)


def _reject_gang(cluster: Cluster, pg, now: int, report: CycleReport,
                 cosched, member_count: int):
    """Reject every waiting sibling, record the failure time, back the
    group off (coscheduling.go:188-209, core.go:174-192). The backoff
    applies only when the gang has at least MinMember pods
    (coscheduling.go:196-204): an incomplete gang retries as soon as its
    members appear."""
    for uid in cluster.gang_reservations(pg):
        cluster.release_reservation(uid)  # clears the pod's permit timer
        report.reserved.pop(uid, None)
        # released siblings are parked too (Permit-Reject moves waiting
        # pods to the unschedulable queue)
        cluster.mark_unschedulable(uid, now)
    cluster.gang_last_failure_ms[pg.full_name] = now
    backoff_s = cosched.pod_group_backoff_seconds if cosched else 0
    if backoff_s > 0 and member_count >= pg.min_member:
        cluster.gang_backoff_until_ms[pg.full_name] = now + 1000 * backoff_s
    report.rejected_gangs.append(pg.full_name)


def _expire_gangs(cluster: Cluster, now: int, report: CycleReport):
    """Permit timeout: any waiting pod past its own deadline fires Reject
    (the upstream per-pod waitingPods timer, coscheduling.go:227-251),
    which unreserves every sibling: the earliest sibling deadline rejects
    the whole gang."""
    for uid, deadline in list(cluster.pod_deadline_ms.items()):
        if now < deadline or uid not in cluster.pod_deadline_ms:
            continue  # not due, or already cleared by a sibling's expiry
        pod = cluster.pods.get(uid)
        pg = cluster.pod_group_of(pod) if pod is not None else None
        if pg is None:
            cluster.release_reservation(uid)  # clears the timer too
            continue
        for sibling_uid in cluster.gang_reservations(pg):
            cluster.release_reservation(sibling_uid)
        cluster.gang_last_failure_ms[pg.full_name] = now
        report.expired_gangs.append(pg.full_name)
