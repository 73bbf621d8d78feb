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

Left out until their slices: the serving engine (`serve`), the solve
watchdog (`resilience`), the rank-aware gang phase (`gangs`), the online
tuner (`tuner`), tracer spans, the pod ledger, the flight recorder and
the sanitizer. Passing one of those arguments raises
NotImplementedError.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np

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
from scheduler_plugins_tpu_torch.parallel.pipeline import (
    streamed_profile_solve,
)
from scheduler_plugins_tpu_torch.plugins.coscheduling import Coscheduling
from scheduler_plugins_tpu_torch.state.cluster import Cluster
from scheduler_plugins_tpu_torch.state.collector import (
    AsyncLoadWatcherCollector,
    make_metrics_client,
)
from scheduler_plugins_tpu_torch.tuning.quality import cycle_quality_np
from scheduler_plugins_tpu_torch.utils.flightrec import explain_solver

#: the `run_cycle` options of the JAX package that later slices bring,
#: each with the slice that brings it
_LATER_SLICES = {
    "serve": "the resident-state serving engine (serving/)",
    "resilience": "the solve watchdog (resilience/)",
    "gangs": "the rank-aware gang phase (gangs/)",
    "tuner": "the online tuner (tuning/shadow.py)",
}


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
    """Mutable state threaded through one cycle's stages."""

    scheduler: Scheduler
    cluster: Cluster
    now: int
    device: object
    report: CycleReport
    #: pods per chunk of the streamed solve; None = the sequential solve
    stream_chunk: Optional[int] = None
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


def _cycle_open(scheduler, cluster, now, device,
                stream_chunk=None) -> CycleCtx:
    """Cycle prologue: the Coscheduling instance, each plugin's cluster
    wiring, permit expiry and the collector ticks."""
    ctx = CycleCtx(scheduler=scheduler, cluster=cluster, now=now,
                   device=device, report=CycleReport(),
                   stream_chunk=stream_chunk)
    ctx.cosched = next(
        (p for p in scheduler.profile.plugins if isinstance(p, Coscheduling)),
        None,
    )
    for plugin in scheduler.profile.plugins:
        plugin.configure_cluster(cluster)
    _expire_gangs(cluster, now, ctx.report)
    _resync_nrt_cache(cluster, now)
    _refresh_metrics(scheduler, cluster, now)
    return ctx


def _cycle_pending(ctx: CycleCtx) -> None:
    """Pending batch: requeue gating, then QueueSort. Sets `ctx.done` on
    an empty batch."""
    pending = _requeue_eligible(ctx.scheduler, ctx.cluster,
                                ctx.cluster.pending_pods(), ctx.now,
                                ctx.report)
    if not pending:
        ctx.done = True
        return
    ctx.pending = ctx.scheduler.sort_pending(pending, ctx.cluster)


def _cycle_snapshot(ctx: CycleCtx) -> None:
    """Lower the store onto the cycle's device and prepare the plugins."""
    ctx.snap, ctx.meta = ctx.cluster.snapshot(ctx.pending, now_ms=ctx.now,
                                              device=ctx.device)
    ctx.scheduler.prepare(ctx.meta, ctx.cluster)


def _cycle_solve_dispatch(ctx: CycleCtx) -> None:
    """The streamed solve when `stream_chunk` is set and the profile
    qualifies, else the sequential solve (which on the card only enqueues
    work). The outputs stay device tensors until the fence."""
    result = None
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
    failure codes, and the snapshot columns the quality stamp reads. The
    first copy waits for the card; later stages read only these. Then the
    report's explain context is attached, with the plugins' `aux()`
    frozen here: the preemption pass re-prepares the shared plugins for
    its own snapshot, and a later cycle for its own."""
    def host(x):
        return x.cpu().numpy()

    result, snap = ctx.result, ctx.snap
    ctx.assignment = host(result.assignment)
    ctx.admitted = host(result.admitted)
    ctx.wait = host(result.wait)
    if result.failed_plugin is not None:
        ctx.failed_plugin = host(result.failed_plugin)
    ctx.quality_view = SimpleNamespace(
        nodes=SimpleNamespace(alloc=host(snap.nodes.alloc),
                              requested=host(snap.nodes.requested),
                              mask=host(snap.nodes.mask)),
        pods=SimpleNamespace(req=host(snap.pods.req),
                             mask=host(snap.pods.mask)),
    )
    _attach_explain_ctx(ctx.report, (
        ctx.scheduler, snap, ctx.meta, ctx.assignment,
        tuple(p.aux() for p in ctx.scheduler.profile.plugins),
    ))


def _cycle_bind(ctx: CycleCtx) -> None:
    """The bind stage: flush this cycle's decisions through the store's
    mutators (bind / reserve / mark_unschedulable)."""
    cluster, report, now = ctx.cluster, ctx.report, ctx.now
    meta, cosched = ctx.meta, ctx.cosched
    assignment, admitted, wait = ctx.assignment, ctx.admitted, ctx.wait
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
            timeout_s = pg.schedule_timeout_seconds if pg is not None else None
            if timeout_s is None and cosched is not None:
                timeout_s = cosched.permit_waiting_seconds
            cluster.pod_deadline_ms[pod.uid] = now + 1000 * (timeout_s or 0)
        else:
            cluster.bind(pod.uid, node_name, now)
            report.bound[pod.uid] = node_name


def _cycle_postbind(ctx: CycleCtx) -> None:
    """Post-bind store machinery: failure attribution, Permit fan-out,
    whole-gang PostFilter rejection and preemption."""
    cluster, report, now = ctx.cluster, ctx.report, ctx.now
    cosched = ctx.cosched
    _attribute_failures(ctx.scheduler, ctx.snap, ctx.failed_plugin,
                        ctx.failed_idx, report)

    # Permit Allow fan-out: quorum reached this cycle releases waiting
    # siblings
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
    _run_preemption(ctx.scheduler, cluster, ctx.pending, report, now,
                    ctx.device)


def _cycle_finalize(ctx: CycleCtx) -> None:
    """Report-only epilogue: the placement-quality stamp."""
    _observe_quality(ctx.report, ctx.quality_view, ctx.assignment,
                     ctx.admitted, ctx.wait)


#: `run_cycle`'s stages after the pending batch, in order, with the names
#: `timings` records them under
_STAGES = (
    ("snapshot", _cycle_snapshot),
    ("solve", _cycle_solve_dispatch),
    ("fence", _cycle_solve_fence),
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
    sequential solve runs. `timings`, a dict, receives each stage's wall
    seconds (`open`, `pending`, then `_STAGES`' names), and
    `scheduling_tables`: the host seconds of the in-tree scheduling tables
    (`state.scheduling.build_scheduling`) inside the snapshot stage. The JAX package's
    `serve`, `resilience`, `gangs` and `tuner` options are not ported yet:
    passing one raises NotImplementedError."""
    options = dict(serve=serve, resilience=resilience, gangs=gangs,
                   tuner=tuner)
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"run_cycle({name}=...) comes with {_LATER_SLICES[name]}"
            )
    device = resolve_device(device)
    if now is None:
        now = _now_ms()
    clock = time.perf_counter
    t0 = clock()
    ctx = _cycle_open(scheduler, cluster, now, device, stream_chunk)
    t1 = clock()
    _cycle_pending(ctx)
    if timings is not None:
        timings["open"] = t1 - t0
        timings["pending"] = clock() - t1
    if ctx.done:
        return ctx.report
    for name, stage in _STAGES:
        t0 = clock()
        stage(ctx)
        if timings is not None:
            timings[name] = clock() - t0
            if name == "snapshot":
                timings["scheduling_tables"] = ctx.meta.scheduling_s
    return ctx.report


def _observe_quality(report, view, assignment, admitted, wait) -> None:
    """Stamp the cycle's placement-quality objectives on the report."""
    q = cycle_quality_np(view, assignment, admitted, wait)
    q["nominations"] = float(len(report.preempted))
    q["preemptions"] = float(
        sum(len(v) for _, v in report.preempted.values())
    )
    report.quality = q


def _attribute_failures(scheduler, snap, codes, failed_idx, report) -> None:
    """Fill `CycleReport.failed_by`: from the sequential solve's per-pod
    codes (`SolveResult.failed_plugin`, host copy) when it carried them,
    else from the failed rows' cycle-initial verdicts
    (`Scheduler.attribution_codes`). Codes <= 0 decode to the built-in
    fit ("NodeResourcesFit")."""
    if not failed_idx:
        return
    if codes is not None:
        per_failure = [codes[i] for i, _ in failed_idx]
    else:
        per_failure = scheduler.attribution_codes(
            snap, [i for i, _ in failed_idx]
        )
    names = scheduler.fail_plugin_names()
    for (_, uid), code in zip(failed_idx, per_failure):
        code = int(code)
        report.failed_by[uid] = names[code] if code > 0 else names[0]


def _requeue_eligible(scheduler, cluster, pending, now, report):
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
    backoff as they bypass the event gate. Pods never parked always run."""
    if not cluster.unschedulable_since:
        return pending
    registered = set(BUILTIN_EVENTS)
    for plugin in scheduler.profile.plugins:
        registered.update(plugin.events_to_register())

    def eligible(pod):
        rec = cluster.unschedulable_since.get(pod.uid)
        if rec is None:
            return True
        seq, flush_at = rec
        if pod.nominated_node_name is not None:
            return True
        if now < cluster.pod_backoff_until_ms.get(pod.uid, 0):
            return False
        if now >= flush_at:
            return True
        return any(
            cluster.event_last.get(kind, 0) > seq for kind in registered
        )

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
            continue
        # nominate now, so later preemptors' live nominated aggregates see
        # this pod exactly once
        pod.nominated_node_name = result.nominated_node
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
