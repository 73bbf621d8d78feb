"""Concurrent cycle pipeline: ingest, solve and bind overlapped across
cycles (port of `scheduler_plugins_tpu.framework.pipeline_cycle`).

`framework.cycle.run_cycle` is strictly serial: ingest, snapshot, solve,
the host-copy fence and bind on one thread. This module composes the SAME
`_cycle_*` stage functions into a pipelined engine (`PipelinedCycle`)
that keeps cycle N's solve in flight while neighbouring cycles' host
stages run:

    tick N:   [conflict fence]──[ingest N]──[dispatch N]╮
                                                        │ the card solves N
              [finalize N-1  ← overlap window]──────────┤
              [fence N: host copies]────────────────────╯
              [bind N → flusher thread]  (tick returns; the flusher's
                                          mutations are joined by tick
                                          N+1's conflict fence)

Ordering contract (what keeps pipelined placements equal to the serial
engine's):

- **Conflict fence.** Cycle N's bind and post-bind stage mutates the
  store (binds, reservations, backoff charges, nomination set and clear).
  Cycle N+1's ingest boundary (the pending-index read and the serving
  engine's sink drain) joins the flusher first, so each of those
  mutations is attributed to the cycle that observed the snapshot. A bind
  that flushes after a drain (possible only outside the tick loop, a
  `flush()` racing an outside drain) still reaches the resident state
  exactly: each mutator pushes its sink event, and a late bind is an
  ordinary delta (`scheduler_cycle_late_binds_total` counts them).
- **Overlap window.** Only report-local work runs while cycle N's solve
  is in flight: cycle N-1's failure decode (when its per-pod codes came
  back with the solve), its quality stamp and nothing else. It reads only
  the host copies N-1's fence made (the resident node columns were
  updated in place by cycle N's refresh by then) and touches no store
  state, so overlap cannot reorder decisions.
- **Gang and preemption machinery** runs in the bind stage, after the
  fence, where the serial engine runs it.

The engine turns on the store's O(changed) pending index
(`Cluster.enable_pending_index`) and pairs with
`serving.engine.StreamingServeEngine`'s node-delete compaction.

On the card the sequential parity solve is a host loop of work calls, so
the dispatch returns only after most of the solve has run, and the solve
envelope the overlap window can cover is under 1 ms of a cycle of about
50 ms at config 11's size. `overlap_efficiency` measured about 0.7 there
(`chip_smoke.py` phase 20, NVIDIA H100 80GB HBM3 at 700 W) because that
envelope is small, not because the solve overlaps the host work: the
pipelined engine's gain over `run_cycle` comes from the streaming engine's
fast verify and node-delete compaction, not from overlap.

The flight recorder and the sanitizer hook in as in `run_cycle`: the
record opens and the foreign sanitizer reports drain at the ingest
boundary, the inputs are captured with the snapshot, the outputs and this
cycle's sanitizer reports after the fence, and the record commits in the
deferred finalize, in the next tick's overlap window.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from typing import Optional

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.framework.cycle import (
    CycleReport,
    _cycle_arm,
    _cycle_bind,
    _cycle_finalize,
    _cycle_open,
    _cycle_pending,
    _cycle_post_solve,
    _cycle_postbind,
    _cycle_snapshot,
    _cycle_solve_dispatch,
    _cycle_solve_fence,
)
from scheduler_plugins_tpu_torch.framework.runtime import now_ms as _now_ms
from scheduler_plugins_tpu_torch.obs import ledger as podledger
from scheduler_plugins_tpu_torch.utils import observability as obs


class CycleTimeline:
    """Host-stamp timeline of one pipelined cycle: every number comes from
    a host-observable boundary (the dispatch returning, the fence's host
    copies completing). The solve envelope (dispatch return to fence
    return) is a conservative window of the device's work: the host cannot
    see the card start or finish closer than its own sync points."""

    __slots__ = (
        "cycle", "t0_s", "ingest_ms", "dispatch_ms", "overlap_ms",
        "fence_wait_ms", "bind_ms", "bind_done_s", "total_ms", "late_bind",
    )

    def __init__(self, cycle: int):
        self.cycle = cycle
        self.t0_s = 0.0
        self.ingest_ms = 0.0
        self.dispatch_ms = 0.0
        self.overlap_ms = 0.0
        self.fence_wait_ms = 0.0
        self.bind_ms = 0.0
        #: seconds on the tick clock when the bind flush completed (the
        #: decision-latency stamp: ingest boundary to host-visible binds);
        #: stamped by the flusher thread
        self.bind_done_s = 0.0
        self.total_ms = 0.0
        self.late_bind = False

    @property
    def pipeline_bubble_ms(self) -> float:
        """Wall time the fence waited with the solve still running and no
        overlap work left: the un-overlapped remainder."""
        return self.fence_wait_ms

    @property
    def overlap_efficiency(self) -> float:
        """Fraction of the post-dispatch solve envelope covered by useful
        host work (1.0 = the fence never waited)."""
        envelope = self.overlap_ms + self.fence_wait_ms
        if envelope <= 0:
            return 1.0
        return min(1.0, self.overlap_ms / envelope)

    def as_dict(self) -> dict:
        return {
            "cycle": self.cycle,
            "ingest_ms": round(self.ingest_ms, 3),
            "dispatch_ms": round(self.dispatch_ms, 3),
            "overlap_ms": round(self.overlap_ms, 3),
            "pipeline_bubble_ms": round(self.pipeline_bubble_ms, 3),
            "bind_ms": round(self.bind_ms, 3),
            "total_ms": round(self.total_ms, 3),
            "overlap_efficiency": round(self.overlap_efficiency, 4),
        }


class PipelinedCycle:
    """Pipelined cycle engine over one scheduler and cluster store, its
    snapshots and solves on `device` (None = the CUDA card, raising
    without one; the CPU only when asked for with "cpu").

    `tick(now)` runs one cycle and returns its `CycleReport`. With
    `async_bind` (the default) the report's bind and post-bind stage may
    still be flushing on the worker thread when `tick` returns: call
    `fence()` (or run the next tick, whose ingest boundary fences) before
    reading the store or the report's decision fields (bound, reserved,
    failed, preempted). The report's deferred fields, `quality` and
    `failed_by` when the per-pod codes came back with the solve, are
    filled by the NEXT tick's overlap window or by `flush()`, which fences
    and finalizes the last cycle (call it, or `close()`, at the end). An
    exception raised on the flusher re-raises at the next `fence()`.

    `serve` (a serving engine), `gangs` (a `GangPhase`), `resilience` (the
    solve watchdog, whose deadline needs a synchronous solve: a resilient
    tick fences inside the dispatch stage, and the overlap window covers
    only the previous cycle's finalize) and `stream_chunk` behave as in
    `run_cycle`. With `async_bind=False` the bind and post-bind stage run
    on the caller's thread inside `tick` and no flusher thread is started:
    the daemon's choice, whose tick holds the feed lock, so every store
    mutation happens under it.
    """

    #: host stages in flight at once: cycle N's bind flush and cycle
    #: N+1's ingest and dispatch, with cycle N's finalize deferred into
    #: N+1's overlap window
    DEPTH = 2

    #: cycles of `CycleTimeline` kept in `timelines`
    TIMELINE_KEEP = 512

    def __init__(self, scheduler, cluster, serve=None, resilience=None,
                 gangs=None, stream_chunk=None, async_bind=True, *,
                 device=None):
        self.scheduler = scheduler
        self.cluster = cluster
        self.serve = serve
        self.resilience = resilience
        self.gangs = gangs
        self.stream_chunk = stream_chunk
        self.device = resolve_device(device)
        cluster.enable_pending_index()
        self._flusher = (
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="spt-bind-flusher")
            if async_bind else None
        )
        self._bind_future = None
        #: (ctx, attribution done in the bind stage) awaiting the deferred
        #: finalize
        self._pending_finalize = None
        self._cycle_id = 0
        self.timelines: deque = deque(maxlen=self.TIMELINE_KEEP)
        self._clock = time.perf_counter

    # -- introspection ---------------------------------------------------
    @property
    def depth(self) -> int:
        return self.DEPTH

    @property
    def inflight(self) -> int:
        """Cycles with host work outstanding: an unflushed bind stage
        and/or a deferred finalize."""
        n = 0
        if self._bind_future is not None and not self._bind_future.done():
            n += 1
        if self._pending_finalize is not None:
            n += 1
        return n

    # -- the conflict fence ---------------------------------------------
    def fence(self) -> None:
        """Join the bind flusher: THE conflict fence. Every store mutation
        of the previous cycle's bind and post-bind stage is visible after
        this returns; the flusher's exception, if any, re-raises here."""
        future, self._bind_future = self._bind_future, None
        if future is not None:
            future.result()

    def flush(self) -> Optional[CycleReport]:
        """Fence the outstanding binds and run the deferred finalize of
        the last cycle. Returns that cycle's report (now complete) or
        None."""
        self.fence()
        return self._finalize_prev()

    def close(self) -> None:
        self.flush()
        if self._flusher is not None:
            self._flusher.shutdown(wait=True)

    # -- the tick --------------------------------------------------------
    def tick(self, now: Optional[int] = None) -> CycleReport:
        if now is None:
            now = _now_ms()
        # the ledger's lane-0 scope is pushed by `_cycle_open` on THIS
        # thread (the flusher pushes its own lane-1 scopes): pop it on
        # every exit, so events between ticks fall back to ambient
        # attribution and a raise cannot leak a scope
        ctx_box: list = []
        try:
            return self._tick(now, ctx_box)
        finally:
            if ctx_box:
                podledger.LEDGER.pop_scope(ctx_box[0].led)
                podledger.LEDGER.cycle_close(ctx_box[0].led)

    def _tick(self, now: int, ctx_box: list) -> CycleReport:
        clock = self._clock
        cid = self._cycle_id
        self._cycle_id += 1
        tl = CycleTimeline(cid)
        tl.t0_s = clock()

        # ---- ingest boundary: the conflict fence, then host ingest -----
        # the log flow spans the snapshot through the fence, as in
        # `run_cycle`; the stack closes it on a raise too
        with ExitStack() as flow:
            with obs.tracer.span(f"ingest cycle {cid}", tid="Cycle/ingest"):
                self.fence()
                ctx = _cycle_open(self.scheduler, self.cluster, now,
                                  self.device, self.stream_chunk,
                                  self.serve, self.resilience, self.gangs)
                ctx.tid = "Cycle/bind"
                ctx_box.append(ctx)
                _cycle_pending(ctx)
                if ctx.done:
                    # an empty or gang-only cycle: nothing in flight to
                    # overlap; finalize the deferred cycle now so reports
                    # stay in order
                    self._finalize_prev()
                    tl.ingest_ms = (clock() - tl.t0_s) * 1000.0
                    tl.total_ms = tl.ingest_ms
                    tl.bind_done_s = clock() - tl.t0_s
                    self.timelines.append(tl)
                    return ctx.report
                _cycle_arm(ctx)
                ctx.serve_t0 = clock() if self.serve is not None else None
                flow.enter_context(obs.flow(
                    "cycle",
                    generation=getattr(self.cluster.nrt_cache,
                                       "generation", None),
                    pending=len(ctx.pending),
                ))
                _cycle_snapshot(ctx)
            tl.ingest_ms = (clock() - tl.t0_s) * 1000.0

            # ---- dispatch: the solve goes in flight --------------------
            t0 = clock()
            with obs.tracer.span(f"solve cycle {cid}", tid="Cycle/solve",
                                 pending=len(ctx.pending)):
                _cycle_solve_dispatch(ctx)
            tl.dispatch_ms = (clock() - t0) * 1000.0

            # ---- overlap window: the previous cycle's epilogue ---------
            t0 = clock()
            with obs.tracer.span(f"finalize cycle {cid - 1}",
                                 tid="Cycle/finalize"):
                self._finalize_prev()
            tl.overlap_ms = (clock() - t0) * 1000.0

            # ---- fence: the host copies complete the solve -------------
            t0 = clock()
            with obs.tracer.span(f"fence cycle {cid}", tid="Cycle/solve"):
                _cycle_solve_fence(ctx)
            tl.fence_wait_ms = (clock() - t0) * 1000.0
            _cycle_post_solve(ctx)

        # ---- bind + post-bind: flushed behind the conflict fence --------
        # The failure decode must run against THIS cycle's snapshot and
        # plugins when the codes did not come back with the solve (the
        # cycle-initial reduction reads the snapshot on the device, which
        # the next refresh updates in place): eagerly, in the flush. The
        # sequential solve's codes are host copies, decodable any time:
        # deferred into the next overlap window.
        eager_attr = ctx.failed_plugin is None
        # the sink's drain generation at submit: inside the tick loop the
        # fence lands every flush before the next drain, so a crossing
        # shows only when an outside drain (a direct `engine.refresh`)
        # overtakes an in-flight bind, the case the binds-as-deltas
        # taxonomy absorbs
        sink = getattr(self.serve, "_sink", None)
        drains_at_submit = sink.drains if sink is not None else None

        def bind_job():
            t0 = clock()
            with obs.tracer.span(f"bind cycle {cid}", tid="Cycle/bind"):
                _cycle_bind(ctx)
                _cycle_postbind(ctx, attribution=eager_attr)
            tl.bind_ms = (clock() - t0) * 1000.0
            tl.bind_done_s = clock() - tl.t0_s
            if sink is not None and sink.drains != drains_at_submit:
                # the flush crossed a drain: its mutations reach the
                # resident state as ordinary deltas of a later window
                tl.late_bind = True
                obs.metrics.inc(obs.CYCLE_LATE_BINDS)

        if self._flusher is not None:
            self._bind_future = self._flusher.submit(bind_job)
        else:
            bind_job()

        self._pending_finalize = (ctx, eager_attr)
        tl.total_ms = (clock() - tl.t0_s) * 1000.0
        obs.metrics.set_gauge(obs.CYCLE_OVERLAP_EFFICIENCY,
                              tl.overlap_efficiency)
        obs.metrics.set_gauge(obs.CYCLE_PIPELINE_BUBBLE,
                              tl.pipeline_bubble_ms)
        self.timelines.append(tl)
        return ctx.report

    def _finalize_prev(self) -> Optional[CycleReport]:
        pending, self._pending_finalize = self._pending_finalize, None
        if pending is None:
            return None
        prev_ctx, attributed = pending
        _cycle_finalize(prev_ctx, attribution=not attributed)
        return prev_ctx.report
