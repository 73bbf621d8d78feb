"""K-lane optimistic-concurrency cycle engine: one conflict fence (port of
`scheduler_plugins_tpu.framework.laned_cycle`).

`framework.cycle.run_cycle` admits the whole pending queue through ONE
sequential solve; `framework.pipeline_cycle.PipelinedCycle` overlaps
cycles but still admits through that one solve. This module composes the
SAME `_cycle_*` stage functions around the K-lane speculative solver
(`parallel.lanes.LaneSolver`): the pending queue partitions across K
lanes by a deterministic key (gang members never split), every lane
solves speculatively against the same snapshot, and a single conflict
fence walks the DEFINED SERIAL ORDER (the global queue order, the order
`run_cycle`'s solve commits), committing validated placements wholesale
and re-solving from the first conflict against the committed state.

Ordering contract (what keeps laned placements equal to `run_cycle`'s at
every K):

- **One solve boundary.** The laned solve replaces ONLY the dispatch and
  fence pair inside the Solve extension span. Everything before (requeue
  gating, queue sort, gang phase, serve refresh, prepare) and after (bind,
  Permit fan-out, PostFilter gang rejection, preemption, finalize) is the
  serial engine's own stage function.
- **Fence exactness.** The fence validates per-pod step signatures (admit
  verdicts and the built-in fit mask) on host int64 twins of the device
  math and re-solves the remaining suffix through the same step body on
  the first mismatch (`parallel.lanes`).
- **Serial fallback.** K == 1, profiles outside the fence-exact gate
  (armed side tables, preemption nominees, unknown admit plugins) and
  packing-mode profiles route to `Scheduler.solve`, the parity path
  itself.
- **Binds land as ordinary deltas.** All K lanes share the one store and
  (when serving) the one delta sink: the fence's merged decisions flow
  through `_cycle_bind`'s store mutators. With `async_bind` the flush runs
  on the "spt-lane-flusher" worker behind the same join-first fence as
  the pipelined engine; a flush crossing an outside drain is counted late
  (`scheduler_cycle_late_binds_total`) and absorbed.

The flight recorder and the sanitizer hook in as in `run_cycle`. The
laned solve returns per-pod codes, so its record is labelled
"sequential" and replays bit-identically through the parity solve; under
`async_bind` the record commits on the "spt-lane-flusher" worker, in the
finalize.
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
    SolveResultView,
    _cycle_arm,
    _cycle_bind,
    _cycle_finalize,
    _cycle_open,
    _cycle_pending,
    _cycle_post_solve,
    _cycle_postbind,
    _cycle_snapshot,
    _cycle_solve_fence,
)
from scheduler_plugins_tpu_torch.framework.runtime import now_ms as _now_ms
from scheduler_plugins_tpu_torch.obs import ledger as podledger
from scheduler_plugins_tpu_torch.utils import observability as obs

#: rolling lane attributions `LanedCycle.lane_reports` keeps
REPORT_KEEP = 512


class LanedCycle:
    """K-lane cycle engine over one scheduler and cluster store, its
    snapshots and solves on `device` (None = the CUDA card, raising
    without one; the CPU only when asked for with "cpu").

    `tick(now)` runs one cycle and returns its `CycleReport`, with
    `report.lanes` carrying the lane attribution (k, per-lane sizes /
    committed / conflicts, the re-resolve count, solve and fence wall ms).
    With `async_bind` the bind / post-bind / finalize epilogue flushes on a
    worker thread: call `fence()` (or tick again: the ingest boundary
    fences first) before reading the store, and `flush()` / `close()` at
    shutdown, the `PipelinedCycle` discipline.

    `serve` and `gangs` compose like `run_cycle`'s parameters. There is
    deliberately no `resilience`: the watchdog's deadline wraps one
    synchronous solve, and its degraded host path IS the sequential
    engine, to which lanes would add nothing but the fence.
    """

    def __init__(self, scheduler, cluster, k: int = 4, serve=None,
                 gangs=None, dispatch: str = "fused",
                 async_bind: bool = False, *, device=None):
        # deferred: parallel.lanes imports the framework package (the step
        # body and SolverState), so a module-level import here would be
        # circular through framework/__init__
        from scheduler_plugins_tpu_torch.parallel.lanes import LaneSolver

        if scheduler.profile.solve_mode == "packing":
            raise ValueError(
                "LanedCycle requires the sequential parity solve "
                "(profile solve_mode 'packing' has no per-pod serial "
                "order for the conflict fence to replay)"
            )
        self.scheduler = scheduler
        self.cluster = cluster
        self.serve = serve
        self.gangs = gangs
        self.device = resolve_device(device)
        # the O(changed) pending index the cycle's pending read walks
        cluster.enable_pending_index()
        self.solver = LaneSolver(scheduler, k=k, dispatch=dispatch,
                                 device=self.device)
        self._flusher = (
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="spt-lane-flusher")
            if async_bind else None
        )
        self._bind_future = None
        self._cycle_id = 0
        #: rolling lane attributions (report.lanes dicts), most recent last
        self.lane_reports: deque = deque(maxlen=REPORT_KEEP)
        self.cycles = 0
        self.conflicts_total = 0
        self.re_resolved_total = 0
        self.serial_fallbacks = 0

    @property
    def k(self) -> int:
        return self.solver.k

    # -- the conflict fence (the bind flusher's join) ---------------------
    def fence(self) -> None:
        """Join the async bind flusher: every store mutation of the
        previous cycle's bind and post-bind stage is visible after this
        returns (its exception, if any, re-raises here)."""
        future, self._bind_future = self._bind_future, None
        if future is not None:
            future.result()

    def flush(self) -> None:
        self.fence()

    def close(self) -> None:
        self.flush()
        if self._flusher is not None:
            self._flusher.shutdown(wait=True)
        self.solver.close()

    # -- the tick --------------------------------------------------------
    def tick(self, now: Optional[int] = None) -> CycleReport:
        if now is None:
            now = _now_ms()
        # the ledger's lane-0 scope is pushed by `_cycle_open` on this
        # thread: pop it on every exit so a raise cannot leak a scope
        ctx_box: list = []
        try:
            return self._tick(now, ctx_box)
        finally:
            if ctx_box:
                podledger.LEDGER.pop_scope(ctx_box[0].led)
                podledger.LEDGER.cycle_close(ctx_box[0].led)

    def _tick(self, now: int, ctx_box: list) -> CycleReport:
        cid = self._cycle_id
        self._cycle_id += 1

        # ingest boundary: join the previous flush FIRST, so every bind,
        # backoff and nomination of cycle N is visible to cycle N+1's
        # pending read and serve drain
        self.fence()
        ctx = _cycle_open(self.scheduler, self.cluster, now, self.device,
                          serve=self.serve, gangs=self.gangs)
        if self._flusher is not None:
            # bind and post-bind spans move off the main thread: their own
            # row keeps every trace row single-threaded
            ctx.tid = "Lane/bind"
        ctx_box.append(ctx)
        _cycle_pending(ctx)
        if ctx.done:
            return ctx.report
        _cycle_arm(ctx)

        ctx.serve_t0 = (
            time.perf_counter() if self.serve is not None else None
        )
        with ExitStack() as flow:
            flow.enter_context(obs.flow(
                "cycle",
                generation=getattr(self.cluster.nrt_cache, "generation",
                                   None),
                pending=len(ctx.pending),
            ))
            _cycle_snapshot(ctx)
            with obs.extension_span(
                "Solve", self.scheduler.profile.name,
                pending=len(ctx.pending), lanes=self.k,
            ):
                if ctx.led is not None:
                    # this engine runs its own solver (not
                    # `_cycle_solve_dispatch`), so the ledger's solve stamp
                    # lands here
                    ctx.led.t_solve = podledger.LEDGER._now()
                assignment, admitted, wait, codes, stats = (
                    self.solver.solve(ctx.snap, ctx.pending, self.cluster,
                                      meta=ctx.meta)
                )
                # host arrays with per-pod codes: failure attribution
                # decodes exactly, as on the parity path
                ctx.result = SolveResultView(assignment, admitted, wait,
                                             failed_plugin=codes)
                _cycle_solve_fence(ctx)
            ctx.report.lanes = stats.as_dict()
            self.cycles += 1
            self.conflicts_total += sum(stats.conflicts or [])
            self.re_resolved_total += stats.re_resolved
            if (stats.path == "serial"
                    and stats.serial_fallback_reason != "k=1"):
                # gate rejections only: K == 1 through the parity solve is
                # the engine's intended degenerate configuration
                self.serial_fallbacks += 1
            self.lane_reports.append(ctx.report.lanes)
            _cycle_post_solve(ctx)

        # bind + post-bind + finalize: inline, or flushed behind the
        # join-first fence. Attribution runs inside the flush: the laned
        # result carries per-pod codes (host ints, decodable any time), and
        # the post-bind gang and preemption machinery needs the failure set
        sink = getattr(self.serve, "_sink", None)
        drains_at_submit = sink.drains if sink is not None else None

        def bind_job():
            with obs.tracer.span(f"bind cycle {cid}", tid=ctx.tid):
                _cycle_bind(ctx)
                _cycle_postbind(ctx, attribution=True)
                _cycle_finalize(ctx)
            if sink is not None and sink.drains != drains_at_submit:
                # crossed an outside drain: the binds reach the resident
                # serving state as ordinary deltas of a later window
                obs.metrics.inc(obs.CYCLE_LATE_BINDS)

        if self._flusher is not None:
            self._bind_future = self._flusher.submit(bind_job)
        else:
            bind_job()
        return ctx.report

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        """Totals and the most recent cycle's lane attribution."""
        last = self.lane_reports[-1] if self.lane_reports else None
        return {
            "k": self.k,
            "partition": self.solver.partition,
            "dispatch": self.solver.dispatch,
            "cycles": self.cycles,
            "conflicts_total": self.conflicts_total,
            "re_resolved_total": self.re_resolved_total,
            "serial_fallbacks": self.serial_fallbacks,
            "last": last,
        }
