"""Double-buffered chunk pipeline (port of `scheduler_plugins_tpu.parallel.pipeline`).

The north-star solve streams pods through the chunked targeted waterfill
with free capacity carried between chunks (queue order preserved across
chunk boundaries). `run_chunk_pipeline` overlaps the three phases of a
chunk with a one-chunk lag:

    dispatch solve(k)            # the card starts on chunk k
    stage chunk k+1's inputs     # pinned host -> card on a side stream
    fetch result k-1             # card -> pinned host, waits for k-1 only

On the card the host numpy inputs of chunk k+1 are copied into pinned
memory and sent with `non_blocking=True` on a side CUDA stream while chunk
k solves; the compute stream waits on that copy before solve k+1 reads it,
and the staged tensors are `record_stream`ed on the compute stream so the
caching allocator cannot hand their memory out under the solve. Chunk
k-1's result is copied into pinned host buffers behind solve k-1 on the
compute stream and waited on with an event, so the fetch never waits for
chunk k. On the CPU the streams and pinned memory drop out and the calls
come in the same order.

The chunk solver takes its carry last and returns `(result, carry)`; the
carry is rebound from each call's return, the calling convention the JAX
package enforces by donating it (`donated_chunk_solver`, not ported: eager
PyTorch has no donation to request).

Consumers: `chip_smoke.py`'s north-star pipeline phase and the cycle
(`framework.cycle.run_cycle(stream_chunk=...)`) through
`streamed_profile_solve` below.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import (
    finish_fetch,
    resolve_device,
    start_fetch,
)
from scheduler_plugins_tpu_torch.ops.assign import waterfill_assign_targeted
from scheduler_plugins_tpu_torch.parallel.solver import (
    fast_path_scoring,
    fast_solve_head,
    finalize_assignment,
)


@dataclass
class PipelineTimeline:
    """Host-sync stamps of one `run_chunk_pipeline` run.

    Every number comes from host-observable boundaries: the chunk solver's
    call returning (`dispatch`), the staging of the next chunk's inputs
    returning (`h2d`: pinning and enqueueing the copy, not its wire time)
    and the fetch of a result completing (`d2h`, the only true completion
    fence). The port's waterfill reads one flag to the host per wave, so
    on the card a chunk's dispatch returns only when the chunk is nearly
    done. `summary(solve_ms=...)` takes the caller's device time of the
    solves (`chip_smoke.py` sums CUDA events around each chunk's solve)
    and charges the rest of the wall time as the pipeline bubble.

    The stamps and `summary` are the JAX class's arithmetic, with its
    rounding. Its Perfetto replay (`emit_trace`) and tracer anchor come
    with the tracing slice."""

    n_chunks: int = 0
    #: [{stage: dispatch|h2d|d2h, chunk, start_s, end_s}] on the caller's
    #: clock (seconds); only differences matter
    events: list = field(default_factory=list)
    start_s: float = 0.0
    end_s: float = 0.0

    def open(self, start_s: float) -> None:
        self.start_s = start_s

    def add(self, stage: str, chunk: int, start_s: float, end_s: float) -> None:
        self.events.append(
            {"stage": stage, "chunk": chunk,
             "start_s": start_s, "end_s": end_s}
        )

    def close(self, end_s: float) -> None:
        self.end_s = end_s

    def stage_ms(self, stage: str) -> float:
        return sum(
            (e["end_s"] - e["start_s"]) * 1000.0
            for e in self.events if e["stage"] == stage
        )

    @property
    def elapsed_ms(self) -> float:
        return (self.end_s - self.start_s) * 1000.0

    def summary(self, solve_ms: float | None = None) -> dict:
        """Pipeline-overlap report. `solve_ms` is the caller's measure of
        the total device solve time; without it only the stage totals are
        reported.

        - `pipeline_bubble_ms` = elapsed - solve_ms, floored at 0: the
          wall time the device was not solving.
        - `overlap_efficiency` = solve_ms / elapsed, capped at 1.
        - `h2d_overlap_efficiency` / `d2h_overlap_efficiency` = the share
          of that host stage's time hidden behind device work, the bubble
          charged to the host stages pro rata by their time (an estimate:
          the lag-1 window cannot see which stage exposed which gap)."""
        h2d = self.stage_ms("h2d")
        d2h = self.stage_ms("d2h")
        dispatch = self.stage_ms("dispatch")
        out = {
            "elapsed_ms": round(self.elapsed_ms, 3),
            "chunks": self.n_chunks,
            "h2d_ms": round(h2d, 3),
            "d2h_ms": round(d2h, 3),
            "dispatch_ms": round(dispatch, 3),
            "pipeline_bubble_ms": None,
            "overlap_efficiency": None,
            "h2d_overlap_efficiency": None,
            "d2h_overlap_efficiency": None,
        }
        if solve_ms is None or self.elapsed_ms <= 0:
            return out
        bubble = max(0.0, self.elapsed_ms - solve_ms)
        out["pipeline_bubble_ms"] = round(bubble, 3)
        out["overlap_efficiency"] = round(
            min(1.0, solve_ms / self.elapsed_ms), 4
        )
        host_total = h2d + d2h + dispatch
        for key, stage_total in (("h2d_overlap_efficiency", h2d),
                                 ("d2h_overlap_efficiency", d2h)):
            if stage_total <= 0 or host_total <= 0:
                out[key] = 1.0
                continue
            exposed = min(stage_total, bubble * stage_total / host_total)
            out[key] = round(1.0 - exposed / stage_total, 4)
        return out


def _on_device(t, device) -> bool:
    """Whether tensor `t` lies on `device` ("cuda" matches any card
    index)."""
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index
    )


class _Stager:
    """Moves one chunk's inputs to the device: tensors already there pass
    through; numpy arrays and host tensors go through pinned memory on the
    side stream (card) or are wrapped as they are (CPU)."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def stage(self, args):
        """(tensors, event): the chunk's device tensors and, on the card,
        the event that marks the end of their copies."""
        out = []
        for a in args:
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a)
            )
            if _on_device(t, self.device):
                out.append(t)
            elif self.cuda:
                pinned = t.pin_memory()
                with torch.cuda.stream(self.stream):
                    out.append(pinned.to(self.device, non_blocking=True))
            else:
                out.append(t.to(self.device))
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record(self.stream)
        return tuple(out), event

    def consume(self, tensors, event) -> None:
        """Make the compute stream wait for the staged copies, and tie the
        staged memory to it."""
        if event is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in tensors:
            if t.device.type == "cuda":
                t.record_stream(compute)


def run_chunk_pipeline(solve_chunk, invariant_args, chunk_inputs, carry,
                       clock=None, fetch_deadline_s=None, *, device=None):
    """Stream `chunk_inputs` through `solve_chunk`, double-buffered, on
    `device` (None = the CUDA card; the CPU only when asked for).

    - ``solve_chunk(*invariant_args, *chunk_tensors, carry) -> (result,
      carry)``; `result` may be a tensor or a tuple / list / dict of them
      (other leaves pass through).
    - ``chunk_inputs``: per-chunk argument tuples, host numpy or tensors;
      tensors already on `device` pass through, the rest are staged one
      chunk ahead.
    - ``carry``: the threaded state (free capacity), rebound from each
      call's return.
    - ``clock``: a ``time.perf_counter``-like callable for the stamps.
    - ``fetch_deadline_s``: the JAX package's per-fetch deadline; it comes
      with the resilience slice, and anything but None raises.

    Returns ``(results, carry, done_s, timeline)``: ``results[k]`` is
    chunk k's result with its tensors fetched to numpy, ``done_s[k]`` the
    seconds from the start to that fetch's completion (observed one
    dispatch later: conservative, never optimistic) and ``timeline`` the
    `PipelineTimeline` of the dispatch, h2d and d2h stamps."""
    if fetch_deadline_s is not None:
        raise NotImplementedError(
            "run_chunk_pipeline(fetch_deadline_s=...) comes with the "
            "resilience slice (resilience/watchdog.py)"
        )
    device = resolve_device(device)
    clock = clock or time.perf_counter
    stager = _Stager(device)
    n = len(chunk_inputs)
    results, done_s = [], []
    timeline = PipelineTimeline(n_chunks=n)
    start = clock()
    timeline.open(start)
    pending = None
    staged = ((), None)
    if n:
        t0 = clock()
        staged = stager.stage(chunk_inputs[0])
        timeline.add("h2d", 0, t0, clock())
    for k in range(n):
        t0 = clock()
        stager.consume(*staged)
        result, carry = solve_chunk(*invariant_args, *staged[0], carry)
        fetch = start_fetch(result, device)
        timeline.add("dispatch", k, t0, clock())
        if k + 1 < n:
            # chunk k+1's copy overlaps solve(k)
            t0 = clock()
            staged = stager.stage(chunk_inputs[k + 1])
            timeline.add("h2d", k + 1, t0, clock())
        if pending is not None:
            # chunk k-1's fetch waits only for its own solve
            t0 = clock()
            results.append(finish_fetch(pending))
            t1 = clock()
            timeline.add("d2h", k - 1, t0, t1)
            done_s.append(t1 - start)
        pending = fetch
    if pending is not None:
        t0 = clock()
        results.append(finish_fetch(pending))
        t1 = clock()
        timeline.add("d2h", n - 1, t0, t1)
        done_s.append(t1 - start)
    timeline.close(clock())
    return results, carry, done_s, timeline


# ---------------------------------------------------------------------------
# Streamed profile solve (the cycle's adoption point)
# ---------------------------------------------------------------------------


#: waves per phase and rescue window of the streamed chunk solve: the
#: JAX package's `streamed_profile_solve` defaults, which every caller there
#: takes
STREAM_MAX_WAVES = 8
STREAM_RESCUE_WINDOW = 256


def streamed_profile_solve(scheduler, snap, chunk: int = 4096, *,
                           device=None):
    """The targeted fast-path solve of `scheduler`'s profile over `snap`,
    streamed in queue-order chunks of `chunk` pods through
    `run_chunk_pipeline` on `device` (None = the CUDA card; the snapshot
    moves there if it lives elsewhere). Admission and the static node
    ranking are computed once (`fast_solve_head`); the free capacity is
    carried from chunk to chunk; the queue-order quota prefix and gang
    quorum run once over the whole batch (`finalize_assignment`).

    Returns (assignment, admitted, wait) device tensors, or None when the
    profile fails the gate (`parallel.solver.fast_path_scoring`) or the
    pod rows are not a multiple of the chunk (the caller then runs the
    sequential solve)."""
    plugins = tuple(scheduler.profile.plugins)
    scoring = fast_path_scoring(plugins)
    if scoring is None:
        return None
    P = snap.num_pods
    chunk = min(chunk, P)
    if P % chunk != 0:
        return None
    device = resolve_device(device)
    if snap.device != device:
        snap = snap.to(device)
    state0 = scheduler.initial_state(snap)
    admitted, raw, free0 = fast_solve_head(plugins, scoring, snap, state0)

    parts = []

    def solve_one(raw, req_chunk, mask_chunk, free):
        assignment, free, _ = waterfill_assign_targeted(
            raw, req_chunk, mask_chunk, free,
            max_waves=STREAM_MAX_WAVES, rescue_window=STREAM_RESCUE_WINDOW,
        )
        # the finalize reads the device copy; the pipeline fetches its own
        parts.append(assignment)
        return assignment, free

    chunk_inputs = [
        (snap.pods.req[lo:lo + chunk], admitted[lo:lo + chunk])
        for lo in range(0, P, chunk)
    ]
    run_chunk_pipeline(solve_one, (raw,), chunk_inputs, free0, device=device)
    assignment, wait = finalize_assignment(torch.cat(parts), snap)
    return assignment, admitted, wait
