"""Solve watchdog and the degraded-mode failover state machine (port of
`scheduler_plugins_tpu.resilience.watchdog`).

Every device solve the cycle dispatches completes through a host copy of
its outputs **in a worker thread** with a deadline, so the deadline
covers the card finishing the work, not just the dispatch: a hung
backend times out instead of stalling the cycle loop. On a timeout, a
device error or garbage output the watchdog retries with seeded-jitter
exponential backoff; when the budget is spent it raises
`BackendUnavailable`, and `Resilience` fails over to the host-side numpy
parity solve (`resilience.hostsolve`, bit-identical by construction) and
marks the process degraded (`scheduler_degraded` gauge,
`CycleReport.solve_path == "host"` and `CycleReport.degraded`). While
degraded, probation probes retry the device path every `probe_every`
cycles and restore it the moment the backend answers.

A thread stuck in a hung backend call cannot be killed: on a timeout the
watchdog ABANDONS its worker (a daemon thread; its eventual result is
discarded) and builds a fresh one for the next attempt. Abandoned workers
are counted (`scheduler_solve_workers_abandoned_total`). An abandoned
worker may go on to solve its stale snapshot while the main thread moves
on, so the solve writes nothing the main thread reads: its carries are
fresh tensors, never the snapshot's (the serving engine adds into its
resident columns in place), and each plugin's per-solve context is kept
per thread (`framework.plugin.Plugin._presolve`).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.framework.runtime import (
    solve_output_anomaly,
)
from scheduler_plugins_tpu_torch.resilience import faults, hostsolve
from scheduler_plugins_tpu_torch.utils import observability as obs


class BackendUnavailable(RuntimeError):
    """The device backend failed past the watchdog's retry budget (or no
    host fallback exists for the profile). `reason` is the structured
    classification ("timeout (2.0s) in solve", "device-error:
    RuntimeError: ...", "garbage-output: ...")."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class GarbageOutput(RuntimeError):
    """A solve returned, but its outputs fail the contract (out-of-range
    node indices, NaN, shape mismatch): treated as a device error."""


def call_with_deadline(fn, deadline_s: float, label: str = "call"):
    """Run `fn()` in a fresh daemon worker with a deadline. Raises
    `BackendUnavailable` on timeout (the worker is abandoned: it cannot be
    killed while stuck inside a backend call). The helper behind
    `parallel.pipeline.run_chunk_pipeline(fetch_deadline_s=...)`; the
    cycle's retry and failover logic is `SolveWatchdog` / `Resilience`."""
    box: dict = {}
    done = threading.Event()

    def worker():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["error"] = exc
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True, name=f"wd-{label}")
    t.start()
    if not done.wait(deadline_s):
        obs.metrics.inc(obs.SOLVE_WORKERS_ABANDONED)
        raise BackendUnavailable(f"timeout ({deadline_s}s) in {label}")
    if "error" in box:
        raise box["error"]
    return box["value"]


class _Worker:
    """One persistent DAEMON worker thread with a job queue.

    Not a `ThreadPoolExecutor`: its workers are non-daemon and joined at
    interpreter exit, so a worker stuck inside a hung backend call would
    block process shutdown forever. A daemon thread dies with the
    process; an abandoned one idles on its own queue."""

    def __init__(self, name: str = "solve-watchdog"):
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self._thread.start()

    def _loop(self):
        while True:
            fn, box, done = self._jobs.get()
            try:
                box["value"] = fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised by caller
                box["error"] = exc
            finally:
                done.set()

    def submit(self, fn):
        box: dict = {}
        done = threading.Event()
        self._jobs.put((fn, box, done))
        return box, done


class SolveWatchdog:
    """Deadline and seeded-jitter retry policy around one callable.

    `timeout_s` defaults from SPT_SOLVE_TIMEOUT_S (30 s). Backoff is
    base * 2^(attempt-1), capped, times a jitter in [0.5, 1.0] drawn from
    `np.random.default_rng(seed)`, so a seed replays the JAX package's
    schedule exactly."""

    def __init__(self, timeout_s: Optional[float] = None,
                 max_attempts: int = 3, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0, seed: int = 0):
        if timeout_s is None:
            timeout_s = float(os.environ.get("SPT_SOLVE_TIMEOUT_S", 30.0))
        self.timeout_s = timeout_s
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = np.random.default_rng(seed)
        self._worker: Optional[_Worker] = None
        self.abandoned = 0
        self.last_reason: Optional[str] = None

    def backoff_s(self, attempt: int) -> float:
        base = min(
            self.backoff_base_s * (2 ** (attempt - 1)), self.backoff_cap_s
        )
        return base * (0.5 + 0.5 * float(self._rng.random()))

    def _abandon(self) -> None:
        # the worker is stuck inside a backend call: it cannot be
        # interrupted, only orphaned (a daemon thread, result discarded)
        self._worker = None
        self.abandoned += 1
        obs.metrics.inc(obs.SOLVE_WORKERS_ABANDONED)

    def call_once(self, fn, label: str = "solve"):
        """One deadlined attempt: raises `BackendUnavailable` on a timeout
        and re-raises the attempt's own error."""
        if self._worker is None:
            self._worker = _Worker()
        box, done = self._worker.submit(fn)
        if not done.wait(self.timeout_s):
            self._abandon()
            raise BackendUnavailable(
                f"timeout ({self.timeout_s}s) in {label}"
            ) from None
        if "error" in box:
            raise box["error"]
        return box["value"]

    def run(self, fn, label: str = "solve", attempts: Optional[int] = None,
            on_fault=None):
        """The retry loop: deadline and backoff, then `BackendUnavailable`
        with the LAST failure's classification. `on_fault(reason)` fires
        on every failed attempt (the anti-entropy force-verify hook)."""
        attempts = attempts or self.max_attempts
        reason = "unknown"
        for attempt in range(1, attempts + 1):
            try:
                return self.call_once(fn, label=label)
            except BackendUnavailable as exc:
                reason = exc.reason
            except GarbageOutput as exc:
                reason = f"garbage-output: {exc}"
            except Exception as exc:  # device/runtime error from the solve
                reason = f"device-error: {type(exc).__name__}: {exc}"
            self.last_reason = reason
            obs.metrics.inc(obs.SOLVE_RETRIES, label=label)
            if on_fault is not None:
                on_fault(reason)
            if attempt < attempts:
                time.sleep(self.backoff_s(attempt))
        raise BackendUnavailable(reason)


class Resilience:
    """The cycle's degraded-mode state machine (one per scheduler
    process). `framework.cycle.run_cycle(resilience=...)` routes every
    solve through `solve_cycle`:

    - **fast** mode: the device solve under the watchdog; on exhausted
      retries fail over to the host parity solve and go degraded.
    - **degraded** mode: the host solve at once (no device dispatch);
      every `probe_every` cycles a probation probe retries the device path
      (one attempt) and restores fast mode on success: the probe IS that
      cycle's solve.

    The optional `engine` (a `serving.engine.ServeEngine`) is told of
    every fault (`note_fault`), which forces an anti-entropy verify at its
    next refresh."""

    def __init__(self, watchdog: Optional[SolveWatchdog] = None,
                 probe_every: int = 2, engine=None):
        self.watchdog = watchdog or SolveWatchdog()
        self.probe_every = max(1, int(probe_every))
        self.engine = engine
        self.mode = "fast"
        self.degraded_reason: Optional[str] = None
        self.cycle = 0
        self.degraded_cycles = 0
        self.failovers = 0
        #: (degraded_at_cycle, restored_at_cycle) pairs: recovery time in
        #: cycles is the difference
        self.recoveries: list = []
        self._degraded_at: Optional[int] = None
        obs.metrics.set_gauge(obs.DEGRADED, 0.0)

    @property
    def degraded(self) -> bool:
        return self.mode == "degraded"

    @property
    def degraded_at(self):
        """Cycle index of the active degradation (None while fast)."""
        return self._degraded_at

    # -- transitions ----------------------------------------------------
    def _on_fault(self, reason: str) -> None:
        if self.engine is not None:
            self.engine.note_fault(reason)

    def _enter_degraded(self, reason: str) -> None:
        self.mode = "degraded"
        self.degraded_reason = reason
        self._degraded_at = self.cycle
        self.failovers += 1
        obs.metrics.inc(obs.SOLVE_FAILOVERS)
        obs.metrics.set_gauge(obs.DEGRADED, 1.0)
        obs.logger.warning(
            "solve backend degraded (%s): failing over to the host "
            "sequential parity path", reason,
        )

    def _restore_fast(self) -> None:
        self.mode = "fast"
        self.recoveries.append((self._degraded_at, self.cycle))
        self._degraded_at = None
        self.degraded_reason = None
        obs.metrics.set_gauge(obs.DEGRADED, 0.0)
        obs.logger.info("solve backend recovered: fast path restored")

    # -- the per-cycle entry --------------------------------------------
    def solve_cycle(self, scheduler, snap, stream_chunk=None, *,
                    device=None):
        """(assignment, admitted, wait, failed_plugin, path): host numpy
        arrays, the device work already finished. `path` is "device" or
        "host"; `device` is the solve's (None = the CUDA card)."""
        device = resolve_device(device)
        self.cycle += 1
        if self.mode == "degraded":
            # anchored on the degradation cycle: the first probe fires
            # exactly probe_every cycles after the failover
            probe_due = (
                (self.cycle - self._degraded_at) % self.probe_every == 0
            )
            if probe_due:
                obs.metrics.inc(obs.PROBATION_PROBES)
                try:
                    out = self.watchdog.run(
                        lambda: self._device_call(
                            scheduler, snap, stream_chunk, device, probe=True
                        ),
                        label="probe", attempts=1, on_fault=self._on_fault,
                    )
                    self._restore_fast()
                    return out + ("device",)
                except BackendUnavailable:
                    pass  # still sick: stay degraded, serve from the host
            self.degraded_cycles += 1
            return self._host_call(scheduler, snap) + ("host",)
        try:
            out = self.watchdog.run(
                lambda: self._device_call(scheduler, snap, stream_chunk,
                                          device),
                label="solve", on_fault=self._on_fault,
            )
            return out + ("device",)
        except BackendUnavailable as exc:
            self._enter_degraded(exc.reason)
            if not hostsolve.supports(scheduler, snap):
                # no bit-faithful fallback for this profile: surface the
                # outage to the caller rather than invent placements
                raise
            self.degraded_cycles += 1
            return self._host_call(scheduler, snap) + ("host",)

    # -- the two solve bodies -------------------------------------------
    def _device_call(self, scheduler, snap, stream_chunk, device,
                     probe=False):
        """Runs IN THE WORKER THREAD: dispatch, the host copy that waits
        for the card, and output validation, with the SOLVE_DISPATCH /
        PROBE fault sites applied around them."""
        spec = None
        if faults.ACTIVE is not None:
            # a probation probe IS a solve dispatch (SOLVE_DISPATCH faults
            # hit it too); the PROBE site keeps the backend sick across
            # probes specifically
            spec = faults.ACTIVE.fire(faults.SOLVE_DISPATCH)
            if spec is None and probe:
                spec = faults.ACTIVE.fire(faults.PROBE)
            if spec is not None and spec.kind == "hang":
                time.sleep(spec.seconds)
            elif spec is not None and spec.kind == "device-error":
                raise RuntimeError("injected device error")
        failed_np = None
        result = None
        if stream_chunk:
            from scheduler_plugins_tpu_torch.parallel.pipeline import (
                streamed_profile_solve,
            )

            result = streamed_profile_solve(
                scheduler, snap, chunk=stream_chunk,
                # a deadline inside the chunk loop as well: the whole
                # solve's deadline still bounds the worst case
                fetch_deadline_s=self.watchdog.timeout_s, device=device,
            )
        if result is not None:
            assignment, admitted, wait = result
        else:
            solved = scheduler.solve(snap, device=device)
            assignment, admitted, wait = (
                solved.assignment, solved.admitted, solved.wait
            )
            if solved.failed_plugin is not None:
                failed_np = solved.failed_plugin.cpu().numpy()
        # the host copies wait for the card inside the deadline window
        assignment = assignment.cpu().numpy()
        admitted = admitted.cpu().numpy()
        wait = wait.cpu().numpy()
        if spec is not None and spec.kind == "garbage":
            # a desynced backend answers with plausible-length junk
            assignment = assignment.copy()
            rng = faults.ACTIVE.rng
            assignment[: max(1, assignment.size // 8)] = rng.integers(
                snap.num_nodes, snap.num_nodes + 1000,
                size=max(1, assignment.size // 8),
            )
        anomaly = solve_output_anomaly(
            assignment, admitted, wait, snap.num_nodes
        )
        if anomaly is not None:
            raise GarbageOutput(anomaly)
        return assignment, admitted, wait, failed_np

    def _host_call(self, scheduler, snap):
        if not hostsolve.supports(scheduler, snap):
            raise BackendUnavailable(
                f"degraded ({self.degraded_reason}) and no host fallback "
                f"for profile {scheduler.profile.name!r}"
            )
        with obs.tracer.span("HostSolve", tid="cycle",
                             pending=snap.num_pods):
            return hostsolve.host_sequential_solve(scheduler, snap)
