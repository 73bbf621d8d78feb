"""Online self-tuning shadow lane with guarded rollout (port of
`scheduler_plugins_tpu.tuning.shadow`).

`ShadowTuner` closes the scoring loop online, built so the live serving
path can never be stalled, corrupted or silently regressed by its own
tuner:

- **Shadow lane, off the cycle thread.** Every `sweep_every` cycles the
  tuner takes the last N COMPLETE flight-recorder ring records and
  replays them under K candidate weight vectors through the vmapped
  sweep (`parallel.solver.sweep_solve_fn`) on a daemon worker thread,
  against a SHADOW scheduler rebuilt from the records' own profile
  capture (`flightrec.rebuild_scheduler`), never the live one. The worker
  issues its device work on the default CUDA stream, the cycle's own (as
  the JAX package's sweep shares its device). The job has a deadline (the
  watchdog's abandonment pattern, `resilience.watchdog`): a hung sweep is
  orphaned and counted, and the lane degrades to "no tuning".
- **Promotion only through the gates.** A candidate is staged only when
  the shared gate body (`tuning.promotion`, the code `tools/tune.py`
  emits offline profiles through) accepts it, AND the same winner
  repeats for `confirm_sweeps` consecutive sweeps.
- **Rollout at the cycle boundary.** `run_cycle(tuner=...)` calls
  `begin_cycle` before anything reads the profile; a promotion or a
  rollback is `Scheduler.set_live_weights`, which every later solve
  reads.
- **Probation and auto-rollback.** Every promotion opens a probation
  window judged by a PAIRED COUNTERFACTUAL PROBE: each probation cycle's
  ring record is replayed under [active, last-known-good] in one
  deadlined 2-lane sweep and the quality objectives are compared on the
  same snapshot (a level-against-recent-baseline comparison is the
  fallback when no record exists). An objective regressing beyond the
  `hysteresis` band (a large single-cycle regression at once, a
  sustained one after `regress_cycles` consecutive cycles) or ANY
  watchdog fault (degraded flag, host-path solve, a probe that cannot
  run) rolls back to the last-known-good weights. Rolled-back vectors
  are blocked from re-promotion and a cooldown follows, so the
  controller cannot flap.
- **Self-disable.** `max_failures` consecutive sweep or promotion faults
  disable the lane (state "disabled", `scheduler_tuner_state` = 3); live
  serving continues as if there were no tuner.

Chaos sites `tune.sweep` (hang / garbage) and `tune.promote` (crash)
instrument the seams (`resilience.faults`). The state file
(`state_dict` / `restore_state`) is the JAX package's format 1, and
either package reads the other's.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.resilience import faults, watchdog
from scheduler_plugins_tpu_torch.tuning import promotion, quality, sweep
from scheduler_plugins_tpu_torch.utils import flightrec
from scheduler_plugins_tpu_torch.utils import observability as obs

#: the per-cycle quality objectives the probation window compares (the
#: subset of `promotion.RANKED_OBJECTIVES` that `run_cycle` stamps every
#: cycle; drift needs a replay anchor and is a sweep-time objective)
PROBATION_OBJECTIVES = (
    "fragmentation", "util_imbalance", "gang_wait_frac", "unplaced_frac",
)

#: tuner state -> `scheduler_tuner_state` gauge value
STATE_GAUGE = {"idle": 0, "probation": 1, "cooldown": 2, "disabled": 3}

#: tuner state-file format version (bump on incompatible layout change)
STATE_FORMAT = 1


def _prepare_ring_cycle(scheduler, rec, meta) -> None:
    """Re-prepare the shadow scheduler for ONE ring record and restore
    that record's captured host_state; runs immediately before every
    solve or score of that cycle."""
    scheduler.prepare(meta, None)
    for plugin, prec in zip(scheduler.profile.plugins,
                            rec.manifest["plugins"]):
        hs = prec.get("host_state")
        if hs is not None:
            plugin.restore_host_state(flightrec.unpack_pytree(hs, rec.blobs))


def _complete(records) -> list:
    """The ring records with their outputs captured and committed."""
    return [rec for rec in records
            if rec.complete and "outputs" in rec.manifest]


def ring_corpus(records, scheduler, base_weights=None, *, device=None):
    """`promotion.CorpusCycle` list over COMPLETE ring records (newest
    last), all sharing `scheduler` (the rebuilt shadow scheduler), their
    snapshots and auxes on `device` (None = the CUDA card). A record
    captured under weights other than `base_weights` (the sweep's lane-0
    incumbent: pre-promotion cycles still in the ring) keeps its snapshot
    but drops its anchor: the incumbent lane places differently from what
    was recorded, so the anchor check and the drift yardstick fall back
    to lane 0's own placements."""
    device = resolve_device(device)
    base = (None if base_weights is None
            else tuple(int(w) for w in base_weights))
    corpus = []
    for rec in _complete(records):
        manifest = rec.manifest
        meta = flightrec.unpack_meta(manifest["meta"], device)
        snap = flightrec._solver_snapshot(
            flightrec.unpack_pytree(manifest["snapshot"], rec.blobs), device)
        auxes = flightrec._on_device(tuple(
            flightrec.unpack_pytree(p["aux"], rec.blobs)
            for p in manifest["plugins"]
        ), device)
        out = manifest["outputs"]
        assignment = flightrec.unpack_pytree(out["assignment"], rec.blobs)
        wait_spec = out.get("wait")
        wait = (None if wait_spec is None
                else flightrec.unpack_pytree(wait_spec, rec.blobs))
        rec_weights = tuple(
            int(p.get("weight", 1)) for p in manifest["plugins"]
        )
        anchor = (np.asarray(assignment)
                  if base is None or rec_weights == base else None)
        corpus.append(promotion.CorpusCycle(
            scheduler=scheduler, snap=snap, meta=meta, auxes=auxes,
            anchor=anchor,
            wait=None if wait is None else np.asarray(wait),
            mode=out.get("mode"),
            prepare=(lambda sched, rec=rec, meta=meta:
                     _prepare_ring_cycle(sched, rec, meta)),
        ))
    return corpus


class ShadowTuner:
    """The guarded-rollout controller (the module docstring has the
    design).

    Cycle-thread API (wired by `run_cycle(tuner=...)`):

    - `begin_cycle(now_ms)`: the ONLY point weights may change; polls the
      shadow worker, applies a staged promotion or a decided rollback,
      dispatches the next sweep.
    - `observe_report(report)`: feeds the probation window from the
      cycle's quality stamp; decides rollbacks.
    - `note_fault(reason)`: immediate rollback while on probation (a
      watchdog seam outside the report path).

    `sync=True` runs each sweep inline through
    `resilience.watchdog.call_with_deadline` instead of the polled
    worker, deterministic for benches and tests; the deadline and the
    degrade-to-no-tuning contract are the same. `observe_only=True` runs
    the whole shadow lane but never stages a promotion: the overhead
    measurement mode, and a standing proof that the lane alone cannot
    change live placements. The sweeps and probes run on `device` (None
    = the CUDA card; the CPU only when asked for with "cpu")."""

    def __init__(self, scheduler, recorder=None, *, candidates: int = 24,
                 corpus_cycles: int = 3, sweep_every: int = 4,
                 confirm_sweeps: int = 2, tolerance: float = 0.01,
                 drift_tolerance: float = 0.10,
                 probation_cycles: int = 6, baseline_window: int = 8,
                 baseline_min: int = 2, baseline_recent: int = 4,
                 hysteresis: float = 0.01,
                 regress_cycles: int = 2, max_failures: int = 3,
                 cooldown_cycles: int = 8, deadline_s: Optional[float] = None,
                 observe_only: bool = False, sync: bool = False,
                 seed: int = 0, device=None):
        if getattr(scheduler.profile, "solve_mode", "sequential") != (
            "sequential"
        ):
            # fail at construction, not at the first promotion: the live
            # rollout seam is the sequential parity path's weights, which
            # a packing profile refuses on every solve
            raise ValueError(
                f"online tuning requires the sequential parity path; "
                f"profile {scheduler.profile.name!r} selects solve mode "
                f"{scheduler.profile.solve_mode!r}"
            )
        self.device = resolve_device(device)
        self.scheduler = scheduler
        self.recorder = recorder if recorder is not None else flightrec.recorder
        self.candidates = max(2, int(candidates))
        self.corpus_cycles = max(1, int(corpus_cycles))
        self.sweep_every = max(1, int(sweep_every))
        self.confirm_sweeps = max(1, int(confirm_sweeps))
        self.tolerance = float(tolerance)
        #: drift stays a disqualification RAIL with its own, looser
        #: tolerance and no rank-sum vote (`promotion.rank_candidates`)
        self.drift_tolerance = float(drift_tolerance)
        self.probation_cycles = max(1, int(probation_cycles))
        self.baseline_min = max(1, int(baseline_min))
        self.baseline_recent = max(1, int(baseline_recent))
        self.hysteresis = float(hysteresis)
        self.regress_cycles = max(1, int(regress_cycles))
        self.max_failures = max(1, int(max_failures))
        self.cooldown_cycles = max(0, int(cooldown_cycles))
        if deadline_s is None:
            deadline_s = float(os.environ.get("SPT_TUNE_TIMEOUT_S", 30.0))
        self.deadline_s = deadline_s
        self.observe_only = bool(observe_only)
        self.sync = bool(sync)
        self.seed = int(seed)

        #: the weights live now (== the scheduler's); promotions move it,
        #: rollbacks restore `last_known_good`
        self.active = np.asarray(
            [int(p.weight) for p in scheduler.profile.plugins], np.int64
        )
        self.last_known_good = self.active.copy()
        self.state = "idle"
        self.disabled_reason: Optional[str] = None
        self.cycle = 0
        self.promotions = 0
        self.rollbacks = 0
        self.sweeps = 0
        self.sweep_failures = 0
        self.last_rollback_reason: Optional[str] = None
        self.last_promotion_cycle: Optional[int] = None
        self.last_rollback_cycle: Optional[int] = None
        #: weight tuples rolled back on probation: never re-promoted
        self.blocked: set = set()
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=max(2, int(baseline_window)))
        self._baseline: Optional[dict] = None
        self._probation_elapsed = 0
        self._regress_counts: dict = {}
        self._cooldown_until = -1
        self._consecutive_failures = 0
        self._first_regress_cycle = None
        self.last_rollback_detect_cycles = None
        self._pending: Optional[dict] = None
        self._last_winner: Optional[tuple] = None
        self._winner_streak = 0
        self._sweep_seq = 0
        self._worker = None
        self._inflight: Optional[dict] = None
        #: the shadow scheduler, one rebuild per profile identity. Its own
        #: lock, NOT self._lock: the sweep worker, the deadlined probe and
        #: the main thread's invalidation all touch it, and a rebuild is
        #: too slow to hold the controller lock across. Order: _lock may
        #: nest _shadow_lock, never the reverse.
        self._shadow_lock = threading.Lock()
        self._shadow_key = None
        self._shadow_sched = None
        self._export_gauges()

    # -- gauges ----------------------------------------------------------
    def _export_gauges(self) -> None:
        obs.metrics.set_gauge(obs.TUNER_STATE, STATE_GAUGE[self.state])
        digest = promotion.weights_digest(self.active)
        obs.metrics.set_gauge(obs.TUNER_ACTIVE_WEIGHTS, int(digest, 16))

    # -- the cycle-boundary hook (the weight-swap seam) ------------------
    def begin_cycle(self, now_ms: int = 0) -> None:
        """Runs on the cycle thread BEFORE the cycle reads the profile:
        the one safe point to swap weights. Never raises: a tuner fault
        costs tuning, not the tick."""
        with self._lock:
            self.cycle += 1
            if self.state == "disabled":
                return
            self._poll_inflight_locked()
            if self.state == "cooldown" and self.cycle >= self._cooldown_until:
                self.state = "idle"
            if (
                self._pending is not None
                and self.state in ("idle", "cooldown")
                # never start probation while a sweep job is in flight:
                # the probe and the job would share the shadow scheduler
                # from two threads
                and self._inflight is None
            ):
                self._apply_pending_locked()
            self._maybe_dispatch_locked()
            self._export_gauges()

    def observe_report(self, report) -> None:
        """Runs on the cycle thread after the finalize: probation
        evidence. A cycle with no solve (no quality stamp) contributes
        nothing: probation advances only on observed cycles."""
        with self._lock:
            if self.state == "disabled":
                return
            degraded = bool(getattr(report, "degraded", False)) or (
                getattr(report, "solve_path", None) == "host"
            )
            if self.state == "probation" and degraded:
                # ANY watchdog fault during probation rolls back at once:
                # a degraded cycle's quality is evidence of nothing
                self._rollback_locked(
                    "watchdog-fault:"
                    + (getattr(report, "solve_path", None) or "degraded")
                )
                return
            q = getattr(report, "quality", None)
            if q is None:
                return
            q = {name: float(q[name])
                 for name in PROBATION_OBJECTIVES if name in q}
            if not q:
                return
            if self.state != "probation":
                self._window.append(q)
                return
            self._probation_elapsed += 1
        # the probe runs OUTSIDE the lock (it has its own deadline), so
        # `status()` and `state_dict()` stay responsive; every state
        # MUTATION happens on this (cycle) thread, and the verdict is
        # re-checked under the lock
        deltas = self._probation_deltas(q)
        with self._lock:
            if self.state != "probation":
                return  # note_fault rolled back while the probe ran
            if deltas is None:
                # the probe could not run (hung, errored): an
                # unverifiable probation cycle is a watchdog fault. A
                # timed-out probe also leaves a zombie worker holding the
                # shadow scheduler: drop it so later sweeps rebuild
                with self._shadow_lock:
                    self._shadow_sched = None
                    self._shadow_key = None
                self._rollback_locked("watchdog-fault:probe-unavailable")
                return
            for name, delta in deltas.items():
                # sense-adjusted delta: negative = worse than the
                # last-known-good counterfactual (or, on the fallback, the
                # recent pre-promotion baseline). Two triggers, both gated
                # by the `hysteresis` band so sub-threshold noise never
                # fires: a LARGE single-cycle regression (>= regress_cycles
                # * hysteresis) rolls back at once, a SUSTAINED one after
                # regress_cycles consecutive cycles
                if delta < -self.hysteresis:
                    if self._first_regress_cycle is None:
                        self._first_regress_cycle = self.cycle
                    self._regress_counts[name] = (
                        self._regress_counts.get(name, 0) + 1
                    )
                else:
                    self._regress_counts[name] = 0
                if (
                    delta < -(self.hysteresis * self.regress_cycles)
                    or self._regress_counts[name] >= self.regress_cycles
                ):
                    self._rollback_locked(f"quality-regression:{name}")
                    return
            if self._probation_elapsed >= self.probation_cycles:
                self._confirm_locked()

    def _probation_deltas(self, q: dict) -> Optional[dict]:
        """Per-objective sense-adjusted deltas for one probation cycle,
        positive = the promoted weights are doing fine. The primary
        instrument is the paired counterfactual probe (the newest ring
        record under [active, last-known-good] in one 2-lane sweep, on
        the same snapshot, so the workload's common-mode trend cancels);
        it has a deadline, and a hung or failed probe returns None, which
        the caller treats as a watchdog fault. With no usable record: the
        level against the recent pre-promotion baseline."""
        try:
            probe = watchdog.call_with_deadline(self._counterfactual_pair,
                                       self.deadline_s, label="tune.probe")
        except Exception:  # noqa: BLE001 - adjudicated by the caller
            return None
        if probe is not None:
            q_active, q_good = probe
            return {
                name: quality.SENSE[name] * (q_active[name] - q_good[name])
                for name in PROBATION_OBJECTIVES
                if name in q_active and name in q_good
            }
        if self._baseline is None:
            return None
        return {
            name: quality.SENSE[name] * (value - self._baseline[name])
            for name, value in q.items()
            if name in self._baseline
        }

    def _counterfactual_pair(self):
        """({objective: float} under active, the same under
        last-known-good) for the newest complete ring record, one 2-lane
        sweep; None when no record exists (the fallback adjudicates)."""
        records = _complete(self.recorder.records())
        if not records:
            return None
        rec = records[-1]
        # `active` and `last_known_good` from the SAME promotion epoch:
        # this probe runs on a deadline worker while the cycle thread may
        # promote or roll back between two bare reads
        with self._lock:
            active = np.asarray(self.active, np.int64).copy()
            good = np.asarray(self.last_known_good, np.int64).copy()
        shadow = self._shadow_scheduler(rec)
        cc = ring_corpus([rec], shadow, base_weights=active,
                         device=self.device)[0]
        cc.prepare(cc.scheduler)
        A, _adm, wt = sweep.sweep_cycle(shadow, cc.snap,
                                        np.stack([active, good]),
                                        auxes=cc.auxes, device=self.device)
        q = quality.batch_quality(cc.snap, A, wt)
        q_active = {name: float(v[0]) for name, v in q.items()}
        q_good = {name: float(v[1]) for name, v in q.items()}
        return q_active, q_good

    def note_fault(self, reason: Optional[str] = None) -> None:
        """External watchdog seam: a backend fault seen outside the report
        path rolls an open probation back at once."""
        with self._lock:
            if self.state == "probation":
                self._rollback_locked(f"watchdog-fault:{reason or 'fault'}")

    def inject_promotion(self, weights) -> None:
        """Harness hook (bench config 14's injected-regression phase, the
        rollback decision tables): stage `weights` for promotion at the
        next cycle boundary, BYPASSING the gates. No production path
        calls it; it exists so the rollback can be shown on demand."""
        with self._lock:
            self._pending = {
                "weights": tuple(int(w) for w in weights), "forced": True,
            }

    # -- promotion / rollback (all under self._lock) ---------------------
    def _apply_pending_locked(self) -> None:
        pending, self._pending = self._pending, None
        if self.observe_only and not pending.get("forced"):
            return
        if self._baseline_snapshot() is None:
            # no pre-promotion baseline yet: probation could not detect a
            # regression, so re-stage and wait
            self._pending = pending
            return
        weights = np.asarray(pending["weights"], np.int64)
        prev = self.active.copy()
        spec = None
        if faults.ACTIVE is not None:
            spec = faults.ACTIVE.fire(faults.TUNE_PROMOTE)
        try:
            if spec is not None and spec.kind == "crash":
                raise RuntimeError("injected promotion crash (tune.promote)")
            self.scheduler.set_live_weights(weights)
        except Exception as exc:
            # the promotion died mid-apply: restore the incumbent (the new
            # vector may or may not have landed), count the fault and keep
            # serving; live placements are untouched either way
            try:
                self.scheduler.set_live_weights(prev)
            except Exception as restore_exc:
                obs.logger.warning(
                    "tuner incumbent restore failed too: %s", restore_exc
                )
            self.sweep_failures += 1
            obs.metrics.inc(obs.TUNER_SWEEP_FAILURES)
            self._consecutive_failures += 1
            obs.logger.warning("tuner promotion failed (%s): incumbent "
                               "weights kept", exc)
            self._maybe_disable_locked(f"promote-crash: {exc}")
            return
        self.active = weights
        self.promotions += 1
        obs.metrics.inc(obs.TUNER_PROMOTIONS)
        self.last_promotion_cycle = self.cycle
        self._baseline = self._baseline_snapshot()
        self._probation_elapsed = 0
        self._regress_counts = {}
        self._first_regress_cycle = None
        self.state = "probation"
        self._winner_streak = 0
        self._last_winner = None
        obs.logger.info(
            "tuner promoted weights %s (digest %s): probation for %d "
            "cycles vs baseline %s",
            [int(w) for w in weights], promotion.weights_digest(weights),
            self.probation_cycles,
            {k: round(v, 4) for k, v in (self._baseline or {}).items()},
        )

    def _baseline_snapshot(self) -> Optional[dict]:
        if len(self._window) < self.baseline_min:
            return None
        # the MOST RECENT pre-promotion cycles only: the gauges trend
        # under a drifting workload, and a whole-window mean would sit off
        # the trend
        recent = list(self._window)[-self.baseline_recent:]
        names = set().union(*(q.keys() for q in recent))
        return {
            name: float(np.mean([q[name] for q in recent if name in q]))
            for name in names
        }

    def _rollback_locked(self, reason: str) -> None:
        self.blocked.add(tuple(int(w) for w in self.active))
        try:
            self.scheduler.set_live_weights(self.last_known_good)
        except Exception as exc:
            obs.logger.warning("tuner rollback set_live_weights failed: %s",
                               exc)
        self.active = np.asarray(self.last_known_good, np.int64).copy()
        self.rollbacks += 1
        obs.metrics.inc(obs.TUNER_ROLLBACKS)
        self.last_rollback_reason = reason
        self.last_rollback_cycle = self.cycle
        #: cycles from the first above-hysteresis regression to this
        #: rollback (0 for a watchdog-fault rollback with no prelude)
        self.last_rollback_detect_cycles = (
            self.cycle - self._first_regress_cycle
            if self._first_regress_cycle is not None else 0
        )
        self.state = "cooldown"
        self._cooldown_until = self.cycle + self.cooldown_cycles
        self._baseline = None
        self._probation_elapsed = 0
        self._regress_counts = {}
        self._window.clear()
        self._pending = None
        self._winner_streak = 0
        self._last_winner = None
        self._export_gauges()
        obs.logger.warning(
            "tuner ROLLBACK (%s): last-known-good weights %s restored, "
            "cooldown %d cycles",
            reason, [int(w) for w in self.active], self.cooldown_cycles,
        )

    def _confirm_locked(self) -> None:
        self.last_known_good = self.active.copy()
        self.state = "idle"
        self._baseline = None
        self._probation_elapsed = 0
        self._regress_counts = {}
        # the pre-promotion window described the OLD weights' regime
        self._window.clear()
        obs.logger.info(
            "tuner promotion CONFIRMED: weights %s are the new "
            "last-known-good", [int(w) for w in self.active],
        )

    def _maybe_disable_locked(self, reason: str) -> None:
        if self._consecutive_failures >= self.max_failures:
            self.state = "disabled"
            self.disabled_reason = reason
            self._pending = None
            self._inflight = None
            obs.logger.warning(
                "shadow tuner DISABLED after %d consecutive faults (%s): "
                "live serving continues on the incumbent weights",
                self._consecutive_failures, reason,
            )
            self._export_gauges()

    # -- the shadow sweep lane -------------------------------------------
    def _maybe_dispatch_locked(self) -> None:
        if (
            self.state not in ("idle", "cooldown")
            or self._pending is not None
            or self.cycle % self.sweep_every != 0
            or self._inflight is not None
            or not self.recorder.enabled
        ):
            return
        records = _complete(self.recorder.records())
        if len(records) < self.corpus_cycles:
            return
        records = records[-self.corpus_cycles:]
        base = self.active.copy()
        self._sweep_seq += 1
        # candidates are seeded per INCUMBENT EPOCH, not per sweep:
        # consecutive sweeps propose the same set over FRESH corpora, so a
        # `confirm_sweeps` streak measures a sustained win
        seq = 97 * (self.promotions + self.rollbacks)
        if self.sync:
            try:
                result = watchdog.call_with_deadline(
                    lambda: self._sweep_job(records, base, seq),
                    self.deadline_s, label="tune.sweep",
                )
                self._consume_sweep_locked(result)
            except watchdog.BackendUnavailable as exc:
                self._sweep_failed_locked(str(exc))
            except Exception as exc:  # noqa: BLE001 - lane must not raise
                self._sweep_failed_locked(f"{type(exc).__name__}: {exc}")
            return
        if self._worker is None:
            self._worker = watchdog._Worker(name="shadow-tuner")
        box, done = self._worker.submit(
            lambda: self._sweep_job(records, base, seq)
        )
        self._inflight = {
            "box": box, "done": done, "started": time.monotonic(),
        }

    def _poll_inflight_locked(self) -> None:
        job = self._inflight
        if job is None:
            return
        if job["done"].is_set():
            self._inflight = None
            if "error" in job["box"]:
                exc = job["box"]["error"]
                self._sweep_failed_locked(f"{type(exc).__name__}: {exc}")
            else:
                self._consume_sweep_locked(job["box"]["value"])
            return
        if time.monotonic() - job["started"] > self.deadline_s:
            # hung sweep: abandon the worker (it cannot be interrupted
            # inside a device call; daemon thread, result discarded)
            self._inflight = None
            self._worker = None
            self._sweep_failed_locked(
                f"timeout ({self.deadline_s}s) in tune.sweep"
            )

    def _sweep_failed_locked(self, reason: str) -> None:
        self.sweep_failures += 1
        obs.metrics.inc(obs.TUNER_SWEEP_FAILURES)
        self._consecutive_failures += 1
        # drop the shadow scheduler: an ABANDONED job keeps running on its
        # worker and still holds it; the next sweep or probe rebuilds
        # rather than race the zombie's host-state writes
        with self._shadow_lock:
            self._shadow_sched = None
            self._shadow_key = None
        obs.logger.warning("shadow sweep failed (%s): no tuning this round",
                           reason)
        self._maybe_disable_locked(reason)

    def _consume_sweep_locked(self, result) -> None:
        self.sweeps += 1
        obs.metrics.inc(obs.TUNER_SWEEPS)
        self._consecutive_failures = 0
        verdict, W = result
        if not verdict.accepted or self.observe_only:
            self._winner_streak = 0
            self._last_winner = None
            return
        winner = None
        W = np.asarray(W)
        for k in verdict.order:
            k = int(k)
            if (
                k == 0 or not np.isfinite(verdict.score[k])
                or verdict.score[k] <= 0 or verdict.violations[k] > 0
            ):
                break  # best first: nothing promotable remains
            cand = tuple(int(w) for w in W[k])
            if cand not in self.blocked:
                winner = cand
                break
        if winner is None:
            self._winner_streak = 0
            self._last_winner = None
            return
        if winner == self._last_winner:
            self._winner_streak += 1
        else:
            self._last_winner = winner
            self._winner_streak = 1
        # a sustained win: the same vector must survive `confirm_sweeps`
        # corpus evaluations before it may touch live serving
        if self._winner_streak >= self.confirm_sweeps:
            self._pending = {"weights": winner, "forced": False}

    def _sweep_job(self, records, base, seq):
        """Runs OFF the cycle thread (or with a deadline inline under
        `sync`): rebuild or reuse the shadow scheduler, sweep the ring
        corpus under the candidate matrix, gate through
        `tuning.promotion`. The `tune.sweep` chaos site is this seam."""
        spec = None
        if faults.ACTIVE is not None:
            spec = faults.ACTIVE.fire(faults.TUNE_SWEEP)
        if spec is not None and spec.kind == "hang":
            time.sleep(spec.seconds)
        shadow = self._shadow_scheduler(records[0])
        # the drift yardstick is the INCUMBENT's objective: score the
        # corpus with the live weight vector, not the recorded one
        for plugin, w in zip(shadow.profile.plugins, base):
            plugin.weight = int(w)
        corpus = ring_corpus(records, shadow, base_weights=base,
                             device=self.device)
        W = sweep.candidate_weights(base, self.candidates,
                                    seed=self.seed + seq)
        mutate = None
        if spec is not None and spec.kind == "garbage":
            rng = faults.ACTIVE.rng

            def mutate(A, adm, wt):
                # a desynced sweep answers with plausible-length junk on
                # every candidate lane; the incumbent lane is kept so the
                # gate's frame of reference survives, and the oracles
                # must disqualify every corrupted lane
                A = np.asarray(A).copy()
                n_nodes = 1 << 20
                A[1:] = rng.integers(
                    n_nodes, n_nodes + 1000, size=A[1:].shape
                )
                return A, adm, wt

        verdict = promotion.evaluate_candidates(
            corpus, W, self.tolerance, mutate=mutate,
            rank_objectives=PROBATION_OBJECTIVES,
            tolerances={"drift": self.drift_tolerance},
            device=self.device,
        )
        return verdict, W

    def _shadow_scheduler(self, rec):
        """Rebuild (or reuse) the shadow replay scheduler from a ring
        record's own profile capture; the live scheduler is never touched
        from the sweep thread. `_shadow_lock` serializes the memo AND the
        rebuild: the sweep worker and the probe both land here."""
        manifest = rec.manifest
        key = (
            flightrec._canonical_json(manifest.get("profile_config")),
            tuple(p["class"] for p in manifest["plugins"]),
        )
        with self._shadow_lock:
            if self._shadow_key == key and self._shadow_sched is not None:
                return self._shadow_sched
            scheduler, _meta, _faithful = flightrec.rebuild_scheduler(
                manifest,
                lambda s, rec=rec: flightrec.unpack_pytree(s, rec.blobs),
                device=self.device,
            )
            # an ABANDONED probe or sweep may still publish after its
            # deadline: lock-serialized and key-idempotent, a late publish
            # costs at most one rebuild on the next key check
            self._shadow_key = key
            self._shadow_sched = scheduler
            return scheduler

    def quiesce(self, timeout_s: float = 60.0) -> bool:
        """Wait for the in-flight shadow sweep (if any) to finish running
        (the next `begin_cycle` still consumes its result); True when
        nothing is left running."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                job = self._inflight
            if job is None or job["done"].is_set():
                return True
            job["done"].wait(0.05)
        return False

    # -- introspection / persistence -------------------------------------
    def status(self) -> dict:
        """The tuner's status block (the daemon's /healthz)."""
        with self._lock:
            return {
                "state": self.state,
                "active_weights": [int(w) for w in self.active],
                "active_digest": promotion.weights_digest(self.active),
                "last_known_good": [int(w) for w in self.last_known_good],
                "promotions": self.promotions,
                "rollbacks": self.rollbacks,
                "sweeps": self.sweeps,
                "sweep_failures": self.sweep_failures,
                "probation_elapsed": (
                    self._probation_elapsed
                    if self.state == "probation" else None
                ),
                "baseline": (
                    None if self._baseline is None
                    else {k: round(v, 6)
                          for k, v in self._baseline.items()}
                ),
                "staged": self._pending is not None,
                "last_rollback_reason": self.last_rollback_reason,
                "last_rollback_detect_cycles":
                    self.last_rollback_detect_cycles,
                "disabled_reason": self.disabled_reason,
                "observe_only": self.observe_only,
            }

    def state_dict(self) -> dict:
        """Persistable controller state (format `STATE_FORMAT`, the JAX
        package's): a restart resumes the promoted weights and the open
        probation window."""
        with self._lock:
            return {
                "format": STATE_FORMAT,
                "active_weights": [int(w) for w in self.active],
                "last_known_good": [int(w) for w in self.last_known_good],
                "state": self.state,
                "probation_elapsed": self._probation_elapsed,
                "baseline": self._baseline,
                "promotions": self.promotions,
                "rollbacks": self.rollbacks,
                "blocked": [list(w) for w in sorted(self.blocked)],
                "disabled_reason": self.disabled_reason,
            }

    def restore_state(self, state: dict) -> bool:
        """Resume from a persisted `state_dict`. Returns False (and starts
        fresh) on a format or shape mismatch: a stale state file must
        never block startup."""
        if not isinstance(state, dict) or state.get("format") != STATE_FORMAT:
            return False
        L = len(self.scheduler.profile.plugins)
        active = state.get("active_weights")
        good = state.get("last_known_good")
        if (
            not isinstance(active, list) or len(active) != L
            or not isinstance(good, list) or len(good) != L
        ):
            return False
        with self._lock:
            self.scheduler.set_live_weights(active)
            self.active = np.asarray(active, np.int64)
            self.last_known_good = np.asarray(good, np.int64)
            restored = state.get("state", "idle")
            self.state = restored if restored in STATE_GAUGE else "idle"
            if self.state == "cooldown":
                self._cooldown_until = self.cycle + self.cooldown_cycles
            self._probation_elapsed = int(state.get("probation_elapsed", 0))
            baseline = state.get("baseline")
            self._baseline = baseline if isinstance(baseline, dict) else None
            if self.state == "probation" and self._baseline is None:
                # probation without a baseline cannot adjudicate: treat
                # the restart as a fresh confirmation window instead
                self.state = "idle"
            self.promotions = int(state.get("promotions", 0))
            self.rollbacks = int(state.get("rollbacks", 0))
            self.blocked = {
                tuple(int(x) for x in w)
                for w in state.get("blocked", []) or []
            }
            self.disabled_reason = state.get("disabled_reason")
            self._export_gauges()
        return True
