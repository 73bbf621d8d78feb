"""Pod-lifecycle SLO ledger: cross-cycle per-pod latency decomposition
(port of `scheduler_plugins_tpu.obs.ledger`).

The upstream scheduler answers "how long did this pod wait, and on
what?" with the `e2e_scheduling_duration` / `pod_scheduling_attempts`
metric families. Every other observability layer instruments a CYCLE;
this module follows a POD across cycles.

Design:

- **Append-only records, O(changed) per cycle.** The store mutators
  (`state.cluster`), the `run_cycle` stage functions, requeue-backoff
  charges and preemption nominations each push one transition when
  something HAPPENS to a pod; nothing ever scans the roster. Records
  retire to a bounded ring on bind/delete.

- **Telescoping stage accounting.** Each record keeps integer-nanosecond
  `stages` plus the stamp of its last transition; every transition closes
  the open interval (`stages[state] += t - last_ns; last_ns = t`), so
  `sum(stages) == retired_ns - first_seen_ns` holds EXACTLY, by
  construction, for every pod (`decomposition_errors()` is empty).

- **Engine-independent sequences.** Events carry `(cycle, lane, seq)`:
  the cycle that observed them, a lane (0 = ingest/solve-side, 1 = the
  bind/postbind stage, which `PipelinedCycle` runs on the flusher
  thread) and a per-(cycle, lane) counter. Wall stamps ride along but
  are excluded from `sequence()`: the serial and pipelined engines must
  produce IDENTICAL sequences on one input stream. Failure blame lands as
  an IN-PLACE fill of the cycle's Unschedulable event (attribution may be
  deferred into the next overlap window; an append there would reorder).

- **Always cheap.** The global `LEDGER` is OFF by default; every feeding
  seam guards on `LEDGER.enabled` before doing any work. Enabled, the
  per-cycle cost is O(batch + transitions).

Everything is host-side Python; nothing here touches a tensor.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ..api import events as ev
from ..utils import observability as obs

#: the fixed decomposition stages: every retired
#: pod's e2e latency is partitioned into exactly these buckets
STAGES = (
    "queue_wait", "backoff_held", "gang_wait",
    "solve", "fence", "bind_flush",
)

#: wait-states a record can sit in between attempts (the first three
#: STAGES); in-attempt stages (solve/fence/bind_flush) are charged
#: arithmetically at the outcome visit and are never a resting state
_WAIT_STATES = frozenset(STAGES[:3])


class LedgerCycle:
    """Per-cycle ledger context: stamps + batch + the two lane counters.

    Created by `Ledger.cycle_open` (the `_cycle_open` stage function),
    carried on `CycleCtx.led`, and filled in by the stage functions as the
    cycle progresses. The bind stage may run on the pipelined engine's
    flusher thread — the stamps written here (pending/solve/fence) are
    all written by the main thread BEFORE the bind job is submitted, so
    the flusher only ever reads them.
    """

    __slots__ = (
        "cid", "now_ms", "batch", "t_open", "t_solve", "t_fence0",
        "t_fence1", "degraded", "solve_path", "_seq", "_lock",
    )

    def __init__(self, cid: int, now_ms: int, t_open: int):
        self.cid = cid
        self.now_ms = now_ms
        self.batch: frozenset = frozenset()
        self.t_open = t_open
        self.t_solve: Optional[int] = None
        self.t_fence0: Optional[int] = None
        self.t_fence1: Optional[int] = None
        self.degraded = False
        self.solve_path: Optional[str] = None
        self._seq = [0, 0]  # per-lane event counters
        self._lock = threading.Lock()

    def next_seq(self, lane: int) -> int:
        with self._lock:
            s = self._seq[lane]
            self._seq[lane] = s + 1
            return s

    def meta(self) -> dict:
        return {
            "cycle": self.cid,
            "now_ms": self.now_ms,
            "batch": len(self.batch),
            "degraded": self.degraded,
            "solve_path": self.solve_path,
        }


class PodRecord:
    """One pod's lifecycle: events + telescoping stage accounting."""

    __slots__ = (
        "uid", "priority", "gang", "gated", "first_ns", "first_cycle",
        "last_ns", "state", "stages", "events", "attempts", "outcome",
        "retired_ns",
    )

    def __init__(self, uid: str, priority: int, gang, t: int, cycle: int):
        self.uid = uid
        self.priority = priority
        self.gang = gang
        self.gated = False
        self.first_ns = t
        self.first_cycle = cycle
        self.last_ns = t
        self.state = "queue_wait"
        self.stages: dict[str, int] = {}
        # events: [cycle, lane, seq, kind, detail, t_ns]
        self.events: list[list] = []
        self.attempts = 0
        self.outcome: Optional[str] = None
        self.retired_ns: Optional[int] = None

    def e2e_ns(self) -> Optional[int]:
        if self.retired_ns is None:
            return None
        return self.retired_ns - self.first_ns

    def to_dict(self) -> dict:
        return {
            "uid": self.uid,
            "priority": self.priority,
            "gang": self.gang,
            "first_seen_ns": self.first_ns,
            "first_cycle": self.first_cycle,
            "state": self.state,
            "attempts": self.attempts,
            "outcome": self.outcome,
            "e2e_ms": (
                None if self.retired_ns is None
                else (self.retired_ns - self.first_ns) / 1e6
            ),
            "stages_ms": {k: v / 1e6 for k, v in self.stages.items()},
            "events": [
                {
                    "cycle": c, "lane": ln, "seq": s, "kind": k,
                    "detail": d, "t_ns": t,
                }
                for c, ln, s, k, d, t in self.events
            ],
        }


class Ledger:
    """The pod-lifecycle ledger + SLI engine. One global instance
    (`LEDGER`) serves the daemon; benches swap per-arm instances in via
    `use()` so interleaved arm-vs-arm runs never share records."""

    def __init__(self, retired_capacity: int = 4096, cycle_meta: int = 512):
        self.enabled = False
        self._lock = threading.RLock()
        self._records: dict[str, PodRecord] = {}
        self._retired: deque[PodRecord] = deque(maxlen=retired_capacity)
        self._cycle_meta: deque[dict] = deque(maxlen=cycle_meta)
        self._cycles = 0
        self._ambient_seq = 0
        self._scopes = threading.local()
        self._now = time.monotonic_ns
        self.pods_bound = 0
        self.pods_deleted = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Ledger":
        self.enabled = True
        return self

    def stop(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._retired.clear()
            self._cycle_meta.clear()
            self._cycles = 0
            self._ambient_seq = 0
            self.pods_bound = 0
            self.pods_deleted = 0

    # -- cycle scopes -----------------------------------------------------
    # A scope pins (LedgerCycle, lane) to the CURRENT thread while a stage
    # function runs, so store-mutator hooks fired underneath it attribute
    # their events to the observing cycle — on whichever thread the
    # pipelined engine runs that stage. Outside any scope (daemon ingest,
    # bench churn between ticks) events attribute to the last opened
    # cycle on lane 0 with a global counter: both engines apply the same
    # stream at the same point, so ambient attribution matches too.

    def _stack(self) -> list:
        st = getattr(self._scopes, "stack", None)
        if st is None:
            st = self._scopes.stack = []
        return st

    def push_scope(self, led: Optional[LedgerCycle], lane: int) -> None:
        if led is not None:
            self._stack().append((led, lane))

    def pop_scope(self, led: Optional[LedgerCycle]) -> None:
        if led is not None:
            st = self._stack()
            if st:
                st.pop()

    def _coords(self) -> tuple:
        """(cycle, lane, seq) for an event appended right now."""
        st = getattr(self._scopes, "stack", None)
        if st:
            led, lane = st[-1]
            return led.cid, lane, led.next_seq(lane)
        with self._lock:
            s = self._ambient_seq
            self._ambient_seq = s + 1
            return self._cycles, 0, s

    def cycle_open(self, now_ms: int) -> Optional[LedgerCycle]:
        if not self.enabled:
            return None
        with self._lock:
            self._cycles += 1
            led = LedgerCycle(self._cycles, now_ms, self._now())
            self._cycle_meta.append(led.meta())
            return led

    def cycle_close(self, led: Optional[LedgerCycle]) -> None:
        """Refresh the cycle's meta entry (degraded/solve_path/batch are
        filled after `cycle_open` appended the initial snapshot)."""
        if led is None:
            return
        with self._lock:
            for i in range(len(self._cycle_meta) - 1, -1, -1):
                if self._cycle_meta[i]["cycle"] == led.cid:
                    self._cycle_meta[i] = led.meta()
                    break

    # -- internals --------------------------------------------------------
    def _append(self, rec: PodRecord, kind: str, detail: dict,
                t: int) -> None:
        assert kind in ev.LIFECYCLE_KINDS, kind
        c, lane, seq = self._coords()
        rec.events.append([c, lane, seq, kind, detail, t])

    def _charge(self, rec: PodRecord, t: int, stage: Optional[str] = None) -> None:
        """Close the open interval at stamp `t`, crediting the record's
        resting wait-state (or an explicit in-attempt stage)."""
        dt = t - rec.last_ns
        if dt:
            s = stage or rec.state
            rec.stages[s] = rec.stages.get(s, 0) + dt
        rec.last_ns = t

    def _charge_attempt(self, rec: PodRecord,
                        led: Optional[LedgerCycle], t: int) -> bool:
        """Stage-split one attempt using the observing cycle's stamps:
        wait-state up to solve dispatch, then solve / fence / bind-flush.
        Falls back to a plain wait-state charge when the pod was not in
        this cycle's batch (gang-phase binds, permit fan-out of pods
        reserved in earlier cycles, external binds)."""
        if (
            led is not None
            and rec.uid in led.batch
            and led.t_solve is not None
            and led.t_fence0 is not None
            and led.t_fence1 is not None
            and rec.last_ns <= led.t_solve
        ):
            self._charge(rec, led.t_solve)
            self._charge(rec, led.t_fence0, "solve")
            self._charge(rec, led.t_fence1, "fence")
            self._charge(rec, t, "bind_flush")
            rec.attempts += 1
            return True
        self._charge(rec, t)
        return False

    def _scope_cycle(self) -> Optional[LedgerCycle]:
        st = getattr(self._scopes, "stack", None)
        return st[-1][0] if st else None

    def _retire(self, rec: PodRecord, t: int, outcome: str) -> None:
        rec.outcome = outcome
        rec.retired_ns = t
        self._retired.append(rec)

    # -- feeding seams (store mutators + stage functions) -----------------
    def on_first_seen(self, pod) -> None:
        """`Cluster.add_pod` of a pending pod (node_name None)."""
        with self._lock:
            if pod.uid in self._records:
                return
            t = self._now()
            rec = PodRecord(
                pod.uid, pod.priority, pod.pod_group() or None, t,
                self._cycles,
            )
            if pod.scheduling_gated:
                rec.state = "gang_wait"
                rec.gated = True
            self._records[pod.uid] = rec
            self._append(rec, ev.LIFECYCLE_FIRST_SEEN, {
                "gated": bool(pod.scheduling_gated),
                "gang": rec.gang,
                "priority": pod.priority,
            }, t)

    def on_bind(self, uid: str, node: str) -> None:
        """`Cluster.bind`: close the lifecycle, feed the SLI engine."""
        with self._lock:
            rec = self._records.pop(uid, None)
            if rec is None:
                return
            t = self._now()
            led = self._scope_cycle()
            self._charge_attempt(rec, led, t)
            self._append(rec, ev.LIFECYCLE_BOUND, {"node": node}, t)
            self._retire(rec, t, "bound")
            self.pods_bound += 1
        # metrics feed outside the ledger lock (lock order: ledger ->
        # metrics would also be fine, but there is no reason to nest);
        # batched so the whole fan-out costs one metrics-lock round-trip
        feed = [
            (obs.E2E_SCHEDULING_MS, (t - rec.first_ns) / 1e6,
             (("priority", str(rec.priority)),)),
            (obs.POD_SCHEDULING_ATTEMPTS, float(max(rec.attempts, 1)), ()),
        ]
        feed.extend(
            (obs.POD_SCHEDULING_SLI_MS, ns / 1e6, (("stage", stage),))
            for stage, ns in rec.stages.items() if ns
        )
        obs.metrics.observe_batch(feed)

    def on_reserve(self, uid: str, node: str) -> None:
        """`Cluster.reserve` (Permit said Wait): the pod now waits on its
        gang's quorum — gang_wait until the fan-out bind or the release."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                return
            t = self._now()
            self._charge_attempt(rec, self._scope_cycle(), t)
            rec.state = "gang_wait"
            self._append(rec, ev.LIFECYCLE_RESERVED, {"node": node}, t)

    def on_unschedulable(self, uid: str, attempt: int, window_ms: int,
                         gang: bool) -> None:
        """`Cluster.mark_unschedulable`'s charged branch: one backoff
        attempt. `window_ms` is the exact deterministic backoff window
        (min(initial·2^(n-1), max) scaled by the blake2b jitter) so the
        decision-table tests compare recorded windows, not wall clocks."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                return
            t = self._now()
            self._charge_attempt(rec, self._scope_cycle(), t)
            rec.state = "gang_wait" if gang else "backoff_held"
            self._append(rec, ev.LIFECYCLE_UNSCHEDULABLE, {
                "attempt": attempt, "window_ms": window_ms, "by": None,
            }, t)

    def set_blame(self, uid: str, cid: Optional[int], plugin: str) -> None:
        """Fill `failed_by` blame into the cycle's Unschedulable event
        IN PLACE (never an append): attribution may run in the next
        tick's overlap window, and an appended event there would order
        differently between the serial and pipelined engines."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                for r in reversed(self._retired):
                    if r.uid == uid:
                        rec = r
                        break
                if rec is None:
                    return
            for evt in reversed(rec.events):
                if evt[3] == ev.LIFECYCLE_UNSCHEDULABLE and (
                    cid is None or evt[0] == cid
                ):
                    evt[4]["by"] = plugin
                    return

    def on_wait(self, uid: str, state: str) -> None:
        """Requeue-gate classification (`_requeue_eligible`): transition
        the resting wait-state — at most one event per park episode
        (backoff expired -> event-waiting), never one per cycle. Gang
        parks keep their gang_wait label through backoff expiry."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None or rec.state == state:
                return
            if state == "queue_wait" and rec.state == "gang_wait":
                return
            t = self._now()
            self._charge(rec, t)
            rec.state = state
            self._append(rec, ev.LIFECYCLE_WAIT, {"state": state}, t)

    def on_nomination(self, uid: str, node: Optional[str]) -> None:
        """Preemption nomination set/clear (`_run_preemption`). A
        nominated pod bypasses backoff (the requeue gate's first check),
        so its resting state returns to queue_wait."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                return
            t = self._now()
            if node is not None:
                self._charge(rec, t)
                rec.state = "queue_wait"
                self._append(
                    rec, ev.LIFECYCLE_NOMINATED, {"node": node}, t
                )
            else:
                self._append(rec, ev.LIFECYCLE_NOMINATION_CLEARED, {}, t)

    def on_gate_flip(self, uid: str, gated: bool) -> None:
        """`Cluster.reindex_pod` — the supported seam for in-place
        scheduling-gate flips (gang ungating). Re-index calls for other
        reasons (reservation releases) are no-ops: only an actual flip
        of the gate transitions the record."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None or rec.gated == gated:
                return
            t = self._now()
            self._charge(rec, t)
            rec.gated = gated
            rec.state = "gang_wait" if gated else "queue_wait"
            self._append(rec, ev.LIFECYCLE_GATE, {"gated": gated}, t)

    def on_terminating(self, uid: str) -> None:
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                return
            self._append(rec, ev.LIFECYCLE_TERMINATING, {}, self._now())

    def on_delete(self, uid: str) -> None:
        """`Cluster.remove_pod` of a still-pending pod: retire without
        feeding the scheduled-pod SLIs (upstream's e2e family only
        observes pods that actually scheduled)."""
        with self._lock:
            rec = self._records.pop(uid, None)
            if rec is None:
                return
            t = self._now()
            self._charge(rec, t)
            self._append(rec, ev.LIFECYCLE_DELETED, {}, t)
            self._retire(rec, t, "deleted")
            self.pods_deleted += 1

    # -- reads ------------------------------------------------------------
    def timeline(self, uid: str) -> Optional[dict]:
        """One pod's full story (live or retired) — the daemon's
        `GET /pods/{uid}/timeline`."""
        with self._lock:
            rec = self._records.get(uid)
            if rec is None:
                for r in reversed(self._retired):
                    if r.uid == uid:
                        rec = r
                        break
            if rec is None:
                return None
            out = rec.to_dict()
            out["cycles"] = [
                m for m in self._cycle_meta
                if rec.first_cycle <= m["cycle"]
                and (rec.retired_ns is None
                     or not rec.events
                     or m["cycle"] <= rec.events[-1][0])
            ]
            return out

    def sequence(self) -> list[tuple]:
        """The engine-comparable event sequence: (cycle, lane, seq, uid,
        kind, stable-detail) sorted — stamps excluded. Serial `run_cycle`
        and `PipelinedCycle` must produce EQUAL sequences on one stream."""
        with self._lock:
            rows = []
            for rec in list(self._retired) + list(self._records.values()):
                for c, lane, seq, kind, detail, _t in rec.events:
                    rows.append((
                        c, lane, seq, rec.uid, kind,
                        tuple(sorted(
                            (k, v) for k, v in detail.items()
                        )),
                    ))
            rows.sort()
            return rows

    def decomposition_errors(self) -> list[tuple]:
        """(uid, sum(stages), e2e) for every retired record where the
        telescoping invariant does NOT hold — always empty by
        construction; gated by the tests and the smoke."""
        with self._lock:
            bad = []
            for rec in self._retired:
                total = sum(rec.stages.values())
                e2e = rec.e2e_ns()
                if e2e is not None and total != e2e:
                    bad.append((rec.uid, total, e2e))
            return bad

    def sli_summary(self) -> dict:
        """Exact percentiles over the retired ring — the `/healthz` SLI
        block and the bench lines' `sli` block. Histogram-family metrics
        (bucketed, prometheus) are fed at retirement by `on_bind`."""
        with self._lock:
            bound = [r for r in self._retired if r.outcome == "bound"]
            live = len(self._records)
            pods_bound, pods_deleted = self.pods_bound, self.pods_deleted
        out = {
            "pods_bound": pods_bound,
            "pods_deleted": pods_deleted,
            "pods_pending": live,
        }
        if not bound:
            return out
        e2e = sorted(r.e2e_ns() / 1e6 for r in bound)

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(q * len(xs)))]

        out["e2e_ms"] = {
            "p50": pct(e2e, 0.50), "p90": pct(e2e, 0.90),
            "p99": pct(e2e, 0.99), "max": e2e[-1], "n": len(e2e),
        }
        out["attempts_mean"] = (
            sum(max(r.attempts, 1) for r in bound) / len(bound)
        )
        stage_ms = {s: 0.0 for s in STAGES}
        for r in bound:
            for s, ns in r.stages.items():
                stage_ms[s] = stage_ms.get(s, 0.0) + ns / 1e6
        out["stage_ms"] = stage_ms
        prios: dict[str, list] = {}
        for r in bound:
            prios.setdefault(str(r.priority), []).append(r.e2e_ns() / 1e6)
        out["by_priority"] = {
            p: {
                "n": len(xs),
                "p50": pct(sorted(xs), 0.50),
                "p99": pct(sorted(xs), 0.99),
            }
            for p, xs in prios.items()
        }
        return out

    def export(self) -> dict:
        """Full dump (bounded by the ring) — the flight-recorder bundle
        segment pod stories are reconstructed from."""
        with self._lock:
            out = {
                "version": 1,
                "cycles": list(self._cycle_meta),
                "retired": [r.to_dict() for r in self._retired],
                "live": [r.to_dict() for r in self._records.values()],
            }
        out["sli"] = self.sli_summary()
        return out


#: the process-global ledger (daemon + tools). Benches swap per-arm
#: instances in via `use()` so interleaved arms never share records.
LEDGER = Ledger()


def use(ledger: Ledger) -> Ledger:
    """Install `ledger` as the global feeding target; returns the
    previous one (callers restore it when their arm finishes)."""
    global LEDGER
    prev, LEDGER = LEDGER, ledger
    return prev
