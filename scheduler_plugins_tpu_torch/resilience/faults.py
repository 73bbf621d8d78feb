"""Deterministic fault injection (port of
`scheduler_plugins_tpu.resilience.faults`): seeded plans fired at named
sites.

A chaos run or a test drives the runtime through the same code paths
production faults would take (a hung or failing device solve, garbage
solve output, dropped, duplicated or corrupted `DeltaSink` events, a
stalled feed, a crash after the bind stage) by installing a `FaultPlan`
into this module's process-global registry. Each instrumented site calls
`fire(SITE)` (or reads `ACTIVE` itself) and interprets the `FaultSpec` it
gets back. Of the sites, the port instruments the delta sink
(`serving.deltas.DeltaSink._push`, through `mutate_delta`) and the cycle's
post-bind crash; the solve watchdog's sites come with the watchdog.

Zero cost when off: every site's fast path is one module-global `is None`
check. Determinism: a plan is made from a seed alone
(`FaultPlan.standard`), every payload draw comes from the plan's own
`np.random.default_rng` stream, and sites fire in the cycle's
deterministic host order, so two runs with one seed inject the same
faults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# -- site names (the instrumented seams) ------------------------------------

#: device solve dispatch (`resilience.watchdog.Resilience._device_call`):
#: kinds "hang" (worker sleeps past the deadline), "device-error"
#: (RuntimeError from the dispatch), "garbage" (solve output corrupted —
#: out-of-range node indices, the shape a desynced tunnel produces)
SOLVE_DISPATCH = "solve.dispatch"
#: delta-sink event push (`serving.deltas.DeltaSink._push`): kinds
#: "drop", "dup", "corrupt" (assign flipped to unassign — a sign error
#: only the anti-entropy digest can see; the Cluster store is untouched)
DELTA_EVENT = "delta.event"
#: harness-level feed stall before a cycle: kind "stall" with `seconds`
FEED_STALL = "feed.stall"
#: crash after the Bind/Permit phase of `framework.cycle.run_cycle`
#: (bindings landed, process state about to die): kind "crash"
CRASH_POST_BIND = "cycle.post_bind"
#: probation probe (`Resilience._probe`): kind "device-error" keeps the
#: backend looking sick so degraded mode persists across cycles
PROBE = "solve.probe"
#: shadow-lane sweep (`tuning.shadow.ShadowTuner._sweep_job`): kinds
#: "hang" (the sweep worker sleeps past the tuner deadline — the lane
#: must degrade to "no tuning", never stall or corrupt a tick),
#: "garbage" (every non-incumbent candidate's replayed placements are
#: corrupted to out-of-range node indices — the numpy replay oracles
#: must disqualify all of them, so nothing garbage can reach the live
#: weights)
TUNE_SWEEP = "tune.sweep"
#: live promotion application (`ShadowTuner.begin_cycle`): kind "crash"
#: (the apply raises mid-promotion — the tuner must keep the incumbent
#: weights live, count the fault, and recover or disable itself)
TUNE_PROMOTE = "tune.promote"

ALL_SITES = (SOLVE_DISPATCH, DELTA_EVENT, FEED_STALL, CRASH_POST_BIND, PROBE,
             TUNE_SWEEP, TUNE_PROMOTE)


class CrashInjected(RuntimeError):
    """Raised by the CRASH_POST_BIND site: simulates process death after
    bindings were committed. Carries the partially-built `CycleReport` so
    the harness can account the crashed cycle's (real, landed) binds."""

    def __init__(self, report=None):
        super().__init__("injected crash (cycle.post_bind)")
        self.report = report


@dataclass
class FaultSpec:
    """One scheduled fault: `kind` is site-specific (see site docs);
    `repeat` is how many consecutive fires at the site consume this spec
    (a hang that outlives the watchdog's retry budget needs repeat >
    max_attempts); `seconds` parameterizes hang/stall kinds."""

    site: str
    cycle: int
    kind: str
    repeat: int = 1
    seconds: float = 0.0
    #: sticky specs roll forward: they stay pending from their scheduled
    #: cycle until the site actually fires (delta faults need a sink
    #: event to pass through — a cycle with no pushes must not silently
    #: void the fault)
    sticky: bool = False
    #: filled by the registry as the spec fires (observability)
    fired: int = 0


@dataclass
class FaultPlan:
    """Seeded schedule of `FaultSpec`s, advanced cycle-by-cycle by the
    harness (`begin_cycle`) and consumed by the instrumented sites
    (`fire`)."""

    seed: int = 0
    specs: list = field(default_factory=list)
    #: every (cycle, site, kind) that actually fired, in order
    log: list = field(default_factory=list)
    _cycle: int = -1
    _rng: Optional[np.random.Generator] = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def rng(self) -> np.random.Generator:
        """The plan's payload stream (garbage values, corrupt picks) —
        one stream, drawn only when a fault fires, so injection stays
        deterministic given the seed and the fire order."""
        return self._rng

    def begin_cycle(self, cycle: int) -> None:
        self._cycle = cycle

    def pending(self, site: str) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.site != site or spec.fired >= spec.repeat:
                continue
            due = (
                spec.cycle == self._cycle
                or (spec.sticky and spec.fired == 0
                    and 0 <= spec.cycle <= self._cycle)
            )
            if due:
                return spec
        return None

    def fire(self, site: str) -> Optional[FaultSpec]:
        spec = self.pending(site)
        if spec is None:
            return None
        spec.fired += 1
        self.log.append((self._cycle, site, spec.kind))
        return spec

    def unfired(self) -> list:
        """Specs that never fired (the harness asserts this is empty —
        a plan entry that missed its site is a harness bug, and a chaos
        run that silently skipped a fault must not pass the gate)."""
        return [s for s in self.specs if s.fired == 0]

    @classmethod
    def standard(cls, seed: int, cycles: int, hang_seconds: float = 3.0,
                 stall_seconds: float = 0.05) -> "FaultPlan":
        """The full fault taxonomy spread deterministically over
        `cycles` (docs/ROBUSTNESS.md): one of each kind, cycle slots
        drawn without replacement from a seeded stream so no two faults
        land on the same cycle (each fault's recovery window is measured
        in isolation). Requires cycles >= 10: 8 distinct slots must fit
        in [1, cycles-2] (cycle 0 and the last cycle stay fault-free)."""
        if cycles < 10:
            raise ValueError(
                f"standard plan needs >= 10 cycles (8 distinct slots in "
                f"[1, cycles-2]), got {cycles}"
            )
        rng = np.random.default_rng(seed)
        kinds = [
            (SOLVE_DISPATCH, "hang", dict(seconds=hang_seconds, repeat=4)),
            (SOLVE_DISPATCH, "device-error", dict(repeat=4)),
            (SOLVE_DISPATCH, "garbage", dict()),
            (DELTA_EVENT, "drop", dict()),
            (DELTA_EVENT, "dup", dict()),
            (DELTA_EVENT, "corrupt", dict()),
            (FEED_STALL, "stall", dict(seconds=stall_seconds)),
            (CRASH_POST_BIND, "crash", dict()),
        ]
        # leave cycle 0 fault-free (the first refresh builds the resident
        # base) and keep one clean cycle after the last fault
        slots = rng.choice(
            np.arange(1, cycles - 1), size=len(kinds), replace=False
        )
        plan = cls(seed=seed)
        for (site, kind, kw), cycle in zip(kinds, sorted(int(s) for s in slots)):
            plan.specs.append(FaultSpec(site=site, cycle=cycle, kind=kind, **kw))
        return plan


#: the process-global registry — `None` is THE fast path (every
#: instrumented site checks this before doing anything else)
ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global ACTIVE
    ACTIVE = plan
    return plan


def clear() -> None:
    global ACTIVE
    ACTIVE = None


def fire(site: str) -> Optional[FaultSpec]:
    """Fire-and-consume for `site` this cycle; None when off/not due.
    Sites on hot paths should check `ACTIVE is None` inline first —
    this function exists for the cooler sites."""
    if ACTIVE is None:
        return None
    return ACTIVE.fire(site)


def mutate_delta(ev: tuple) -> list:
    """The DELTA_EVENT site's event transform: [] (drop), [ev, ev]
    (dup), or a corrupted copy (assign<->unassign sign flip; non-usage
    events degrade to drop). Poisons ONLY the sink's view — the Cluster
    store never sees the mutation, which is exactly what makes the
    divergence invisible to everything except the anti-entropy digest."""
    spec = None if ACTIVE is None else ACTIVE.fire(DELTA_EVENT)
    if spec is None:
        return [ev]
    if spec.kind == "drop":
        return []
    if spec.kind == "dup":
        return [ev, ev]
    # corrupt: flip a usage event's sign (pod_assign <-> pod_unassign)
    kind = ev[0]
    if kind == "pod_assign":
        return [("pod_unassign",) + ev[1:]]
    if kind == "pod_unassign":
        return [("pod_assign",) + ev[1:]]
    return []  # node events: corruption degrades to drop
