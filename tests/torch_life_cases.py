"""Bench config 11, the cluster-life endurance run (`bench.py`
`cluster_life`, `bench.py:2270-2700`): ONE seeded event stream, phased as
Poisson churn, Coscheduling gang arrivals with elastic resizes, churn under
a seeded fault plan with the solve watchdog, and node add / remove waves,
run through the pipelined engine (`PipelinedCycle` +
`StreamingServeEngine`) and the serial one (`run_cycle` + `ServeEngine`).
Shared by `tests/test_torch_pipeline_cycle.py` (the port against the JAX
package) and `chip_smoke.py` (the card against the CPU).

Every function takes either package's names in a namespace and imports
neither package: the churn helpers' (`pkg.objects` or `pkg.o`,
`pkg.Cluster`), plus `pkg.Engine` and `pkg.StreamingEngine` (the two
serving engines), `pkg.Pipelined(scheduler, cluster, serve)` (a
`PipelinedCycle` on the caller's device), `pkg.run(scheduler, cluster,
now, engine, resilience)` (one `run_cycle`), `pkg.faults`,
`pkg.Resilience`, `pkg.SolveWatchdog`, `pkg.ledger` (the `obs.ledger`
module), `pkg.Scheduler`, `pkg.Profile` and `pkg.plugins`.

- `CLUSTER_LIFE_SHAPE` is config 11's full shape, `ENDURANCE_SMOKE_SHAPE`
  the bench's reduced gate; `life_fault_plan` the chaos phase's plan;
  `life_gang_events` / `drain_life_gangs` the gang lifecycle;
  `life_scheduler` the profile; `LifeArm` one arm as a state machine
  stepped one cycle at a time, so several arms interleave; `life_gates`
  the hard checks between two finished arms.
"""

from __future__ import annotations

import time

import numpy as np

from torch_chaos_cases import chaos_resilience
from torch_churn_cases import (
    GIB,
    capacity_violations,
    churn_cluster,
    churn_events,
)

#: config 11's shape (`bench.py` CLUSTER_LIFE_SHAPE): 2,000 nodes, 12,288
#: bound pods, 4 warm-up cycles, then 48 churn, 12 gang, 16 chaos and 16
#: wave cycles
CLUSTER_LIFE_SHAPE = dict(
    n_nodes=2000, prefill=12288, warmup=4, seed=0,
    churn=dict(cycles=48, lam_arrive=48, lam_depart=24,
               node_add_every=16, node_remove_every=24),
    gangs=dict(cycles=12, lam_arrive=24, lam_depart=12, gang_every=4,
               gang_size=4, grow_by=2),
    chaos=dict(cycles=16, lam_arrive=32, lam_depart=16, verify_every=1,
               timeout_s=5.0),
    waves=dict(cycles=16, lam_arrive=24, lam_depart=24,
               node_add_every=3, node_remove_every=2),
)
#: the bench's reduced gate (`bench.py` ENDURANCE_SMOKE_SHAPE)
ENDURANCE_SMOKE_SHAPE = dict(
    n_nodes=500, prefill=4096, warmup=3, seed=0,
    churn=dict(cycles=16, lam_arrive=24, lam_depart=12,
               node_add_every=9, node_remove_every=5),
    gangs=dict(cycles=6, lam_arrive=12, lam_depart=6, gang_every=3,
               gang_size=3, grow_by=1),
    chaos=dict(cycles=8, lam_arrive=16, lam_depart=8, verify_every=1,
               timeout_s=5.0),
    waves=dict(cycles=8, lam_arrive=12, lam_depart=12,
               node_add_every=3, node_remove_every=2),
)
#: the phase order is part of the workload
CLUSTER_LIFE_PHASES = ("churn", "gangs", "chaos", "waves")


def _objects(pkg):
    return getattr(pkg, "objects", None) or pkg.o


def life_scheduler(pkg):
    """Config 11's profile: NodeResourcesAllocatable and Coscheduling
    with a 30 s permit wait."""
    P = pkg.plugins
    return pkg.Scheduler(pkg.Profile(plugins=[
        P.NodeResourcesAllocatable(),
        P.Coscheduling(permit_waiting_seconds=30),
    ]))


def life_fault_plan(pkg, shape, seed=0):
    """The chaos phase's seeded plan (`bench.py` `_life_fault_plan`):
    solve garbage and the three sink-delta corruptions (sticky: they fire
    at the first delta after their slot)."""
    F = pkg.faults
    cycles = shape["chaos"]["cycles"]
    rng = np.random.default_rng(seed + 17)
    kinds = [
        (F.SOLVE_DISPATCH, "garbage", False),
        (F.DELTA_EVENT, "drop", True),
        (F.DELTA_EVENT, "dup", True),
        (F.DELTA_EVENT, "corrupt", True),
    ]
    slots = rng.choice(np.arange(1, cycles - 1), size=len(kinds),
                       replace=False)
    plan = F.FaultPlan(seed=seed)
    for (site, kind, sticky), cycle in zip(kinds,
                                           sorted(int(s) for s in slots)):
        plan.specs.append(F.FaultSpec(site=site, cycle=cycle, kind=kind,
                                      sticky=sticky))
    return plan


def _gang_members(cluster, gname, bound_only=False):
    return [p.uid for p in cluster.pods.values()
            if p.namespace == "life" and p.pod_group() == gname
            and (not bound_only or p.node_name is not None)]


def life_gang_events(pkg, cluster, phase_cycle, shape, now, roster):
    """The gangs phase's lifecycle (`bench.py` `_life_gang_events`): a
    gang every `gang_every` cycles, grown by `grow_by` members two cycles
    in, shrunk by its highest-serial bound member three cycles later, and
    completed (members and group removed) after eight. `roster` carries
    {gang name: (birth cycle, next member serial)}."""
    o = _objects(pkg)
    cfg = shape["gangs"]

    def add_member(gname, m):
        cluster.add_pod(o.Pod(
            name=f"{gname}-m{m}", namespace="life", creation_ms=now + m,
            labels={o.POD_GROUP_LABEL: gname},
            containers=[o.Container(requests={"cpu": 1500,
                                              "memory": 3 * GIB})],
        ))

    if phase_cycle % cfg["gang_every"] == 0:
        gname = f"lg{phase_cycle:03d}"
        cluster.add_pod_group(o.PodGroup(
            name=gname, namespace="life", min_member=cfg["gang_size"] - 1,
            creation_ms=now,
        ))
        for m in range(cfg["gang_size"]):
            add_member(gname, m)
        roster[gname] = (phase_cycle, cfg["gang_size"])
    for gname, (birth, serial) in list(roster.items()):
        age = phase_cycle - birth
        if age == 2:
            for m in range(serial, serial + cfg["grow_by"]):
                add_member(gname, m)
            roster[gname] = (birth, serial + cfg["grow_by"])
        elif age == 5:
            members = sorted(_gang_members(cluster, gname, bound_only=True),
                             reverse=True)
            if members:
                cluster.remove_pod(members[0])
        elif age >= 8:
            for uid in _gang_members(cluster, gname):
                cluster.remove_pod(uid)
            cluster.pod_groups.pop(f"life/{gname}", None)
            roster.pop(gname, None)


def drain_life_gangs(cluster, roster):
    """The end of the gangs phase: every remaining gang completes, so the
    serving engines own the snapshot again."""
    for gname in list(roster):
        for uid in _gang_members(cluster, gname):
            cluster.remove_pod(uid)
        cluster.pod_groups.pop(f"life/{gname}", None)
        roster.pop(gname, None)


class LifeArm:
    """One cluster-life arm as a state machine (`bench.py` `_LifeArm`):
    `step()` runs one cycle (the events, then the tick), so several arms
    can be stepped interleaved. Every random draw comes from the seeded
    stream and the cluster's bound set, so arms with equal placements see
    the same events. Each arm has its own ledger, swapped in around its
    step, and its own fault plan, installed around its own tick; the
    pipelined arm fences inside the timed window."""

    def __init__(self, pkg, shape, pipelined, seed=0, scheduler=None):
        self.pkg = pkg
        self.shape = shape
        self.pipelined = pipelined
        self.seed = seed
        self.scheduler = scheduler or life_scheduler(pkg)
        t0 = time.perf_counter()
        self.cluster = churn_cluster(pkg, shape["n_nodes"], shape["prefill"],
                                     seed)
        self.build_s = time.perf_counter() - t0
        self.engine = (pkg.StreamingEngine() if pipelined
                       else pkg.Engine()).attach(self.cluster)
        self.pipe = (pkg.Pipelined(self.scheduler, self.cluster, self.engine)
                     if pipelined else None)
        self.rng = np.random.default_rng(seed + 1)
        self.serial = 0
        self.cycle = 0
        self.times = {name: [] for name in CLUSTER_LIFE_PHASES}
        self.decided = {name: [] for name in CLUSTER_LIFE_PHASES}
        #: (rebases, compactions) at the end of each cycle
        self.counters: list = []
        self.placements: dict = {}
        #: the timed cycles' reports: their failure attribution is
        #: complete only after the pipelined arm's next overlap window
        self.reports: list = []
        self.gang_roster: dict = {}
        self.schedule = (
            ["churn"] * (shape["warmup"] + shape["churn"]["cycles"])
            + ["gangs"] * shape["gangs"]["cycles"]
            + ["chaos"] * shape["chaos"]["cycles"]
            + ["waves"] * shape["waves"]["cycles"]
        )
        self.gang_phase_start = shape["warmup"] + shape["churn"]["cycles"]
        self.chaos_start = self.gang_phase_start + shape["gangs"]["cycles"]
        self._events = {
            "churn": dict(shape["churn"]),
            "gangs": dict(shape["gangs"],
                          node_add_every=shape["gangs"].get(
                              "node_add_every", 0),
                          node_remove_every=shape["gangs"].get(
                              "node_remove_every", 0)),
            # the anti-entropy window is one refresh in the chaos phase,
            # so both arms detect a corruption at the refresh that applied
            # it (`bench.py` `_LifeArm`)
            "chaos": dict(shape["chaos"], node_add_every=0,
                          node_remove_every=0, probe_every=1),
            "waves": dict(shape["waves"]),
        }
        self.plan = life_fault_plan(pkg, shape, seed)
        self.rz = chaos_resilience(pkg, self._events["chaos"], self.engine,
                                   seed)
        self._old_verify = self.engine.verify_every
        self._prev_phase = None
        self.ledger = pkg.ledger.Ledger().start()

    @property
    def done(self) -> bool:
        return self.cycle >= len(self.schedule)

    @property
    def phase(self) -> str:
        return self.schedule[min(self.cycle, len(self.schedule) - 1)]

    def _transition(self, phase):
        if phase == self._prev_phase:
            return
        if self._prev_phase == "gangs":
            if self.pipe is not None:
                self.pipe.flush()
            drain_life_gangs(self.cluster, self.gang_roster)
            self.engine.verify_every = self._old_verify
        if self._prev_phase == "chaos":
            if self.pipe is not None:
                self.pipe.flush()
                self.pipe.resilience = None
            self.engine.verify_every = self._old_verify
        if phase == "gangs":
            # the periodic verify stays out of the short gang window (the
            # two engines' refresh counters drift apart across deletes)
            self.engine.verify_every = 0
        if phase == "chaos":
            if self.pipe is not None:
                self.pipe.resilience = self.rz
            self.engine.verify_every = self.shape["chaos"]["verify_every"]
        self._prev_phase = phase

    def step(self):
        """Run one cycle (events, then the tick) of the schedule."""
        prev = self.pkg.ledger.use(self.ledger)
        try:
            self._step()
        finally:
            # the pipelined arm's flusher is joined inside `_step`, so no
            # hook fires against another arm's ledger after this restore
            self.pkg.ledger.use(prev)

    def _step(self):
        F = self.pkg.faults
        phase = self.schedule[self.cycle]
        self._transition(phase)
        now = 1000 * (self.cycle + 1)
        self.serial = churn_events(self.pkg, self.cluster, self.rng,
                                   self._events[phase], self.cycle, now,
                                   self.serial)
        if phase == "gangs":
            life_gang_events(self.pkg, self.cluster,
                             self.cycle - self.gang_phase_start, self.shape,
                             now, self.gang_roster)
        chaos = phase == "chaos"
        if chaos:
            F.install(self.plan)
            self.plan.begin_cycle(self.cycle - self.chaos_start)
        start = time.perf_counter()
        try:
            if self.pipelined:
                report = self.pipe.tick(now)
                # decision latency ends at host-visible binds: the fence
                # is inside the timed window
                self.pipe.fence()
            else:
                report = self.pkg.run(self.scheduler, self.cluster, now,
                                      self.engine,
                                      self.rz if chaos else None)
        finally:
            if chaos:
                F.clear()
        elapsed = time.perf_counter() - start
        self.placements.update(report.bound)
        if self.cycle >= self.shape["warmup"]:
            self.times[phase].append(elapsed)
            self.decided[phase].append(len(report.bound)
                                       + len(report.failed))
            self.reports.append((phase, report))
        self.counters.append((self.engine.rebases,
                              getattr(self.engine, "compactions", 0)))
        self.cycle += 1

    def finish(self) -> dict:
        """Flush and close the pipelined arm, then the arm's record."""
        prev = self.pkg.ledger.use(self.ledger)
        try:
            if self.pipe is not None:
                self.pipe.flush()
                self.pipe.close()
        finally:
            self.pkg.ledger.use(prev)
        out = {
            "sli": self.ledger.sli_summary(),
            "ledger_sequence": self.ledger.sequence(),
            "ledger_decomposition_errors":
                len(self.ledger.decomposition_errors()),
            "times": self.times,
            "decided": self.decided,
            "placements": self.placements,
            "report_digests": [report_digest(r) for _, r in self.reports],
            "final_state": {uid: p.node_name
                            for uid, p in sorted(self.cluster.pods.items())},
            "violations": capacity_violations(self.cluster),
            "rebases": self.engine.rebases,
            "compactions": getattr(self.engine, "compactions", 0),
            "phase_counters": self.phase_counters(),
            "gang_fallbacks": self.engine.gang_fallbacks,
            "antientropy_divergences": self.engine.antientropy_divergences,
            "faults_fired": len(self.plan.log),
            "degraded_end": self.rz.degraded,
            "build_s": self.build_s,
        }
        if self.pipe is not None:
            tls = list(self.pipe.timelines)
            out["overlap_efficiency_mean"] = (
                float(np.mean([t.overlap_efficiency for t in tls]))
                if tls else None)
            out["pipeline_bubble_ms_mean"] = (
                float(np.mean([t.pipeline_bubble_ms for t in tls]))
                if tls else None)
            out["late_binds"] = sum(1 for t in tls if t.late_bind)
            late = {name: 0 for name in CLUSTER_LIFE_PHASES}
            for t in tls:
                late[self.schedule[t.cycle]] += int(t.late_bind)
            out["phase_late_binds"] = late
        return out

    def phase_counters(self) -> dict:
        """{phase: (rebases, compactions)} made during the phase's timed
        cycles (the warm-up's excluded)."""
        out = {}
        prev = self.counters[self.shape["warmup"] - 1] \
            if self.shape["warmup"] else (0, 0)
        for name in CLUSTER_LIFE_PHASES:
            idx = [k for k, ph in enumerate(self.schedule)
                   if ph == name and k >= self.shape["warmup"]]
            end = self.counters[idx[-1]] if idx else prev
            out[name] = (end[0] - prev[0], end[1] - prev[1])
            prev = end
        return out


def report_digest(report) -> tuple:
    """One cycle's decisions: bound, reserved, failed, the failure
    attribution and the rejected gangs."""
    return (tuple(sorted(report.bound.items())),
            tuple(sorted(report.reserved.items())),
            tuple(sorted(report.failed)),
            tuple(sorted(report.failed_by.items())),
            tuple(sorted(report.rejected_gangs)))


def cycles_per_sec(arm: dict, phase=None) -> float:
    ts = (arm["times"][phase] if phase else
          [t for name in CLUSTER_LIFE_PHASES for t in arm["times"][name]])
    return len(ts) / sum(ts) if ts else 0.0


def decision_latency_ms(arm: dict, phase=None) -> tuple:
    """(p50, p99) decision latency in ms: each decision takes its cycle's
    wall time (ingest to host-visible binds), weighted by the cycle's
    decisions (`bench.py` `cluster_life`)."""
    names = (phase,) if phase else CLUSTER_LIFE_PHASES
    times = np.array([t for n in names for t in arm["times"][n]])
    weights = np.array([d for n in names for d in arm["decided"][n]],
                       dtype=np.int64)
    lat = np.repeat(times, weights) if times.size else np.array([])
    if not lat.size:
        return 0.0, 0.0
    return (float(np.percentile(lat, 50)) * 1000,
            float(np.percentile(lat, 99)) * 1000)


def life_gates(pipe: dict, serial: dict) -> list:
    """The hard checks between a finished pipelined arm and another arm
    (`bench.py` `cluster_life` and `endurance_smoke`), as a list of
    failures: every cycle's decisions, the final store and the ledger
    sequences equal, no capacity violation, no decomposition error, row
    compactions made in the waves phase, and fewer rebases in the
    streaming arm when the other one is serial."""
    bad = []
    if pipe["report_digests"] != serial["report_digests"]:
        first = next(k for k, (a, b) in enumerate(zip(
            pipe["report_digests"], serial["report_digests"])) if a != b) \
            if len(pipe["report_digests"]) == len(serial["report_digests"]) \
            else "length"
        bad.append(f"per-cycle decisions differ (first at {first})")
    if pipe["final_state"] != serial["final_state"]:
        bad.append("final store differs")
    if pipe["ledger_sequence"] != serial["ledger_sequence"]:
        bad.append("ledger sequences differ")
    for label, arm in (("pipelined", pipe), ("other", serial)):
        if arm["violations"]:
            bad.append(f"{label}: {arm['violations']} capacity violations")
        if arm["ledger_decomposition_errors"]:
            bad.append(f"{label}: {arm['ledger_decomposition_errors']} "
                       "decomposition errors")
    if pipe["phase_counters"]["waves"][1] <= 0:
        bad.append("no row compaction in the waves phase")
    if "overlap_efficiency_mean" not in serial and \
            not pipe["rebases"] < serial["rebases"]:
        bad.append(f"streaming rebases {pipe['rebases']} not below the "
                   f"serial engine's {serial['rebases']}")
    return bad
