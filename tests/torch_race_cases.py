"""The race checker's composite (`utils.racecheck`, `SPT_RACE=1`): a cut of
bench config 11's churn stream through `PipelinedCycle` +
`StreamingServeEngine` with the solve watchdog (`Resilience`), one
planted hang and config 11's pod-lifecycle ledger on. Shared by
`tests/test_torch_racecheck.py` (the CPU) and `chip_smoke.py` (the card).

What the checker sees: the ledger (a fresh `obs.ledger.Ledger` made
after `install`) takes its RLock on the main thread and on the bind
flusher's, and inside it each cycle's `LedgerCycle` lock (the lane
sequence numbers), so the two threads' nested acquisitions record order
edges an inversion would break; the delta sink's lock; and the
watchdog's completion Events. The flusher itself is a stdlib
`ThreadPoolExecutor`, whose own locks stay raw (the checker wraps only
the port's modules). `race_gates` requires every checked run to have
wrapped locks and Events and recorded at least one order edge, so "no
violation" never stands for "nothing checked".

`race_composite(pkg, racecheck, shape, seed, race)` runs the cut once;
with `race` the checker is installed with `seed` first (it wraps only the
locks and events made after `install`, from the port's modules), so the
seeds steer the interleaving while the data stays the same: every run's
placements and ledger counts must be equal, with or without the
checker. `pkg` is the namespace of `tests/torch_life_cases.py` plus
`PipelinedResilient(scheduler, cluster, engine, resilience)`.

The profile is NodeResourcesAllocatable alone (config 11 adds
Coscheduling, which has no gang in the churn phase): the host failover
covers that profile, so a slow host that misses the deadline twice still
places exactly.
"""

from __future__ import annotations

import time

import numpy as np

from torch_churn_cases import churn_cluster, churn_events

#: the card's cut: 256 nodes, 2,048 bound pods, six ticks of churn, the
#: hang on the third (one attempt abandoned, the retry places)
RACE_SHAPE = dict(
    n_nodes=256, prefill=2048, ticks=6, hang_tick=2, hang_s=1.2,
    timeout_s=1.0,
    churn=dict(lam_arrive=32, lam_depart=16, node_add_every=4,
               node_remove_every=3),
)
#: the CPU tests' cut
RACE_TEST_SHAPE = dict(RACE_SHAPE, n_nodes=32, prefill=128)
#: the checker's seeds
RACE_SEEDS = (0, 1, 2)


def race_composite(pkg, racecheck, shape, seed=0, race=True) -> dict:
    """One run of the composite: every tick's bound map, the final
    store's placements, the watchdog's retries and failovers, the plan's
    fired faults and, under the checker, its report."""
    F = pkg.faults
    installed = racecheck.install(seed=seed) if race else False
    if race and not installed:
        raise RuntimeError("racecheck.install refused: set SPT_RACE=1")
    rc_report = None
    led = pkg.ledger.Ledger().start()
    prev_ledger = pkg.ledger.use(led)
    plan = F.FaultPlan(seed=0)
    plan.specs.append(F.FaultSpec(site=F.SOLVE_DISPATCH,
                                  cycle=shape["hang_tick"], kind="hang",
                                  seconds=shape["hang_s"]))
    try:
        cluster = churn_cluster(pkg, shape["n_nodes"], shape["prefill"], 0)
        sched = pkg.Scheduler(pkg.Profile(plugins=[
            pkg.plugins.NodeResourcesAllocatable()]))
        engine = pkg.StreamingEngine().attach(cluster)
        rz = pkg.Resilience(
            watchdog=pkg.SolveWatchdog(timeout_s=shape["timeout_s"],
                                       max_attempts=2, backoff_base_s=0.01,
                                       seed=0),
            probe_every=1, engine=engine)
        pipe = pkg.PipelinedResilient(sched, cluster, engine, rz)
        rng = np.random.default_rng(1)
        serial = 0
        ticks = []
        F.install(plan)
        try:
            for k in range(shape["ticks"]):
                plan.begin_cycle(k)
                now = 1000 * (k + 1)
                serial = churn_events(pkg, cluster, rng, shape["churn"], k,
                                      now, serial)
                report = pipe.tick(now)
                pipe.fence()
                ticks.append((dict(report.bound), list(report.failed),
                              report.solve_path))
            pipe.close()
        finally:
            F.clear()
        # the abandoned worker wakes after the hang and solves its stale
        # snapshot: let it finish before anything else runs
        time.sleep(shape["hang_s"])
        if installed:
            rc_report = racecheck.report()
    finally:
        pkg.ledger.use(prev_ledger)
        if installed:
            racecheck.uninstall()
    return {
        "ticks": ticks,
        "placements": {uid: p.node_name for uid, p in cluster.pods.items()},
        "failovers": rz.failovers,
        "fired": list(plan.log),
        "ledger": (led.pods_bound, led.pods_deleted),
        "racecheck": rc_report,
    }


def race_gates(runs: list, control: dict) -> list:
    """The composite's failures (empty = pass): any checker violation, a
    checked run that wrapped no lock or Event or recorded no order edge,
    an unfired hang, or placements or ledger counts that differ between
    runs or from the run without the checker."""
    errors = []
    for i, run in enumerate(runs):
        rep = run["racecheck"]
        if rep["violations"]:
            errors.append(f"run {i}: violations {rep['violations'][:3]}")
        if not (rep["locks_created"] >= 2 and rep["events_created"] >= 1
                and rep["order_edges"] >= 1):
            errors.append(
                f"run {i}: the checker checked too little: "
                f"locks={rep['locks_created']} "
                f"events={rep['events_created']} "
                f"edges={rep['order_edges']}")
        if not run["fired"]:
            errors.append(f"run {i}: the planted hang never fired")
        if run["ticks"] != control["ticks"]:
            errors.append(f"run {i}: tick decisions differ from control")
        if run["placements"] != control["placements"]:
            errors.append(f"run {i}: final placements differ from control")
        if run["ledger"] != control["ledger"]:
            errors.append(f"run {i}: ledger counts differ from control")
    return errors
