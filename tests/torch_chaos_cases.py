"""Bench config 9, the chaos churn (`bench.py` `chaos_churn`,
`bench.py:1465-1790`): config 7's serving churn through the serving
engine and the solve watchdog, with the full seeded fault taxonomy
injected (a hung solve, a device error, garbage output, dropped,
duplicated and corrupted sink events, a feed stall, a crash after the
binds). Shared by `tests/test_torch_resilience.py` (the port against the
JAX package) and `chip_smoke.py` (the card against the CPU).

Every function takes either package's names in a namespace: the churn
helpers' (`pkg.objects` or `pkg.o`, `pkg.Cluster`), plus `pkg.Engine`
(`ServeEngine`), `pkg.faults`, `pkg.Resilience`, `pkg.SolveWatchdog`,
`pkg.run(scheduler, cluster, now, engine, resilience)` (one `run_cycle`)
and `pkg.restore(engine, checkpoint)`. It imports neither package.

- `CHAOS_SHAPE` is config 9's full shape, `CHAOS_SMOKE_SHAPE` the
  bench's reduced gate; `chaos_fault_plan` the standard plan with sticky
  delta faults; `chaos_resilience` the watchdog configuration;
  `run_chaos_arm` one arm (None = the fault-free control);
  `chaos_gates` the gate arithmetic of `chaos_churn`.
"""

from __future__ import annotations

import time

import numpy as np

from torch_churn_cases import (
    capacity_violations,
    churn_cluster,
    churn_events,
)

#: config 9's shape (`bench.py` CHAOS_SHAPE): config 7's churn at 500
#: nodes and 4,096 bound pods, 4 + 32 cycles, a 2.0 s solve deadline and a
#: 3.0 s injected hang
CHAOS_SHAPE = dict(
    n_nodes=500, prefill=4096, cycles=32, warmup=4,
    lam_arrive=32, lam_depart=16, node_add_every=10, node_remove_every=0,
    timeout_s=2.0, hang_seconds=3.0, stall_seconds=0.05, probe_every=1,
)
#: the recovery bound of the bench's chaos gate (`bench.py` `chaos_smoke`)
RECOVERY_BOUND = 4
#: the bench's reduced gate (`bench.py` CHAOS_SMOKE_SHAPE)
CHAOS_SMOKE_SHAPE = dict(
    n_nodes=120, prefill=1024, cycles=16, warmup=2,
    lam_arrive=12, lam_depart=6, node_add_every=7, node_remove_every=0,
    timeout_s=1.5, hang_seconds=2.5, stall_seconds=0.02, probe_every=1,
)


def chaos_fault_plan(pkg, shape, seed=0):
    """The standard fault plan over the timed cycles, its delta faults
    sticky: a delta fault fires at the first cycle a sink event passes
    through, never silently missing (`bench.py` `_chaos_fault_plan`)."""
    F = pkg.faults
    plan = F.FaultPlan.standard(
        seed, shape["cycles"], hang_seconds=shape["hang_seconds"],
        stall_seconds=shape["stall_seconds"],
    )
    for spec in plan.specs:
        if spec.site == F.DELTA_EVENT:
            spec.sticky = True
    return plan


def chaos_resilience(pkg, shape, engine, seed=0):
    """The chaos arms' watchdog: the shape's deadline, two attempts, a
    10 ms backoff base (`bench.py` `_chaos_resilience`)."""
    return pkg.Resilience(
        watchdog=pkg.SolveWatchdog(
            timeout_s=shape["timeout_s"], max_attempts=2,
            backoff_base_s=0.01, seed=seed,
        ),
        probe_every=shape["probe_every"],
        engine=engine,
    )


def run_chaos_arm(pkg, scheduler, shape, seed=0, plan=None) -> dict:
    """One chaos-churn run (`bench.py` `_run_chaos_arm`): config 7's event
    stream through the serving engine and the watchdog, with `plan`
    installed (None = the fault-free control: the same engine and
    watchdog configuration, so the arms differ only in injected faults).
    The anti-entropy window is one cycle (`verify_every=1`). A crash
    restarts from the last checkpoint with a fresh engine and watchdog.
    Returns per-cycle wall times and bound maps, the per-cycle solve
    paths, and the recovery bookkeeping."""
    F = pkg.faults
    cluster = churn_cluster(pkg, shape["n_nodes"], shape["prefill"], seed)
    engine = pkg.Engine().attach(cluster)
    engine.verify_every = 1
    rz = chaos_resilience(pkg, shape, engine, seed)
    rng = np.random.default_rng(seed + 1)
    serial = 0
    times, decided, bound_per_cycle, paths = [], [], [], []
    degraded_cycles = 0
    crashes = 0
    # accumulated across engine replacements (a crash swaps the engine)
    rebases_acc = 0
    divergences_acc = 0
    abandoned_acc = 0
    rebases0 = engine.rebases
    recoveries: list = []
    checkpoint = None
    if plan is not None:
        F.install(plan)
    try:
        total = shape["warmup"] + shape["cycles"]
        for cycle in range(total):
            now = 1000 * (cycle + 1)
            timed_idx = cycle - shape["warmup"]
            if plan is not None:
                # warmup cycles are fault-free (timed_idx < 0 matches no
                # spec); the window also covers the churn's sink pushes
                plan.begin_cycle(timed_idx)
                stall = plan.fire(F.FEED_STALL)
                if stall is not None:
                    time.sleep(stall.seconds)  # a stalled feed costs
                    # latency; the cycle itself is unaffected
            serial = churn_events(pkg, cluster, rng, shape, cycle, now,
                                  serial)
            start = time.perf_counter()
            try:
                report = pkg.run(scheduler, cluster, now, engine, rz)
                bound = dict(report.bound)
                failed = len(report.failed)
                degraded = report.degraded
                path = report.solve_path
            except F.CrashInjected as crash:
                # process death after the binds landed: the engine (its
                # resident tensors and undrained sink) and the watchdog
                # die; the restart restores the last checkpoint, and the
                # anti-entropy verify rebases the stale base within one
                # window
                crashes += 1
                bound = dict(crash.report.bound)
                failed = len(crash.report.failed)
                degraded = rz.degraded
                path = "crash"
                recoveries.extend(rz.recoveries)
                if rz.degraded:
                    # the crash ends an open degradation at the restart
                    recoveries.append((rz.degraded_at, rz.cycle))
                rebases_acc += engine.rebases - rebases0
                divergences_acc += engine.antientropy_divergences
                abandoned_acc += rz.watchdog.abandoned
                engine.detach()
                engine = pkg.Engine().attach(cluster)
                engine.verify_every = 1
                rebases0 = engine.rebases
                if checkpoint is not None:
                    pkg.restore(engine, checkpoint)
                rz = chaos_resilience(pkg, shape, engine, seed)
            elapsed = time.perf_counter() - start
            checkpoint = engine.checkpoint_bytes() or checkpoint
            if timed_idx >= 0:
                times.append(elapsed)
                decided.append(len(bound) + failed)
                bound_per_cycle.append(bound)
                paths.append(path)
                degraded_cycles += 1 if degraded else 0
    finally:
        if plan is not None:
            F.clear()
    recoveries.extend(rz.recoveries)
    if rz.degraded:
        # never recovered within the run: charge the open window through
        # one past the end, so the recovery bound fails honestly
        recoveries.append((rz.degraded_at, rz.cycle + 1))
    return {
        "times": times, "decided": decided, "bound": bound_per_cycle,
        "paths": paths, "cluster": cluster, "engine": engine,
        "resilience": rz, "degraded_cycles": degraded_cycles,
        "crashes": crashes,
        "rebases": rebases_acc + engine.rebases - rebases0,
        "divergences": divergences_acc + engine.antientropy_divergences,
        "abandoned": abandoned_acc + rz.watchdog.abandoned,
        "recoveries": recoveries,
    }


def chaos_gates(chaos: dict, control: dict, plan) -> dict:
    """`bench.py` `chaos_churn`'s line arithmetic over a chaos arm and its
    control: bit-identical cycles, cumulative placements, capacity
    violations, recovery windows, degraded share, crashes, rebases and
    divergences, and the decision latency percentiles. The watchdog
    overhead pairs are the bench's own timing study, not a gate here."""
    cycles_match = sum(
        1 for a, b in zip(chaos["bound"], control["bound"]) if a == b
    )
    n_cycles = len(chaos["times"])
    cumulative_chaos: dict = {}
    cumulative_control: dict = {}
    for b in chaos["bound"]:
        cumulative_chaos.update(b)
    for b in control["bound"]:
        cumulative_control.update(b)
    recovery_cycles = [b - a for a, b in chaos["recoveries"]]
    # delta faults recover within the one-cycle anti-entropy window by
    # construction; solve faults measure their own windows by probation
    recovery_max = max(
        recovery_cycles + ([1] if chaos["divergences"] else [0])
    )
    lat = np.repeat(chaos["times"], chaos["decided"])
    return {
        "cycles": n_cycles,
        "faults_injected": len(plan.log),
        "faults_unfired": len(plan.unfired()),
        "fault_log": [list(entry) for entry in plan.log],
        "cycles_bit_identical": cycles_match,
        "all_cycles_bit_identical": cycles_match == n_cycles,
        "cumulative_placements_match": (
            cumulative_chaos == cumulative_control
        ),
        "capacity_violations": capacity_violations(chaos["cluster"]),
        "recovery_cycles": recovery_cycles,
        "recovery_cycles_max": recovery_max,
        "degraded_cycles": chaos["degraded_cycles"],
        "degraded_fraction": chaos["degraded_cycles"] / n_cycles,
        "crashes": chaos["crashes"],
        "rebases": chaos["rebases"],
        "antientropy_divergences": chaos["divergences"],
        "decision_latency_p50_ms": (
            float(np.percentile(lat, 50)) * 1000 if lat.size else 0.0),
        "decision_latency_p99_ms": (
            float(np.percentile(lat, 99)) * 1000 if lat.size else 0.0),
        "decisions": int(sum(chaos["decided"])),
    }
