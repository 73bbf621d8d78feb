"""Bench config 14, the drifting mix (`bench.py` `tuned_drifting_mix`,
`bench.py:3380-4000`): a trimaran pair (TargetLoadPacking 1 :
LoadVariationRiskBalancing 20) serving a sustained churn whose mix drifts
mid-run, driven once with the static profile and once with the online
tuner (the flight-recorder ring and a `ShadowTuner` through
`run_cycle(tuner=)`), plus the shadow lane's per-tick overhead pairs and
the chaos gate's tuner-fault check (`bench.py:1779`). Shared by
`tests/test_torch_shadow_tuner.py` (the port against the JAX package)
and `chip_smoke.py` (the card against the CPU).

Every function takes either package's names in a namespace `pkg`:
`pkg.objects` (Node, Pod, Container), `pkg.Cluster`, `pkg.plugins`,
`pkg.Profile`, `pkg.Scheduler`, `pkg.ShadowTuner` (the port's with its
device bound), `pkg.run(scheduler, cluster, now, tuner)` (one
`run_cycle`), `pkg.flightrec` (its `recorder`), `pkg.faults` and
`pkg.SENSE`. It imports neither package.

- `TUNE_LIVE_SHAPE` is config 14's full shape, `TUNE_LIVE_SMOKE_SHAPE`
  the bench's reduced gate, `CHAOS_TUNE_SHAPE` the chaos check's;
- `_drift_cluster`, `_drift_script`, `_drift_metrics`, `_drift_profile`,
  `_drift_apply_events` build and drive the workload, one event script
  from the rng alone, so every arm replays the same stream;
- `run_drift_arm` is one arm, `tune_overhead_pct` the interleaved
  lane-off / lane-on pairs, `drift_line` the bench line's fields from a
  static and a tuned arm, `tune_live_checks` the `tune_live_smoke` gate
  (`bench.py:3963-4000`) but its compile count, which the port replaces
  with the sweep step's K-independent work calls (`chip_smoke.py`);
- `tuner_chaos_check` the tuner faults against a no-tuner control.
"""

from __future__ import annotations

import time

import numpy as np

from torch_churn_cases import capacity_violations

GIB = 1 << 30

#: config 14's headline shape (`bench.py:3396`): 96 nodes, 24 arrivals
#: and 10 departures a cycle, 8 + 8 + 14 + 12 + 4 cycles, K = 16
#: candidates, a corpus of 3, a sweep every 2 cycles
TUNE_LIVE_SHAPE = dict(
    n_nodes=96, hot_frac=0.25, hot_util=0.62, cold_util=0.15,
    arrivals=24, departs=10,
    warmup=8, cycles_a=8, cycles_b=14, regression_cycles=12,
    settle_cycles=4,
    candidates=16, corpus=3, sweep_every=2, confirm_sweeps=2,
    probation_cycles=8, baseline_window=8, baseline_min=2,
    baseline_recent=3, hysteresis=0.002, regress_cycles=2, cooldown=16,
    tolerance=0.01,
    deadline_s=60.0, inject=(1, 64),
)
#: the bench's reduced gate (`bench.py:3408`)
TUNE_LIVE_SMOKE_SHAPE = dict(
    n_nodes=48, hot_frac=0.25, hot_util=0.62, cold_util=0.15,
    arrivals=16, departs=6,
    warmup=8, cycles_a=6, cycles_b=12, regression_cycles=12,
    settle_cycles=4,
    candidates=12, corpus=3, sweep_every=2, confirm_sweeps=2,
    probation_cycles=8, baseline_window=8, baseline_min=2,
    baseline_recent=3, hysteresis=0.002, regress_cycles=2, cooldown=16,
    tolerance=0.01,
    deadline_s=60.0, inject=(1, 64),
)
#: the chaos gate's tuner-fault shape (`bench.py:1795`): 32 nodes, 8
#: arrivals and 3 departures a cycle, 2 + 2 + 12 cycles, K = 8
CHAOS_TUNE_SHAPE = dict(
    TUNE_LIVE_SMOKE_SHAPE, n_nodes=32, arrivals=8, departs=3,
    warmup=2, cycles_a=2, cycles_b=12, regression_cycles=0,
    settle_cycles=0, candidates=8, corpus=2, sweep_every=2,
    confirm_sweeps=1,
)
#: interleaved lane-off / lane-on pairs of the overhead bound
TUNE_OVERHEAD_PAIRS = 9
#: the probation objectives (`tuning.shadow.PROBATION_OBJECTIVES`)
TUNE_OBJECTIVES = (
    "fragmentation", "util_imbalance", "gang_wait_frac", "unplaced_frac",
)


def _drift_cluster(pkg, shape, seed=0):
    """Hot/cold fleet with an imbalanced, already-bound base load: the
    first `hot_frac` of the nodes prefilled to `hot_util` of their cpu,
    the rest to `cold_util`."""
    o = pkg.objects
    cluster = pkg.Cluster()
    n = shape["n_nodes"]
    hot = max(1, int(n * shape["hot_frac"]))
    serial = 0
    for i in range(n):
        cluster.add_node(o.Node(
            name=f"node-{i:05d}",
            allocatable={"cpu": 64_000, "memory": 256 * GIB, "pods": 512},
        ))
        target = shape["hot_util"] if i < hot else shape["cold_util"]
        filled = 0
        while filled < int(64_000 * target):
            serial += 1
            pod = o.Pod(
                name=f"base-{serial:06d}", creation_ms=serial,
                containers=[o.Container(requests={
                    "cpu": 2000, "memory": 4 * GIB})],
            )
            pod.node_name = f"node-{i:05d}"
            cluster.add_pod(pod)
            filled += 2000
    return cluster


def _drift_script(shape, seed=0):
    """(script, drift_at): the per-cycle events (phase, arrivals [(name,
    cpu, mem)], departures [names]) from the rng stream alone, so every
    arm replays the same workload. Departures draw only from pods that
    arrived in EARLIER cycles."""
    rng = np.random.default_rng(seed + 1)
    total = (shape["warmup"] + shape["cycles_a"] + shape["cycles_b"]
             + shape["regression_cycles"] + shape["settle_cycles"])
    drift_at = shape["warmup"] + shape["cycles_a"]
    serial = 0
    live: list = []
    script = []
    for c in range(total):
        phase = "a" if c < drift_at else "b"
        departs = []
        k = min(shape["departs"], len(live))
        if k > 0:
            picks = sorted(
                int(x) for x in rng.choice(len(live), size=k, replace=False)
            )
            departs = [live[i] for i in picks]
            live = [nm for i, nm in enumerate(live) if i not in set(picks)]
        arrivals = []
        for _ in range(shape["arrivals"]):
            serial += 1
            if phase == "a":
                cpu = int(rng.integers(800, 1600))
                mem = int(rng.integers(GIB, 2 * GIB))
            elif rng.random() < 0.5:
                # bimodal post-drift mix: sidecar dust and fat batch pods
                cpu, mem = 600, GIB // 2
            else:
                cpu, mem = 4200, 3 * GIB
            name = f"arr-{serial:06d}"
            arrivals.append((name, cpu, mem))
            live.append(name)
        script.append((phase, arrivals, departs))
    return script, drift_at


def _drift_metrics(pkg, cluster, shape, phase) -> None:
    """One cycle's `cluster.node_metrics`: cpu / memory averages mirror
    each node's requested utilization, while the variance drifts with the
    phase (in phase "b" the cold class turns metric-noisy, which steers
    LVRB away from the nodes that balance the fleet)."""
    n = len(cluster.nodes)
    hot = max(1, int(n * shape["hot_frac"]))
    used_cpu: dict = {}
    used_mem: dict = {}
    for pod in cluster.pods.values():
        if pod.node_name is None:
            continue
        req = pod.effective_request()
        used_cpu[pod.node_name] = (used_cpu.get(pod.node_name, 0)
                                   + req.get("cpu", 0))
        used_mem[pod.node_name] = (used_mem.get(pod.node_name, 0)
                                   + req.get("memory", 0))
    metrics = {}
    for i, (name, node) in enumerate(cluster.nodes.items()):
        cpu_pct = 100.0 * used_cpu.get(name, 0) / max(
            node.allocatable.get("cpu", 1), 1)
        mem_pct = 100.0 * used_mem.get(name, 0) / max(
            node.allocatable.get("memory", 1), 1)
        noisy = phase == "b" and i >= hot
        metrics[name] = {
            "cpu_avg": min(cpu_pct, 100.0),
            "cpu_std": 60.0 if noisy else 3.0,
            "mem_avg": min(mem_pct, 100.0),
            "mem_std": 8.0 if noisy else 2.0,
        }
    cluster.node_metrics = metrics


def _drift_profile(pkg):
    """The static serving profile: TargetLoadPacking 1 :
    LoadVariationRiskBalancing 20."""
    tlp = pkg.plugins.TargetLoadPacking()
    lvrb = pkg.plugins.LoadVariationRiskBalancing()
    lvrb.weight = 20
    return pkg.Scheduler(pkg.Profile(plugins=[tlp, lvrb]))


def _drift_apply_events(pkg, cluster, arrivals, departs, now) -> None:
    o = pkg.objects
    for name in departs:
        uid = f"default/{name}"
        if uid in cluster.pods:
            cluster.remove_pod(uid)
    for name, cpu, mem in arrivals:
        cluster.add_pod(o.Pod(
            name=name, creation_ms=now,
            containers=[o.Container(requests={"cpu": cpu, "memory": mem})],
        ))


def _sense_quality_win(pkg, tuned_rows, static_rows) -> float:
    """Sense-adjusted quality delta, positive = tuned better: the sum over
    the probation objectives of SENSE * (mean tuned - mean static)."""
    if not tuned_rows or not static_rows:
        return 0.0
    win = 0.0
    for name in TUNE_OBJECTIVES:
        t = [q[name] for q in tuned_rows if name in q]
        s = [q[name] for q in static_rows if name in q]
        if t and s:
            win += pkg.SENSE[name] * (float(np.mean(t)) - float(np.mean(s)))
    return win


class _TimedSeams:
    """The tuner as `run_cycle(tuner=)` sees it, with the wall time of
    `begin_cycle` (a synchronous sweep runs there) and of `observe_report`
    (the probation probe) summed apart from the cycle's, as the bench
    times them outside its cycle, and a hook after `begin_cycle` (the arm
    reads promotions at the boundary)."""

    def __init__(self, tuner, after_begin):
        self.tuner = tuner
        self.after_begin = after_begin
        self.begin_s = 0.0
        self.observe_s = 0.0

    def begin_cycle(self, now_ms=0):
        t0 = time.perf_counter()
        self.tuner.begin_cycle(now_ms=now_ms)
        self.begin_s += time.perf_counter() - t0
        self.after_begin()

    def observe_report(self, report):
        t0 = time.perf_counter()
        self.tuner.observe_report(report)
        self.observe_s += time.perf_counter() - t0


def run_drift_arm(pkg, shape, seed=0, tuned=False) -> dict:
    """One drifting-mix run (`bench.py` `_run_drift_arm`). `tuned=False`
    is the static control; `tuned=True` arms the flight recorder and a
    synchronous `ShadowTuner` through `run_cycle(tuner=)` (the wall time
    of its sweeps and probation probes summed apart from the cycle times)
    and drives the
    injected-regression phase. Returns per-cycle times, decisions,
    quality, bound placements, failed pods and weights, and the tuner's
    ledger."""
    script, drift_at = _drift_script(shape, seed)
    b_end = drift_at + shape["cycles_b"]
    inject_at = b_end
    cluster = _drift_cluster(pkg, shape, seed)
    scheduler = _drift_profile(pkg)
    out = {
        "times": [], "decided": [], "quality": [], "bound": [],
        "failed": [], "violations": 0, "promotions": [], "sweep_wall_s": 0.0,
        "probe_wall_s": 0.0,
        "weights_by_cycle": [], "rollback": None, "regress_seen_at": None,
        "injected_at": None,
    }
    tuner = seams = None
    if tuned:
        pkg.flightrec.recorder.start(capacity=shape["corpus"] + 2)
        tuner = pkg.ShadowTuner(
            scheduler, candidates=shape["candidates"],
            corpus_cycles=shape["corpus"], sweep_every=shape["sweep_every"],
            confirm_sweeps=shape["confirm_sweeps"],
            tolerance=shape["tolerance"],
            probation_cycles=shape["probation_cycles"],
            baseline_window=shape["baseline_window"],
            baseline_min=shape["baseline_min"],
            baseline_recent=shape["baseline_recent"],
            hysteresis=shape["hysteresis"],
            regress_cycles=shape["regress_cycles"],
            cooldown_cycles=shape["cooldown"],
            deadline_s=shape["deadline_s"], sync=True, seed=seed,
        )
        cycle = [0]

        def after_begin():
            st = tuner.status()
            if st["promotions"] > len(out["promotions"]):
                out["promotions"].append({
                    "cycle": cycle[0], "weights": st["active_weights"],
                    # the injected promotion may apply a cycle or two
                    # after staging: identify it by its weights
                    "injected": (out["injected_at"] is not None
                                 and st["active_weights"]
                                 == list(shape["inject"])),
                })

        seams = _TimedSeams(tuner, after_begin)
    try:
        for c, (phase, arrivals, departs) in enumerate(script):
            now = 1000 * (c + 1)
            _drift_apply_events(pkg, cluster, arrivals, departs, now)
            _drift_metrics(pkg, cluster, shape, phase)
            if tuner is not None:
                cycle[0] = c
                st = tuner.status()
                if (
                    out["injected_at"] is None and c >= inject_at
                    and st["state"] == "idle"
                    and st["promotions"] > st["rollbacks"]
                    and st["active_weights"] == st["last_known_good"]
                ):
                    # armed only once the real promotion is confirmed:
                    # stage a known-bad vector past the gates; probation
                    # must catch it and roll back to the confirmed weights
                    tuner.inject_promotion(shape["inject"])
                    out["injected_at"] = c
                    out["rollbacks_pre_inject"] = st["rollbacks"]
            hooks0 = (seams.begin_s, seams.observe_s) if seams else (0, 0)
            start = time.perf_counter()
            report = pkg.run(scheduler, cluster, now, seams)
            elapsed = time.perf_counter() - start
            if seams is not None:
                sweep_s = seams.begin_s - hooks0[0]
                out["sweep_wall_s"] += sweep_s
                out["probe_wall_s"] += seams.observe_s - hooks0[1]
                elapsed -= sweep_s + seams.observe_s - hooks0[1]
                st = tuner.status()
                if (
                    out["injected_at"] is not None
                    and c >= out["injected_at"]
                    and st["state"] == "probation"
                    and st["baseline"] and report.quality is not None
                    and out["regress_seen_at"] is None
                ):
                    # the first cycle the injected regression is
                    # DETECTABLE: any objective past the hysteresis band
                    for name in TUNE_OBJECTIVES:
                        if name not in st["baseline"]:
                            continue
                        delta = pkg.SENSE[name] * (
                            report.quality[name] - st["baseline"][name])
                        if delta < -shape["hysteresis"]:
                            out["regress_seen_at"] = c
                            break
                if (
                    out["rollback"] is None
                    and out["injected_at"] is not None
                    and st["rollbacks"] > out.get("rollbacks_pre_inject", 0)
                ):
                    out["rollback"] = {
                        "cycle": c,
                        "reason": st["last_rollback_reason"],
                        "restored_weights": st["active_weights"],
                    }
            out["weights_by_cycle"].append(
                [int(p.weight) for p in scheduler.profile.plugins])
            out["times"].append(elapsed)
            out["decided"].append(len(report.bound) + len(report.failed))
            out["quality"].append(dict(report.quality or {}))
            out["bound"].append(dict(report.bound))
            out["failed"].append(sorted(report.failed))
            out["violations"] += capacity_violations(cluster)
    finally:
        if tuned:
            pkg.flightrec.recorder.stop()
    out["tuner"] = tuner.status() if tuner is not None else None
    out["drift_at"] = drift_at
    out["b_end"] = b_end
    out["inject_at"] = inject_at
    return out


def tune_overhead_pct(pkg, shape, seed=77):
    """The shadow lane's per-tick overhead, paired (`bench.py`
    `_tune_overhead_pct`): two drift clusters evolving alike and ONE
    scheduler, one cycle each a pair (lane off, then lane on = the
    recorder's capture and the observe-only tuner's hooks with its sweep
    worker in the background). Two passes over the same script, the first
    untimed; the timed pass dispatches no new sweep. Returns
    (overhead_pct, jitter_floor_pct, placements_match, overlap): the
    median of the paired deltas, the off series' p10-p90 spread, whether
    the observe-only lane left every placement as the lane-off arm's, and
    the untimed pass's pairs split by whether a background sweep was
    still running when the lane-on cycle ended ({"busy_pairs",
    "busy_pct", "idle_pct"}, medians; None where a side is empty): how
    far the worker's sweeps, on the cycle's own device, slow a cycle."""
    script, _ = _drift_script(shape, seed)
    script = script[:shape["warmup"] + TUNE_OVERHEAD_PAIRS]
    scheduler = _drift_profile(pkg)
    rec = pkg.flightrec.recorder
    off, pair_pct = [], []
    busy, idle = [], []
    placements_match = True
    for timed in (False, True):
        arms = {name: _drift_cluster(pkg, shape, seed)
                for name in ("off", "on")}
        rec.start(capacity=shape["corpus"] + 2)
        rec.stop()  # armed for each lane-on cycle by resume()
        tuner = pkg.ShadowTuner(
            scheduler, candidates=shape["candidates"],
            corpus_cycles=shape["corpus"], sweep_every=shape["sweep_every"],
            deadline_s=shape["deadline_s"], observe_only=True, sync=False,
            seed=seed,
        )
        for c, (phase, arrivals, departs) in enumerate(script):
            now = 1000 * (c + 1)
            if timed and c == shape["warmup"]:
                # the timed pairs bound the always-on cost: no NEW sweep
                # mid-measurement, and the one in flight drains first
                tuner.sweep_every = 10 ** 9
                tuner.quiesce(shape["deadline_s"])
            times, bound = {}, {}
            for name in ("off", "on"):
                cluster = arms[name]
                _drift_apply_events(pkg, cluster, arrivals, departs, now)
                _drift_metrics(pkg, cluster, shape, phase)
                if name == "on":
                    rec.resume()
                start = time.perf_counter()
                report = pkg.run(scheduler, cluster, now,
                                 tuner if name == "on" else None)
                times[name] = time.perf_counter() - start
                rec.stop()
                bound[name] = dict(report.bound)
                job = tuner._inflight
                running = job is not None and not job["done"].is_set()
            if bound["off"] != bound["on"]:
                placements_match = False
            pct = 100.0 * (times["on"] - times["off"]) / times["off"]
            if timed and c >= shape["warmup"]:
                off.append(times["off"])
                pair_pct.append(pct)
            elif not timed:
                (busy if running else idle).append(pct)
        tuner.quiesce(shape["deadline_s"])
    rec.stop()
    off_sorted = sorted(off)
    median_off = off_sorted[len(off) // 2]
    overhead_pct = sorted(pair_pct)[len(pair_pct) // 2]
    spread_pct = 100.0 * (
        off_sorted[int(0.9 * (len(off) - 1))]
        - off_sorted[int(0.1 * (len(off) - 1))]
    ) / median_off

    def median(xs):
        return sorted(xs)[len(xs) // 2] if xs else None

    overlap = {"busy_pairs": len(busy), "busy_pct": median(busy),
               "idle_pct": median(idle)}
    return overhead_pct, spread_pct, placements_match, overlap


def drift_line(pkg, shape, static, tuned) -> dict:
    """The bench line's fields from a static and a tuned arm
    (`bench.py` `tuned_drifting_mix`), the overhead pairs left out."""
    drift_at, b_end = tuned["drift_at"], tuned["b_end"]
    t_idx = list(range(shape["warmup"], b_end))
    real_promos = [p for p in tuned["promotions"] if not p["injected"]]
    promo_cycle = real_promos[0]["cycle"] if real_promos else None
    post_idx = (
        list(range(max(promo_cycle, drift_at), b_end))
        if promo_cycle is not None and promo_cycle < b_end
        else list(range(drift_at, b_end))
    )
    win_post = _sense_quality_win(
        pkg, [tuned["quality"][i] for i in post_idx],
        [static["quality"][i] for i in post_idx])
    win_overall = _sense_quality_win(
        pkg, [tuned["quality"][i] for i in t_idx],
        [static["quality"][i] for i in t_idx])
    rollback = tuned["rollback"]
    final = tuned["tuner"]
    # no flapping: after the rollback the controller holds the
    # last-known-good weights (no further promotion)
    flapped = bool(rollback is not None and (
        any(p["cycle"] > rollback["cycle"] for p in tuned["promotions"])
        or final["active_weights"] != final["last_known_good"]))
    serve_s = sum(tuned["times"][i] for i in t_idx)
    static_s = sum(static["times"][i] for i in t_idx)
    decided = sum(tuned["decided"][i] for i in t_idx)
    return {
        "cycles": len(t_idx),
        "drift_at_cycle": drift_at,
        "promotions": len(real_promos),
        "promotion_cycle": promo_cycle,
        "promoted_weights": real_promos[0]["weights"] if real_promos
        else None,
        "static_weights": static["weights_by_cycle"][0],
        "quality_win_post_promotion": win_post,
        "quality_win_overall": win_overall,
        "capacity_violations": tuned["violations"] + static["violations"],
        "sweeps": final["sweeps"],
        "sweep_failures": final["sweep_failures"],
        "shadow_sweep_wall_s": tuned["sweep_wall_s"],
        "probation_probe_wall_s": tuned["probe_wall_s"],
        "injected_weights": list(shape["inject"]),
        "injected_at_cycle": tuned["injected_at"],
        "regression_detected_cycle": tuned["regress_seen_at"],
        "rollback": rollback,
        "rollback_detect_cycles": (final["last_rollback_detect_cycles"]
                                   if rollback is not None else None),
        "rollbacks_total": final["rollbacks"],
        "flapped": flapped,
        "tuner_state_final": final["state"],
        "decisions": decided,
        "tuned_cycles_per_s": len(t_idx) / serve_s if serve_s else 0.0,
        "static_cycles_per_s": len(t_idx) / static_s if static_s else 0.0,
    }


def tune_live_checks(line, bound_pct=5.0, rollback_bound=2) -> dict:
    """`tune_live_smoke`'s checks (`bench.py:3963-4000`) on a line with
    the overhead pairs' fields, but the compile count: the port compiles
    no sweep program, and `chip_smoke.py` checks instead that a sweep
    step's work calls are equal at K = 1 and K = 16."""
    overhead_bound = max(bound_pct, line["overhead_jitter_floor_pct"])
    return {
        "promoted": line["promotions"] >= 1,
        "tuned_beats_static": line["quality_win_post_promotion"] > 0,
        "tuned_not_worse_overall": line["quality_win_overall"] >= -0.002,
        "zero_violations": line["capacity_violations"] == 0,
        "overhead_bounded": line["overhead_pct"] <= overhead_bound,
        "observe_lane_placements_identical":
            line["observe_only_placements_match"],
        "no_sweep_failures": line["sweep_failures"] == 0,
        "rollback_observed": line["rollback"] is not None,
        "rollback_within_bound": (
            line["rollback_detect_cycles"] is not None
            and line["rollback_detect_cycles"] <= rollback_bound
        ),
        "no_flapping": not line["flapped"],
    }


def tuner_chaos_check(pkg, seed=5, shape=CHAOS_TUNE_SHAPE,
                      hang_seconds=5.0, hang_deadline_s=2.0) -> dict:
    """The chaos gate's tuner-fault phase (`bench.py` `_tuner_chaos_check`):
    the drifting mix twice, a no-tuner control and a shadow tuner under
    injected `tune.sweep` faults (garbage output from cycle 5, a hang
    from cycle 9 once the deadline is lowered to `hang_deadline_s`) and a
    `tune.promote` crash on EVERY application attempt. Every injected
    fault must leave the live placements equal to the control's, and the
    tuner must keep sweeping or disable itself. Returns the check's line
    with "ok"."""
    F = pkg.faults
    script, _ = _drift_script(shape, seed)
    total = len(script)

    def run_arm(with_tuner):
        cluster = _drift_cluster(pkg, shape, seed)
        scheduler = _drift_profile(pkg)
        tuner = plan = None
        if with_tuner:
            pkg.flightrec.recorder.start(capacity=shape["corpus"] + 2)
            tuner = pkg.ShadowTuner(
                scheduler, candidates=shape["candidates"],
                corpus_cycles=shape["corpus"],
                sweep_every=shape["sweep_every"],
                confirm_sweeps=shape["confirm_sweeps"],
                tolerance=shape["tolerance"], sync=True, seed=seed,
            )
            plan = F.FaultPlan(seed=seed)
            plan.specs = [
                F.FaultSpec(site=F.TUNE_SWEEP, cycle=5, kind="garbage",
                            sticky=True),
                F.FaultSpec(site=F.TUNE_SWEEP, cycle=9, kind="hang",
                            seconds=hang_seconds, sticky=True),
            ] + [
                F.FaultSpec(site=F.TUNE_PROMOTE, cycle=cc, kind="crash")
                for cc in range(total)
            ]
            F.install(plan)
        bound = []
        try:
            for c, (phase, arrivals, departs) in enumerate(script):
                now = 1000 * (c + 1)
                _drift_apply_events(pkg, cluster, arrivals, departs, now)
                _drift_metrics(pkg, cluster, shape, phase)
                if plan is not None:
                    plan.begin_cycle(c)
                if tuner is not None and c == 9:
                    # the sweep is warm by now: a hang must trip the
                    # deadline
                    tuner.deadline_s = hang_deadline_s
                bound.append(dict(
                    pkg.run(scheduler, cluster, now, tuner).bound))
        finally:
            if with_tuner:
                F.clear()
                pkg.flightrec.recorder.stop()
        if with_tuner:
            # let the abandoned hang worker (its sleep and one sweep)
            # drain before anything else runs
            time.sleep(hang_seconds + 1.0)
        return bound, tuner, plan

    control, _t, _p = run_arm(False)
    chaos, tuner, plan = run_arm(True)
    st = tuner.status()
    cycles_match = sum(1 for a, b in zip(chaos, control) if a == b)
    line = {
        "cycles": total,
        "cycles_bit_identical": cycles_match,
        "all_cycles_bit_identical": cycles_match == total,
        "fault_log": [list(entry) for entry in plan.log],
        "sweep_hang_fired": any(e[1] == F.TUNE_SWEEP and e[2] == "hang"
                                for e in plan.log),
        "sweep_garbage_fired": any(
            e[1] == F.TUNE_SWEEP and e[2] == "garbage" for e in plan.log),
        "promote_crashes": sum(1 for e in plan.log
                               if e[1] == F.TUNE_PROMOTE),
        "promotions": st["promotions"],
        "sweeps": st["sweeps"],
        "sweep_failures": st["sweep_failures"],
        "tuner_state": st["state"],
        # the static profile weights (TLP 1 / LVRB 20) still rule
        "weights_unchanged": (st["active_weights"] == [1, 20]
                              and st["last_known_good"] == [1, 20]),
    }
    line["ok"] = bool(
        line["all_cycles_bit_identical"]
        and line["sweep_hang_fired"]
        and line["sweep_garbage_fired"]
        and line["promote_crashes"] >= 1
        and line["promotions"] == 0
        and line["weights_unchanged"]
        and line["tuner_state"] in ("idle", "cooldown", "disabled")
        and line["sweep_failures"] >= 1
    )
    return line
