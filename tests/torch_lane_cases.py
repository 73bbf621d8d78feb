"""Bench config 15, the K-lane bench (`bench.py` `lane_scaling`,
`bench.py:4010-4300`): zoned disjoint-tenant steady-state churn with an
adversarial contended tail, solved every cycle by the sequential parity
solve and by `LaneSolver` at several K, held digest to digest. Shared by
`tests/test_torch_lanes.py` (the port against the JAX package) and
`chip_smoke.py` (the card against the CPU).

Every function takes either package's names in a namespace and imports
neither package: `pkg.objects` or `pkg.o`, `pkg.Cluster`,
`pkg.Scheduler`, `pkg.Profile`, `pkg.plugins`, and

- `pkg.snapshot(cluster, pending, now, device)` -> (snap, meta) on that
  device (the JAX package ignores `device`);
- `pkg.serial(scheduler, snap, device)` -> host (assignment, admitted,
  wait) of `Scheduler.solve(mode="sequential")`;
- `pkg.LaneSolver(scheduler, k, partition, dispatch, device)`;
- for `lane_engine_run`: `pkg.Engine` and `pkg.StreamingEngine` (the two
  serving engines), `pkg.Laned(scheduler, cluster, engine)` (a
  `LanedCycle` with `async_bind`) and `pkg.run(scheduler, cluster, now,
  engine)` (one `run_cycle`).

`LANE_SHAPE` is config 15's full shape, `LANE_SMOKE_SHAPE` the bench's
reduced gate, `LANE_MICRO_SHAPE` `tests/test_lanes.py`
TestLaneBenchMicro's, `LANE_CARD_SHAPE` the card's depth cut of the full
width. `lane_scaling` returns the bench's line (its keys, plus `arms` and
per-cycle `digests`); `lane_engine_run` drives the same stream through the
laned or the serial cycle engine.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from torch_churn_cases import GIB, capacity_violations

#: config 15's headline shape (`bench.py:4020` LANE_SHAPE): 64 tenants
#: over 8 zone extended resources (R = 12 axes) on 64 deep nodes that
#: never fill, plus a contended tail where `hot_bidders` pods of distinct
#: tenants race `hot_slots` units of one node's scarce resource
LANE_SHAPE = dict(
    n_nodes=64, zones=8, tenants=64, prefill=12288,
    cycles=10, warmup=2, lam_arrive=12288, lam_depart=12288,
    contend_cycles=3, hot_slots=8, hot_bidders=16,
    ks=(1, 2, 4, 8), headline_k=4, reps=3,
)
#: the bench's reduced gate (`bench.py:4032` LANE_SMOKE_SHAPE)
LANE_SMOKE_SHAPE = dict(
    n_nodes=48, zones=8, tenants=64, prefill=2048,
    cycles=5, warmup=2, lam_arrive=6144, lam_depart=6144,
    contend_cycles=2, hot_slots=4, hot_bidders=8,
    ks=(1, 2, 4), headline_k=4, reps=3,
)
#: `tests/test_lanes.py` TestLaneBenchMicro's shape
LANE_MICRO_SHAPE = dict(
    n_nodes=8, zones=4, tenants=8, prefill=32,
    cycles=3, warmup=1, lam_arrive=64, lam_depart=64,
    contend_cycles=1, hot_slots=2, hot_bidders=4,
    ks=(1, 2), headline_k=2, reps=1,
)
#: the card's cut: LANE_SHAPE's full width (65 nodes, 64 tenants, 12
#: axes, 12,288 prefill, 12,288 arrivals and departures a cycle, 16 hot
#: bidders for 8 slots), its depth cut to 1 timed disjoint and 1
#: contended cycle with one rep (no warm-up cycle: the first cycle is
#: the timed one)
LANE_CARD_SHAPE = dict(LANE_SHAPE, cycles=2, warmup=0, contend_cycles=1,
                       ks=(4, 8), reps=1)


def _objects(pkg):
    return getattr(pkg, "objects", None) or pkg.o


def lane_scheduler(pkg):
    """Config 15's profile: NodeResourcesAllocatable alone."""
    return pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourcesAllocatable()]))


def lane_cluster(pkg, shape, seed=0):
    """`bench.py` `_lane_cluster`: the zoned multi-tenant cluster and one
    scarce "hot" node. Prefill pods arrive bound, each one's zone request
    matching its node's zone."""
    o = _objects(pkg)
    rng = np.random.default_rng(seed)
    cluster = pkg.Cluster()
    Z = shape["zones"]
    for i in range(shape["n_nodes"]):
        cluster.add_node(o.Node(
            name=f"node-{i:04d}",
            allocatable={"cpu": 256_000, "memory": 1024 * GIB,
                         "pods": 1024, f"example.com/zone-{i % Z}": 100_000},
        ))
    cluster.add_node(o.Node(
        name="node-hot",
        allocatable={"cpu": 64_000, "memory": 256 * GIB, "pods": 512,
                     "example.com/hot": shape["hot_slots"]},
    ))
    for i in range(shape["prefill"]):
        j = i % shape["n_nodes"]
        pod = o.Pod(
            name=f"bound-{i:06d}", creation_ms=i,
            namespace=f"tenant-{i % shape['tenants']:03d}",
            containers=[o.Container(requests={
                "cpu": int(rng.integers(100, 900)),
                "memory": int(rng.integers(256 << 20, 1 * GIB)),
                f"example.com/zone-{j % Z}": 1,
            })],
        )
        pod.node_name = f"node-{j:04d}"
        cluster.add_pod(pod)
    return cluster


class LaneStream:
    """`lane_scaling`'s event stream over one cluster: each `step(cycle)`
    applies the cycle's arrivals (in a contended cycle, first removing the
    hot population and racing `hot_bidders` hot pods) and departures, and
    returns (now, in_contention, timed)."""

    def __init__(self, pkg, shape, seed=0):
        self.o = _objects(pkg)
        self.shape = shape
        self.cluster = lane_cluster(pkg, shape, seed)
        self.cluster.enable_pending_index()
        self.rng = np.random.default_rng(1)
        self.serial_no = 0
        self.total = shape["warmup"] + shape["cycles"]
        self.contended_from = self.total - shape["contend_cycles"]

    def _arrive(self, n, hot=False):
        o, shape, rng = self.o, self.shape, self.rng
        T, Z = shape["tenants"], shape["zones"]
        for _ in range(n):
            self.serial_no += 1
            t = self.serial_no % T
            req = {"cpu": int(rng.integers(100, 900)),
                   "memory": int(rng.integers(256 << 20, 1 * GIB))}
            if hot:
                req["example.com/hot"] = 1
            else:
                req[f"example.com/zone-{t % Z}"] = 1
            self.cluster.add_pod(o.Pod(
                name=f"{'hot' if hot else 'arr'}-{self.serial_no:06d}",
                namespace=f"tenant-{t:03d}",
                creation_ms=1_000_000 + self.serial_no,
                containers=[o.Container(requests=req)],
            ))

    def step(self, cycle):
        shape, cluster = self.shape, self.cluster
        now = 1000 * (cycle + 1)
        in_contention = cycle >= self.contended_from
        if in_contention:
            # reset the hot population (bound AND last round's losers),
            # then race hot_bidders distinct-tenant pods for hot_slots
            for uid in [u for u, p in cluster.pods.items()
                        if p.name.startswith("hot-")]:
                cluster.remove_pod(uid)
            self._arrive(shape["lam_arrive"] - shape["hot_bidders"])
            self._arrive(shape["hot_bidders"], hot=True)
        else:
            self._arrive(shape["lam_arrive"])
        bound = sorted(
            u for u, p in cluster.pods.items()
            if p.node_name is not None and p.name.startswith(("bound", "arr"))
        )
        picks = self.rng.choice(
            len(bound), size=min(shape["lam_depart"], len(bound)),
            replace=False,
        )
        for i in sorted(int(x) for x in picks):
            cluster.remove_pod(bound[i])
        timed = cycle >= shape["warmup"] and not in_contention
        return now, in_contention, timed


def digest(assignment, admitted, wait, P) -> str:
    """The bench's per-cycle digest of the first P rows."""
    return hashlib.sha256(
        np.asarray(assignment)[:P].tobytes()
        + np.asarray(admitted)[:P].tobytes()
        + np.asarray(wait)[:P].tobytes()
    ).hexdigest()[:16]


def bench_arms(shape, device=None):
    """The bench's arms: the serial solve, then `LaneSolver` at every K of
    the shape in "sequential" dispatch, all on `device`, every cycle. An
    arm is (name, k, dispatch, device, only); k = 0 is the serial solve,
    and `only` is None (every cycle) or the kinds of cycle the arm runs
    on, among "warmup", "timed" and "contended"."""
    return ([("serial", 0, None, device, None)]
            + [(f"k{k}", k, "sequential", device, None)
               for k in shape["ks"]])


def lane_scaling(pkg, shape, arms=None, probe=None):
    """Config 15 (`bench.py` `lane_scaling`): the zoned churn through every
    arm on the same cluster state every cycle, gated on per-cycle digest
    identity (assignment + admitted + wait) to the FIRST arm, which must
    be a serial one that runs every cycle, and whose placements are
    committed through the store's bind.

    Throughput accounting is the bench's: `ratio` is the serial solve wall
    over the laned solve boundary, max(lane_ms) + fence_ms (solve_ms
    without per-lane times), `ratio_full` adds partition_ms, `ratio_wall`
    is wall over wall; the serial wall is that of the first serial arm on
    the lane arm's device. Only timed (disjoint-tenant, post-warm-up)
    cycles count, and each timed cycle takes the minimum over `reps`. An
    arm with `only` set runs on those kinds of cycle alone. `probe(scheds, views,
    pending, cluster, now)`, if given, runs once after the arms of the
    first timed cycle, before its commit, with the schedulers and
    (snapshot, meta) views keyed by device.
    Returns the bench's line plus `arms` (each arm's summed seconds and
    per-cycle records) and `digests` (the reference digest of every
    cycle)."""
    arms = list(arms or bench_arms(shape))
    ref = arms[0]
    if ref[1] != 0 or ref[4] is not None:
        raise ValueError("the first arm must be the serial solve, run "
                         "every cycle")
    stream = LaneStream(pkg, shape)
    cluster = stream.cluster
    scheds = {arm[3]: lane_scheduler(pkg) for arm in arms}
    solvers = {
        arm[0]: pkg.LaneSolver(scheds[arm[3]], arm[1], "namespace", arm[2],
                               arm[3])
        for arm in arms if arm[1]
    }
    # the ratio's serial arm on each device: the first one there
    serial_arm = {}
    for name, k, _, dev, _ in arms:
        if not k:
            serial_arm.setdefault(dev, name)
    serial_s = dict.fromkeys(serial_arm, 0.0)
    decided = 0
    timed_cycles = 0
    acc = {arm[0]: dict(boundary=0.0, full=0.0, wall=0.0, conflicts=0,
                        re_resolved=0, fallbacks=0, partition=0.0,
                        fence=0.0, max_lane=0.0)
           for arm in arms}
    records = {arm[0]: [] for arm in arms}
    contended = dict(cycles=0, conflicts=0, re_resolved=0)
    digests_ok = True
    mismatches = []
    digests = []

    for cycle in range(stream.total):
        now, in_contention, timed = stream.step(cycle)
        pending = cluster.pending_pods()
        P = len(pending)
        kind = ("contended" if in_contention
                else "timed" if timed else "warmup")
        runs = [arm for arm in arms if arm[4] is None or kind in arm[4]]
        views = {}
        for dev in {arm[3] for arm in runs}:
            snap, meta = pkg.snapshot(cluster, pending, now, dev)
            scheds[dev].prepare(meta, cluster)
            views[dev] = (snap, meta)
        reps = shape.get("reps", 1) if timed else 1
        if timed:
            timed_cycles += 1
            decided += P
        if in_contention:
            contended["cycles"] += 1
        ref_digest = None
        for name, k, dispatch, dev, _ in runs:
            snap, meta = views[dev]
            best = None
            for rep in range(reps):
                t0 = time.perf_counter()
                if k == 0:
                    a, ok, w = pkg.serial(scheds[dev], snap, dev)
                    st = None
                else:
                    a, ok, w, _, st = solvers[name].solve(
                        snap, pending, cluster, meta=meta)
                wall = time.perf_counter() - t0
                if st is None:
                    boundary = wall * 1000.0
                elif st.lane_ms:
                    boundary = max(st.lane_ms) + st.fence_ms
                else:
                    boundary = st.solve_ms
                if rep == 0:
                    d = digest(a, ok, w, P)
                    if ref_digest is None:
                        ref_digest = d
                        ref_out = (a, ok)
                        digests.append(d)
                    elif d != ref_digest:
                        digests_ok = False
                        mismatches.append({"cycle": cycle, "arm": name})
                    rec = {"cycle": cycle, "digest": d, "wall_s": wall}
                    if st is not None:
                        conflicts = sum(st.conflicts or [])
                        acc[name]["conflicts"] += conflicts
                        acc[name]["re_resolved"] += st.re_resolved
                        if k > 1 and st.path == "serial":
                            acc[name]["fallbacks"] += 1
                        if in_contention and k > 1:
                            contended["conflicts"] += conflicts
                            contended["re_resolved"] += st.re_resolved
                        partition0 = st.partition_ms
                        rec.update(st.as_dict())
                    records[name].append(rec)
                if best is None or boundary < best[0]:
                    best = (boundary, wall,
                            st.fence_ms if st is not None else 0.0,
                            max(st.lane_ms) if st is not None
                            and st.lane_ms else 0.0)
            if timed:
                boundary, wall, fence, max_lane = best
                if name == serial_arm.get(dev):
                    serial_s[dev] += wall
                if k:
                    a_k = acc[name]
                    a_k["boundary"] += boundary / 1000.0
                    a_k["full"] += (boundary + partition0) / 1000.0
                    a_k["wall"] += wall
                    a_k["partition"] += partition0
                    a_k["fence"] += fence
                    a_k["max_lane"] += max_lane
        if probe is not None and timed and timed_cycles == 1:
            probe(scheds, views, pending, cluster, now)
        # commit the reference arm's placements (identical at every arm by
        # the digest gate) through the store's bind
        a_ser, ok_ser = ref_out
        meta = views[ref[3]][1]
        for i, pod in enumerate(pending):
            if ok_ser[i] and a_ser[i] >= 0:
                cluster.bind(pod.uid, meta.node_names[int(a_ser[i])],
                             now_ms=now)

    for solver in solvers.values():
        solver.close()
    hk = shape["headline_k"]
    curve = []
    n = max(1, timed_cycles)
    for name, k, dispatch, dev, _ in arms:
        if not k:
            continue
        a_k = acc[name]
        ser = serial_s.get(dev, 0.0)
        curve.append({
            "k": k, "arm": name, "dispatch": dispatch,
            "ratio": round(ser / a_k["boundary"], 2)
            if a_k["boundary"] and ser else None,
            "ratio_full": round(ser / a_k["full"], 2)
            if a_k["full"] and ser else None,
            "ratio_wall": round(ser / a_k["wall"], 2)
            if a_k["wall"] and ser else None,
            "pods_per_sec": round(decided / a_k["boundary"], 1)
            if a_k["boundary"] else None,
            "conflicts": a_k["conflicts"],
            "re_resolved": a_k["re_resolved"],
            "serial_fallbacks": a_k["fallbacks"],
            "partition_ms_mean": round(a_k["partition"] / n, 3),
            "max_lane_ms_mean": round(a_k["max_lane"] / n, 3),
            "fence_ms_mean": round(a_k["fence"] / n, 3),
        })
    heads = [c for c in curve if c["k"] == hk]
    head = next((c for c in heads if c["dispatch"] == "sequential"),
                heads[0] if heads else {})
    head_dev = next((arm[3] for arm in arms if arm[0] == head.get("arm")),
                    ref[3])
    return {
        "lanes": {
            "ks": sorted({c["k"] for c in curve}), "headline_k": hk,
            "dispatch": head.get("dispatch"), "partition": "namespace",
            "timed_cycles": timed_cycles, "decisions": decided,
            "serial_ms_total": round(serial_s.get(head_dev, 0.0) * 1000,
                                     3),
            "curve": curve,
            "contended": dict(contended),
            "digest_mismatches": mismatches[:8],
        },
        "lane_ratio": head.get("ratio"),
        "lane_ratio_full": head.get("ratio_full"),
        "lane_ratio_wall": head.get("ratio_wall"),
        "digests_match": bool(digests_ok),
        "conflicts": contended["conflicts"],
        "re_resolved": contended["re_resolved"],
        "serial_fallbacks": sum(a["fallbacks"] for a in acc.values()),
        "capacity_violations": capacity_violations(cluster),
        "arms": {name: {"solve_s": sum(r["wall_s"] for r in recs),
                        "cycles": recs}
                 for name, recs in records.items()},
        "digests": digests,
    }


def lane_engine_run(pkg, shape, laned: bool):
    """The same stream through a cycle engine, every cycle's placements
    bound by the cycle itself: `pkg.Laned` (a `LanedCycle` on a
    `StreamingServeEngine`, fenced after each tick and closed at the end)
    or `pkg.run` (`run_cycle` on a `ServeEngine`). Returns (per-cycle
    (bound, reserved, failed, failed_by, lanes), the final store, each
    cycle's wall seconds)."""
    stream = LaneStream(pkg, shape)
    cluster = stream.cluster
    sched = lane_scheduler(pkg)
    engine = (pkg.StreamingEngine() if laned else pkg.Engine()).attach(
        cluster)
    lane_engine = pkg.Laned(sched, cluster, engine) if laned else None
    reports, walls = [], []
    for cycle in range(stream.total):
        now, _, _ = stream.step(cycle)
        t0 = time.perf_counter()
        if laned:
            report = lane_engine.tick(now)
            lane_engine.fence()
        else:
            report = pkg.run(sched, cluster, now, engine)
        walls.append(time.perf_counter() - t0)
        reports.append(report)
    if laned:
        lane_engine.close()
    per_cycle = [(dict(r.bound), dict(r.reserved), list(r.failed),
                  dict(r.failed_by), r.lanes) for r in reports]
    final = {u: p.node_name for u, p in sorted(cluster.pods.items())}
    return per_cycle, final, walls
