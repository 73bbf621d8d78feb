"""The sustained-churn loop of bench config 7 (`bench.py:1200-1330`, the
serving headline) and the flagship profile's thirty-cycle churn
(`tests/test_churn.py`), shared by `tests/test_torch_churn.py`,
`tests/test_torch_serving.py` (the port against JAX) and `chip_smoke.py`
(the card against the CPU).

Every function takes either package's names in a namespace (`pkg.objects`,
`pkg.Cluster`, and for the flagship script `pkg.Profile`,
`pkg.Scheduler`, `pkg.plugins`) and imports neither package itself. A
cycle runs through the caller's `run(scheduler, cluster, now, engine)`,
so one loop serves `run_cycle` of either package, on either device,
with or without a serving engine.

- `churn_cluster` is config 7's cluster: identical nodes and a deep
  population of pods arriving bound; `churn_events` one cycle's Poisson
  arrivals and departures with a node added every `node_add_every`
  cycles and one drained and deleted every `node_remove_every`;
  `run_churn` drives `warmup + cycles` of them.
- `capacity_violations` and `churn_invariants` are host oracles.
- `flagship_churn` is `tests/test_churn.py`'s thirty cycles (gangs,
  quota, completions) and ten drain cycles, without its controller
  reconciles (the controllers come with their own slice).
"""

from __future__ import annotations

import time

import numpy as np

GIB = 1 << 30
#: config 7's profile (`bench.py` `serving_churn`)
CHURN_PROFILE = {"plugins": ["NodeResourcesAllocatable"]}

#: the serving headline shape (`bench.py` SERVING_SHAPE): 2,000 nodes,
#: 12,288 bound pods, Poisson arrivals 48 and departures 24 a cycle, a
#: node added every 16 cycles and one removed every 24
SERVING_SHAPE = dict(
    n_nodes=2000, prefill=12288, cycles=48, warmup=4,
    lam_arrive=48, lam_depart=24, node_add_every=16, node_remove_every=24,
)
#: `bench.py` CHURN_SMOKE_SHAPE: node counts below their padding bucket,
#: no node delete
CHURN_SMOKE_SHAPE = dict(
    n_nodes=240, prefill=2048, cycles=24, warmup=3,
    lam_arrive=16, lam_depart=8, node_add_every=9, node_remove_every=0,
)
#: the tests' cut: 64 nodes, 512 bound pods, 12 timed cycles, node adds
#: (one growing the padding bucket) and two node deletes (rebases)
CHURN_TEST_SHAPE = dict(
    n_nodes=62, prefill=512, cycles=12, warmup=2,
    lam_arrive=12, lam_depart=6, node_add_every=3, node_remove_every=7,
)


def _objects(pkg):
    return getattr(pkg, "objects", None) or pkg.o


def _node(o, name):
    return o.Node(name=name, allocatable={"cpu": 64_000, "memory": 256 * GIB,
                                          "pods": 256})


def churn_cluster(pkg, n_nodes: int, prefill: int, seed: int = 0):
    """A cluster of `n_nodes` identical nodes and `prefill` pods that
    arrive bound, round robin (`bench.py` `churn_cluster`)."""
    o = _objects(pkg)
    rng = np.random.default_rng(seed)
    cluster = pkg.Cluster()
    for i in range(n_nodes):
        cluster.add_node(_node(o, f"node-{i:05d}"))
    cpus = rng.integers(100, 2000, size=prefill)
    mems = rng.integers(256 << 20, 2 * GIB, size=prefill)
    for i in range(prefill):
        pod = o.Pod(
            name=f"bound-{i:06d}", creation_ms=i,
            containers=[o.Container(requests={
                "cpu": int(cpus[i]), "memory": int(mems[i])})],
        )
        pod.node_name = f"node-{i % n_nodes:05d}"
        cluster.add_pod(pod)
    return cluster


def churn_events(pkg, cluster, rng, shape: dict, cycle: int, now: int,
                 serial: int) -> int:
    """One cycle's churn on `cluster` (`bench.py` `_churn_events`);
    returns the new pod serial. Every draw depends only on the rng stream
    and the cluster's bound set, so runs with equal placements see the
    same events."""
    o = _objects(pkg)
    for _ in range(int(rng.poisson(shape["lam_arrive"]))):
        serial += 1
        cluster.add_pod(o.Pod(
            name=f"arr-{serial:06d}", creation_ms=now * 1000 + serial,
            containers=[o.Container(requests={
                "cpu": int(rng.integers(100, 2000)),
                "memory": int(rng.integers(256 << 20, 2 * GIB))})],
        ))
    n_dep = int(rng.poisson(shape["lam_depart"]))
    if n_dep:
        bound = sorted(
            uid for uid, p in cluster.pods.items()
            if p.node_name is not None and p.node_name in cluster.nodes
        )
        if bound:
            picks = rng.choice(len(bound), size=min(n_dep, len(bound)),
                               replace=False)
            for i in sorted(int(x) for x in picks):
                cluster.remove_pod(bound[i])
    every = shape.get("node_add_every")
    if every and cycle % every == every - 1:
        cluster.add_node(_node(o, f"node-x{cycle:04d}"))
    every = shape.get("node_remove_every")
    if every and cycle % every == every - 1 and len(cluster.nodes) > 1:
        # drain, then delete: the pods leave, then the node row goes
        victim = next(iter(cluster.nodes))
        for uid in [u for u, p in cluster.pods.items()
                    if p.node_name == victim]:
            cluster.remove_pod(uid)
        cluster.remove_node(victim)
    return serial


def run_churn(pkg, cluster, scheduler, shape: dict, run, seed: int = 0,
              engine=None) -> dict:
    """`shape['warmup'] + shape['cycles']` churn cycles through
    `run(scheduler, cluster, now, engine)` (`bench.py` `run_churn`).
    Returns the timed cycles' wall seconds and decisions, each cycle's
    (bound, failed) and the accumulated uid -> node placements."""
    rng = np.random.default_rng(seed + 1)
    serial = 0
    times, decided, reports = [], [], []
    placements = {}
    for cycle in range(shape["warmup"] + shape["cycles"]):
        now = 1000 * (cycle + 1)
        serial = churn_events(pkg, cluster, rng, shape, cycle, now, serial)
        start = time.perf_counter()
        report = run(scheduler, cluster, now, engine)
        elapsed = time.perf_counter() - start
        placements.update(report.bound)
        reports.append((dict(report.bound), list(report.failed)))
        if cycle >= shape["warmup"]:
            times.append(elapsed)
            decided.append(len(report.bound) + len(report.failed))
    return {"times": times, "decided": decided, "reports": reports,
            "placements": placements}


def capacity_violations(cluster) -> int:
    """Nodes over allocatable on any resource, the bound pods replayed
    against the nodes (`bench.py` `_churn_capacity_violations`)."""
    used: dict = {name: {} for name in cluster.nodes}
    for pod in cluster.pods.values():
        if pod.node_name is None or pod.node_name not in used:
            continue
        bucket = used[pod.node_name]
        for r, q in pod.effective_request().items():
            bucket[r] = bucket.get(r, 0) + q
        bucket["pods"] = bucket.get("pods", 0) + 1
    return sum(
        1 for name, node in cluster.nodes.items()
        for r, q in used[name].items() if q > node.allocatable.get(r, 0)
    )


def churn_invariants(cluster) -> list:
    """`tests/test_churn.py` `check_invariants` as a list of violations:
    nodes over capacity, namespaces over their quota Max, gangs bound
    partially (0 < bound < MinMember)."""
    bad = []
    if capacity_violations(cluster):
        bad.append("capacity")
    for eq in cluster.quotas.values():
        total: dict = {}
        for pod in cluster.pods.values():
            if pod.namespace == eq.namespace and pod.node_name is not None:
                for r, q in pod.effective_request().items():
                    total[r] = total.get(r, 0) + q
        bad += [f"quota {eq.namespace} {r}" for r, cap in eq.max.items()
                if total.get(r, 0) > cap]
    for pg in cluster.pod_groups.values():
        bound = sum(1 for p in cluster.gang_members(pg)
                    if p.node_name is not None)
        if 0 < bound < pg.min_member:
            bad.append(f"gang {pg.full_name} {bound}")
    return bad


def flagship_churn(pkg, run, serve=None) -> dict:
    """`tests/test_churn.py`'s thirty churn cycles and ten drain cycles on
    8 nodes with an ElasticQuota and the flagship profile
    (NodeResourcesAllocatable, Coscheduling with a 5 s permit wait,
    CapacityScheduling), without its controller reconciles. `serve(
    cluster)` gives the serving engine to attach, or None. Returns each
    cycle's report fields, the invariant violations, the pending plain
    pods left and the final uid -> node placements."""
    o = _objects(pkg)
    rng = np.random.default_rng(7)
    cluster = pkg.Cluster()
    engine = serve(cluster) if serve is not None else None
    for i in range(8):
        cluster.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 16_000, "memory": 64 * GIB, "pods": 30}))
    cluster.add_quota(o.ElasticQuota(
        name="eq", namespace="team",
        min={"cpu": 64_000, "memory": 256 * GIB},
        max={"cpu": 96_000, "memory": 384 * GIB},
    ))
    P = pkg.plugins
    sched = pkg.Scheduler(pkg.Profile(plugins=[
        P.NodeResourcesAllocatable(),
        P.Coscheduling(permit_waiting_seconds=5),
        P.CapacityScheduling(),
    ]))
    serial = 0
    reports, violations = [], []

    def cycle_at(now):
        report = run(sched, cluster, now, engine)
        reports.append((dict(report.bound), list(report.failed),
                        dict(report.reserved), list(report.rejected_gangs)))
        violations.extend(churn_invariants(cluster))

    for cycle in range(30):
        now = 1000 * (cycle + 1)
        for _ in range(int(rng.integers(0, 6))):
            serial += 1
            cluster.add_pod(o.Pod(
                name=f"p{serial:04d}", namespace="team", creation_ms=now,
                priority=int(rng.integers(0, 5)),
                containers=[o.Container(requests={
                    "cpu": int(rng.integers(200, 4000)),
                    "memory": int(rng.integers(1, 8)) * GIB})],
            ))
        if cycle % 5 == 1:
            gname = f"g{cycle}"
            cluster.add_pod_group(o.PodGroup(
                name=gname, namespace="team", min_member=3, creation_ms=now))
            for m in range(3):
                serial += 1
                cluster.add_pod(o.Pod(
                    name=f"{gname}-m{m}", namespace="team",
                    creation_ms=now + m,
                    labels={o.POD_GROUP_LABEL: gname},
                    containers=[o.Container(requests={
                        "cpu": 2000, "memory": 4 * GIB})],
                ))
        # plain pods complete; gangs stay whole
        bound = [p for p in cluster.pods.values()
                 if p.node_name is not None and not p.pod_group()]
        for pod in bound:
            if rng.random() < 0.15:
                cluster.remove_pod(pod.uid)
        cycle_at(now)
        for pod in cluster.pods.values():
            if (pod.node_name is not None
                    and pod.phase == o.PodPhase.PENDING):
                pod.phase = o.PodPhase.RUNNING
    for extra in range(10):
        running_plain = [p for p in cluster.pods.values()
                         if p.node_name is not None and not p.pod_group()]
        for pod in running_plain[: max(1, len(running_plain) // 2)]:
            cluster.remove_pod(pod.uid)
        cycle_at(40_000 + extra * 1000)
    return {
        "reports": reports, "violations": violations,
        "plain_left": [p.uid for p in cluster.pending_pods()
                       if not p.pod_group()],
        "placements": {uid: p.node_name for uid, p in cluster.pods.items()
                       if p.node_name is not None},
        "engine": engine,
    }
