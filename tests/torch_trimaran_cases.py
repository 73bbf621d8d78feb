"""Seeded Trimaran problems shared by `tests/test_torch_trimaran.py`
(the port against JAX `Scheduler.solve`) and `chip_smoke.py` (the card
against the CPU).

`trimaran_case(name, objects, cluster_cls)` builds a case's cluster from
either package's `objects` module and `Cluster` class, and returns it
with the profile configuration each package loads with its own
`api.config.load_profile`; it imports neither package itself. Each
cluster has nodes of spread sizes, pods already bound (with limits above
their requests on some), and metrics that leave some nodes without any,
give some only a CPU std sample, some only memory, and one node no CPU at
all."""

from __future__ import annotations

GIB = 1 << 30

#: the cases, each profile run through `Scheduler.solve` by both packages
CASES = ("lroc", "peaks", "tlp_loaded")


def _metrics(rng, names):
    """Per-node metric dicts: every fifth node reports nothing, every
    seventh only a CPU std, every eleventh only memory; the rest report
    cpu and memory average and std."""
    out = {}
    for i, name in enumerate(names):
        if i % 5 == 4:
            continue
        if i % 7 == 6:
            out[name] = {"cpu_std": float(rng.uniform(0, 20))}
        elif i % 11 == 10:
            out[name] = {"mem_avg": float(rng.uniform(5, 80)),
                         "mem_std": float(rng.uniform(0, 10))}
        else:
            out[name] = {
                "cpu_avg": float(rng.uniform(2, 95)),
                "cpu_std": float(rng.uniform(0, 25)),
                "mem_avg": float(rng.uniform(2, 90)),
                "mem_std": float(rng.uniform(0, 15)),
            }
    return out


def _cluster(o, cluster_cls, rng, n_nodes, n_pods, limits: bool):
    cluster = cluster_cls()
    names = [f"node-{i:03d}" for i in range(n_nodes)]
    cpu = rng.integers(4, 33, n_nodes) * 1000
    mem = rng.integers(8, 65, n_nodes)
    for i, name in enumerate(names):
        cluster.add_node(o.Node(name=name, allocatable={
            # node 0 has no CPU at all: zero capacity on the curves
            "cpu": 0 if i == 0 else int(cpu[i]),
            "memory": int(mem[i]) * GIB, "pods": 40,
        }))
    # bound pods: node usage, and limits over requests (overcommit)
    for j in range(2 * n_nodes):
        req_cpu = int(rng.integers(100, 3000))
        req_mem = int(rng.integers(1, 4)) * GIB
        lim = ({"cpu": req_cpu * int(rng.integers(1, 4)),
                "memory": req_mem * int(rng.integers(1, 3))}
               if limits and j % 2 == 0 else {})
        cluster.add_pod(o.Pod(
            name=f"bound-{j:03d}",
            node_name=names[1 + int(rng.integers(0, n_nodes - 1))],
            containers=[o.Container(
                requests={"cpu": req_cpu, "memory": req_mem}, limits=lim)],
        ))
    cluster.node_metrics = _metrics(rng, names)
    for i in range(n_pods):
        kind = i % 6
        if kind == 5:
            # best effort: no request, no limit
            container = o.Container()
        else:
            req_cpu = int(rng.integers(100, 4000))
            req_mem = int(rng.integers(256, 6144)) << 20
            lim = {}
            if limits and kind in (1, 3):
                lim = {"cpu": req_cpu * int(rng.integers(2, 5)),
                       "memory": req_mem * 2}
            elif kind == 4:
                # a CPU limit only: the TLP prediction takes it
                lim = {"cpu": req_cpu + int(rng.integers(0, 2000))}
            container = o.Container(
                requests={"cpu": req_cpu, "memory": req_mem}, limits=lim)
        cluster.add_pod(o.Pod(name=f"pod-{i:04d}", creation_ms=i,
                              containers=[container]))
    return cluster


def trimaran_case(name: str, objects, cluster_cls, seed: int = 0):
    """(cluster, profile config) of the case `name` (see `CASES`):

    - `lroc`: LowRiskOverCommitment with a smoothing window of 3 and
      weights cpu 0.3 / memory 0.7, on pods whose limits exceed their
      requests, and best-effort pods it does not score;
    - `peaks`: Peaks with a power model for two nodes in three (the rest
      get K1 = K2 = 0);
    - `tlp_loaded`: TargetLoadPacking loaded with targetUtilization 60
      and defaultRequestsMultiplier "2", beside LoadVariationRiskBalancing
      with margin 2 and sensitivity 2, weights [2, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name == "lroc":
        cluster = _cluster(objects, cluster_cls, rng, 24, 48, limits=True)
        return cluster, {
            "plugins": ["LowRiskOverCommitment"],
            "pluginConfig": [{"name": "LowRiskOverCommitment", "args": {
                "smoothingWindowSize": 3,
                "riskLimitWeights": {"cpu": 0.3, "memory": 0.7}}}],
        }
    if name == "peaks":
        cluster = _cluster(objects, cluster_cls, rng, 24, 96, limits=False)
        model = {
            node: [float(rng.uniform(50, 150)), float(rng.uniform(0.5, 8)),
                   float(rng.uniform(0.005, 0.06))]
            for i, node in enumerate(cluster.nodes) if i % 3 != 2
        }
        return cluster, {
            "plugins": ["Peaks"],
            "pluginConfig": [{"name": "Peaks",
                              "args": {"nodePowerModel": model}}],
        }
    if name == "tlp_loaded":
        cluster = _cluster(objects, cluster_cls, rng, 32, 128, limits=True)
        return cluster, {
            "plugins": ["TargetLoadPacking", "LoadVariationRiskBalancing"],
            "pluginConfig": [
                {"name": "TargetLoadPacking", "args": {
                    "targetUtilization": 60,
                    "defaultRequestsMultiplier": "2"}},
                {"name": "LoadVariationRiskBalancing", "args": {
                    "safeVarianceMargin": 2.0,
                    "safeVarianceSensitivity": 2.0}},
            ],
            "weights": [2, 1],
        }
    raise KeyError(name)


def solve_inputs(scheduler, cluster, now_ms: int = 0, **snapshot_kw):
    """What `Scheduler.solve` of a case runs on, for either package: each
    plugin's `configure_cluster` (as the cycle's prologue runs it), the
    QueueSorted batch, the snapshot and `prepare`. Returns (pending,
    snapshot, meta)."""
    for plugin in scheduler.profile.plugins:
        plugin.configure_cluster(cluster)
    pending = scheduler.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=now_ms, **snapshot_kw)
    scheduler.prepare(meta, cluster)
    return pending, snap, meta
