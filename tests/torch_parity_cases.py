"""Cases of the port's sequential parity solve shared by
`tests/test_torch_parity_solve.py` (against JAX `Scheduler.solve`, and
card against CPU) and `chip_smoke.py` (card against CPU at bench size).

`nominee_cluster` builds from either package's `objects` module and
`Cluster` class and imports neither package itself; `parity_outputs`
names the outputs a parity solve is compared on. The comparisons stay
with each caller."""

from __future__ import annotations


def nominee_cluster(objects, cluster_cls, n_nodes: int = 12,
                    n_pods: int = 96, seed: int = 0):
    """A tight cluster with nominated pods inside and outside the batch,
    built from either package's `objects` module and `Cluster` class:
    three quota namespaces, gated (so unbatched) pods nominated to the
    first nodes at high priority, and batch pods of mixed priority of which
    every eighth is nominated to a node."""
    import numpy as np

    o = objects
    gib = 1 << 30
    rng = np.random.default_rng(seed)
    cluster = cluster_cls()
    for i in range(n_nodes):
        cluster.add_node(o.Node(name=f"node-{i:04d}", allocatable={
            "cpu": 8000 + 2000 * (i % 3), "memory": (24 + 8 * (i % 2)) * gib,
            "pods": 12,
        }))
    namespaces = ["team-a", "team-b", "team-c"]
    for k, ns in enumerate(namespaces):
        cluster.add_quota(o.ElasticQuota(
            name=f"eq-{ns}", namespace=ns,
            min={"cpu": 20_000 + 8000 * k, "memory": 80 * gib},
            max={"cpu": 36_000 + 6000 * k, "memory": 160 * gib},
        ))
    for j in range(4):
        cluster.add_pod(o.Pod(
            name=f"held-{j}", namespace=namespaces[j % 3], priority=5,
            creation_ms=-100 + j, scheduling_gated=True,
            nominated_node_name=f"node-{j:04d}",
            containers=[o.Container(requests={"cpu": 3000, "memory": 6 * gib})],
        ))
    cpus = rng.integers(200, 3000, n_pods)
    mems = rng.integers(1, 6, n_pods)
    pris = rng.integers(0, 8, n_pods)
    for i in range(n_pods):
        cluster.add_pod(o.Pod(
            name=f"pod-{i:04d}", namespace=namespaces[i % 3],
            priority=int(pris[i]), creation_ms=i,
            nominated_node_name=(f"node-{int(rng.integers(0, n_nodes)):04d}"
                                 if i % 8 == 3 else None),
            containers=[o.Container(requests={
                "cpu": int(cpus[i]), "memory": int(mems[i]) * gib})],
        ))
    return cluster


def parity_outputs(result) -> dict:
    """A `SolveResult`'s outputs and final carries by name (None where a
    carry is absent)."""
    outputs = {k: getattr(result, k) for k in
               ("assignment", "admitted", "wait", "failed_plugin")}
    for k in ("free", "eq_used", "gang_scheduled", "gang_inflight",
              "placed_mask", "numa_avail", "net_placed", "sel_counts",
              "sel_dom_counts", "anti_domains", "sym_counts"):
        outputs[k] = getattr(result.state, k)
    return outputs
