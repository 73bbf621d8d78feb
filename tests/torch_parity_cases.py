"""Cases of the port's sequential parity solve shared by
`tests/test_torch_parity_solve.py` (against JAX `Scheduler.solve`, and
card against CPU) and `chip_smoke.py` (card against CPU at bench size).

`nominee_cluster` builds from either package's `objects` module and
`Cluster` class, `mixed_cluster` from a namespace holding both; neither
imports a package itself. `parity_outputs` names the outputs a parity
solve is compared on. The comparisons stay with each caller."""

from __future__ import annotations

GIB = 1 << 30


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


def mixed_cluster(pkg, seed, n_nodes=19, n_pods=160, *, gangs=False,
                  cordon=(3,), n_assigned=12):
    """A tight heterogeneous cluster, built identically by either package
    `pkg`: random node sizes with `cordon`ed nodes, pods already bound
    (node usage), init containers and overhead (effective requests),
    a nominated pod, and with `gangs` four quota namespaces holding
    PodGroups: one admitted, one short of members, one with a gated
    sibling, one whose MinResources exceed the cluster, and one that
    outgrows its namespace's quota Max."""
    import numpy as np

    o = pkg.objects
    rng = np.random.default_rng(seed)
    cluster = pkg.Cluster()
    cpu = rng.integers(2000, 16_000, n_nodes)
    mem = rng.integers(4, 64, n_nodes)
    slots = rng.integers(2, 40, n_nodes)
    for i in range(n_nodes):
        cluster.add_node(o.Node(
            name=f"node-{i:03d}",
            allocatable={"cpu": int(cpu[i]), "memory": int(mem[i]) * GIB,
                         "pods": int(slots[i])},
            unschedulable=i in cordon,
        ))
    namespaces = [f"team-{k}" for k in range(4)] if gangs else ["default"]
    for i in range(n_assigned):
        cluster.add_pod(o.Pod(
            name=f"bound-{i:03d}", namespace=namespaces[i % len(namespaces)],
            node_name=f"node-{int(rng.integers(0, n_nodes)):03d}",
            containers=[o.Container(requests={
                "cpu": int(rng.integers(100, 1500)),
                "memory": int(rng.integers(1, 4)) * GIB})],
        ))
    if gangs:
        for k, ns in enumerate(namespaces):
            cluster.add_quota(o.ElasticQuota(
                name=f"eq-{ns}", namespace=ns,
                min={"cpu": 6000 + 3000 * k, "memory": 24 * GIB},
                max={"cpu": 14_000 + 4000 * k, "memory": 80 * GIB},
            ))
        # (name, namespace, min_member, members, gated members, minres)
        groups = [
            ("g-ok", "team-0", 4, 6, 0, None),
            ("g-short", "team-1", 8, 5, 0, None),
            ("g-gated", "team-2", 5, 5, 1, None),
            ("g-minres", "team-3", 3, 4, 0, {"cpu": 10 ** 9}),
            ("g-capped", "team-0", 16, 16, 0, None),
        ]
        for name, ns, min_member, members, gated, minres in groups:
            cluster.add_pod_group(o.PodGroup(
                name=name, namespace=ns, min_member=min_member,
                min_resources=minres or {},
            ))
            for m in range(members):
                cluster.add_pod(o.Pod(
                    name=f"{name}-m{m}", namespace=ns,
                    # g-capped heads the queue and outgrows its quota's
                    # Max: its tail is rejected, its head waits on quorum
                    creation_ms=(-1000 if name == "g-capped" else 1000)
                    + 10 * m,
                    containers=[o.Container(requests={
                        "cpu": 900 + 100 * (m % 3), "memory": 2 * GIB})],
                    labels={o.POD_GROUP_LABEL: name},
                    scheduling_gated=m < gated,
                ))
    cpus = rng.integers(50, 6000, n_pods)
    mems = rng.integers(1, 12, n_pods)
    for i in range(n_pods):
        init = []
        if i % 7 == 0:
            init = [o.Container(name="init", requests={
                "cpu": int(cpus[i]) + 500, "memory": GIB})]
        cluster.add_pod(o.Pod(
            name=f"pod-{i:04d}", namespace=namespaces[i % len(namespaces)],
            creation_ms=i, priority=int(i % 3),
            containers=[o.Container(requests={
                "cpu": int(cpus[i]), "memory": int(mems[i]) * GIB})],
            init_containers=init,
            overhead={"cpu": 10} if i % 5 == 0 else {},
            nominated_node_name="node-001" if i == 2 else None,
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
