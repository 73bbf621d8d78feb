"""Synthetic scenario builders (port of `scheduler_plugins_tpu.models.scenarios`).

Seeded with `np.random.default_rng(seed)` and drawing in the same order as
the JAX package, so both packages build the same cluster from one seed.
"""

from __future__ import annotations

import numpy as np

from scheduler_plugins_tpu_torch.api.objects import (
    APP_GROUP_LABEL,
    POD_GROUP_LABEL,
    REGION_LABEL,
    WORKLOAD_SELECTOR_LABEL,
    ZONE_LABEL,
    AppGroup,
    AppGroupDependency,
    AppGroupWorkload,
    Container,
    ElasticQuota,
    LabelSelector,
    NetworkTopology,
    Node,
    NodeResourceTopology,
    NUMAZone,
    Pod,
    PodAffinityTerm,
    PodGroup,
    SeccompProfile,
    TopologyManagerPolicy,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from scheduler_plugins_tpu_torch.api.resources import CPU, MEMORY, PODS
from scheduler_plugins_tpu_torch.state.cluster import Cluster

GIB = 1 << 30


def _nodes(n, cpu=64_000, mem=256 * GIB, pods=256):
    return [
        Node(name=f"node-{i:05d}", allocatable={CPU: cpu, MEMORY: mem, PODS: pods})
        for i in range(n)
    ]


def _pods(p, rng, cpu_range=(100, 4000), mem_range=(256 << 20, 8 * GIB)):
    cpus = rng.integers(*cpu_range, size=p)
    mems = rng.integers(*mem_range, size=p)
    return [
        Pod(
            name=f"pod-{i:06d}",
            creation_ms=i,
            containers=[Container(requests={CPU: int(cpus[i]), MEMORY: int(mems[i])})],
        )
        for i in range(p)
    ]


def allocatable_scenario(n_nodes=100, n_pods=1000, seed=0) -> Cluster:
    """Plain allocatable-scored placement: homogeneous nodes, random
    cpu/memory requests."""
    rng = np.random.default_rng(seed)
    cluster = Cluster()
    for node in _nodes(n_nodes):
        cluster.add_node(node)
    for pod in _pods(n_pods, rng):
        cluster.add_pod(pod)
    return cluster


def trimaran_scenario(n_nodes=5000, n_pods=2000, seed=0) -> Cluster:
    """Load-aware scoring: `allocatable_scenario`'s cluster with synthetic
    load-watcher metrics per node (cpu and memory, average and std), drawn
    from a second generator of the same seed, as the JAX package draws
    them."""
    rng = np.random.default_rng(seed)
    cluster = allocatable_scenario(n_nodes, n_pods, seed)
    cluster.node_metrics = {
        f"node-{i:05d}": {
            "cpu_avg": float(rng.uniform(5, 90)),
            "cpu_std": float(rng.uniform(0, 15)),
            "mem_avg": float(rng.uniform(5, 80)),
            "mem_std": float(rng.uniform(0, 10)),
        }
        for i in range(n_nodes)
    }
    return cluster


def numa_scenario(n_nodes=1000, n_pods=1000, zones=8, seed=0) -> Cluster:
    """NUMA-aware filter and score (bench config 3): `_nodes`' nodes, each
    with a single-numa-node NRT of `zones` equal zones (distance 10 to
    itself, 20 to the others), and guaranteed pods of one container whose
    CPU request, 500 to half a zone, equals its limit, at 1 GiB memory."""
    rng = np.random.default_rng(seed)
    cluster = Cluster()
    per_zone_cpu = 64_000 // zones
    per_zone_mem = 256 * GIB // zones
    for node in _nodes(n_nodes):
        cluster.add_node(node)
        cluster.add_nrt(NodeResourceTopology(
            node_name=node.name,
            policy=TopologyManagerPolicy.SINGLE_NUMA_NODE,
            zones=[
                NUMAZone(
                    numa_id=z,
                    available={CPU: per_zone_cpu, MEMORY: per_zone_mem},
                    costs={o: 10 if o == z else 20 for o in range(zones)},
                )
                for z in range(zones)
            ],
        ))
    cpus = rng.integers(500, per_zone_cpu // 2, size=n_pods)
    for i in range(n_pods):
        cpu = int(cpus[i])
        cluster.add_pod(Pod(
            name=f"pod-{i:06d}",
            creation_ms=i,
            containers=[Container(
                requests={CPU: cpu, MEMORY: 1 * GIB},
                limits={CPU: cpu, MEMORY: 1 * GIB},
            )],
        ))
    return cluster


def gang_quota_scenario(n_gangs=100, gang_size=64, n_nodes=1000, seed=0) -> Cluster:
    """Gangs in 16 quota-governed namespaces."""
    cluster = Cluster()
    for node in _nodes(n_nodes):
        cluster.add_node(node)
    for g in range(n_gangs):
        ns = f"team-{g % 16}"
        if ns not in cluster.quotas:
            cluster.add_quota(
                ElasticQuota(
                    name=f"eq-{ns}",
                    namespace=ns,
                    min={CPU: n_nodes * 4000, MEMORY: n_nodes * 16 * GIB},
                    max={CPU: n_nodes * 8000, MEMORY: n_nodes * 32 * GIB},
                )
            )
        cluster.add_pod_group(
            PodGroup(name=f"gang-{g:04d}", namespace=ns, min_member=gang_size)
        )
        for m in range(gang_size):
            cluster.add_pod(
                Pod(
                    name=f"gang-{g:04d}-m{m:03d}",
                    namespace=ns,
                    creation_ms=g * 1000 + m,
                    containers=[
                        Container(requests={CPU: 1000, MEMORY: 2 * GIB})
                    ],
                    labels={POD_GROUP_LABEL: f"gang-{g:04d}"},
                )
            )
    return cluster


def _add_app_group_mesh(cluster, rng, n_workloads, n_regions,
                        zones_per_region, max_network_cost):
    """The AppGroup "mesh": workload w > 0 depends on one earlier
    workload drawn from `rng`, topology order = workload index; plus the
    "UserDefined" NetworkTopology weights, 5 between any two zones and 50
    between any two regions. Returns the zone names."""
    workloads = [AppGroupWorkload(selector=f"wl-{w}")
                 for w in range(n_workloads)]
    for w in range(1, n_workloads):
        workloads[w].dependencies.append(AppGroupDependency(
            workload_selector=f"wl-{rng.integers(0, w)}",
            max_network_cost=max_network_cost,
        ))
    cluster.add_app_group(AppGroup(
        name="mesh", workloads=workloads,
        topology_order={f"wl-{w}": w for w in range(n_workloads)},
    ))
    zone_names = [f"zone-{z}" for z in range(n_regions * zones_per_region)]
    region_names = [f"region-{r}" for r in range(n_regions)]
    cluster.add_network_topology(NetworkTopology(weights={
        "UserDefined": {
            "zone": {(a, b): 5 for a in zone_names for b in zone_names
                     if a != b},
            "region": {(a, b): 50 for a in region_names
                       for b in region_names if a != b},
        }
    }))
    return zone_names


def network_scenario(n_nodes=1000, n_pods=1000, n_regions=4,
                     zones_per_region=4, n_workloads=32, seed=0) -> Cluster:
    """NetworkOverhead + TopologicalSort (bench config 5): `_nodes`'
    nodes labelled round-robin with `n_regions` regions and
    `n_regions * zones_per_region` zones, the AppGroup mesh of
    `n_workloads` workloads (MaxNetworkCost 10), and pods of 500m CPU and
    1 GiB, each in a workload drawn from `rng`."""
    rng = np.random.default_rng(seed)
    cluster = Cluster()
    for i, node in enumerate(_nodes(n_nodes)):
        node.labels = {
            REGION_LABEL: f"region-{i % n_regions}",
            ZONE_LABEL: f"zone-{i % (n_regions * zones_per_region)}",
        }
        cluster.add_node(node)
    _add_app_group_mesh(cluster, rng, n_workloads, n_regions,
                        zones_per_region, max_network_cost=10)
    for i in range(n_pods):
        w = int(rng.integers(0, n_workloads))
        cluster.add_pod(Pod(
            name=f"pod-{i:06d}",
            creation_ms=i,
            containers=[Container(requests={CPU: 500, MEMORY: 1 * GIB})],
            labels={APP_GROUP_LABEL: "mesh", WORKLOAD_SELECTOR_LABEL: f"wl-{w}"},
        ))
    return cluster


def mixed_scenario(n_nodes=16, n_pods=32, zones=2, n_regions=2,
                   zones_per_region=2, n_workloads=4, seed=0) -> Cluster:
    """The full-roster mixed scenario: every node carries an NRT
    (single-numa-node policy, `zones` equal zones) and region / zone
    labels (round-robin); the pods are guaranteed-QoS members of the
    AppGroup mesh (MaxNetworkCost 60) with a zone DoNotSchedule spread
    constraint (maxSkew max(2, pods / zones)) and a region ScheduleAnyway
    one (maxSkew 1), both over the AppGroup label. One profile then
    exercises allocatable scoring, NUMA zone fitting, network dependency
    thresholds and spread skew together."""
    rng = np.random.default_rng(seed)
    cluster = Cluster()
    per_zone_cpu = 64_000 // zones
    per_zone_mem = 256 * GIB // zones
    zone_names = [f"zone-{z}" for z in range(n_regions * zones_per_region)]
    for i, node in enumerate(_nodes(n_nodes)):
        node.labels = {
            REGION_LABEL: f"region-{i % n_regions}",
            ZONE_LABEL: zone_names[i % len(zone_names)],
        }
        cluster.add_node(node)
        cluster.add_nrt(NodeResourceTopology(
            node_name=node.name,
            policy=TopologyManagerPolicy.SINGLE_NUMA_NODE,
            zones=[
                NUMAZone(
                    numa_id=z,
                    available={CPU: per_zone_cpu, MEMORY: per_zone_mem},
                    costs={o: 10 if o == z else 20 for o in range(zones)},
                )
                for z in range(zones)
            ],
        ))
    _add_app_group_mesh(cluster, rng, n_workloads, n_regions,
                        zones_per_region, max_network_cost=60)
    cpus = rng.integers(500, per_zone_cpu // 4, size=n_pods)
    mesh = LabelSelector(match_labels={APP_GROUP_LABEL: "mesh"})
    for i in range(n_pods):
        cpu = int(cpus[i])
        w = int(rng.integers(0, n_workloads))
        cluster.add_pod(Pod(
            name=f"pod-{i:06d}",
            creation_ms=i,
            containers=[Container(
                requests={CPU: cpu, MEMORY: 1 * GIB},
                limits={CPU: cpu, MEMORY: 1 * GIB},
            )],
            labels={APP_GROUP_LABEL: "mesh",
                    WORKLOAD_SELECTOR_LABEL: f"wl-{w}"},
            topology_spread=[
                TopologySpreadConstraint(
                    max_skew=max(2, n_pods // len(zone_names)),
                    topology_key=ZONE_LABEL,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=mesh,
                ),
                TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=REGION_LABEL,
                    when_unsatisfiable="ScheduleAnyway",
                    label_selector=mesh,
                ),
            ],
        ))
    return cluster


def metric_affinity_scenario(n_nodes=16, n_pods=32, seed=3) -> Cluster:
    """The JAX package's metric-roster problem: synthetic load metrics
    (TargetLoadPacking, LoadVariationRiskBalancing), inter-pod affinity
    terms over four zones with an assigned seed pod (InterPodAffinity's
    symmetric carry) and two seccomp profiles (SySched's syscall sets).
    Pods come in threes: a db pod, then two web pods, the first of which
    requires its zone to hold a db pod; each prefers one (weight 50)."""
    rng = np.random.default_rng(seed)
    cluster = Cluster()
    for i, node in enumerate(_nodes(n_nodes, cpu=16_000, mem=64 * GIB,
                                    pods=40)):
        node.labels = {ZONE_LABEL: f"z-{i % 4}"}
        cluster.add_node(node)
    cluster.node_metrics = {
        f"node-{i:05d}": {
            "cpu_avg": float(rng.uniform(5, 80)),
            "cpu_std": float(rng.uniform(0, 12)),
            "mem_avg": float(rng.uniform(5, 70)),
            "mem_std": float(rng.uniform(0, 8)),
        }
        for i in range(n_nodes)
    }
    cluster.add_seccomp_profile(SeccompProfile(
        name="web", syscalls=frozenset({"read", "write", "accept"})))
    cluster.add_seccomp_profile(SeccompProfile(
        name="db", syscalls=frozenset({"read", "write", "fsync"})))
    seed_pod = Pod(name="seed-db", labels={"app": "db"},
                   containers=[Container(
                       requests={CPU: 500},
                       seccomp_profile="operator/default/db.json")])
    seed_pod.node_name = "node-00000"
    cluster.add_pod(seed_pod)
    affinity = PodAffinityTerm(
        topology_key=ZONE_LABEL,
        label_selector=LabelSelector(match_labels={"app": "db"}),
    )
    for j in range(n_pods):
        kind = j % 3
        cluster.add_pod(Pod(
            name=f"p{j}", creation_ms=j,
            labels={"app": "web" if kind else "db"},
            containers=[Container(
                requests={
                    CPU: int(rng.integers(200, 1500)),
                    MEMORY: int(rng.integers(1, 4)) * GIB},
                seccomp_profile=(
                    "operator/default/web.json" if kind
                    else "operator/default/db.json"
                ))],
            pod_affinity_preferred=[WeightedPodAffinityTerm(
                weight=50, term=affinity)],
            pod_affinity_required=[affinity] if kind == 1 else [],
        ))
    return cluster


#: bench config 13's packing problem: a mid-life cluster of four
#: heterogeneous SKUs with uneven resident load, the iteration budgets its
#: sweep runs (0, the wave-path anchor, always first)
PACKING_SHAPE = dict(
    n_nodes=768, demand_frac=0.92, empty_frac=0.05, budgets=(8, 32, 128),
)
#: the reduced packing shape (the JAX package's pack-smoke gate)
PACK_SMOKE_SHAPE = dict(
    n_nodes=96, demand_frac=0.8, empty_frac=0.1, budgets=(8, 32),
)


def packing_scenario(n_nodes, demand_frac=0.8, empty_frac=0.1, seed=0, *,
                     device=None):
    """(cluster, snap, meta, weights) of the packing problem (bench config
    13, the JAX `bench.packing_problem`, same draws in the same order):
    `1 - empty_frac` of the nodes carry bound residents at 20-80 % of
    their cpu over four SKUs, the last `empty_frac` stand empty on the
    biggest SKU, and a pending batch asks for `demand_frac` of the
    cluster's free cpu. The snapshot lowers the pending pods in creation
    order onto `device` (None = the CUDA card); `weights` is the (R,)
    int64 allocatable weight vector (cpu 2^20, memory 1) on that
    device."""
    import torch

    from scheduler_plugins_tpu_torch.api.resources import ResourceIndex
    from scheduler_plugins_tpu_torch.device import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    skus = [
        (64_000, 256 * GIB, 256),
        (32_000, 128 * GIB, 220),
        (96_000, 384 * GIB, 256),
        (16_000, 64 * GIB, 128),
    ]
    cluster = Cluster()
    serial = 0
    free_cpu = 0
    n_empty = max(1, int(n_nodes * empty_frac))
    for i in range(n_nodes):
        # the last n_empty nodes stand empty on the biggest SKU
        empty = i >= n_nodes - n_empty
        sku = 2 if empty else int(rng.integers(0, len(skus)))
        cpu, mem, pods = skus[sku]
        cluster.add_node(Node(
            name=f"node-{i:05d}",
            allocatable={CPU: cpu, MEMORY: mem, PODS: pods},
        ))
        used = 0
        if not empty:
            # uneven resident fill: 20-80 % of cpu in 100-2000m pieces
            target = int(cpu * rng.uniform(0.2, 0.8))
            while used < target:
                c = int(rng.integers(100, 2000))
                m = int(rng.integers(256 << 20, 2 * GIB))
                pod = Pod(
                    name=f"bound-{serial:06d}", creation_ms=serial,
                    containers=[Container(requests={CPU: c, MEMORY: m})],
                )
                pod.node_name = f"node-{i:05d}"
                cluster.add_pod(pod)
                used += c
                serial += 1
        free_cpu += cpu - used
    base_ms = serial
    target_demand = int(free_cpu * demand_frac)
    demand = 0
    j = 0
    while demand < target_demand:
        c = int(rng.integers(100, 2000))
        cluster.add_pod(Pod(
            name=f"pend-{j:06d}", creation_ms=base_ms + j,
            containers=[Container(requests={
                CPU: c,
                MEMORY: int(rng.integers(256 << 20, 2 * GIB))})],
        ))
        demand += c
        j += 1
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    snap, meta = cluster.snapshot(pending, now_ms=0, device=device)
    weights = torch.as_tensor(
        ResourceIndex().encode({CPU: 1 << 20, MEMORY: 1}),
        dtype=torch.int64,
    ).to(device)
    return cluster, snap, meta, weights
