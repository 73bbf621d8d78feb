"""Seeded network-aware problems shared by `tests/test_torch_network.py`
(the port against JAX) and `chip_smoke.py` (the card against the CPU).

`network_case(name, pkg)` builds a case's cluster with either package's
objects (`pkg.objects`, `pkg.Cluster`, `pkg.scenarios`) and returns it
with the profile configuration each package loads with its own
`api.config.load_profile`; it imports neither package itself.
`network_cycle_script(pkg)` is a multi-cycle script in the form of
`tests/test_torch_cycle.py`'s scripts (`pkg.o`, `pkg.Cluster`,
`pkg.Profile`, `pkg.Scheduler`, `pkg.plugins`, `pkg.pre`).
`dependency_violations` is the host oracle of NetworkOverhead's Filter,
independent of both solvers."""

from __future__ import annotations

GIB = 1 << 30
#: networkoverhead.go MaxCost
MAX_COST = 100

#: the cases, each solved by both packages
CASES = ("config5_small", "placed_mesh", "labels", "custom_topology")

CONFIG5 = {"plugins": ["NetworkOverhead", "TopologicalSort"]}


def _mesh(o, cluster, rng, *, n_nodes, n_pods, n_regions=3,
          zones_per_region=2, n_workloads=6, max_deps=2, n_placed=20,
          unlabeled=0.1, region_only=0.1, missing=0.3, cpu_slots=(2, 6),
          namespace="default", ag_name="mesh", weights_name="UserDefined",
          nt_name="nt-default", node_prefix="n", pod_prefix="p",
          loose=0.1):
    """Nodes in `n_regions` regions of `zones_per_region` zones (a share
    unlabelled, a share with a region only, node 3 cordoned), an AppGroup
    of `n_workloads` workloads where each depends on up to `max_deps`
    earlier ones (MaxNetworkCost 0, 5, 10 or 30), a NetworkTopology with
    a `missing` share of its zone and region pairs left out, `n_placed`
    bound member pods and `n_pods` pending ones (a `loose` share without
    AppGroup labels), priorities 0-2."""
    regions = [f"{ag_name}-r{r}" for r in range(n_regions)]
    zones = {r: [f"{r}-z{z}" for z in range(zones_per_region)]
             for r in regions}
    nodes = []
    for i in range(n_nodes):
        labels = {}
        u = float(rng.random())
        region = regions[int(rng.integers(0, n_regions))]
        zone = zones[region][int(rng.integers(0, zones_per_region))]
        if u >= unlabeled:
            labels[o.REGION_LABEL] = region
            if u >= unlabeled + region_only:
                labels[o.ZONE_LABEL] = zone
        name = f"{node_prefix}{i:03d}"
        nodes.append(name)
        cluster.add_node(o.Node(
            name=name, labels=labels, unschedulable=(i == 3),
            allocatable={"cpu": int(rng.integers(*cpu_slots)) * 1000,
                         "memory": 64 * GIB, "pods": 110}))
    workloads = [o.AppGroupWorkload(selector=f"wl-{w}")
                 for w in range(n_workloads)]
    for w in range(1, n_workloads):
        n_deps = int(rng.integers(0, max_deps + 1))
        picks = sorted({int(rng.integers(0, w)) for _ in range(n_deps)})
        for d in picks:
            workloads[w].dependencies.append(o.AppGroupDependency(
                workload_selector=f"wl-{d}",
                max_network_cost=int(rng.choice([0, 5, 10, 30]))))
    cluster.add_app_group(o.AppGroup(
        name=ag_name, namespace=namespace, workloads=workloads,
        topology_order={f"wl-{w}": int(rng.integers(0, n_workloads))
                        for w in range(n_workloads)}))
    zone_names = [z for r in regions for z in zones[r]]
    zone_w = {}
    for a in zone_names:
        for b in zone_names:
            if a != b and rng.random() >= missing:
                zone_w[(a, b)] = int(rng.integers(1, 21))
    region_w = {}
    for a in regions:
        for b in regions:
            if a != b and rng.random() >= missing:
                region_w[(a, b)] = int(rng.integers(10, 61))
    cluster.add_network_topology(o.NetworkTopology(
        name=nt_name, namespace=namespace,
        weights={weights_name: {"zone": zone_w, "region": region_w}}))

    def member(name, created, node=None):
        labels = {}
        if rng.random() >= loose:
            labels = {o.APP_GROUP_LABEL: ag_name,
                      o.WORKLOAD_SELECTOR_LABEL:
                          f"wl-{int(rng.integers(0, n_workloads))}"}
        pod = o.Pod(name=name, namespace=namespace, creation_ms=created,
                    priority=int(rng.integers(0, 3)), labels=labels,
                    containers=[o.Container(requests={
                        "cpu": int(rng.integers(1, 4)) * 250,
                        "memory": GIB})])
        pod.node_name = node
        return pod

    for j in range(n_placed):
        cluster.add_pod(member(f"{pod_prefix}placed-{j:03d}", j,
                               node=nodes[int(rng.integers(0, n_nodes))]))
    for j in range(n_pods):
        cluster.add_pod(member(f"{pod_prefix}{j:04d}", 1000 + j))


def network_case(name: str, pkg, seed: int = 0):
    """(cluster, profile config) of the case `name` (see `CASES`):

    - `config5_small`: bench config 5's generator cut to 64 nodes x 128
      pods (NetworkOverhead + TopologicalSort);
    - `placed_mesh`: 40 nodes, 160 pending pods, 24 bound ones, two
      dependencies a workload at most, some pairs missing, tight CPU so
      Filter and capacity both reject;
    - `labels`: many unlabelled and region-only nodes, three dependency
      slots, every cost pair present or absent at random;
    - `custom_topology`: two AppGroups in two namespaces, a custom
      weights name and topology name (a decoy topology under the default
      name), NodeResourcesAllocatable beside NetworkOverhead (weight 3)."""
    import numpy as np

    o = pkg.objects
    rng = np.random.default_rng(seed)
    if name == "config5_small":
        return pkg.scenarios.network_scenario(64, 128, seed=seed), CONFIG5
    c = pkg.Cluster()
    if name == "placed_mesh":
        _mesh(o, c, rng, n_nodes=40, n_pods=160, n_placed=24,
              cpu_slots=(1, 4))
        return c, CONFIG5
    if name == "labels":
        _mesh(o, c, rng, n_nodes=24, n_pods=96, n_workloads=8, max_deps=3,
              unlabeled=0.25, region_only=0.3, missing=0.5, n_placed=30)
        return c, CONFIG5
    if name == "custom_topology":
        _mesh(o, c, rng, n_nodes=20, n_pods=60, namespace="a",
              ag_name="shop", weights_name="Custom", nt_name="nt-shop",
              node_prefix="a", pod_prefix="a")
        _mesh(o, c, rng, n_nodes=16, n_pods=50, namespace="b",
              ag_name="shop", weights_name="Custom", nt_name="nt-decoy",
              node_prefix="b", pod_prefix="b")
        c.add_network_topology(o.NetworkTopology(weights={"Custom": {
            "zone": {}, "region": {}}}))
        return c, {
            "plugins": ["TopologicalSort", "NodeResourcesAllocatable",
                        "NetworkOverhead"],
            "pluginConfig": [{"name": "NetworkOverhead", "args": {
                "weightsName": "Custom", "networkTopologyName": "nt-shop"}}],
            "weights": [1, 1, 3],
        }
    raise KeyError(name)


def network_cycle_script(pkg):
    """Four cycles of NetworkOverhead + TopologicalSort with DEFAULT
    preemption on three nodes: na1 (region a) holds the db pod `db-far`
    (priority 100); nb1 and nb2 (region b, zones b1 / b2, zone cost 3,
    region cost 50) hold fillers.

    - cycle 1 binds `db-near` to nb1;
    - cycle 2's `web-0` (depends on db, MaxNetworkCost 5) passes the
      Filter only because cycle 1's bind counts: nb1 (db-near on the
      node) and nb2 (db-near a zone away) each satisfy one dependency
      against db-far's violated one, and the lower cost takes nb1;
    - cycle 3's `web-hi` (priority 50) must preempt: on nb1 the eviction
      would take db-near, and the post-eviction Filter then rejects nb1,
      though its victims rank best; nb2's priority-1 fillers go;
    - before cycle 4 the victims are deleted, and web-hi binds to nb2."""
    o = pkg.o
    c = pkg.Cluster()
    for name, region, zone in (("na1", "r-a", "z-a1"), ("nb1", "r-b", "z-b1"),
                               ("nb2", "r-b", "z-b2")):
        c.add_node(o.Node(name=name, labels={
            o.REGION_LABEL: region, o.ZONE_LABEL: zone},
            allocatable={"cpu": 4000, "memory": 32 * GIB, "pods": 110}))
    c.add_app_group(o.AppGroup(name="ag", workloads=[
        o.AppGroupWorkload(selector="db"),
        o.AppGroupWorkload(selector="web", dependencies=[
            o.AppGroupDependency(workload_selector="db",
                                 max_network_cost=5)]),
    ], topology_order={"db": 1, "web": 2}))
    c.add_network_topology(o.NetworkTopology(weights={"UserDefined": {
        "zone": {("z-b1", "z-b2"): 3, ("z-b2", "z-b1"): 3},
        "region": {("r-a", "r-b"): 50, ("r-b", "r-a"): 50},
    }}))

    def pod(name, cpu, priority=0, created=0, workload=None, node=None):
        labels = {} if workload is None else {
            o.APP_GROUP_LABEL: "ag", o.WORKLOAD_SELECTOR_LABEL: workload}
        p = o.Pod(name=name, priority=priority, creation_ms=created,
                  labels=labels, containers=[o.Container(
                      requests={"cpu": cpu, "memory": GIB})])
        p.node_name = node
        return p

    c.add_pod(pod("db-far", 4000, priority=100, workload="db", node="na1"))
    for j in range(2):
        c.add_pod(pod(f"fill-b1-{j}", 1000, created=j, node="nb1"))
    for j in range(3):
        c.add_pod(pod(f"fill-b2-{j}", 1000, priority=1, created=j,
                      node="nb2"))
    c.add_pod(pod("db-near", 1000, created=10, workload="db"))
    sched = pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NetworkOverhead(),
                 pkg.plugins.TopologicalSort()],
        preemption=pkg.pre.PreemptionEngine(pkg.pre.PreemptionMode.DEFAULT)))

    def web(pkg, cluster):
        cluster.add_pod(pod("web-0", 1000, created=20, workload="web"))

    def preemptor(pkg, cluster):
        cluster.add_pod(pod("web-hi", 3000, priority=50, created=30,
                            workload="web"))

    def evict(pkg, cluster):
        for uid in [u for u, p in cluster.pods.items() if p.terminating]:
            cluster.remove_pod(uid)

    return c, sched, [(1000, None), (2000, web), (3000, preemptor),
                      (4000, evict)]


def _pair(cand, other, max_cost, zone_w, region_w):
    """(satisfied, violated, cost) of one placed dependency pod on node
    `other` seen from candidate node `cand` (networkoverhead.go:500-638,
    on the nodes' labels)."""
    if cand.name == other.name:
        return 1, 0, 0
    if not other.region and not other.zone:
        return 0, 1, MAX_COST
    if cand.zone == other.zone and (other.zone
                                    or cand.region == other.region):
        return 1, 0, 1
    cost = None
    if other.zone and cand.region == other.region:
        cost = zone_w.get((cand.zone, other.zone)) if cand.zone else None
    elif cand.region != other.region and cand.region:
        cost = region_w.get((cand.region, other.region))
    if cost is None:
        return 0, 0, MAX_COST
    return (1, 0, cost) if cost <= max_cost else (0, 1, cost)


def dependency_violations(cluster, pending, assignment, node_names,
                          weights_name="UserDefined",
                          topology_name="nt-default", wave_of=None) -> int:
    """Host oracle of NetworkOverhead's Filter, independent of the
    solvers: replay the placements of the `pending` pods on top of the
    store's bound and reserved pods, and count the placed pods with
    dependencies on whose node the violated dependencies outnumbered the
    satisfied ones at their turn. A pod's turn is its queue position, or
    with `wave_of` (the batched solve's wave of each pod) its wave: a
    wave's pods are filtered against the placements of the earlier waves,
    as the batched solve re-filters once a wave. Works on the nodes'
    labels and the NetworkTopology's weight maps directly."""
    nt = next((t for t in cluster.network_topologies.values()
               if t.name == topology_name), None)
    weights = nt.weights.get(weights_name, {}) if nt is not None else {}
    zone_w, region_w = weights.get("zone", {}), weights.get("region", {})
    deps = {}
    for ag in cluster.app_groups.values():
        for w in ag.workloads:
            deps[f"{ag.namespace}/{w.selector}"] = [
                (f"{ag.namespace}/{d.workload_selector}", d.max_network_cost)
                for d in w.dependencies]
    placed = {}  # workload key -> [node name]

    def key(pod):
        sel = pod.workload_selector()
        return f"{pod.namespace}/{sel}" if sel else None

    for pod in cluster.pods.values():
        k = key(pod)
        node = pod.node_name or cluster.reserved.get(pod.uid)
        if k in deps and node in cluster.nodes:
            placed.setdefault(k, []).append(node)
    turns = {}
    for i in range(len(pending)):
        if int(assignment[i]) >= 0:
            turn = i if wave_of is None else int(wave_of[i])
            turns.setdefault(turn, []).append(i)
    bad = 0
    for turn in sorted(turns):
        landed = []
        for i in turns[turn]:
            pod = pending[i]
            k = key(pod)
            cand = cluster.nodes[node_names[int(assignment[i])]]
            if deps.get(k):
                sat = vio = 0
                for dep, max_cost in deps[k]:
                    for other in placed.get(dep, []):
                        s, v, _ = _pair(cand, cluster.nodes[other],
                                        max_cost, zone_w, region_w)
                        sat, vio = sat + s, vio + v
                bad += vio > sat
            if k in deps:
                landed.append((k, cand.name))
        for k, name in landed:
            placed.setdefault(k, []).append(name)
    return bad
