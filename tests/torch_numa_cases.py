"""Seeded NUMA problems shared by `tests/test_torch_numa.py`,
`tests/test_torch_batch.py` (the port against JAX) and `chip_smoke.py`
(the card against the CPU).

`numa_case(name, pkg)` builds a case's cluster with either package's
objects (`pkg.objects`, `pkg.Cluster`, `pkg.scenarios`) and returns it
with the profile configuration each package loads with its own
`api.config.load_profile`; it imports neither package itself.
`numa_cycle_script(pkg)` is a multi-cycle script in the form of
`tests/test_torch_cycle.py`'s scripts (`pkg.o`, `pkg.Cluster`,
`pkg.Profile`, `pkg.Scheduler`, `pkg.plugins`); `nrt_cache_script(pkg)`
is one through the NRT cache tier (it also reads `pkg.nrt_cache`, the
package's `state.nrt_cache`), and `cache_state(cache)` the cache's
bookkeeping in a form both packages' caches compare in."""

from __future__ import annotations

GIB = 1 << 30
NIC = "vendor.com/nic"

#: the cases, each solved by both packages
CASES = ("config3_small", "mixed_scope", "multi_container", "best_effort",
         "least_numa", "float64")


def nrt(o, node, zone_avail, policy=None, scope=None, costs=None):
    """A NodeResourceTopology CR of zones `zone_avail` (one quantity dict
    per NUMA id); distances 10 to itself and 20 elsewhere unless `costs`
    (id -> id -> cost) says otherwise."""
    Z = len(zone_avail)
    zones = [
        o.NUMAZone(numa_id=z, available=dict(avail), costs=(
            costs[z] if costs else
            {w: 10 if w == z else 20 for w in range(Z)}))
        for z, avail in enumerate(zone_avail)
    ]
    return o.NodeResourceTopology(
        node_name=node, zones=zones,
        policy=(o.TopologyManagerPolicy.SINGLE_NUMA_NODE if policy is None
                else policy),
        scope=o.TopologyManagerScope.CONTAINER if scope is None else scope,
    )


def _container(o, rng, kind, mem_unit, nic):
    """One container of QoS `kind`: guaranteed (requests == limits),
    burstable (requests only) or best-effort (nothing); `nic` adds a
    device request."""
    cpu = int(rng.integers(1, 13)) * 250
    mem = int(rng.integers(1, 5)) * mem_unit
    req = {"cpu": cpu, "memory": mem}
    if nic:
        req[NIC] = int(rng.integers(1, 3))
    if kind == "guaranteed":
        return o.Container(requests=dict(req), limits=dict(req))
    if kind == "burstable":
        return o.Container(requests=req)
    return o.Container(requests={NIC: req[NIC]} if nic else {})


def _random_cluster(o, cluster_cls, rng, n_nodes, n_pods, zones=4, *,
                    scopes=("container",), policies=("snn",),
                    kinds=("guaranteed",), max_containers=1,
                    mem_unit=GIB, nics=False, costs=False):
    """Nodes of spread sizes, each with an NRT of `zones` zones of spread
    availability (a node in eleven without any, one cordoned node), the
    scope and policy of each node drawn from `scopes` / `policies`; pods
    of QoS kinds drawn from `kinds` with up to `max_containers` app
    containers (and an init container on every fifth multi-container
    pod)."""
    c = cluster_cls()
    scope_of = {"container": o.TopologyManagerScope.CONTAINER,
                "pod": o.TopologyManagerScope.POD}
    policy_of = {"snn": o.TopologyManagerPolicy.SINGLE_NUMA_NODE,
                 "best_effort": o.TopologyManagerPolicy.BEST_EFFORT}
    for i in range(n_nodes):
        name = f"node-{i:03d}"
        zone_avail = []
        for _ in range(zones):
            avail = {"cpu": int(rng.integers(2, 17)) * 500,
                     "memory": int(rng.integers(2, 17)) * mem_unit}
            if nics and i % 3 != 2:
                avail[NIC] = int(rng.integers(0, 4))
            zone_avail.append(avail)
        alloc = {"cpu": sum(z["cpu"] for z in zone_avail),
                 "memory": sum(z["memory"] for z in zone_avail) + mem_unit,
                 "pods": 40}
        if nics:
            alloc[NIC] = 8
        c.add_node(o.Node(name=name, allocatable=alloc,
                          unschedulable=i == 1))
        if i % 11 == 10:
            continue  # no NRT for this node
        cost = None
        if costs:
            cost = {z: {w: 10 if w == z else int(rng.integers(11, 40))
                        for w in range(zones)} for z in range(zones)}
            for z in range(zones):  # symmetric
                for w in range(z):
                    cost[z][w] = cost[w][z]
        c.add_nrt(nrt(
            o, name, zone_avail,
            policy=policy_of[policies[int(rng.integers(0, len(policies)))]],
            scope=scope_of[scopes[int(rng.integers(0, len(scopes)))]],
            costs=cost,
        ))
    for j in range(n_pods):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        n_cont = int(rng.integers(1, max_containers + 1))
        nic = nics and j % 4 == 0
        containers = [_container(o, rng, kind, mem_unit, nic)
                      for _ in range(n_cont)]
        init = []
        if n_cont > 1 and j % 5 == 0:
            init = [_container(o, rng, kind, mem_unit, False)]
        c.add_pod(o.Pod(name=f"pod-{j:03d}", creation_ms=j,
                        containers=containers, init_containers=init))
    return c


def _config(strategy, resources=None):
    args = {"scoringStrategy": strategy}
    if resources:
        args["resources"] = resources
    return {"plugins": ["NodeResourceTopologyMatch"],
            "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                              "args": args}]}


def numa_case(name: str, pkg, seed: int = 0):
    """(cluster, profile config) of the case `name` (see `CASES`):

    - `config3_small`: bench config 3's generator cut to 64 nodes x 96
      pods (8 zones, the default LeastAllocated profile);
    - `mixed_scope`: 16 nodes x 128 pods, container- and pod-scope
      nodes, single-numa-node and
      best-effort policies, guaranteed / burstable / best-effort pods of
      up to 3 containers with device requests, LeastAllocated with cpu
      weighted 2;
    - `multi_container`: container scope, guaranteed pods of up to 3
      containers and init containers, MostAllocated;
    - `best_effort`: pod scope, a QoS mix, BalancedAllocation;
    - `least_numa`: mixed scopes, LeastNUMANodes over asymmetric
      distances;
    - `float64`: memory in units no power of two divides, so the snapshot
      does not pack and the solve carries float64."""
    import numpy as np

    o = pkg.objects
    rng = np.random.default_rng(seed)
    if name == "config3_small":
        return (pkg.scenarios.numa_scenario(64, 96, zones=8, seed=seed),
                _config("LeastAllocated"))
    if name == "mixed_scope":
        c = _random_cluster(
            o, pkg.Cluster, rng, 16, 128, scopes=("container", "pod"),
            policies=("snn", "snn", "best_effort"),
            kinds=("guaranteed", "guaranteed", "burstable", "besteffort"),
            max_containers=3, nics=True)
        return c, _config("LeastAllocated", [["cpu", 2]])
    if name == "multi_container":
        c = _random_cluster(o, pkg.Cluster, rng, 20, 56, max_containers=3)
        return c, _config("MostAllocated")
    if name == "best_effort":
        c = _random_cluster(
            o, pkg.Cluster, rng, 20, 64, scopes=("pod",),
            kinds=("guaranteed", "burstable", "besteffort"))
        return c, _config("BalancedAllocation")
    if name == "least_numa":
        c = _random_cluster(
            o, pkg.Cluster, rng, 16, 48, scopes=("container", "pod"),
            kinds=("guaranteed", "guaranteed", "burstable"),
            max_containers=2, costs=True)
        return c, _config("LeastNUMANodes")
    if name == "float64":
        c = _random_cluster(o, pkg.Cluster, rng, 16, 40,
                            mem_unit=GIB + 3)
        return c, _config("LeastAllocated")
    raise KeyError(name)


def solve_inputs(scheduler, cluster, now_ms: int = 0, **snapshot_kw):
    """QueueSort, snapshot and `prepare` (with the cluster, so the
    uniform-scope selection runs) of either package. Returns (pending,
    snapshot, meta)."""
    pending = scheduler.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=now_ms, **snapshot_kw)
    scheduler.prepare(meta, cluster)
    return pending, snap, meta


def numa_cycle_script(pkg):
    """Three cycles of a NUMA profile, in the form of
    `tests/test_torch_cycle.py`'s scripts: cycle 1 places what its zones
    hold and parks the rest; then an NRT update doubles two nodes' zones
    and new pods arrive, so cycle 2 takes the parked pods back through the
    NodeResourceTopology/Update event; then an NRT delete and more pods
    before cycle 3."""
    import numpy as np

    o = pkg.o
    rng = np.random.default_rng(5)
    c = pkg.Cluster()
    zone_avail = {}
    for i in range(6):
        name = f"n{i}"
        zones = [{"cpu": 2000 + 500 * ((i + z) % 3), "memory": 8 * GIB}
                 for z in range(2)]
        zone_avail[name] = zones
        c.add_node(o.Node(name=name, allocatable={
            "cpu": 12_000, "memory": 64 * GIB, "pods": 40}))
        c.add_nrt(nrt(o, name, zones))

    def pods(prefix, n, start):
        for j in range(n):
            cpu = int(rng.integers(2, 7)) * 250
            c.add_pod(o.Pod(
                name=f"{prefix}{j}", creation_ms=start + j,
                containers=[o.Container(
                    requests={"cpu": cpu, "memory": GIB},
                    limits={"cpu": cpu, "memory": GIB})]))

    pods("a", 20, 0)
    sched = pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourceTopologyMatch()]))

    def grow(pkg, cluster):
        for name in ("n0", "n3"):
            cluster.add_nrt(nrt(pkg.o, name, [
                {"cpu": 2 * z["cpu"], "memory": 2 * z["memory"]}
                for z in zone_avail[name]]))
        pods("b", 6, 100)

    def shrink(pkg, cluster):
        cluster.remove_nrt("n5")
        pods("c", 6, 200)

    return c, sched, [(1000, None), (2000, grow), (3000, shrink)]


def nrt_cache_script(pkg, informer_mode="Dedicated"):
    """Four cycles of a NUMA profile whose cacheResyncPeriodSeconds (1)
    installs the over-reserve cache: five nodes of two 4000m zones and
    guaranteed 1500m pods.

    - cycle 1 binds six pods; the cache assumes each bound pod on every
      zone of its node;
    - before cycle 2 eight more pods arrive, the agent has published
      nothing, and a pod of another scheduler lands on n4: the assumed
      deduction blocks the overcommit (only nodes holding one pod take
      one more), n4 is stale, and the failures mark the nodes with
      assumed pods maybe-overreserved;
    - before cycle 3 the agent reports n0, n1 and n4 with fingerprints
      that match the pods the store has there, n2 with a stale
      fingerprint and n3 with none: cycle 3's resync flushes n0, n1 and
      n4 (one generation), and their freed zones take new pods;
    - before cycle 4 the pod bound last on n0 is deleted, which drops its
      deduction, and two more arrive.
    """
    o = pkg.o
    c = pkg.Cluster()
    zones = [{"cpu": 4000, "memory": 16 * GIB}] * 2
    for i in range(5):
        c.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 16_000, "memory": 64 * GIB, "pods": 40}))
        c.add_nrt(nrt(o, f"n{i}", zones))

    def pods(cluster, prefix, n, start):
        for j in range(n):
            cluster.add_pod(o.Pod(
                name=f"{prefix}{j}", creation_ms=start + j,
                containers=[o.Container(
                    requests={"cpu": 1500, "memory": GIB},
                    limits={"cpu": 1500, "memory": GIB})]))

    pods(c, "a", 6, 0)
    sched = pkg.Scheduler(pkg.Profile(plugins=[
        pkg.plugins.NodeResourceTopologyMatch(
            cache_resync_period_seconds=1,
            cache={"informerMode": informer_mode})]))

    def overcommit(pkg, cluster):
        pods(cluster, "b", 8, 100)
        alien = pkg.o.Pod(
            name="alien", scheduler_name="default-scheduler",
            phase=pkg.o.PodPhase.RUNNING,
            containers=[pkg.o.Container(requests={"cpu": 500})])
        alien.node_name = "n4"
        cluster.add_pod(alien)

    def agent_reports(pkg, cluster):
        fingerprint = pkg.nrt_cache.compute_pod_fingerprint
        for name in ("n0", "n1", "n2", "n3", "n4"):
            on_node = [(p.namespace, p.name) for p in cluster.pods.values()
                       if p.node_name == name]
            used = 1500 * len(on_node)
            report = nrt(pkg.o, name, [
                {"cpu": 4000 - used // 2 - used % 2000, "memory": 16 * GIB},
                {"cpu": 4000 - used // 2, "memory": 16 * GIB}])
            if name == "n2":
                on_node = on_node[:-1]  # the agent has not caught up
            if name != "n3":  # n3's agent stamps no fingerprint
                report.pod_fingerprint = fingerprint(on_node)
            cluster.add_nrt(report)
        pods(cluster, "c", 4, 200)

    def churn(pkg, cluster):
        last = [p for p in cluster.pods.values() if p.node_name == "n0"][-1]
        cluster.remove_pod(last.uid)
        pods(cluster, "d", 2, 300)

    return c, sched, [(1000, None), (2000, overcommit),
                      (3000, agent_reports), (4000, churn)]


def cache_state(cache) -> dict:
    """The NRT cache's bookkeeping as plain data, equal across the two
    packages: the NRT copies and pending reports as (node, policy,
    scope, fingerprint, zones) tuples, the assumed map, the flag sets,
    the generation, the reservations and the resync clock (whichever the
    cache has), plus `view()`."""
    def nrt_tuple(t):
        return (t.node_name, int(t.policy), int(t.scope), t.max_numa_nodes,
                t.pod_fingerprint, t.pod_fingerprint_method,
                [(z.numa_id, sorted(z.available.items()),
                  sorted(z.allocatable.items()), sorted(z.costs.items()))
                 for z in t.zones])

    if cache is None:
        return None
    out = {"type": type(cache).__name__}
    for attr in ("nrts", "pending"):
        if hasattr(cache, attr):
            out[attr] = [nrt_tuple(t) for _, t in
                         sorted(getattr(cache, attr).items())]
    if hasattr(cache, "assumed"):
        out["assumed"] = sorted(
            (node, sorted((uid, (ns, name, sorted(req.items())))
                          for uid, (ns, name, req) in entries.items()))
            for node, entries in cache.assumed.items())
    for attr in ("foreign", "maybe_overreserved", "attr_changed"):
        if hasattr(cache, attr):
            out[attr] = sorted(getattr(cache, attr))
    if hasattr(cache, "reservations"):
        out["reservations"] = sorted(
            (node, sorted(uids)) for node, uids in cache.reservations.items())
    for attr in ("generation", "resync_period_ms", "_last_resync_ms",
                 "our_schedulers", "informer_mode", "resync_method",
                 "foreign_pods_detect"):
        if hasattr(cache, attr):
            value = getattr(cache, attr)
            out[attr] = sorted(value) if isinstance(value, set) else value
    view, stale = cache.view()
    out["view"] = [nrt_tuple(t) for t in view]
    out["stale"] = sorted(stale)
    return out


def zone_violations(snap, affine, host_level, assignment, order=None) -> int:
    """Host oracle of the single-numa-node constraint, independent of the
    solvers: replay the placements in `order` (default: queue order; the
    batched solve's commit order is (wave, queue)) with the pessimistic
    deduction (every placed pod's request leaves every reported zone of
    its node), and count the placed pods that found no zone fitting their
    request at their turn. Checked: pods on single-numa-node nodes whose
    filter takes the whole request at once (pod scope, or one container);
    a guaranteed pod needs every requested reported resource to fit, any
    other pod its non-NUMA-affine ones, a best-effort pod without an
    extended request nothing. `snap` holds numpy arrays (the snapshot's
    `numpy()`), `affine` / `host_level` the (R,) resource classes."""
    import numpy as np

    numa, pods = snap["numa"], snap["pods"]
    avail = numa["available"].astype(np.int64).copy()
    reported = numa["reported"] & numa["zone_mask"][:, :, None]
    req = pods["req"]
    n_cont = pods["container_mask"].sum(axis=1)
    a = np.asarray(assignment)
    P = a.shape[0]
    order = np.arange(P) if order is None else np.asarray(order)
    bad = 0
    for p in order:
        n = int(a[p])
        if n < 0:
            continue
        relevant = req[p] > 0
        has_affinity = reported[n].any(axis=0)
        constrain = relevant & ~(~has_affinity & host_level)
        guaranteed = pods["qos"][p] == 2
        if not guaranteed:
            constrain &= ~affine
        checked = (numa["has_nrt"][n] and numa["policy"][n] == 3
                   and (numa["scope"][n] == 1 or n_cont[p] == 1))
        if checked and constrain.any():
            ok_zone = np.all(~constrain[None, :] | (
                reported[n] & (avail[n] >= req[p][None, :])), axis=1)
            if not (ok_zone & numa["zone_mask"][n]).any():
                bad += 1
        avail[n][reported[n]] -= np.broadcast_to(
            req[p][None, :], avail[n].shape)[reported[n]]
    return bad
