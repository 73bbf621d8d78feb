"""Seeded in-tree plugin problems shared by `tests/test_torch_intree.py`
(the port against JAX) and `chip_smoke.py` (the card against the CPU).

`intree_case(name, pkg, seed)` builds a case's cluster with either
package's objects (`pkg.objects`, `pkg.Cluster`, `pkg.scenarios`) and
returns it with the profile configuration each package loads with its own
`api.config.load_profile`; it imports neither package itself.
`intree_cluster` is the in-tree roster problem at any size (1,024 nodes x
1,024 pending pods is `intree_1k`); `intree_preemption_script(pkg)` is a
cycle script in the form of `tests/test_torch_cycle.py`'s (`pkg.o`,
`pkg.Cluster`, `pkg.Profile`, `pkg.Scheduler`, `pkg.plugins`,
`pkg.pre`). `intree_violations` is the host oracle of the four plugins'
hard constraints and the built-in fit, independent of both solvers."""

from __future__ import annotations

GIB = 1 << 30
ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"
HOST = "kubernetes.io/hostname"
#: the NoSchedule taint the node-affinity pods tolerate
DEDICATED = "dedicated"

#: the JAX package's full-roster mixed profile (`tools/tpu_lower.py`,
#: `__graft_entry__.py`)
MIXED = {"plugins": ["NodeResourcesAllocatable", "NodeResourceTopologyMatch",
                     "NetworkOverhead", "PodTopologySpread"]}
#: the in-tree roster
INTREE = {"plugins": ["NodeResourcesAllocatable", "NodeAffinity",
                      "TaintToleration", "PodTopologySpread",
                      "InterPodAffinity"]}

#: the cases, each solved by both packages
CASES = ("mixed_small", "intree_small", "intree_tight", "intree_args")

#: the namespaces and their tier labels
NAMESPACES = (("prod-a", "prod"), ("prod-b", "prod"), ("dev", "dev"))
N_APPS = 8


def intree_cluster(pkg, n_nodes=1024, n_pods=1024, n_bound=256, seed=0,
                   n_zones=16, n_regions=4, cpu_cores=(16, 65),
                   pod_millis=(250, 2001)):
    """The in-tree roster problem: `n_nodes` nodes in `n_regions` regions
    of `n_zones` zones (round-robin), each with its hostname label and
    `disk=ssd|hdd` (half each), 10 % with a `dedicated` NoSchedule taint
    and 10 % a PreferNoSchedule one, `cpu_cores` cores; three namespaces
    labelled `tier=prod|dev`; `n_bound` bound pods over N_APPS `app`
    labels; and `n_pods` pending pods of four kinds in turn:

    - spread: a zone DoNotSchedule constraint (maxSkew 2, nodeTaintsPolicy
      Honor) and a hostname ScheduleAnyway one over its own app;
    - anti-affinity: a required hostname anti-affinity against its own
      app, and a preferred zone affinity toward another app in the
      namespaces labelled `tier=prod` (weight 1-100);
    - node affinity: required `disk In (ssd)`, a preferred region term of
      weight 30, and a toleration of the `dedicated` NoSchedule taint;
    - region affinity: a required region affinity toward another app,
      and a preferred zone anti-affinity (weight 20) against its own.

    Requests are `pod_millis` CPU millicores and 1 GiB; priorities 0-9."""
    import numpy as np

    o = pkg.objects
    rng = np.random.default_rng(seed)
    c = pkg.Cluster()
    for name, tier in NAMESPACES:
        c.add_namespace(o.Namespace(name=name, labels={"tier": tier}))
    names = []
    for i in range(n_nodes):
        name = f"node-{i:05d}"
        names.append(name)
        taints = []
        u = float(rng.random())
        if u < 0.1:
            taints.append(o.Taint(key=DEDICATED, value="batch",
                                  effect="NoSchedule"))
        elif u < 0.2:
            taints.append(o.Taint(key="spot", value="true",
                                  effect="PreferNoSchedule"))
        cores = int(rng.integers(*cpu_cores))
        c.add_node(o.Node(
            name=name,
            labels={ZONE: f"zone-{i % n_zones}",
                    REGION: f"region-{i % n_zones % n_regions}",
                    HOST: name, "disk": "ssd" if i % 2 == 0 else "hdd"},
            taints=taints,
            allocatable={"cpu": cores * 1000, "memory": 4 * cores * GIB,
                         "pods": 110}))

    def app(k):
        return f"app-{k % N_APPS}"

    def selector(a):
        return o.LabelSelector(match_labels={"app": a})

    def pod(name, ns, a, created, **kw):
        return o.Pod(
            name=name, namespace=ns, creation_ms=created,
            priority=int(rng.integers(0, 10)), labels={"app": a},
            containers=[o.Container(requests={
                "cpu": int(rng.integers(*pod_millis)), "memory": GIB})],
            **kw)

    for j in range(n_bound):
        ns = NAMESPACES[j % len(NAMESPACES)][0]
        bound = pod(f"bound-{j:04d}", ns, app(int(rng.integers(0, N_APPS))),
                    j)
        bound.node_name = names[int(rng.integers(0, n_nodes))]
        c.add_pod(bound)
    for j in range(n_pods):
        ns = NAMESPACES[int(rng.integers(0, len(NAMESPACES)))][0]
        a = app(int(rng.integers(0, N_APPS)))
        other = app(int(rng.integers(0, N_APPS)))
        kind = j % 4
        kw = {}
        if kind == 0:
            kw["topology_spread"] = [
                o.TopologySpreadConstraint(
                    max_skew=2, topology_key=ZONE, label_selector=selector(a),
                    node_taints_policy="Honor"),
                o.TopologySpreadConstraint(
                    max_skew=1, topology_key=HOST,
                    when_unsatisfiable="ScheduleAnyway",
                    label_selector=selector(a)),
            ]
        elif kind == 1:
            kw["pod_anti_affinity_required"] = [o.PodAffinityTerm(
                topology_key=HOST, label_selector=selector(a))]
            kw["pod_affinity_preferred"] = [o.WeightedPodAffinityTerm(
                weight=int(rng.integers(1, 101)), term=o.PodAffinityTerm(
                    topology_key=ZONE, label_selector=selector(other),
                    namespace_selector=o.LabelSelector(
                        match_labels={"tier": "prod"})))]
        elif kind == 2:
            kw["node_affinity_required"] = [o.NodeSelectorTerm(
                match_expressions=[o.NodeSelectorRequirement(
                    key="disk", operator="In", values=("ssd",))])]
            kw["node_affinity_preferred"] = [o.PreferredSchedulingTerm(
                weight=30, preference=o.NodeSelectorTerm(
                    match_expressions=[o.NodeSelectorRequirement(
                        key=REGION, operator="In",
                        values=(f"region-{int(rng.integers(0, n_regions))}",
                                ))]))]
            kw["tolerations"] = [o.Toleration(
                key=DEDICATED, operator="Exists", effect="NoSchedule")]
        else:
            kw["pod_affinity_required"] = [o.PodAffinityTerm(
                topology_key=REGION, label_selector=selector(other))]
            kw["pod_anti_affinity_preferred"] = [o.WeightedPodAffinityTerm(
                weight=20, term=o.PodAffinityTerm(
                    topology_key=ZONE, label_selector=selector(a)))]
        c.add_pod(pod(f"pod-{j:05d}", ns, a, 10_000 + j, **kw))
    return c


def intree_case(name: str, pkg, seed: int = 0):
    """(cluster, profile config) of the case `name` (see `CASES`):

    - `mixed_small`: the JAX package's `mixed_scenario` cut to 64 nodes x
      128 pods under the full-roster profile (MIXED);
    - `intree_small`: `intree_cluster` cut to 64 nodes x 128 pending and
      32 bound pods (INTREE);
    - `intree_tight`: 24 smaller nodes (4-8 cores), 96 pending pods of
      up to 3 cores and 24 bound: pods fail capacity and the Filters;
    - `intree_args`: `intree_small` with NodeAffinity's addedAffinity
      (the wire form: `disk In (ssd)` or a named node) and
      InterPodAffinity's hardPodAffinityWeight 7 and
      ignorePreferredTermsOfExistingPods, weights [1, 2, 1, 3, 2]."""
    if name == "mixed_small":
        return pkg.scenarios.mixed_scenario(64, 128, seed=seed), MIXED
    if name == "intree_small":
        return intree_cluster(pkg, 64, 128, 32, seed=seed), INTREE
    if name == "intree_tight":
        return intree_cluster(pkg, 24, 96, 24, seed=seed, cpu_cores=(4, 9),
                              pod_millis=(500, 3001)), INTREE
    if name == "intree_args":
        return intree_cluster(pkg, 64, 128, 32, seed=seed), {
            **INTREE,
            "pluginConfig": [
                {"name": "NodeAffinity", "args": {"addedAffinity": [
                    {"match_expressions": [{"key": "disk", "operator": "In",
                                            "values": ["ssd"]}]},
                    {"match_fields": [{"key": "metadata.name",
                                       "operator": "In",
                                       "values": ["node-00003"]}]},
                ]}},
                {"name": "InterPodAffinity", "args": {
                    "hardPodAffinityWeight": 7,
                    "ignorePreferredTermsOfExistingPods": True}},
            ],
            "weights": [1, 2, 1, 3, 2],
        }
    raise KeyError(name)


def intree_preemption_script(pkg):
    """Three cycles of the in-tree roster with DEFAULT preemption on two
    nodes of zone z-a (4 cores each): n0 holds the low-priority `db-0`
    (app=db, 3.5 cores), n1 a priority-5 filler of 3.5 cores.

    - cycle 1: `claimant` (priority 10, 3 cores) with a required zone
      anti-affinity against app=db fails: db-0 blocks the whole zone,
      and n1 lacks the cores. Preemption must look past the current
      Filter verdict: on n0, evicting db-0 frees the zone AND the cores
      (the post-eviction re-filter passes); on n1 evicting the filler
      frees the cores but db-0 still blocks the zone. So n0 is
      nominated with db-0 as its victim;
    - before cycle 2 the victim is deleted; cycle 2 binds the claimant
      to n0;
    - cycle 3: `db-1` (app=db, priority 20, half a core) fails: the
      claimant now blocks the zone through its own anti term (the
      symmetry), on both nodes. Only evicting the claimant lifts the
      block, so n0 is nominated with the claimant as its victim."""
    o = pkg.o
    c = pkg.Cluster()
    for name in ("n0", "n1"):
        c.add_node(o.Node(name=name, labels={ZONE: "z-a", HOST: name},
                          allocatable={"cpu": 4000, "memory": 32 * GIB,
                                       "pods": 110}))

    def pod(name, cpu, priority=0, created=0, labels=None, node=None, **kw):
        p = o.Pod(name=name, priority=priority, creation_ms=created,
                  labels=labels or {}, containers=[o.Container(
                      requests={"cpu": cpu, "memory": GIB})], **kw)
        p.node_name = node
        return p

    c.add_pod(pod("db-0", 3500, priority=1, labels={"app": "db"},
                  node="n0"))
    c.add_pod(pod("fill-1", 3500, priority=5, node="n1"))
    anti = o.PodAffinityTerm(
        topology_key=ZONE,
        label_selector=o.LabelSelector(match_labels={"app": "db"}))
    c.add_pod(pod("claimant", 3000, priority=10, created=10,
                  labels={"app": "web"}, pod_anti_affinity_required=[anti]))
    plugins = pkg.plugins
    sched = pkg.Scheduler(pkg.Profile(
        plugins=[plugins.NodeResourcesAllocatable(), plugins.NodeAffinity(),
                 plugins.TaintToleration(), plugins.PodTopologySpread(),
                 plugins.InterPodAffinity()],
        preemption=pkg.pre.PreemptionEngine(pkg.pre.PreemptionMode.DEFAULT)))

    def evict(pkg, cluster):
        for uid in [u for u, p in cluster.pods.items() if p.terminating]:
            cluster.remove_pod(uid)

    def db1(pkg, cluster):
        cluster.add_pod(pod("db-1", 500, priority=20, created=20,
                            labels={"app": "db"}))

    return c, sched, [(1000, None), (2000, evict), (3000, db1)]


# --- the host oracle ------------------------------------------------------------

def _sel_matches(selector, scope, pod) -> bool:
    if "*" not in scope and pod.namespace not in scope:
        return False
    return selector is not None and selector.matches(pod.labels)


def _term_scope(pod, term, namespaces) -> tuple:
    scope = set(term.namespaces)
    sel = term.namespace_selector
    if sel is not None:
        if not sel.match_labels and not sel.match_expressions:
            return ("*",)
        scope.update(ns.name for ns in namespaces if sel.matches(ns.labels))
    elif not scope:
        scope = {pod.namespace}
    return tuple(scope)


def _node_filter_ok(pod, node) -> bool:
    if any(node.labels.get(k) != v for k, v in pod.node_selector.items()):
        return False
    return not pod.node_affinity_required or any(
        t.matches(node) for t in pod.node_affinity_required)


def _taints_ok(pod, node) -> bool:
    return all(any(t.tolerates(taint) for t in pod.tolerations)
               for taint in node.taints
               if taint.effect in ("NoSchedule", "NoExecute"))


def _spread_selector(o_selector, pod, tsc):
    """The constraint's selector with matchLabelKeys merged in, as a
    predicate over pods (None matches nothing)."""
    if o_selector is None:
        return lambda other: False
    extra = {k: pod.labels[k] for k in tsc.match_label_keys
             if k in pod.labels}
    return lambda other: (o_selector.matches(other.labels) and all(
        other.labels.get(k) == v for k, v in extra.items()))


def intree_violations(cluster, pending, assignment, node_names,
                      wave_of=None) -> dict:
    """Host oracle of the hard constraints of NodeAffinity,
    TaintToleration, PodTopologySpread (DoNotSchedule) and
    InterPodAffinity, and of the built-in fit, independent of the
    solvers: the placements of the `pending` pods are replayed one at a
    time on top of the store's bound and reserved pods, in queue order, or
    with `wave_of` (the batched solve's wave of each pod) by wave and then
    queue order (the batched solve re-checks each wave's winners in queue
    order against the earlier ones). Each placed pod is checked against
    the pods placed before it, from the objects' labels, taints and
    terms. Returns the count of placed pods that broke each rule:
    `fit`, `node_affinity`, `taints`, `spread`, `affinity`, `anti` (the
    pod's own anti terms) and `symmetry` (an earlier pod's anti term)."""
    nodes = list(cluster.nodes.values())
    namespaces = list(cluster.namespaces.values())
    placed = []  # (pod, node)
    used = {}
    for pod in cluster.pods.values():
        name = pod.node_name or cluster.reserved.get(pod.uid)
        if name in cluster.nodes:
            placed.append((pod, cluster.nodes[name]))
    for pod, node in placed:
        u = used.setdefault(node.name, {"pods": 0})
        u["pods"] += 1
        for r, q in pod.effective_request().items():
            u[r] = u.get(r, 0) + q
    order = [i for i in range(len(pending)) if int(assignment[i]) >= 0]
    if wave_of is not None:
        order.sort(key=lambda i: (int(wave_of[i]), i))
    bad = dict.fromkeys(("fit", "node_affinity", "taints", "spread",
                         "affinity", "anti", "symmetry"), 0)
    for i in order:
        pod = pending[i]
        node = cluster.nodes[node_names[int(assignment[i])]]
        # the built-in fit
        u = used.setdefault(node.name, {"pods": 0})
        u["pods"] += 1
        for r, q in pod.effective_request().items():
            u[r] = u.get(r, 0) + q
        bad["fit"] += any(u.get(r, 0) > q
                          for r, q in node.allocatable.items())
        bad["node_affinity"] += not _node_filter_ok(pod, node)
        bad["taints"] += not _taints_ok(pod, node)
        bad["spread"] += not _spread_ok(pod, node, nodes, placed)
        for term in pod.pod_affinity_required:
            bad["affinity"] += not _affinity_ok(pod, term, node, placed,
                                                namespaces)
        for term in pod.pod_anti_affinity_required:
            key = term.topology_key
            scope = _term_scope(pod, term, namespaces)
            bad["anti"] += key in node.labels and any(
                other_node.labels.get(key) == node.labels[key]
                and _sel_matches(term.label_selector, scope, other)
                for other, other_node in placed)
        bad["symmetry"] += any(
            key in node.labels and other_node.labels.get(key)
            == node.labels[key] and _sel_matches(
                term.label_selector, _term_scope(other, term, namespaces),
                pod)
            for other, other_node in placed
            for term in other.pod_anti_affinity_required
            for key in (term.topology_key,))
        placed.append((pod, node))
    return bad


def _affinity_ok(pod, term, node, placed, namespaces) -> bool:
    key = term.topology_key
    if key not in node.labels:
        return False
    scope = _term_scope(pod, term, namespaces)
    matching = [other_node for other, other_node in placed
                if key in other_node.labels
                and _sel_matches(term.label_selector, scope, other)]
    if any(n.labels[key] == node.labels[key] for n in matching):
        return True
    # the first-pod escape: nobody matches, and the pod matches its term
    return not matching and _sel_matches(term.label_selector, scope, pod)


def _spread_ok(pod, node, nodes, placed) -> bool:
    hard = [t for t in pod.topology_spread
            if t.when_unsatisfiable == "DoNotSchedule"]
    hard_keys = [t.topology_key for t in hard]
    for tsc in hard:
        key = tsc.topology_key
        if key not in node.labels:
            return False
        eligible = [
            n for n in nodes
            if all(k in n.labels for k in hard_keys)
            and (tsc.node_affinity_policy == "Ignore"
                 or _node_filter_ok(pod, n))
            and (tsc.node_taints_policy != "Honor" or _taints_ok(pod, n))]
        matches = _spread_selector(tsc.label_selector, pod, tsc)
        elig_names = {n.name for n in eligible}
        counts = {n.labels[key]: 0 for n in eligible}
        for other, other_node in placed:
            if (other_node.name in elig_names
                    and other.namespace == pod.namespace and matches(other)):
                counts[other_node.labels[key]] += 1
        if not counts:
            continue  # no eligible domain: the skew check passes
        minimum = min(counts.values())
        if tsc.min_domains and len(counts) < tsc.min_domains:
            minimum = 0
        own = counts.get(node.labels[key], 0)
        if own + int(matches(pod)) - minimum > tsc.max_skew:
            return False
    return True
