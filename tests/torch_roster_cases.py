"""Seeded problems of the rest of the plugin roster (SySched, PodState,
QOSSort, PreemptionToleration, CrossNodePreemption), shared by
`tests/test_torch_sysched.py` and `tests/test_torch_roster.py` (the port
against JAX) and `chip_smoke.py` (the card against the CPU).

Every builder takes either package's names in a namespace (`pkg.objects`
or `pkg.o`, `pkg.Cluster`, and for the scripts `pkg.Profile`,
`pkg.Scheduler`, `pkg.plugins`) and imports neither package itself.

- `roster_cluster` is the whole new roster's problem at any size (1,024
  nodes x 1,024 pending pods is `roster_1k`), loaded with the profile
  `ROSTER_PROFILE`; `add_preemptors` makes its second cycle;
  `roster_script` runs both cycles in the form of
  `tests/test_torch_cycle.py`'s scripts.
- `cross_node_script` is a small CrossNodePreemption cycle script.
- `sysched_reference_rows`, `toleration_violations` and
  `cross_node_outcomes` are host oracles independent of both solvers."""

from __future__ import annotations

GIB = 1 << 30
ZONE = "topology.kubernetes.io/zone"

#: the whole new roster in one profile, QOSSort first (the queue sort)
ROSTER_PROFILE = {"plugins": ["QOSSort", "NodeResourcesAllocatable",
                              "SySched", "PodState",
                              "PreemptionToleration"]}
#: the JAX package's metric roster (`__graft_entry__.py:176-181`)
METRIC_PROFILE = {"plugins": ["TargetLoadPacking",
                              "LoadVariationRiskBalancing",
                              "InterPodAffinity", "SySched"]}

#: syscall names: about the x86_64 table an all-syscalls profile lists;
#: synthetic, since SySched compares sets only
N_SYSCALLS = 360
SYSCALL_CORE = 40
PROFILE_NAMESPACES = ("team-a", "team-b", "team-c")
PROFILES_PER_NAMESPACE = 4
PROFILE_SIZES = (40, 301)
ALL_SYSCALLS = "all-syscalls"
#: the Security Profiles Operator's annotation on a pod
SPO_KEY = "container.seccomp.security.alpha.kubernetes.io/app"

#: the PriorityClasses: name, value, toleration-seconds (None = no
#: toleration annotations); the annotated ones tolerate preemptors below
#: MIN_PREEMPTABLE
MIN_PREEMPTABLE = 10_000
PRIORITY_CLASSES = (("pc-0", 0, None), ("pc-100", 100, 300),
                    ("pc-1000", 1000, -1), ("pc-10000", 10_000, None))
TOLERATION_PREFIX = "preemption-toleration.scheduling.x-k8s.io/"

#: node size and the pods' CPU requests (millicores): three bound pods use
#: at least 9,000 of a node's 16,000, so no node has MID_CPU free after
#: the first cycle without an eviction; a HIGH preemptor needs a node
#: nearly to itself
NODE_CPU = 16_000
BOUND_CPU = (3000, 4001)
PENDING_CPU = (500, 3001)
MID_PRIORITY, MID_CPU = 5000, 7500
HIGH_PRIORITY, HIGH_CPU = 20_000, 15_000

#: the two cycles' times: bound pods are created in the first 3.1 s and
#: the pending ones from 10 s, so at ROSTER_NOW[1] the 300 s window of
#: a bound pc-100 pod has passed and that of a pod placed by cycle 1 has
#: not
CREATED_PENDING = 10_000
ROSTER_NOW = (20_000, 305_000)


def _objects(pkg):
    return getattr(pkg, "objects", None) or pkg.o


def syscall_names(n: int = N_SYSCALLS) -> list:
    return [f"sys_{i:03d}" for i in range(n)]


def roster_cluster(pkg, n_nodes=1024, n_pods=1024, n_zones=16,
                   bound_per_node=3, seed=0, all_syscalls=True):
    """The roster problem: `n_nodes` identical nodes (16 cores, 64 GiB,
    110 pods) in `n_zones` zones; the N_SYSCALLS-name universe, 12
    SeccompProfile CRs in three namespaces of 40-300 syscalls each (a
    shared core of 40 plus a seeded draw; added first, so the universe's
    order is theirs) and, when `all_syscalls`, a `default/all-syscalls`
    CR of the whole universe; the four PRIORITY_CLASSES.

    `bound_per_node` bound pods a node, each naming a profile by
    "namespace/name" and taking the node's slot's class (slot 0
    pc-1000, slot 1 pc-100, slot 2 pc-0 or pc-10000), about 5 %
    terminating. `n_pods` pending pods from CREATED_PENDING ms, in equal
    shares by how they name their profile (a bare name, "ns/name", a
    localhost path, the SPO annotation, nothing: the all-syscalls
    fallback), every 7th also naming one from an init container and
    every 11th first an unresolvable one; QoS classes in thirds
    (Guaranteed, Burstable, BestEffort); a seeded class each; every
    16th nominated to a node."""
    import numpy as np

    o = _objects(pkg)
    rng = np.random.default_rng(seed)
    c = pkg.Cluster()
    for name, value, seconds in PRIORITY_CLASSES:
        annotations = {}
        if seconds is not None:
            annotations = {
                TOLERATION_PREFIX + "minimum-preemptable-priority":
                    str(MIN_PREEMPTABLE),
                TOLERATION_PREFIX + "toleration-seconds": str(seconds),
            }
        c.add_priority_class(o.PriorityClass(name=name, value=value,
                                             annotations=annotations))
    names = syscall_names()
    core = names[:SYSCALL_CORE]
    rest = names[SYSCALL_CORE:]
    profiles = []
    for ns in PROFILE_NAMESPACES:
        for k in range(PROFILES_PER_NAMESPACE):
            size = int(rng.integers(*PROFILE_SIZES))
            extra = rng.choice(len(rest), size - SYSCALL_CORE, replace=False)
            syscalls = frozenset(core) | frozenset(rest[i] for i in extra)
            c.add_seccomp_profile(o.SeccompProfile(
                name=f"prof-{k}", namespace=ns, syscalls=syscalls))
            profiles.append((ns, f"prof-{k}"))
    if all_syscalls:
        c.add_seccomp_profile(o.SeccompProfile(
            name=ALL_SYSCALLS, namespace="default",
            syscalls=frozenset(names)))

    node_names = []
    for i in range(n_nodes):
        name = f"node-{i:05d}"
        node_names.append(name)
        c.add_node(o.Node(name=name, labels={ZONE: f"zone-{i % n_zones}"},
                          allocatable={"cpu": NODE_CPU, "memory": 64 * GIB,
                                       "pods": 110}))

    def profile_ref():
        ns, name = profiles[int(rng.integers(0, len(profiles)))]
        return ns, name

    created = 0
    for i, node in enumerate(node_names):
        for slot in range(bound_per_node):
            cls = ("pc-1000", "pc-100")[slot] if slot < 2 else (
                "pc-0" if rng.random() < 0.5 else "pc-10000")
            value = dict((n, v) for n, v, _ in PRIORITY_CLASSES)[cls]
            ns, prof = profile_ref()
            pod = o.Pod(
                name=f"bound-{i:05d}-{slot}", namespace=ns,
                creation_ms=created, priority=value,
                priority_class_name=cls,
                containers=[o.Container(
                    requests={"cpu": int(rng.integers(*BOUND_CPU)),
                              "memory": GIB},
                    seccomp_profile=f"{ns}/{prof}")])
            pod.node_name = node
            if rng.random() < 0.05:
                pod.deletion_ms = 500
            c.add_pod(pod)
            created += 1

    for j in range(n_pods):
        ns = PROFILE_NAMESPACES[j % len(PROFILE_NAMESPACES)]
        own = [p for p in profiles if p[0] == ns]
        _, prof = own[int(rng.integers(0, len(own)))]
        other_ns, other = profile_ref()
        kind = j % 5
        ref, annotations = None, {}
        if kind == 0:
            ref = prof
        elif kind == 1:
            ref = f"{other_ns}/{other}"
        elif kind == 2:
            ref = f"operator/{other_ns}/{other}.json"
        elif kind == 3:
            annotations = {
                SPO_KEY: f"localhost/operator/{other_ns}/{other}.json"}
        cpu = int(rng.integers(*PENDING_CPU))
        qos = j % 3
        if qos == 0:  # Guaranteed
            req = {"cpu": cpu, "memory": GIB}
            lim = dict(req)
        elif qos == 1:  # Burstable
            req, lim = {"cpu": cpu, "memory": GIB}, {}
        else:  # BestEffort
            req, lim = {}, {}
        containers = []
        if j % 11 == 0:
            containers.append(o.Container(name="sidecar",
                                          seccomp_profile="no-such-profile"))
        containers.append(o.Container(name="app", requests=req, limits=lim,
                                      seccomp_profile=ref))
        init = []
        if j % 7 == 0:
            init_ns, init_prof = profile_ref()
            init = [o.Container(name="init",
                                seccomp_profile=f"{init_ns}/{init_prof}")]
        cls, value, _ = PRIORITY_CLASSES[int(rng.integers(0, 4))]
        pod = o.Pod(
            name=f"pod-{j:05d}", namespace=ns,
            creation_ms=CREATED_PENDING + j, priority=value,
            priority_class_name=cls, annotations=annotations,
            containers=containers, init_containers=init)
        if j % 16 == 0:
            pod.nominated_node_name = node_names[int(rng.integers(
                0, n_nodes))]
        c.add_pod(pod)
    return c


def add_preemptors(pkg, cluster, n_mid=32, n_high=4):
    """The second cycle's pods: `n_mid` Burstable preemptors at
    MID_PRIORITY needing MID_CPU, which the toleration policies stop
    short of the pc-1000 pods and of the pc-100 pods inside their
    window, and `n_high` at HIGH_PRIORITY needing HIGH_CPU, above every
    policy's MinimumPreemptablePriority."""
    o = _objects(pkg)
    created = ROSTER_NOW[0] + 1
    for kind, n, priority, cpu in (("mid", n_mid, MID_PRIORITY, MID_CPU),
                                   ("high", n_high, HIGH_PRIORITY,
                                    HIGH_CPU)):
        for j in range(n):
            cluster.add_pod(o.Pod(
                name=f"{kind}-{j:03d}", namespace=PROFILE_NAMESPACES[0],
                creation_ms=created, priority=priority,
                containers=[o.Container(
                    requests={"cpu": cpu, "memory": GIB},
                    seccomp_profile="prof-0")]))
            created += 1


def roster_scheduler(pkg, config=ROSTER_PROFILE):
    """A scheduler of `config`'s plugins, built from `pkg.plugins` at
    their defaults."""
    return pkg.Scheduler(pkg.Profile(plugins=[
        getattr(pkg.plugins, name)() for name in config["plugins"]]))


def roster_script(pkg, n_nodes=32, n_pods=64, n_mid=4, n_high=1, seed=0):
    """Two cycles of `roster_cluster` (at ROSTER_NOW), the preemptors of
    `add_preemptors` added before the second: (cluster, scheduler,
    [(now, mutate or None)])."""
    c = roster_cluster(pkg, n_nodes=n_nodes, n_pods=n_pods, seed=seed)

    def preemptors(pkg, cluster):
        add_preemptors(pkg, cluster, n_mid=n_mid, n_high=n_high)

    return c, roster_scheduler(pkg), [(ROSTER_NOW[0], None),
                                      (ROSTER_NOW[1], preemptors)]


# --- oracles -----------------------------------------------------------------

def resolve_syscalls(cluster, pod):
    """The pod's syscall set as a Python set, or None when it resolves
    no profile: container then init-container references (bare names in
    the pod's namespace, "ns/name", or a localhost path whose last two
    segments name the CR), the first SPO annotation in sorted key order,
    else the store's default profile when it exists and is not empty
    (sysched.go:124-210)."""
    profiles = cluster.seccomp_profiles

    def lookup(ref):
        if not ref:
            return None
        if ref.count("/") >= 2 or ref.endswith(".json"):
            parts = ref.split("/")
            if len(parts) < 2:
                return None
            ref = f"{parts[-2]}/{parts[-1].rsplit('.', 1)[0]}"
        elif "/" not in ref:
            ref = f"{pod.namespace}/{ref}"
        return profiles.get(ref)

    out, found = set(), False
    for cont in list(pod.containers) + list(pod.init_containers):
        prof = lookup(cont.seccomp_profile)
        if prof is not None:
            found = True
            out |= set(prof.syscalls)
    spo = [k for k in sorted(pod.annotations)
           if "seccomp.security.alpha.kubernetes.io" in k]
    if spo:
        prof = lookup(pod.annotations[spo[0]])
        if prof is not None:
            found = True
            out |= set(prof.syscalls)
    default = getattr(cluster, "sysched_default_profile", None)
    if not found and default in profiles and profiles[default].syscalls:
        return set(profiles[default].syscalls)
    return out if found else None


def sysched_reference_rows(cluster, pending, rows, node_names):
    """SySched's raw scores of the pending pods `rows`, straight from the
    reference formula over Python sets (sysched.go:234-279): on a node
    hosting pods, |host - pod| + the sum over those pods p of
    |(host ∪ pod) - p|, host being the union of their sets; 0 on an
    empty node; 2^53 everywhere for a pod with no profile. Bound and
    reserved pods are the node's. Returns a list of lists of ints."""
    on_node = {}
    for p in cluster.pods.values():
        name = p.node_name or cluster.reserved.get(p.uid)
        if name is not None:
            on_node.setdefault(name, []).append(
                resolve_syscalls(cluster, p) or set())
    out = []
    for i in rows:
        pod_set = resolve_syscalls(cluster, pending[i])
        row = []
        for name in node_names:
            sets = on_node.get(name, [])
            if pod_set is None:
                row.append(2 ** 53)
                continue
            if not sets:
                row.append(0)
                continue
            host = set().union(*sets)
            new_host = host | pod_set
            row.append(len(host - pod_set)
                       + sum(len(new_host - s) for s in sets))
        out.append(row)
    return out


def _exempt(cluster, victim, preemptor, now_ms) -> bool:
    """The toleration policy of the victim's PriorityClass spares it from
    the preemptor at now_ms (preemption_toleration.go:129-181)."""
    pc = cluster.priority_classes.get(victim.priority_class_name)
    if pc is None:
        return False
    try:
        floor = int(pc.annotations[TOLERATION_PREFIX
                                   + "minimum-preemptable-priority"])
        seconds = int(pc.annotations.get(
            TOLERATION_PREFIX + "toleration-seconds", 0))
    except (KeyError, ValueError):
        return False
    if preemptor.priority >= floor:
        return False
    return seconds < 0 or victim.creation_ms + seconds * 1000 > now_ms


def toleration_outcomes(cluster, preempted: dict, now_ms: int) -> dict:
    """Counts of a cycle's preemptions (`CycleReport.preempted`) against
    the toleration policies at `now_ms`: `evicted` victims, `violations`
    (a victim its policy spares from its preemptor), `overridden` (a
    victim a preemptor below MIN_PREEMPTABLE could not have taken),
    and `spared`, the bound lower-priority pods the policies keep from a
    MID_PRIORITY preemptor."""
    probe = type("Probe", (), {"priority": MID_PRIORITY})()
    out = dict.fromkeys(("evicted", "violations", "overridden"), 0)
    for uid, (_, victims) in preempted.items():
        preemptor = cluster.pods[uid]
        for v in victims:
            victim = cluster.pods[v]
            out["evicted"] += 1
            out["violations"] += _exempt(cluster, victim, preemptor, now_ms)
            out["overridden"] += _exempt(cluster, victim, probe, now_ms)
    out["spared"] = sum(
        1 for p in cluster.pods.values()
        if p.node_name is not None and p.priority < MID_PRIORITY
        and not p.terminating and _exempt(cluster, p, probe, now_ms))
    return out


def cross_node_script(pkg):
    """Three cycles of NodeResourcesAllocatable + CrossNodePreemption
    (max_pool 12) over 12 lower-priority pods on four nodes, so the
    search runs all 4,096 subsets of the pool. Cycle 1: `small` (1,400m)
    takes the single lowest-priority victim that frees enough (node a's
    v-a2, not the two-pod subset), `big` (3,000m) a whole-node victim on
    c, not the PodDisruptionBudget-guarded one on b, `wide` (6,500m, more
    than one node holds) nothing. Cycle 2, the victims still
    terminating: the nominees wait. Cycle 3, the victims gone: both
    bind on their nominated nodes."""
    o = _objects(pkg)
    c = pkg.Cluster()
    for name in ("a", "b", "c", "d"):
        c.add_node(o.Node(name=name, allocatable={
            "cpu": 4000, "memory": 32 * GIB, "pods": 110}))
    c.add_pdb(o.PodDisruptionBudget(name="guard",
                                    selector={"app": "guarded"},
                                    disruptions_allowed=0))

    def pod(name, cpu, priority, node=None, labels=None, created=0):
        p = o.Pod(name=name, priority=priority, labels=labels or {},
                  creation_ms=created,
                  containers=[o.Container(requests={"cpu": cpu,
                                                    "memory": GIB})])
        p.node_name = node
        return p

    bound = [("v-a1", 1500, 5, "a"), ("v-a2", 1500, 1, "a"),
             ("v-b", 3000, 2, "b"), ("v-c", 3000, 2, "c")]
    bound += [(f"v-d{k}", 400, 3 + k % 3, "d") for k in range(8)]
    for k, (name, cpu, priority, node) in enumerate(bound):
        c.add_pod(pod(name, cpu, priority, node=node, created=k,
                      labels={"app": "guarded"} if name == "v-b" else None))
    c.add_pod(pod("small", 1400, 10, created=100))
    c.add_pod(pod("big", 3000, 10, created=101))
    c.add_pod(pod("wide", 6500, 10, created=102))

    def evict(pkg, cluster):
        for uid in [u for u, p in cluster.pods.items() if p.terminating]:
            cluster.remove_pod(uid)

    sched = pkg.Scheduler(pkg.Profile(plugins=[
        pkg.plugins.NodeResourcesAllocatable(),
        pkg.plugins.CrossNodePreemption(max_pool=12)]))
    return c, sched, [(1000, None), (2000, None), (3000, evict)]
