"""Multi-cycle scripts for the port's `run_cycle`, shared by
`tests/test_torch_cycle.py` (against JAX `run_cycle`, at 16 nodes) and
`chip_smoke.py` (card against CPU, at 1024 nodes).

They build from either package's `objects` module and `Cluster` class and
import neither package itself. `script_outcomes` names what `cycle_script`
is built to reach; `pdb_script` extends it by one preemption that a
PodDisruptionBudget steers. The comparisons stay with each caller."""

from __future__ import annotations

#: Coscheduling arguments of `cycle_script`'s profile: a short Permit
#: wait, a gang backoff, and a reject slack that keeps a gang with one
#: failed member of three waiting
SCRIPT_COSCHED = dict(permit_waiting_seconds=5, pod_group_backoff_seconds=10,
                      reject_percentage=50)


def cycle_script(objects, cluster_cls, n_nodes: int = 1024):
    """A multi-cycle script for `run_cycle` with the flagship profile
    (`SCRIPT_COSCHED`), built from either package's `objects` module and
    `Cluster` class. Returns (cluster, steps): steps are (now, mutate or
    None), `mutate(objects, cluster)` applied just before that cycle.

    Every node has 2000 millicores free (a priority-100 resident fills the
    rest; on node-0000 two team-b pods hold 3000, over team-b's quota Min).
    Gang ga (3 members, one of 3000 millicores) waits on two reservations
    until a small node arrives at t=3000 and its third member binds, which
    releases the other two (fan-out); until then the failed member is
    parked and skipped (t=2000). Gang gb's third member fits nowhere, so
    its reservations time out at t=6500. Gang gc (3 of 4 members fit
    nowhere) is rejected whole and backed off. At t=8000 a team-a pod of
    3000 millicores preempts team-b's pods on node-0000 (CAPACITY mode: a
    claimant within its Min preys on namespaces over theirs), stays
    nominated while they terminate, and binds there once they are removed
    at t=10000."""
    o = objects
    gib = 1 << 30
    cluster = cluster_cls()

    def pod(name, cpu, ns="default", node=None, priority=0, created=0,
            gang=None):
        return o.Pod(
            name=name, namespace=ns, node_name=node, priority=priority,
            creation_ms=created,
            labels={o.POD_GROUP_LABEL: gang} if gang else {},
            containers=[o.Container(requests={"cpu": cpu, "memory": gib})],
        )

    for i in range(n_nodes):
        cluster.add_node(o.Node(name=f"node-{i:04d}", allocatable={
            "cpu": 64_000, "memory": 256 * gib, "pods": 256}))
    for ns, min_cpu in (("team-a", 50_000), ("team-b", 1000)):
        cluster.add_quota(o.ElasticQuota(
            name=f"eq-{ns}", namespace=ns,
            min={"cpu": min_cpu, "memory": 1 << 42},
            max={"cpu": 100_000, "memory": 1 << 44}))
    for i in range(n_nodes):
        cluster.add_pod(pod(f"resident-{i:04d}", 59_000 if i == 0 else 62_000,
                            node=f"node-{i:04d}", priority=100, created=-1))
    for j in (1, 2):
        cluster.add_pod(pod(f"b{j}", 1500, ns="team-b", node="node-0000",
                            created=j))
    for gang, min_member, cpus in (("ga", 3, (1500, 1500, 3000)),
                                   ("gb", 3, (1500, 1500, 100_000)),
                                   ("gc", 4, (1500,) + (100_000,) * 3)):
        cluster.add_pod_group(o.PodGroup(name=gang, min_member=min_member))
        for m, cpu in enumerate(cpus):
            cluster.add_pod(pod(f"{gang}-m{m}", cpu, created=m, gang=gang))

    def add_small_node(o, cluster):
        cluster.add_node(o.Node(name="node-extra", allocatable={
            "cpu": 3000, "memory": 16 * gib, "pods": 16}))

    def add_claimant(o, cluster):
        cluster.add_pod(pod("a1", 3000, ns="team-a", priority=10,
                            created=8000))

    def finish_terminations(o, cluster):
        for uid in [u for u, p in cluster.pods.items() if p.terminating]:
            cluster.remove_pod(uid)

    steps = [(1000, None), (2000, None), (3000, add_small_node),
             (6500, None), (8000, add_claimant), (9000, None),
             (10_000, finish_terminations)]
    return cluster, steps


def script_outcomes(reports) -> list:
    """The outcomes `cycle_script` is built to reach, as failed checks
    (empty when all hold)."""
    r = reports
    ga = [f"default/ga-m{m}" for m in range(3)]
    checks = {
        "ga waits": set(ga[:2]) <= set(r[0].reserved),
        "gc rejected": r[0].rejected_gangs == ["default/gc"],
        "parked ga-m2 skipped": ("default/ga-m2" in r[1].skipped
                                 and r[1].quality is None),
        "ga fan-out bind": set(ga) <= set(r[2].bound),
        "gb permit timeout": r[3].expired_gangs == ["default/gb"],
        "a1 preempts": "team-a/a1" in r[4].preempted,
        "a1 binds where nominated": (
            "team-a/a1" in r[4].preempted
            and r[6].bound.get("team-a/a1") == r[4].preempted["team-a/a1"][0]),
    }
    return [name for name, ok in checks.items() if not ok]


def pdb_script(objects, cluster_cls, n_nodes: int = 1024,
               guard: bool = True):
    """`cycle_script` extended by one cycle at t=12000, just before which
    two nodes of 8000 millicores arrive, each with one bound victim of
    6000: "web" (priority 1, app=web) on pdb-a and "batch" (priority 5) on
    pdb-b; a PodDisruptionBudget with no disruptions allowed selects
    app=web when `guard`; and a claimant of 5000 millicores and priority
    10 that fits nowhere else. Without the PDB the lower victim priority
    nominates pdb-a; with it, fewest PDB violations (the first key)
    nominates pdb-b. Returns (cluster, steps) as `cycle_script`."""
    cluster, steps = cycle_script(objects, cluster_cls, n_nodes)
    gib = 1 << 30

    def add_guarded_victims(o, cluster):
        for node, victim, priority, labels in (
                ("pdb-a", "web", 1, {"app": "web"}),
                ("pdb-b", "batch", 5, {})):
            cluster.add_node(o.Node(name=node, allocatable={
                "cpu": 8000, "memory": 64 * gib, "pods": 16}))
            cluster.add_pod(o.Pod(
                name=victim, node_name=node, priority=priority,
                creation_ms=11_000, labels=labels,
                containers=[o.Container(requests={"cpu": 6000,
                                                  "memory": gib})]))
        if guard:
            cluster.add_pdb(o.PodDisruptionBudget(
                name="web-pdb", selector={"app": "web"},
                disruptions_allowed=0))
        cluster.add_pod(o.Pod(
            name="urgent", priority=10, creation_ms=11_500,
            containers=[o.Container(requests={"cpu": 5000,
                                              "memory": gib})]))

    return cluster, steps + [(12_000, add_guarded_victims)]


def pdb_nomination(reports):
    """(node, victims) the last cycle of `pdb_script` nominated for its
    claimant, or None."""
    return reports[-1].preempted.get("default/urgent")
