"""PodDisruptionBudgets in the port's store and preemption against the JAX
package (mirrors tests/test_pdb.py, filterPodsWithPDBViolation semantics).

`PreemptionEngine.partition_pdb_violations` must split the same
candidates the same way in both packages (a budget spent per matching
candidate, names in `disrupted_pods` not counted again, an empty selector
matching nothing); a cycle whose preemption a PDB steers must equal JAX
`run_cycle` in every report field and in the store's bookkeeping, the
event ledger included (tolerance 0). The `pdb_script` flip (the same
script with and without the PDB nominates different nodes) is in
tests/test_torch_cycle.py."""

import pytest

from test_torch_cycle import (
    JAX,
    PORT,
    jax_package,  # noqa: F401 (fixture)
    mknode,
    mkpod,
    run_script,
    store_diff,
)

GIB = 1 << 30


def pdb(pkg, **kw):
    return pkg.o.PodDisruptionBudget(name="pdb", **kw)


def partition(pkg, budget, pods):
    """Both lists of `partition_pdb_violations` for `pods` ((name, labels)
    pairs, indexed in order) under the one PDB `budget`."""
    candidates = [(i, mkpod(pkg, name, labels=labels))
                  for i, (name, labels) in enumerate(pods)]
    return pkg.pre.PreemptionEngine.partition_pdb_violations(
        candidates, [budget])


WEB = {"app": "web"}
CASES = {
    # the first web pod spends the budget, the second violates, db is
    # not selected
    "budget_decrement": (
        dict(selector=WEB, disruptions_allowed=1),
        [("w1", WEB), ("w2", WEB), ("other", {"app": "db"})],
        ([1], [0, 2]),
    ),
    # a pod already being disrupted (by NAME) is not counted again
    "disrupted_not_recounted": (
        dict(selector=WEB, disruptions_allowed=0,
             disrupted_pods=frozenset({"w1"})),
        [("w1", WEB)],
        ([], [0]),
    ),
    # an empty selector matches nothing
    "empty_selector": (
        dict(disruptions_allowed=0),
        [("w1", WEB)],
        ([], [0]),
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_matches_jax(jax_package, case):  # noqa: F811
    kwargs, pods, want = CASES[case]
    got = partition(PORT, pdb(PORT, **kwargs), pods)
    assert got == partition(JAX, pdb(JAX, **kwargs), pods)
    assert got == want


def test_other_namespace_not_selected(jax_package):  # noqa: F811
    kwargs = dict(selector=WEB, disruptions_allowed=0, namespace="team-a")
    pods = [("w1", WEB)]
    assert partition(PORT, pdb(PORT, **kwargs), pods) == ([], [0])
    assert partition(JAX, pdb(JAX, **kwargs), pods) == ([], [0])


def prefers_node_without_violation(pkg):
    """tests/test_pdb.py TestPDBInCycle: node a hosts a victim a PDB with
    no budget guards; node b an unguarded victim of HIGHER priority. The
    first pickOneNode key, fewest PDB violations, outranks victim
    priority."""
    c = pkg.Cluster()
    for name in ("a", "b"):
        c.add_node(mknode(pkg, name, cpu=4000))
    c.add_pdb(pkg.o.PodDisruptionBudget(name="guard", selector=WEB,
                                        disruptions_allowed=0))
    c.add_pod(mkpod(pkg, "va", cpu=3500, mem=GIB, priority=1, node="a",
                    labels=WEB))
    c.add_pod(mkpod(pkg, "vb", cpu=3500, mem=GIB, priority=5, node="b"))
    c.add_pod(mkpod(pkg, "claimant", cpu=3500, mem=GIB, priority=10))
    sched = pkg.Scheduler(pkg.Profile(
        plugins=[pkg.plugins.NodeResourcesAllocatable()],
        preemption=pkg.pre.PreemptionEngine(pkg.pre.PreemptionMode.DEFAULT),
    ))
    return c, sched, [(1000, None), (2000, None)]


def test_prefers_node_without_violation(jax_package):  # noqa: F811
    _, (r1, _) = run_script(prefers_node_without_violation)
    assert r1.preempted == {"default/claimant": ("b", ["default/vb"])}


def test_add_pdb_notes_events_like_jax(jax_package):  # noqa: F811
    """Add, then update: PDB_ADD, then PDB_UPDATE, noted before the PDB is
    stored, with the same event counters as the JAX store."""
    stores = []
    for pkg in (JAX, PORT):
        c = pkg.Cluster()
        c.add_node(mknode(pkg, "n0"))
        c.add_pdb(pdb(pkg, selector=WEB, disruptions_allowed=1))
        c.add_pdb(pdb(pkg, selector=WEB, disruptions_allowed=2))
        c.add_pdb(pdb(pkg, selector=WEB, namespace="team-a"))
        stores.append(c)
    jc, pc = stores
    assert store_diff(jc, pc) == []
    assert pc.event_last == {"Node/Add": 1, "PodDisruptionBudget/Add": 4,
                             "PodDisruptionBudget/Update": 3}
    assert list(pc.pdbs) == list(jc.pdbs) == ["default/pdb", "team-a/pdb"]
    assert pc.pdbs["default/pdb"].disruptions_allowed == 2
