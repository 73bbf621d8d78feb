"""The port's quality gauges (`tuning/quality.py`: `placed_demand`,
`fragmentation`, `packed_utilization`, `util_imbalance`, `cycle_quality`,
`cycle_quality_np`) and hard-constraint oracles (`tuning/gates.py`)
against the JAX package's, on `tests/test_tuning.py`'s tables: the
round-number two-node cluster with its fixed placements (fragmentation,
imbalance, unplaced and gang-wait fractions, packed utilization with both,
one and no node occupied), its gate cases (a fit overflow, an
out-of-range node, the flagship solve of a gang / quota roster and a lone
gang member), plus seeded random clusters.

Tolerances: every gauge of the tables is compared bit for bit. On the
random clusters `util_imbalance` sums non-integer per-node utilizations,
whose float64 sum depends on the reduction order (XLA's and torch's
differ), so it is held to 1e-12 relative there; the other gauges sum
exact integers below 2^53 and stay bit-equal. Gate counts are integers:
tolerance 0."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.models import (
    gang_quota_scenario as port_gang_quota,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.tuning import gates as t_gates
from scheduler_plugins_tpu_torch.tuning import quality as t_quality

try:
    import jax.numpy as jnp

    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.plugins as jax_plugins
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.models import (
        gang_quota_scenario as jax_gang_quota,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    from scheduler_plugins_tpu.tuning import gates as j_gates
    from scheduler_plugins_tpu.tuning import quality as j_quality
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    jax_objects = None

GIB = 1 << 30
PORT = SimpleNamespace(o=port_objects, Cluster=PCluster, plugins=port_plugins,
                       Profile=PProfile, Scheduler=PScheduler,
                       gang_quota=port_gang_quota,
                       snap=lambda c, pend: c.snapshot(pend, now_ms=0,
                                                       device="cpu"))
JAX = None if jax_objects is None else SimpleNamespace(
    o=jax_objects, Cluster=JCluster, plugins=jax_plugins, Profile=JProfile,
    Scheduler=JScheduler, gang_quota=jax_gang_quota,
    snap=lambda c, pend: c.snapshot(pend, now_ms=0))


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def tiny_cluster(pkg):
    """`tests/test_tuning.py` `_tiny_cluster`: 2 nodes x 3 pods of round
    numbers."""
    cluster = pkg.Cluster()
    for name, cpu in (("n0", 1000), ("n1", 3000)):
        cluster.add_node(pkg.o.Node(
            name=name, allocatable={"cpu": cpu, "memory": 1000, "pods": 10}))
    for i, (c, m) in enumerate([(500, 200), (1000, 300), (100, 100)]):
        cluster.add_pod(pkg.o.Pod(
            name=f"p{i}", creation_ms=i,
            containers=[pkg.o.Container(requests={"cpu": c, "memory": m})]))
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    return pkg.snap(cluster, pending)[0]


def host_view(snap):
    """Host numpy copies of the columns the gauges and gates read (the
    form `run_cycle` stamps its quality from)."""
    def h(x):
        return x.numpy()

    return SimpleNamespace(
        nodes=SimpleNamespace(alloc=h(snap.nodes.alloc),
                              requested=h(snap.nodes.requested),
                              mask=h(snap.nodes.mask)),
        pods=SimpleNamespace(req=h(snap.pods.req), mask=h(snap.pods.mask)),
        quota=None, gangs=None)


def padded(n, values, fill):
    out = np.full(n, fill, dtype=np.asarray(values).dtype)
    out[: len(values)] = values
    return out


@pytest.fixture(scope="module")
def tiny():
    snap_j, snap_p = tiny_cluster(JAX), tiny_cluster(PORT)
    assert snap_j.num_pods == snap_p.num_pods
    return snap_j, snap_p


#: (assignment of the three real pods, wait of the three): the tables'
#: fixed placements
TABLE = {
    "fixed": ([0, 1, -1], [False, False, False]),
    "gang_wait": ([0, 1, -1], [True, False, False]),
    "only_n0": ([0, -1, -1], [False, False, False]),
    "nothing": ([-1, -1, -1], [False, False, False]),
    "both_on_n0": ([0, 0, -1], [False, False, False]),
    "all_placed": ([0, 1, 1], [False, True, False]),
}


class TestGauges:
    @pytest.mark.parametrize("case", sorted(TABLE))
    def test_cycle_quality_matches_jax(self, tiny, case):
        snap_j, snap_p = tiny
        a, w = TABLE[case]
        assignment = padded(snap_p.num_pods, np.array(a, np.int32), -1)
        wait = padded(snap_p.num_pods, np.array(w), False)
        want = j_quality.cycle_quality(snap_j, assignment, None, wait)
        got = t_quality.cycle_quality(snap_p, assignment, None, wait)
        assert got == want
        assert list(got) == list(t_quality.CYCLE_OBJECTIVES)
        # the tensor form and the cycle's numpy stamp agree too
        assert t_quality.cycle_quality_np(host_view(snap_p), assignment,
                                          None, wait) == want

    def test_hand_computed_table(self, tiny):
        """`tests/test_tuning.py`'s hand-computed values."""
        _, snap = tiny
        n = snap.num_pods
        a = padded(n, np.array([0, 1, -1], np.int32), -1)
        w = padded(n, np.zeros(3, bool), False)
        q = t_quality.cycle_quality(snap, a, None, w)
        frag = ((1 - 2000 / 2500) + (1 - 800 / 1500)) / 2
        u0, u1 = (0.5 + 0.2) / 2, (1000 / 3000 + 0.3) / 2
        mean = (u0 + u1) / 2
        imb = np.sqrt(((u0 - mean) ** 2 + (u1 - mean) ** 2) / 2)
        packed = 1 - ((500 + 2000) / 4000 + (800 + 700) / 2000) / 2
        assert q["fragmentation"] == pytest.approx(frag, abs=1e-12)
        assert q["util_imbalance"] == pytest.approx(imb, abs=1e-12)
        assert q["packed_utilization"] == pytest.approx(packed, abs=1e-12)
        assert q["unplaced_frac"] == pytest.approx(1 / 3, abs=1e-12)
        only = padded(n, np.array([0, -1, -1], np.int32), -1)
        assert t_quality.cycle_quality(snap, only, None, w)[
            "packed_utilization"] == pytest.approx(1 - (0.5 + 0.8) / 2,
                                                   abs=1e-12)
        none = np.full(n, -1, np.int32)
        assert t_quality.cycle_quality(snap, none, None, w)[
            "packed_utilization"] == 0.0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_functions_match_jax_on_random_clusters(self, seed):
        rng = np.random.default_rng(seed)
        N, P = 16, 40
        alloc = np.stack([rng.integers(1000, 64_000, N),
                          rng.integers(1, 256, N) * GIB,
                          np.zeros(N), rng.integers(8, 110, N)],
                         axis=1).astype(np.int64)
        alloc[rng.integers(0, N)] = 0  # a node with nothing allocatable
        free = (alloc * rng.uniform(0, 1, (N, 1))).astype(np.int64)
        idle = rng.random(N) < 0.2  # nothing used: not occupied
        free[idle] = alloc[idle]
        node_mask = rng.random(N) < 0.85
        req = np.stack([rng.integers(100, 2000, P),
                        rng.integers(1, 4, P) * GIB,
                        np.zeros(P), np.zeros(P)], axis=1).astype(np.int64)
        assignment = rng.integers(-1, N, P).astype(np.int32)
        tj = [jnp.asarray(x) for x in (alloc, free, node_mask)]
        tp = [torch.as_tensor(x) for x in (alloc, free, node_mask)]
        assert np.array_equal(
            t_quality.placed_demand(torch.as_tensor(req),
                                    torch.as_tensor(assignment), N).numpy(),
            np.asarray(j_quality.placed_demand(
                jnp.asarray(req), jnp.asarray(assignment), N)))
        assert float(t_quality.fragmentation(tp[1], tp[2])) == float(
            j_quality.fragmentation(tj[1], tj[2]))
        assert float(t_quality.packed_utilization(*tp)) == float(
            j_quality.packed_utilization(*tj))
        assert float(t_quality.util_imbalance(*tp)) == pytest.approx(
            float(j_quality.util_imbalance(*tj)), rel=1e-12)
        assert 0.0 < float(t_quality.util_imbalance(*tp))


class TestGates:
    def test_fit_and_mask_cases_match_jax(self, tiny):
        snap_j, snap_p = tiny
        n = snap_p.num_pods
        cases = {
            "both_heavy_on_n0": [0, 0, -1],
            "ok": [0, 1, 1],
            "out_of_range": [0, 5, -1],
            "none": [-1, -1, -1],
        }
        for name, a in cases.items():
            a = padded(n, np.array(a, np.int32), -1)
            w = np.zeros(n, bool)
            got = t_gates.hard_violations(snap_p, torch.as_tensor(a), w)
            assert got == j_gates.hard_violations(snap_j, a, w), name
            assert got == t_gates.hard_violations(host_view(snap_p), a, w)
        bad = padded(n, np.array([0, 0, -1], np.int32), -1)
        assert t_gates.fit_violations(snap_p, bad) > 0
        # a padded node row is in range: it overflows and is masked
        pad = padded(n, np.array([0, 5, -1], np.int32), -1)
        assert t_gates.mask_violations(snap_p, pad) > 0
        assert t_gates.fit_violations(snap_p, pad) > 0
        # past every row: the mask oracle's alone
        oor = padded(n, np.array([0, 99, -1], np.int32), -1)
        assert t_gates.mask_violations(snap_p, oor) == 1
        assert t_gates.fit_violations(snap_p, oor) == 0
        assert j_gates.hard_violations(snap_j, oor, np.zeros(n, bool)) == (
            t_gates.hard_violations(snap_p, oor, np.zeros(n, bool)))

    def test_pod_fit_demand_matches_jax(self, tiny):
        snap_j, snap_p = tiny
        assert np.array_equal(t_gates.pod_fit_demand_np(snap_p.pods.req),
                              j_gates.pod_fit_demand_np(snap_j.pods.req))

    def test_quota_and_quorum_on_gang_roster(self):
        """The flagship solve of a gang / quota roster is gate-clean in both
        packages; a lone bound member of an unmet gang is one quorum
        violation; placements past a quota's Max count in queue order."""
        out = {}
        for name, pkg in (("jax", JAX), ("port", PORT)):
            cluster = pkg.gang_quota(n_gangs=2, gang_size=4, n_nodes=16)
            sched = pkg.Scheduler(pkg.Profile(plugins=[
                pkg.plugins.NodeResourcesAllocatable(),
                pkg.plugins.Coscheduling(),
                pkg.plugins.CapacityScheduling()]))
            pending = sched.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = pkg.snap(cluster, pending)
            sched.prepare(meta, cluster)
            kw = {"device": "cpu"} if pkg is PORT else {}
            result = sched.solve(snap, **kw)
            out[name] = (snap, np.array(result.assignment),
                         np.array(result.wait))
        (snap_j, a, w), (snap_p, a_p, w_p) = out["jax"], out["port"]
        assert np.array_equal(a, a_p) and np.array_equal(w, w_p)
        gates = (t_gates, j_gates)
        for g, snap in zip(gates, (snap_p, snap_j)):
            assert g.hard_violations(snap, a, w)["total"] == 0
        gang = np.asarray(snap_j.pods.gang)
        g = int(gang[np.argmax(a >= 0)])
        lone = np.full_like(a, -1)
        member = int(np.argmax((gang == g) & (a >= 0)))
        lone[member] = a[member]
        assert int(np.asarray(snap_j.gangs.min_member)[g]) > 1
        assert t_gates.gang_quorum_violations(
            snap_p, lone, np.zeros_like(w)) == j_gates.gang_quorum_violations(
            snap_j, lone, np.zeros_like(w)) == 1

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_quota_and_quorum_tables_match_jax(self, seed):
        """Seeded quota and gang tables (host arrays, the form both
        packages' oracles take): tight Max and aggregate-Min pools and
        gangs part placed, part waiting; the counts equal JAX's and some
        are positive."""
        rng = np.random.default_rng(seed)
        P, NS, G, R = 40, 3, 4, 4
        req = np.stack([rng.integers(100, 900, P), rng.integers(1, 5, P),
                        np.zeros(P), np.zeros(P)], axis=1).astype(np.int64)
        quota = SimpleNamespace(
            has_quota=np.array([True, True, False]),
            max=np.stack([rng.integers(1000, 4000, NS),
                          rng.integers(5, 30, NS), np.zeros(NS),
                          np.full(NS, 100)], axis=1).astype(np.int64),
            min=np.stack([rng.integers(500, 3000, NS),
                          rng.integers(3, 20, NS), np.zeros(NS),
                          np.full(NS, 100)], axis=1).astype(np.int64),
            used=np.zeros((NS, R), np.int64))
        gangs = SimpleNamespace(min_member=rng.integers(1, 6, G),
                                assigned=rng.integers(0, 2, G))
        snap = SimpleNamespace(
            pods=SimpleNamespace(req=req, ns=rng.integers(0, NS, P),
                                 gang=rng.integers(-1, G, P)),
            quota=quota, gangs=gangs)
        assignment = np.where(rng.random(P) < 0.7,
                              rng.integers(0, 8, P), -1).astype(np.int32)
        wait = rng.random(P) < 0.3
        got = (t_gates.quota_violations(snap, assignment),
               t_gates.gang_quorum_violations(snap, assignment, wait))
        assert got == (j_gates.quota_violations(snap, assignment),
                       j_gates.gang_quorum_violations(snap, assignment,
                                                      wait))
        assert sum(got) > 0
