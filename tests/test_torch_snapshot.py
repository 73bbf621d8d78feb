"""Port parity for the cluster store and snapshot lowering
(`scheduler_plugins_tpu_torch.state`, `.models.scenarios`, `.convert`):
the same clusters, drawn from one numpy seed, lower to the same tensors in
both packages, and a JAX snapshot carried across with
`snapshot_from_numpy` is the port's own snapshot. Every quantity is an
exact integer, so every comparison is exact (tolerance 0).

The cluster builders here are shared by the other `test_torch_*` files."""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu.api.objects as jax_objects
import scheduler_plugins_tpu.models.scenarios as jax_scenarios
import scheduler_plugins_tpu.state.cluster as jax_cluster
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.models.scenarios as port_scenarios
import scheduler_plugins_tpu_torch.state.cluster as port_cluster
from scheduler_plugins_tpu_torch.convert import snapshot_from_numpy
from torch_parity_cases import mixed_cluster  # noqa: F401

GIB = 1 << 30
CPU_DEV = torch.device("cpu")

JAX = SimpleNamespace(
    objects=jax_objects, Cluster=jax_cluster.Cluster, scenarios=jax_scenarios
)
PORT = SimpleNamespace(
    objects=port_objects, Cluster=port_cluster.Cluster,
    scenarios=port_scenarios,
)


def queue(cluster):
    """The pending batch in queue order (creation time, then insertion)."""
    return sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)


def snapshot_pair(build, **snap_kwargs):
    """(JAX snapshot, JAX meta, port snapshot, port meta) of the cluster
    `build(pkg)` makes, lowered on the CPU."""
    jc, pc = build(JAX), build(PORT)
    snap_j, meta_j = jc.snapshot(queue(jc), now_ms=0, **snap_kwargs)
    snap_t, meta_t = pc.snapshot(queue(pc), now_ms=0, device="cpu",
                                 **snap_kwargs)
    return snap_j, meta_j, snap_t, meta_t


def jax_tree(snap_j) -> dict:
    """The JAX snapshot's four tables as nested dicts of numpy arrays."""
    tree = {}
    for name in ("nodes", "pods", "gangs", "quota"):
        table = getattr(snap_j, name)
        tree[name] = None if table is None else {
            f.name: np.asarray(getattr(table, f.name))
            for f in fields(table) if getattr(table, f.name) is not None
        }
    return tree


def assert_tables_equal(snap_t, tree):
    """Every field of the port's snapshot equals the JAX array of the
    same name: same values, same dtype."""
    for name in ("nodes", "pods", "gangs", "quota"):
        table = getattr(snap_t, name)
        assert (table is None) == (tree[name] is None), name
        if table is None:
            continue
        for f in fields(table):
            got = getattr(table, f.name).numpy()
            want = tree[name][f.name]
            assert got.dtype == want.dtype, (name, f.name)
            assert np.array_equal(got, want), (name, f.name)


BUILDS = {
    "allocatable": lambda pkg: pkg.scenarios.allocatable_scenario(37, 300),
    "gang_quota": lambda pkg: pkg.scenarios.gang_quota_scenario(6, 16, 9),
    "mixed": lambda pkg: mixed_cluster(pkg, 0),
    "mixed_gangs": lambda pkg: mixed_cluster(pkg, 1, gangs=True),
}


class TestSnapshotParity:
    @pytest.mark.parametrize("case", sorted(BUILDS))
    def test_tensors_equal_jax(self, case):
        snap_j, meta_j, snap_t, meta_t = snapshot_pair(BUILDS[case])
        assert_tables_equal(snap_t, jax_tree(snap_j))
        assert meta_t.index.names == meta_j.index.names
        assert meta_t.node_names == meta_j.node_names
        assert meta_t.pod_names == meta_j.pod_names
        assert meta_t.namespaces == meta_j.namespaces
        assert meta_t.gang_names == meta_j.gang_names

    def test_explicit_padding_matches(self):
        # 9 nodes held at exactly 9 rows: the blocked solve's padding edge
        snap_j, _, snap_t, _ = snapshot_pair(
            lambda pkg: mixed_cluster(pkg, 2, n_nodes=9), pad_nodes=9,
            pad_pods=200,
        )
        assert snap_t.num_nodes == 9 and snap_t.num_pods == 200
        assert_tables_equal(snap_t, jax_tree(snap_j))

    def test_gang_quota_tables_are_populated(self):
        _, _, snap_t, _ = snapshot_pair(BUILDS["mixed_gangs"])
        gangs, quota = snap_t.gangs, snap_t.quota
        assert gangs.gated.sum() == 1 and gangs.has_min_resources.sum() == 1
        assert quota.has_quota.sum() == 4 and quota.used.sum() > 0
        assert (quota.nom_batch_idx >= 0).sum() == 1
        assert quota.nom_total_mask.any()

    def test_queue_order_keeps_gated_pods_out(self):
        for pkg in (JAX, PORT):
            cluster = mixed_cluster(pkg, 1, gangs=True)
            names = [p.name for p in queue(cluster)]
            assert "g-gated-m0" not in names and "g-gated-m1" in names


class TestCarryAcross:
    @pytest.mark.parametrize("case", ["allocatable", "mixed_gangs"])
    def test_round_trip(self, case):
        snap_j, _, snap_t, _ = snapshot_pair(BUILDS[case])
        tree = jax_tree(snap_j)
        carried = snapshot_from_numpy(tree, device="cpu")
        assert_tables_equal(carried, tree)
        # ...and it is the port's own lowering of the same cluster
        assert_tables_equal(carried, snap_t.numpy() | {
            k: None for k in ("gangs", "quota") if getattr(snap_t, k) is None
        })
        assert carried.device == CPU_DEV

    def test_missing_field_raises(self):
        snap_j, _, _, _ = snapshot_pair(BUILDS["allocatable"])
        tree = jax_tree(snap_j)
        del tree["nodes"]["alloc"]
        with pytest.raises(KeyError):
            snapshot_from_numpy(tree, device="cpu")


class TestScenarios:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_same_draws_as_jax(self, seed):
        jc = jax_scenarios.allocatable_scenario(5, 50, seed=seed)
        pc = port_scenarios.allocatable_scenario(5, 50, seed=seed)
        want = [(p.name, p.effective_request()) for p in queue(jc)]
        got = [(p.name, p.effective_request()) for p in queue(pc)]
        assert got == want
