"""The rank mesh and the launch recipe in one process
(`scheduler_plugins_tpu_torch.parallel.mesh` and `.launch`) against the
JAX package's `parallel.mesh` and `parallel.launch`:

- the ("pods", "nodes") factorisation equals JAX `make_mesh(n)` for
  n = 1 ... 8 (the 8 virtual CPU devices of the test bootstrap);
- `pad_to_shards` and `block_bounds`, and the old import path
  `parallel.solver.pad_to_shards`;
- a single process is the 1 x 1 mesh: its collectives are the identity,
  its `shard_snapshot` view is the whole snapshot, and a mesh that asks for
  more ranks than the process group has raises;
- `launch.initialize()` is False alone, `make_multihost_mesh` falls back
  to the local mesh, `broadcast_snapshot` is the identity, and
  `distributed_solve` equals `batch_solve` (`tests/test_parallel.py`
  TestMultiHostLaunch), with a missing backend or rendezvous named.

The rank cases across processes are `tests/test_torch_ranks.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheduler_plugins_tpu.parallel import launch as j_launch
from scheduler_plugins_tpu.parallel import mesh as j_mesh
from scheduler_plugins_tpu.parallel import solver as j_solver
from scheduler_plugins_tpu_torch.parallel import launch, mesh
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from tests.test_torch_ranks import multihost_cluster
from tests.test_torch_snapshot import snapshot_pair
from tests.test_torch_wave import weights_of


@pytest.mark.parametrize("n", range(1, 9))
def test_factorisation_matches_jax(n):
    assert mesh.mesh_shape(n) == j_mesh.make_mesh(n).devices.shape


@pytest.mark.parametrize("n,shards", [(19, 8), (16, 8), (9, 8), (1, 3),
                                      (300, 7)])
def test_padding_and_blocks(n, shards):
    padded = mesh.pad_to_shards(n, shards)
    assert padded == j_mesh.pad_to_shards(n, shards)
    assert t_solver.pad_to_shards(n, shards) == padded
    bounds = [mesh.block_bounds(n, shards, s) for s in range(shards)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))
    assert max(hi - lo for lo, hi in bounds) == padded // shards


def test_single_process_is_the_unit_mesh():
    m = mesh.make_mesh()
    assert m.shape == {"pods": 1, "nodes": 1} and m.rank == 0
    assert m.backend is None and m.group("nodes") is None
    t = torch.arange(6).view(2, 3)
    mesh.reset_exchanges()
    assert torch.equal(mesh.all_gather(t, m, "nodes"), t[None])
    assert torch.equal(mesh.gather_blocks(t, 2, m, None), t)
    assert mesh.exchanges() == {"calls": 0, "bytes": 0, "seconds": 0.0}
    assert mesh.make_node_mesh().shape == {"nodes": 1}
    with pytest.raises(ValueError, match="process group of 8"):
        mesh.make_mesh(8)


def test_single_process_view_is_the_snapshot():
    _, _, snap_t, _ = snapshot_pair(multihost_cluster, pad_nodes=8)
    view = mesh.shard_snapshot(snap_t, mesh.make_mesh())
    for table in ("nodes", "pods"):
        for name, x in getattr(snap_t, table).numpy().items():
            assert np.array_equal(getattr(view, table).numpy()[name], x)


class TestLaunchAlone:
    def test_initialize_is_false_alone(self, monkeypatch):
        for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        assert launch.initialize() is False
        assert j_launch.initialize() is False
        monkeypatch.setenv("WORLD_SIZE", "1")
        assert launch.initialize(backend="gloo") is False

    def test_initialize_names_what_is_missing(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(ValueError, match="backend"):
            launch.initialize(world_size=2, rank=0)
        with pytest.raises(ValueError, match="rendezvous"):
            launch.initialize(world_size=2, rank=0, backend="gloo")

    def test_multihost_mesh_falls_back_locally(self):
        m = launch.make_multihost_mesh()
        assert set(m.axis_names) == set(
            j_launch.make_multihost_mesh().axis_names)
        assert m.shape == {"pods": 1, "nodes": 1}

    def test_distributed_solve_matches_local(self):
        snap_j, meta_j, snap_t, meta_t = snapshot_pair(
            multihost_cluster, pad_nodes=8, pad_pods=32)
        w = weights_of(meta_j)
        snap_b = launch.broadcast_snapshot(snap_t)
        assert snap_b is snap_t
        assert launch.broadcast_snapshot(snap_t, meta_t) == (snap_t, meta_t)
        got = launch.distributed_solve(snap_b, launch.make_multihost_mesh(),
                                       torch.as_tensor(w))
        local = t_solver.batch_solve(snap_t, torch.as_tensor(w))[0]
        assert got.tolist() == local.tolist()
        want = j_solver.batch_solve(snap_j, jnp.asarray(w, jnp.int64))[0]
        assert got.tolist() == np.asarray(want).tolist()
        assert (got >= 0).sum() > 0
