"""The port's blocked wave solve (`scheduler_plugins_tpu_torch.parallel
.solver.sharded_wave_solve`, node axis in S rank blocks on one device)
against two JAX oracles on the same cluster: JAX `sharded_wave_solve` on an
S-device mesh with the Pallas ring kernels (`SPT_PALLAS=1`, interpret mode)
and JAX `batch_solve`. Assignment, admitted and wait must be bit-identical
at S in {1, 2, 3, 8}, including node counts that are not a multiple of S
(19 nodes; 9 nodes over 8 blocks) and a cordoned node.

The gang + quota envelope has its own file (`test_torch_wave_gang.py`) so
the two JAX compile sets run on different test workers."""

import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheduler_plugins_tpu.parallel.mesh import make_node_mesh
from scheduler_plugins_tpu.parallel import solver as j_solver
from scheduler_plugins_tpu_torch.ops import PODS_I
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from tests.test_torch_snapshot import mixed_cluster, snapshot_pair

#: the small windows make lite windows, rescue waves and hopeless
#: retirements fire at test size
RESCUE_WINDOW = 16


def weights_of(meta):
    return meta.index.encode({"cpu": 1 << 20, "memory": 1})


def jax_sharded(snap_j, weights, S, **kw):
    """JAX `sharded_wave_solve` with the Pallas election kernels, run in
    interpret mode (the reference's own CPU path for them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPT_PALLAS", "1")
        mp.setenv("SPT_PALLAS_INTERPRET", "1")
        if not hasattr(pltpu, "TPUCompilerParams"):
            # the installed JAX renamed it; alias it for this call only
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        out = j_solver.sharded_wave_solve(
            snap_j, make_node_mesh(S), jnp.asarray(weights, jnp.int64), **kw
        )
    return tuple(np.asarray(x) for x in out)


def assert_same(port_out, jax_out, label):
    for name, got, want in zip(("assignment", "admitted", "wait"),
                               port_out, jax_out):
        assert np.array_equal(got.numpy(), want), (label, name)


def fit_ok(snap_t, assignment):
    """No placement on a cordoned or padding node, no node over capacity."""
    a = assignment.numpy().astype(np.int64)
    placed = a >= 0
    mask = snap_t.nodes.mask.numpy()
    if not mask[a[placed]].all():
        return False
    demand = snap_t.pods.req.numpy().copy()
    demand[:, PODS_I] = 1
    used = np.zeros_like(snap_t.nodes.alloc.numpy())
    np.add.at(used, a[placed], demand[placed])
    free = (snap_t.nodes.alloc - snap_t.nodes.requested).numpy()
    return bool((used <= free).all())


@pytest.fixture(scope="module")
def nineteen():
    """19 nodes (one cordoned), 300 tight pods: (snap_j, snap_t, weights,
    JAX batch_solve result)."""
    snap_j, meta_j, snap_t, _ = snapshot_pair(
        lambda pkg: mixed_cluster(pkg, 3, n_nodes=19, n_pods=300),
        pad_nodes=19,
    )
    w = weights_of(meta_j)
    ref = tuple(np.asarray(x) for x in j_solver.batch_solve(
        snap_j, jnp.asarray(w, jnp.int64)))
    return snap_j, snap_t, w, ref


class TestBlockedWave:
    @pytest.mark.parametrize("S", [1, 2, 3, 8])
    def test_matches_jax_oracles(self, nineteen, S):
        snap_j, snap_t, w, ref = nineteen
        weights = torch.as_tensor(w)
        # JAX batch_solve runs the default windows
        out = t_solver.sharded_wave_solve(snap_t, weights, S)
        assert_same(out, ref, ("batch_solve", S))
        # the JAX blocked solve, with small rescue windows
        small = t_solver.sharded_wave_solve(
            snap_t, weights, S, rescue_window=RESCUE_WINDOW
        )
        assert_same(small, jax_sharded(snap_j, w, S,
                                       rescue_window=RESCUE_WINDOW),
                    ("sharded_wave_solve", S))
        for a, _, _ in (out, small):
            placed = int((a >= 0).sum())
            assert 0 < placed < int(snap_t.pods.mask.sum())
            assert fit_ok(snap_t, a)
            assert (a != 3).all()  # node-003 is cordoned

    def test_unblocked_port_matches_jax(self, nineteen):
        snap_j, snap_t, w, ref = nineteen
        out = t_solver.batch_solve(snap_t, torch.as_tensor(w))
        assert_same(out, ref, "batch_solve")

    def test_chunks_carry_free_capacity(self, nineteen):
        snap_j, snap_t, w, _ = nineteen
        kw = dict(chunk=128, rescue_window=RESCUE_WINDOW)
        out = t_solver.sharded_wave_solve(snap_t, torch.as_tensor(w), 3, **kw)
        assert_same(out, jax_sharded(snap_j, w, 3, **kw), "chunked")
        unblocked = t_solver.batch_solve(snap_t, torch.as_tensor(w), **kw)
        assert_same(out, tuple(x.numpy() for x in unblocked), "unblocked")

    def test_nine_nodes_over_eight_blocks(self):
        # 9 rank rows pad to 16: seven zero-capacity rows of node id -1
        snap_j, meta_j, snap_t, _ = snapshot_pair(
            lambda pkg: mixed_cluster(pkg, 4, n_nodes=9, n_pods=120,
                                      cordon=(0,)),
            pad_nodes=9,
        )
        w = weights_of(meta_j)
        out = t_solver.sharded_wave_solve(
            snap_t, torch.as_tensor(w), 8, rescue_window=RESCUE_WINDOW,
            collect_stats=True,
        )
        assert_same(out, jax_sharded(snap_j, w, 8,
                                     rescue_window=RESCUE_WINDOW), "9/8")
        stats = out[3]
        pad = stats["node_ids"].reshape(-1) < 0
        assert int(pad.sum()) == 7
        assert (stats["rank_free"].reshape(-1, 4)[pad] == 0).all()
        assert fit_ok(snap_t, out[0]) and (out[0] != 0).all()
        ref = j_solver.batch_solve(snap_j, jnp.asarray(w, jnp.int64))
        out = t_solver.sharded_wave_solve(snap_t, torch.as_tensor(w), 8)
        assert_same(out, tuple(np.asarray(x) for x in ref), "9/8 batch")
