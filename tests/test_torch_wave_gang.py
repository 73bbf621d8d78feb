"""The port's blocked wave solve through the whole flagship envelope —
gang and elastic-quota PreFilter, the queue-order namespace quota prefix
and the gang quorum Permit — against JAX `sharded_wave_solve` with the
Pallas ring kernels (`SPT_PALLAS=1`, interpret mode) and JAX `batch_solve`:
bit-identical assignment, admitted and wait at S in {1, 2, 3, 8}."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheduler_plugins_tpu.parallel import solver as j_solver
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from tests.test_torch_snapshot import BUILDS, mixed_cluster, snapshot_pair
from tests.test_torch_wave import (
    RESCUE_WINDOW,
    assert_same,
    fit_ok,
    jax_sharded,
    weights_of,
)


@pytest.fixture(scope="module")
def gangs():
    """19 nodes, five PodGroups in four quota namespaces among 160 plain
    pods: (snap_j, snap_t, weights, JAX batch_solve result)."""
    snap_j, meta_j, snap_t, _ = snapshot_pair(
        lambda pkg: mixed_cluster(pkg, 6, gangs=True), pad_nodes=19
    )
    w = weights_of(meta_j)
    ref = tuple(np.asarray(x) for x in j_solver.batch_solve(
        snap_j, jnp.asarray(w, jnp.int64)))
    return snap_j, snap_t, w, ref


class TestBlockedWaveEnvelope:
    @pytest.mark.parametrize("S", [1, 2, 3, 8])
    def test_matches_jax_oracles(self, gangs, S):
        snap_j, snap_t, w, ref = gangs
        weights = torch.as_tensor(w)
        out = t_solver.sharded_wave_solve(snap_t, weights, S)
        assert_same(out, ref, ("batch_solve", S))
        small = t_solver.sharded_wave_solve(
            snap_t, weights, S, rescue_window=RESCUE_WINDOW
        )
        assert_same(small, jax_sharded(snap_j, w, S,
                                       rescue_window=RESCUE_WINDOW),
                    ("sharded_wave_solve", S))
        for a, admitted, wait in (out, small):
            assert fit_ok(snap_t, a)
            # PreFilter rejects the short, gated and MinResources gangs;
            # the quorum Permit holds back a gang placed below MinMember
            assert not admitted[snap_t.pods.gang >= 0].all()
            assert not (a[~admitted] >= 0).any()
            assert wait.any()

    def test_scenario_envelope(self):
        # the repo's gang + quota scenario, every member placed
        snap_j, meta_j, snap_t, _ = snapshot_pair(BUILDS["gang_quota"])
        w = weights_of(meta_j)
        ref = j_solver.batch_solve(snap_j, jnp.asarray(w, jnp.int64))
        out = t_solver.sharded_wave_solve(snap_t, torch.as_tensor(w), 8)
        assert_same(out, tuple(np.asarray(x) for x in ref), "gang_quota")
        assert int((out[0] >= 0).sum()) == 96
