"""Port parity for the scheduling math (`scheduler_plugins_tpu_torch.ops`,
`.utils.intmath` and the admission/finalize half of `.parallel.solver`):
each function equals its JAX counterpart on the same numpy inputs. All
results are exact integers or booleans: tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scheduler_plugins_tpu.ops import allocatable as j_alloc
from scheduler_plugins_tpu.ops import assign as j_assign
from scheduler_plugins_tpu.ops import gang as j_gang
from scheduler_plugins_tpu.ops import quota as j_quota
from scheduler_plugins_tpu.parallel import solver as j_solver
from scheduler_plugins_tpu.utils import intmath as j_intmath
from scheduler_plugins_tpu_torch.ops import allocatable as t_alloc
from scheduler_plugins_tpu_torch.ops import assign as t_assign
from scheduler_plugins_tpu_torch.ops import fit as t_fit
from scheduler_plugins_tpu_torch.ops import gang as t_gang
from scheduler_plugins_tpu_torch.ops import quota as t_quota
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from scheduler_plugins_tpu_torch.utils import intmath as t_intmath
from tests.test_torch_snapshot import BUILDS, mixed_cluster, snapshot_pair

GIB = 1 << 30


def same(port_value, jax_value):
    """Exact equality of a port tensor and a JAX array."""
    got = port_value.numpy()
    want = np.asarray(jax_value)
    return got.shape == want.shape and np.array_equal(got, want)


@pytest.fixture(scope="module")
def gang_pair():
    """The gang + quota cluster lowered by both packages."""
    return snapshot_pair(BUILDS["mixed_gangs"])


class TestIntmath:
    def test_go_div_truncates_toward_zero(self):
        rng = np.random.default_rng(0)
        a = rng.integers(-(1 << 50), 1 << 50, 4000)
        a[:4] = [-7, 7, -1, 0]
        for b in (1, 3, 1 << 20, (1 << 20) + 1):
            got = t_intmath.go_div(torch.as_tensor(a), b)
            assert same(got, j_intmath.go_div(jnp.asarray(a), b))
        assert t_intmath.go_div(torch.tensor([-7]), 2).item() == -3

    @pytest.mark.parametrize("n", [0, 1, 8, 9, 1000, 1024, 1025, 3000, 10_240])
    def test_bucket_size(self, n):
        assert t_intmath.bucket_size(n) == j_intmath.bucket_size(n)


class TestAllocatable:
    @pytest.mark.parametrize("k", [22, 23, 24, 31, 40, 52])
    def test_demote_at_powers_of_two(self, k):
        # the shift count is ceil(log2(max|raw| + 1)) - 23: exact powers
        # of two, one below and one above, on both signs
        edge = 1 << k
        for top in (edge - 1, edge, edge + 1):
            raw = np.array([-top, -(top // 3), 0, top // 5, 17], np.int64)
            got = t_alloc.demote_scores_int32(torch.as_tensor(raw))
            assert got.dtype == torch.int32
            assert same(got, j_alloc.demote_scores_int32(jnp.asarray(raw)))

    def test_scores_match_on_random_allocatables(self):
        rng = np.random.default_rng(1)
        alloc = np.stack([
            rng.integers(1000, 128_000, 64), rng.integers(1, 512, 64) * GIB,
            np.zeros(64, np.int64), rng.integers(8, 256, 64),
        ], axis=1)
        weights = np.array([1 << 20, 1, 0, 0])
        for mode in (t_alloc.MODE_LEAST, t_alloc.MODE_MOST):
            got = t_alloc.allocatable_scores(
                torch.as_tensor(alloc), torch.as_tensor(weights), mode
            )
            want = j_alloc.allocatable_scores(
                jnp.asarray(alloc), jnp.asarray(weights), mode
            )
            assert same(got, want)
            assert same(t_alloc.demote_scores_int32(got),
                        j_alloc.demote_scores_int32(want))


class TestFit:
    def test_free_and_demand(self, gang_pair):
        snap_j, _, snap_t, _ = gang_pair
        from scheduler_plugins_tpu.ops import fit as j_fit

        assert same(
            t_fit.free_capacity(snap_t.nodes.alloc, snap_t.nodes.requested),
            j_fit.free_capacity(snap_j.nodes.alloc, snap_j.nodes.requested),
        )
        assert same(t_fit.pod_fit_demand(snap_t.pods.req),
                    j_fit.pod_fit_demand(snap_j.pods.req))


class TestAdmission:
    def test_gang_admit(self, gang_pair):
        snap_j, _, snap_t, _ = gang_pair
        free_t = t_fit.free_capacity(snap_t.nodes.alloc, snap_t.nodes.requested)
        free_j = snap_j.nodes.alloc - snap_j.nodes.requested
        got = t_gang.gang_admit(snap_t.gangs, free_t, snap_t.pods.gang)
        want = jax.vmap(lambda g: j_gang.gang_admit(snap_j.gangs, free_j, g))(
            snap_j.pods.gang
        )
        assert same(got, want)
        # the short, gated and MinResources gangs are rejected
        assert (~got & (snap_t.pods.gang >= 0)).sum() > 0
        assert same(t_gang.cluster_free_total(free_t),
                    j_gang.cluster_free_total(free_j))

    def test_quota_admit(self, gang_pair):
        snap_j, _, snap_t, _ = gang_pair
        q_t, q_j = snap_t.quota, snap_j.quota
        nom_t = t_solver.nominated_aggregates_batch(q_t)
        nom_j = j_solver.nominated_aggregates_batch(q_j)
        for a, b in zip(nom_t, nom_j):
            assert same(a, b)
        got = t_quota.quota_admit(
            q_t.used, q_t.min, q_t.max, q_t.has_quota, snap_t.pods.ns,
            snap_t.pods.req, *nom_t,
        )
        want = jax.vmap(lambda ns, req, a, b: j_quota.quota_admit(
            q_j.used, q_j.min, q_j.max, q_j.has_quota, ns, req, a, b,
        ))(snap_j.pods.ns, snap_j.pods.req, *nom_j)
        assert same(got, want)

    def test_batch_admission(self, gang_pair):
        snap_j, _, snap_t, _ = gang_pair
        free_t = t_fit.free_capacity(snap_t.nodes.alloc, snap_t.nodes.requested)
        free_j = snap_j.nodes.alloc - snap_j.nodes.requested
        assert same(t_solver.batch_admission(snap_t, free_t),
                    j_solver.batch_admission(snap_j, free_j))

    def test_nominee_contribution_table(self):
        from scheduler_plugins_tpu.ops.quota import nominee_contribution

        for args in np.ndindex(2, 3, 3, 2):
            same_ns, m_pri, p_pri, over = (bool(args[0]), args[1], args[2],
                                           bool(args[3]))
            assert t_quota.nominee_contribution(same_ns, m_pri, p_pri, over) \
                == tuple(nominee_contribution(same_ns, m_pri, p_pri, over))


class TestQuotaPrefix:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_fixpoint_matches_jax(self, gang_pair, seed):
        snap_j, _, snap_t, _ = gang_pair
        rng = np.random.default_rng(seed)
        placed = rng.random(snap_t.num_pods) < 0.8
        placed &= snap_t.pods.mask.numpy()
        got = t_solver._namespace_quota_prefix_ok(
            torch.as_tensor(placed), snap_t, snap_t.quota.used
        )
        want = j_solver._namespace_quota_prefix_ok(
            jnp.asarray(placed), snap_j, snap_j.quota.used
        )
        scan = j_solver._namespace_quota_prefix_ok_scan(
            jnp.asarray(placed), snap_j, snap_j.quota.used
        )
        assert same(got, want) and same(got, scan)
        assert (placed & ~got.numpy()).sum() > 0  # the caps bite

    def test_finalize_matches_jax(self, gang_pair):
        snap_j, _, snap_t, _ = gang_pair
        rng = np.random.default_rng(5)
        a = rng.integers(-1, 19, snap_t.num_pods).astype(np.int32)
        # only gang members placed, so the quota caps leave them standing
        a[~snap_t.pods.mask.numpy() | (snap_t.pods.gang.numpy() < 0)] = -1
        got_a, got_w = t_solver.finalize_assignment(torch.as_tensor(a), snap_t)
        want_a, want_w = j_solver.finalize_assignment(jnp.asarray(a), snap_j)
        assert same(got_a, want_a) and same(got_w, want_w)
        assert got_w.any()  # some placed gang member waits for quorum


class TestWaveHelpers:
    """The targeted waterfill's building blocks, on random inputs."""

    def test_segment_prefix(self):
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 1 << 40, (300, 4)).astype(np.float64)
        first = rng.random(300) < 0.1
        first[0] = True
        got = t_assign._segment_prefix(torch.as_tensor(vals),
                                       torch.as_tensor(first))
        want = j_assign._segment_prefix(jnp.asarray(vals), jnp.asarray(first))
        assert same(got, want)

    def test_cumulative_demand_positions(self):
        # searchsorted on the LEFT side: equal cumulative sums land on the
        # node that reaches them
        rng = np.random.default_rng(1)
        free = rng.integers(0, 10, (40, 3)) * 100
        dem = rng.integers(0, 5, (64, 3)) * 100
        order = np.argsort(-rng.integers(0, 8, 40), kind="stable")
        got = t_assign._cumulative_demand_positions(
            torch.as_tensor(dem), torch.as_tensor(free), torch.as_tensor(order)
        )
        want = j_assign._cumulative_demand_positions(
            jnp.asarray(dem), jnp.asarray(free), jnp.asarray(order)
        )
        assert same(got, want)

    def test_queue_order_admission(self):
        rng = np.random.default_rng(2)
        W, N = 200, 12
        choice = rng.integers(-1, N, W)
        dem = rng.integers(1, 6, (W, 3))
        free = rng.integers(0, 30, (N, 3))
        got = t_assign._queue_order_admission_choice(
            torch.as_tensor(choice), torch.as_tensor(dem), torch.as_tensor(free)
        )
        want = j_assign._queue_order_admission_choice(
            jnp.asarray(choice, jnp.int32), jnp.asarray(dem), jnp.asarray(free)
        )
        assert same(got, (choice >= 0) & np.asarray(want))

    @pytest.mark.parametrize("W", [1, 16, 64, 500])
    def test_straggler_window(self, W):
        rng = np.random.default_rng(W)
        P = 300
        demand = rng.integers(0, 100, (P, 4))
        mask = rng.random(P) < 0.9
        assignment = np.where(rng.random(P) < 0.5, 3, -1)
        hopeless = rng.random(P) < 0.1
        got = t_assign._straggler_window(
            torch.as_tensor(demand), torch.as_tensor(mask),
            torch.as_tensor(assignment), torch.as_tensor(hopeless), W,
        )
        want = j_assign._straggler_window(
            jnp.asarray(demand), jnp.asarray(mask),
            jnp.asarray(assignment, jnp.int32), jnp.asarray(hopeless), W,
        )
        for a, b in zip(got, want):
            assert same(a, np.asarray(b).astype(a.numpy().dtype))

    @pytest.mark.parametrize("n_shards", [1, 3, 8])
    def test_rank_order_inputs(self, n_shards):
        rng = np.random.default_rng(n_shards)
        raw = rng.integers(-5, 5, 19)  # ties: the lower index ranks first
        free0 = rng.integers(0, 100, (19, 4))
        mask = rng.random(19) < 0.8
        got = t_solver.rank_order_inputs(
            torch.as_tensor(raw), torch.as_tensor(free0),
            torch.as_tensor(mask), n_shards,
        )
        want = j_solver.rank_order_inputs(
            jnp.asarray(raw), jnp.asarray(free0), jnp.asarray(mask), n_shards,
        )
        for a, b in zip(got, want):
            assert same(a, b)
        from scheduler_plugins_tpu.parallel.mesh import pad_to_shards

        assert t_solver.pad_to_shards(19, n_shards) == pad_to_shards(19, n_shards)


class TestTargetedWaterfill:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_unblocked_matches_jax(self, seed):
        # tight capacity and small windows: lite windows, rescue waves and
        # hopeless retirements all fire
        snap_j, meta_j, snap_t, _ = snapshot_pair(
            lambda pkg: mixed_cluster(pkg, seed, n_pods=300)
        )
        free_t = torch.where(
            snap_t.nodes.mask[:, None],
            snap_t.nodes.alloc - snap_t.nodes.requested, 0,
        )
        weights = np.asarray(meta_j.index.encode({"cpu": 1 << 20, "memory": 1}))
        raw_t = t_alloc.demote_scores_int32(t_alloc.allocatable_scores(
            snap_t.nodes.alloc, torch.as_tensor(weights))).to(torch.int64)
        kw = dict(max_waves=8, rescue_window=16, lite_window=32)
        a_t, f_t, stats = t_assign.waterfill_assign_targeted(
            raw_t, snap_t.pods.req, snap_t.pods.mask, free_t, **kw
        )
        a_j, f_j, stats_j = j_assign.waterfill_assign_targeted(
            jnp.asarray(raw_t.numpy()), snap_j.pods.req, snap_j.pods.mask,
            jnp.asarray(free_t.numpy()), collect_stats=True, **kw,
        )
        assert same(a_t, a_j) and same(f_t, f_j)
        assert stats["waves"] == int(stats_j["waves"]) > 2
        assert 0 < int((a_t >= 0).sum()) < int(snap_t.pods.mask.sum())
