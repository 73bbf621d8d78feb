"""The port's test-only placement modes (`ops/assign.py` `greedy_assign`,
`waterfill_assign`, `wave_assign`, with `_pick` and the one-hot
`_queue_order_admission`) against the JAX package's on the same numpy
inputs: the cases of `tests/test_core_ops.py` TestAssign, the 24-node x
160-pod problem of `tests/test_parallel.py` (the targeted waterfill places
at least as many pods as the generic one), and seeded random problems with
tied and spread scores. Assignment and free rows are integers: tolerance
0."""

import numpy as np
import pytest
import torch

from scheduler_plugins_tpu_torch.ops import CPU_I
from scheduler_plugins_tpu_torch.ops import assign as t_assign
from scheduler_plugins_tpu_torch.ops import fit as t_fit
from scheduler_plugins_tpu_torch.ops import normalize as t_norm

try:
    import jax.numpy as jnp

    import scheduler_plugins_tpu.ops.assign as j_assign
    import scheduler_plugins_tpu.ops.fit as j_fit
    import scheduler_plugins_tpu.ops.normalize as j_norm
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    j_assign = None

GIB = 1 << 30


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if j_assign is None:
        pytest.skip("the JAX package is not importable here")


def vec(cpu=0, mem=0, eph=0, pods=0):
    return [cpu, mem, eph, pods]


def step_fns(req, node_mask):
    """(JAX, port) step functions of `tests/test_core_ops.py`: Filter =
    fit, Score = remaining cpu."""
    jreq, jmask = jnp.asarray(req), jnp.asarray(node_mask)
    treq, tmask = torch.as_tensor(req), torch.as_tensor(node_mask)

    def jstep(free, p):
        return j_fit.fits_one(jreq[p], free, jmask), free[:, CPU_I]

    def tstep(free, p):
        return t_fit.fits_one(treq[p], free, tmask), free[:, CPU_I]

    return jstep, tstep


def batch_fns(req, scores=None):
    """(JAX, port) batch functions: Filter = fit; Score = remaining cpu,
    or the fixed (P, N) `scores`."""
    def make(xp, fits, broadcast):
        r = xp(req)

        def batch_fn(free, active):
            ok = fits(r, free, pod_mask=active)
            s = (broadcast(free[None, :, CPU_I], ok.shape) if scores is None
                 else xp(scores))
            return ok, s
        return batch_fn

    return (make(jnp.asarray, j_fit.fits, jnp.broadcast_to),
            make(torch.as_tensor, t_fit.fits, torch.broadcast_to))


def same(got, want):
    """Port outputs (assignment, free) == JAX outputs, exactly."""
    assert got[0].dtype == torch.int32
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def random_problem(seed, N, P, tied):
    rng = np.random.default_rng(seed)
    free0 = np.stack([rng.integers(1000, 6000, N),
                      rng.integers(1, 16, N) * GIB,
                      np.zeros(N, np.int64),
                      rng.integers(2, 12, N)], axis=1).astype(np.int64)
    req = np.stack([rng.integers(100, 2500, P),
                    rng.integers(1, 4, P) * GIB,
                    np.zeros(P, np.int64),
                    np.zeros(P, np.int64)], axis=1).astype(np.int64)
    scores = (np.zeros((P, N), np.int64) if tied
              else rng.integers(0, 100, (P, N)).astype(np.int64))
    pod_mask = rng.random(P) < 0.9
    return free0, req, scores, pod_mask


class TestGreedy:
    def test_sequential_updates_capacity(self):
        free0 = np.array([vec(1000, 10, 0, 10), vec(1000, 10, 0, 10)])
        req = np.array([vec(600, 1)] * 3)
        mask = np.ones(3, bool)
        jstep, tstep = step_fns(req, np.ones(2, bool))
        want = j_assign.greedy_assign(jstep, jnp.asarray(req),
                                      jnp.asarray(mask), jnp.asarray(free0))
        got = t_assign.greedy_assign(tstep, torch.as_tensor(req),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(free0))
        same(got, want)
        assert got[0].tolist() == [0, 1, -1]
        assert got[1][:, CPU_I].tolist() == [400, 400]

    def test_tiebreak_lowest_index(self):
        free0 = np.full((3, 4), 1000)
        req = np.array([vec(100, 1)])
        jstep, tstep = step_fns(req, np.ones(3, bool))
        args = (req, np.ones(1, bool), free0)
        want = j_assign.greedy_assign(jstep, *map(jnp.asarray, args))
        got = t_assign.greedy_assign(tstep, *map(torch.as_tensor, args))
        same(got, want)
        assert got[0].tolist() == [0]

    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_matches_jax(self, seed):
        free0, req, _, pod_mask = random_problem(seed, 8, 40, tied=False)
        node_mask = np.arange(8) != 3
        jstep, tstep = step_fns(req, node_mask)
        args = (req, pod_mask, free0)
        want = j_assign.greedy_assign(jstep, *map(jnp.asarray, args))
        got = t_assign.greedy_assign(tstep, *map(torch.as_tensor, args))
        same(got, want)
        assert (got[0] >= 0).any()


class TestWave:
    def test_matches_greedy_on_spread(self):
        free0 = np.array([vec(1000, 10, 0, 10), vec(900, 10, 0, 10)])
        req = np.array([vec(600, 1), vec(600, 1)])
        jb, tb = batch_fns(req)
        args = (req, np.ones(2, bool), free0)
        want = j_assign.wave_assign(jb, *map(jnp.asarray, args))
        got = t_assign.wave_assign(tb, *map(torch.as_tensor, args))
        same(got, want)
        assert got[0].tolist() == [0, 1]

    def test_queue_order_conflict_resolution(self):
        free0 = np.array([vec(700, 10, 0, 10)])
        req = np.array([vec(600, 1), vec(600, 1)])
        jb, tb = batch_fns(req, scores=np.zeros((2, 1), np.int64))
        args = (req, np.ones(2, bool), free0)
        want = j_assign.wave_assign(jb, *map(jnp.asarray, args))
        got = t_assign.wave_assign(tb, *map(torch.as_tensor, args))
        same(got, want)
        assert got[0].tolist() == [0, -1]

    @pytest.mark.parametrize("tied", [True, False], ids=["tied", "spread"])
    def test_random_matches_jax(self, tied):
        free0, req, scores, pod_mask = random_problem(2, 12, 48, tied)
        jb, tb = batch_fns(req, scores=scores)
        args = (req, pod_mask, free0)
        want = j_assign.wave_assign(jb, *map(jnp.asarray, args))
        got = t_assign.wave_assign(tb, *map(torch.as_tensor, args))
        same(got, want)
        assert (got[0] >= 0).any()


class TestWaterfill:
    def _problem(self):
        """`tests/test_parallel.py`'s 24 x 160 completeness problem, its
        same draws, with the 110-pod column in the pods slot (that test
        leaves the resource axis at three columns, where JAX drops the
        pods-slot write out of bounds and the port's indexing raises)."""
        rng = np.random.default_rng(5)
        N, P = 24, 160
        free0 = np.stack([rng.integers(4000, 16000, N),
                          rng.integers(8, 64, N) * GIB,
                          np.zeros(N), np.full(N, 110)],
                         axis=1).astype(np.int64)
        req = np.stack([rng.integers(100, 2500, P),
                        rng.integers(1, 8, P) * GIB,
                        np.zeros(P), np.zeros(P)], axis=1).astype(np.int64)
        raw = rng.integers(0, 1000, N).astype(np.int64)
        return free0, req, raw, np.ones(P, bool)

    def test_generic_matches_jax_and_targeted_is_complete(self):
        free0, req, raw, pod_mask = self._problem()

        def make(xp, fits, minmax, broadcast):
            r, s = xp(req), xp(raw)

            def batch_fn(free, active):
                feasible = fits(r, free, pod_mask=active)
                scores = minmax(broadcast(s[None, :], feasible.shape),
                                feasible)
                return feasible, scores
            return batch_fn

        jb = make(jnp.asarray, j_fit.fits, j_norm.minmax_normalize,
                  jnp.broadcast_to)
        tb = make(torch.as_tensor, t_fit.fits, t_norm.minmax_normalize,
                  torch.broadcast_to)
        args = (req, pod_mask, free0)
        want = j_assign.waterfill_assign(jb, *map(jnp.asarray, args))
        got = t_assign.waterfill_assign(tb, *map(torch.as_tensor, args))
        same(got, want)
        a_tgt = t_assign.waterfill_assign_targeted(
            torch.as_tensor(raw), *map(torch.as_tensor, args))[0]
        assert int((a_tgt >= 0).sum()) >= int((got[0] >= 0).sum())

    @pytest.mark.parametrize("tied", [True, False], ids=["tied", "spread"])
    @pytest.mark.parametrize("max_waves", [1, 4])
    def test_random_matches_jax(self, tied, max_waves):
        free0, req, scores, pod_mask = random_problem(3, 12, 48, tied)
        jb, tb = batch_fns(req, scores=scores)
        args = (req, pod_mask, free0)
        want = j_assign.waterfill_assign(jb, *map(jnp.asarray, args),
                                         max_waves=max_waves)
        got = t_assign.waterfill_assign(tb, *map(torch.as_tensor, args),
                                        max_waves=max_waves)
        same(got, want)


class TestHelpers:
    def test_pick_and_one_hot_admission_match_jax(self):
        rng = np.random.default_rng(4)
        for _ in range(6):
            feasible = rng.random(9) < 0.5
            scores = rng.integers(0, 3, 9).astype(np.int64)
            want = j_assign._pick(jnp.asarray(feasible), jnp.asarray(scores))
            got = t_assign._pick(torch.as_tensor(feasible),
                                 torch.as_tensor(scores))
            assert got.tolist() == [int(want)]
        choice = rng.integers(-1, 5, 30)
        onehot = (choice[:, None] == np.arange(5)[None, :])
        demand = np.stack([rng.integers(1, 400, 30), np.ones(30)],
                          axis=1).astype(np.int64)
        free = np.stack([rng.integers(0, 2000, 5), np.full(5, 4)], axis=1)
        want = j_assign._queue_order_admission(
            jnp.asarray(onehot), jnp.asarray(demand), jnp.asarray(free))
        got = t_assign._queue_order_admission(
            torch.as_tensor(onehot), torch.as_tensor(demand),
            torch.as_tensor(free))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got.any() and not got.all()
