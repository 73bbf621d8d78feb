"""The port's cross-block exchange kernels (`scheduler_plugins_tpu_torch
.parallel.kernels`): each plain PyTorch version equals the JAX Pallas ring
kernel it replaces, run in interpret mode through a `shard_map` over S
virtual CPU devices, at S in {2, 3, 8} and at the sentinel-tie and padding
edges; the wrappers take the plain version for CPU tensors without counting
a launch. Integer results, tolerance 0.

The installed JAX renamed `pltpu.TPUCompilerParams` to
`pltpu.CompilerParams`; the `pallas_names` fixture aliases the old name for
the duration of one test so that the reference kernels run unchanged.

The CUDA kernels themselves run only on a card: the `cuda`-marked tests
hold them against the plain versions there and skip here. They need JAX
importable but not the JAX package (run them on the card with
`python -m pytest tests/test_torch_kernels.py -m cuda`)."""

import sys

import jax
import jax.experimental.pallas.tpu as pltpu
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from scheduler_plugins_tpu_torch.parallel import kernels as pk

try:
    from scheduler_plugins_tpu.parallel import kernels as jk
except ImportError:
    # a card machine may lack the JAX package's own dependencies; only the
    # reference tests need it, never the cuda-marked `TestOnCard`
    jk = None

AXIS = "nodes"
INT32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def pallas_names(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(
            pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False
        )


def shard_run(fn, S, x, out_specs):
    """`fn` per shard over the leading axis of `x` (an array, or a tuple of
    arrays each split the same way) on an S-device mesh."""
    mesh = Mesh(np.asarray(jax.devices()[:S]), (AXIS,))
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=P(AXIS),
                          out_specs=out_specs, check_rep=False))
    return f(jax.tree.map(jnp.asarray, x))


def t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def election_inputs(rng, S, BS, R, W):
    """(prop (S, W) int64, node_ids (S, BS) int32, rank_free (S, BS, R)
    int64) as the blocked solve gives them: node ids of the real nodes in
    rank order, -1 on the padding rows (the last BS // 2 ranks, zero free
    capacity there), free capacity below 2^40, and each block proposing a
    rank of its own block about half the time, the sentinel N = S*BS
    elsewhere; the last three columns are all-sentinel (the tie edge)."""
    N = S * BS
    n_real = N - BS // 2
    node_ids = np.full(N, -1, np.int32)
    node_ids[:n_real] = rng.permutation(n_real)
    rank_free = rng.integers(0, 1 << 40, (N, R))
    rank_free[n_real:] = 0
    prop = np.full((S, W), N, np.int64)
    for s in range(S):
        propose = rng.random(W) < 0.5
        propose[-3:] = False
        prop[s, propose] = s * BS + rng.integers(0, BS, int(propose.sum()))
    return prop, node_ids.reshape(S, BS), rank_free.reshape(S, BS, R)


@pytest.mark.usefixtures("pallas_names")
class TestPlainEqualsPallas:
    @pytest.mark.parametrize("S", [2, 3, 8])
    def test_block_offsets_vs_ring_offsets_i32(self, S):
        rng = np.random.default_rng(S)
        W = 37  # not a lane multiple: the ring pads, the plain version not
        x = rng.integers(0, 1 << 20, (S, W)).astype(np.int32)
        excl_j, tot_j = shard_run(
            lambda xs: jk.ring_offsets_i32(xs[0], AXIS, S, interpret=True),
            S, x, (P(AXIS), P()),
        )
        excl, tot = pk.block_offsets(t(x.astype(np.int64)))
        assert np.array_equal(excl.numpy(), np.asarray(excl_j).reshape(S, W))
        assert np.array_equal(tot.numpy(), np.asarray(tot_j))

    @pytest.mark.parametrize("S", [2, 3, 8])
    def test_block_offsets_vs_ring_offsets_f64(self, S):
        # exact-integer float64 block totals, up to the 2^53 bound in sum
        rng = np.random.default_rng(10 + S)
        x = rng.integers(0, 1 << 49, (S, 4)).astype(np.float64)
        excl_j, tot_j = shard_run(
            lambda xs: jk.ring_offsets_f64(xs[0], AXIS, S, interpret=True),
            S, x, (P(AXIS), P()),
        )
        excl, tot = pk.block_offsets(t(x))  # float64 in, float64 out
        assert excl.dtype == tot.dtype == torch.float64
        assert np.array_equal(excl.numpy(), np.asarray(excl_j).reshape(S, 4))
        assert np.array_equal(tot.numpy(), np.asarray(tot_j))

    @pytest.mark.parametrize("S", [2, 3, 8])
    def test_block_offsets_strided_f64_vs_ring_offsets_f64(self, S):
        # the lite wave's call: the last row of each block's (BS, R)
        # cumulative-free table, read in place through the row stride
        rng = np.random.default_rng(40 + S)
        BS, R = 5, 4
        cumfree = rng.integers(0, 1 << 49, (S, BS, R)).astype(np.float64)
        view = torch.as_tensor(cumfree)[:, -1, :]
        assert view.stride() == (BS * R, 1) and not view.is_contiguous()
        excl_j, tot_j = shard_run(
            lambda xs: jk.ring_offsets_f64(xs[0], AXIS, S, interpret=True),
            S, cumfree[:, -1, :], (P(AXIS), P()),
        )
        excl, tot = pk.block_offsets(view)
        assert np.array_equal(excl.numpy(), np.asarray(excl_j).reshape(S, R))
        assert np.array_equal(tot.numpy(), np.asarray(tot_j))

    @staticmethod
    def elect_min_rows(S):
        rng = np.random.default_rng(20 + S)
        x = rng.integers(0, 1 << 30, (S, 4, 50)).astype(np.int32)
        x[rng.random(x.shape) < 0.2] = INT32_MAX  # padding never wins...
        x[:, :, -1] = INT32_MAX  # ...unless it is all there is
        want = shard_run(
            lambda xs: jk.elect_min(xs[0], AXIS, S, interpret=True),
            S, x, P(),
        )
        return x, np.asarray(want)

    @pytest.mark.parametrize("S", [2, 3, 8])
    def test_elect_min(self, S):
        x, want = self.elect_min_rows(S)
        got = pk.elect_min(t(x))
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("S", [2, 3, 8])
    def test_elect_min_int64(self, S):
        # the lite wave's call: int64 candidate ranks, the same values
        x, want = self.elect_min_rows(S)
        got = pk.elect_min(t(x.astype(np.int64)))
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("S", [2, 3, 8])
    def test_fused_election(self, S):
        """The plain version against JAX `fused_election` fed the per-shard
        payload the JAX wave builds (`winner_payload`,
        scheduler_plugins_tpu/ops/assign.py:910: node id + 1 and the free
        row as base-2^18 limbs, zero where the shard does not propose)."""
        rng = np.random.default_rng(30 + S)
        BS, R, W = 6, 4, 45
        N = S * BS
        prop, node_ids, rank_free = election_inputs(rng, S, BS, R, W)

        def body(xs):
            prop_s, nid_s, free_s = xs[0][0], xs[1][0], xs[2][0]
            local = prop_s - jax.lax.axis_index(AXIS) * BS
            has = (local >= 0) & (local < BS) & (prop_s < N)
            safe = jnp.clip(local, 0, BS - 1)
            nid = jnp.where(has, nid_s[safe].astype(jnp.int32) + 1, 0)
            row = jnp.where(has[:, None], free_s[safe], 0)  # (W, R)
            limbs = jk.split_limbs(row).transpose(0, 2, 1).reshape(
                jk.N_LIMBS * R, -1
            )
            k, p = jk.fused_election(
                prop_s.astype(jnp.int32),
                jnp.concatenate([nid[None], limbs], axis=0),
                AXIS, S, interpret=True,
            )
            return jnp.concatenate([k[None], p], axis=0)

        want = np.asarray(shard_run(
            body, S, (prop, node_ids, rank_free), P(),
        ))
        want_row = np.asarray(jk.join_limbs(
            want[2:].reshape(jk.N_LIMBS, R, W).transpose(0, 2, 1)
        )).astype(np.int64)
        rank, node_plus, win_row = pk.fused_election(
            t(prop), t(node_ids), t(rank_free)
        )
        assert rank.dtype == node_plus.dtype == win_row.dtype == torch.int64
        assert np.array_equal(rank.numpy(), want[0])
        assert np.array_equal(node_plus.numpy(), want[1])
        assert np.array_equal(win_row.numpy(), want_row)
        # the all-sentinel columns elect the sentinel with a zero payload
        assert (rank.numpy()[-3:] == N).all()
        assert (node_plus.numpy()[-3:] == 0).all()
        assert (win_row.numpy()[-3:] == 0).all()


class TestPlainEdges:
    def test_one_block_is_the_identity(self):
        x = torch.tensor([[3, 5, 7]])
        excl, tot = pk.block_offsets(x)
        assert excl.tolist() == [[0, 0, 0]] and tot.tolist() == [3, 5, 7]
        assert pk.elect_min(x[:, None].to(torch.int32)).tolist() == [[3, 5, 7]]
        # one block: each rank is its own winner, read straight from the
        # carry (rank 8 = N is the sentinel)
        node_ids = torch.arange(8, dtype=torch.int32).flip(0)[None]
        rank_free = torch.arange(16).view(1, 8, 2)
        rank, node_plus, win_row = pk.fused_election(
            torch.tensor([[3, 5, 7, 8]]), node_ids, rank_free
        )
        assert rank.tolist() == [3, 5, 7, 8]
        assert node_plus.tolist() == [5, 3, 1, 0]
        assert win_row.tolist() == [[6, 7], [10, 11], [14, 15], [0, 0]]

    def test_tie_takes_the_first_block(self):
        # S = 3 blocks of BS = 2 (N = 6). Rank 1 (block 0's) is held by
        # blocks 0 and 1, rank 3 (block 1's) by blocks 1 and 2: the first
        # holder wins and owns the rank, so its row is read; a later holder
        # would not own it and would give zeros. The last column is all
        # sentinels.
        prop = torch.tensor([[1, 6, 6], [1, 3, 6], [5, 3, 6]])
        node_ids = torch.tensor([[10, 11], [12, 13], [14, 15]],
                                dtype=torch.int32)
        rank_free = torch.arange(12).view(3, 2, 2)
        rank, node_plus, win_row = pk.fused_election(prop, node_ids, rank_free)
        assert rank.tolist() == [1, 3, 6]
        assert node_plus.tolist() == [12, 14, 0]
        assert win_row.tolist() == [[2, 3], [6, 7], [0, 0]]

    def test_rank_outside_the_holders_block_gives_zeros(self):
        # block 1 proposes rank 0, which block 0 owns: the rank is elected
        # but no row is read for it (the JAX payload rule)
        prop = torch.tensor([[4, 4], [0, 3]])
        node_ids = torch.tensor([[7, 8], [9, -1]], dtype=torch.int32)
        rank_free = torch.arange(1, 9).view(2, 2, 2)
        rank, node_plus, win_row = pk.fused_election(prop, node_ids, rank_free)
        assert rank.tolist() == [0, 3]
        assert node_plus.tolist() == [0, 0]  # rank 3 is padding: id -1
        assert win_row.tolist() == [[0, 0], [7, 8]]


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_uncounted(self):
        pk.reset_launches()
        x = torch.arange(12).view(3, 4)
        assert all(torch.equal(a, b) for a, b in
                   zip(pk.block_offsets(x), pk.block_offsets_plain(x)))
        pk.elect_min(x[:, None].to(torch.int32))
        pk.fused_election(x, x.to(torch.int32), x[:, :, None])
        assert pk.launches() == {name: 0 for name in pk.LAUNCH_SHAPES}

    def test_unsupported_dtype_or_layout_raises(self):
        x = torch.arange(24).view(2, 3, 4)
        for bad in (x[:, 0].to(torch.int32), x[:, 0].float(), x[:, :, 0],
                    x[:, 0].T, x[:0, 0], x):
            with pytest.raises(ValueError, match="block_offsets: want"):
                pk.block_offsets(bad)
        for bad in (x.float(), x.transpose(1, 2), x[:0], x[0]):
            with pytest.raises(ValueError, match="elect_min: want"):
                pk.elect_min(bad)
        prop = torch.zeros((2, 4), dtype=torch.int64)
        node_ids = torch.zeros((2, 3), dtype=torch.int32)
        rank_free = torch.zeros((2, 3, 4), dtype=torch.int64)
        for bad in (prop.to(torch.int32), prop.T, prop[:0], x[:, 0]):
            with pytest.raises(ValueError, match="fused_election prop: "):
                pk.fused_election(bad, node_ids, rank_free)
        for bad in (node_ids.long(), node_ids.T, node_ids[:, :, None]):
            with pytest.raises(ValueError, match="fused_election node_ids: "):
                pk.fused_election(prop, bad, rank_free)
        for bad in (rank_free.float(), rank_free.transpose(1, 2), x[:, 0]):
            with pytest.raises(ValueError, match="fused_election rank_free: "):
                pk.fused_election(prop, node_ids, bad)

    def test_fused_election_blocks_must_agree(self):
        prop = torch.zeros((2, 5), dtype=torch.int64)
        node_ids = torch.zeros((2, 3), dtype=torch.int32)
        for rank_free in (torch.zeros((3, 3, 4), dtype=torch.int64),
                          torch.zeros((2, 4, 4), dtype=torch.int64)):
            with pytest.raises(ValueError, match="do not share S blocks"):
                pk.fused_election(prop, node_ids, rank_free)
        with pytest.raises(ValueError, match="do not share S blocks"):
            pk.fused_election(prop[:1], node_ids,
                              torch.zeros((2, 3, 4), dtype=torch.int64))

    def test_no_kernel_for_other_devices(self):
        x = torch.empty((2, 4), dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            pk.block_offsets(x)
        with pytest.raises(ValueError, match="different devices"):
            pk.fused_election(torch.zeros((2, 4), dtype=torch.int64),
                              torch.zeros((2, 3), dtype=torch.int32),
                              torch.empty((2, 3, 4), device="meta"))


class TestCallSites:
    @staticmethod
    def record_blocked_solve(monkeypatch):
        """A small blocked solve on the CPU (S = 3, rescue waves included)
        with every kernel wrapper recording (kernel, calling function,
        arguments): returns (calls, stats)."""
        from scheduler_plugins_tpu_torch.models import allocatable_scenario
        from scheduler_plugins_tpu_torch.parallel import solver

        calls = []

        def recording(name):
            kernel = getattr(pk, name)

            def wrapper(*args):
                caller = sys._getframe(1).f_code.co_name
                calls.append((name, caller, args))
                return kernel(*args)
            return wrapper

        for name in pk.LAUNCH_SHAPES:
            monkeypatch.setattr(pk, name, recording(name))
        cluster = allocatable_scenario(12, 400)
        snap, meta = cluster.snapshot(cluster.pending_pods(), device="cpu")
        _, _, _, stats = solver.sharded_wave_solve(
            snap, meta.index.encode({"cpu": 1 << 20, "memory": 1}), 3,
            rescue_window=16, collect_stats=True,
        )
        return calls, stats

    def test_blocked_solve_passes_producer_dtypes_in_place(self, monkeypatch):
        """During a small blocked solve on the CPU, the lite wave hands
        `block_offsets` its float64 block totals as a strided view (no cast,
        no copy) and `elect_min` its int64 candidate ranks; the rescue wave
        hands `block_offsets` its int64 feasible counts; both waves hand
        `fused_election` their int64 proposals and the solve's own
        `node_ids` and resident `rank_free`."""
        calls, stats = self.record_blocked_solve(monkeypatch)
        node_ids, rank_free = stats["node_ids"], stats["rank_free"]
        _, BS, R = rank_free.shape
        assert BS > 1
        kinds = {(name, caller, args[0].dtype) for name, caller, args in calls}
        assert kinds == {
            ("block_offsets", "lite_choice", torch.float64),
            ("elect_min", "lite_choice", torch.int64),
            ("fused_election", "lite_choice", torch.int64),
            ("block_offsets", "rescue_choice", torch.int64),
            ("fused_election", "rescue_choice", torch.int64),
        }
        for name, caller, args in calls:
            x = args[0]
            if name == "block_offsets" and caller == "lite_choice":
                assert x.stride() == (BS * R, 1) and not x.is_contiguous()
            else:
                assert x.is_contiguous()
            if name == "fused_election":
                assert len(args) == 3
                assert args[1].data_ptr() == node_ids.data_ptr()
                assert args[1].shape == node_ids.shape
                assert args[1].dtype == torch.int32
                assert args[2].data_ptr() == rank_free.data_ptr()
                assert args[2].shape == rank_free.shape

    def test_each_wave_elects_once_on_the_resident_carry(self, monkeypatch):
        """One `fused_election` call per wave, and no payload built for it:
        `winner_payload` and the int32 cast of the proposals are gone."""
        import inspect

        from scheduler_plugins_tpu_torch.ops import assign

        calls, stats = self.record_blocked_solve(monkeypatch)
        elections = [c for c in calls if c[0] == "fused_election"]
        assert len(elections) == stats["waves"]
        assert {caller for _, caller, _ in elections} == {
            "lite_choice", "rescue_choice"
        }
        source = inspect.getsource(assign)
        assert "winner_payload" not in source
        assert "prop.to(torch.int32)" not in source


@pytest.mark.cuda
class TestOnCard:
    """Kernel against plain version on the card, at the blocked solve's
    shapes (S = 8 blocks, windows of 256, 1024 and 8192 pods)."""

    @pytest.mark.parametrize("W", [256, 1024, 8192])
    def test_kernels_equal_plain(self, W):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card (CUDA is not available)")
        rng = np.random.default_rng(W)
        dev = torch.device("cuda")
        S, R = 8, 4
        cases = {
            "block_offsets": (t(rng.integers(0, 1 << 40, (S, W))),),
            "elect_min": (t(rng.integers(0, 1 << 30, (S, R, W)).astype(np.int32)),),
            "fused_election": tuple(
                t(a) for a in election_inputs(rng, S, 1280, R, W)
            ),
        }
        pk.reset_launches()
        for name, args in cases.items():
            args = tuple(a.to(dev) for a in args)
            got = getattr(pk, name)(*args)
            want = getattr(pk, f"{name}_plain")(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            assert pk.launches()[name] == 1

    @pytest.fixture
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card (CUDA is not available)")
        return torch.device("cuda")

    @pytest.mark.parametrize("W", [256, 1024, 8192])
    def test_path_dtypes_and_strides_equal_plain(self, card, W):
        """The inputs as the blocked solve gives them: the lite wave's
        strided float64 block totals and int64 candidate ranks, the rescue
        wave's int64 counts, and a strided int64 and a contiguous float64
        block_offsets input besides."""
        rng = np.random.default_rng(W + 1)
        S, BS, R = 8, 1280, 4
        cumfree = t(rng.integers(0, 1 << 40, (S, BS, R)).astype(np.float64))
        wide = t(rng.integers(0, 1 << 40, (S, W + 3)))
        cand = rng.integers(0, S * BS, (S, R, W))
        cand[rng.random(cand.shape) < 0.1] = S * BS  # "no candidate"
        cases = [
            ("block_offsets", cumfree.to(card)[:, -1, :]),
            ("block_offsets", wide.to(card)),
            ("block_offsets", wide.to(card)[:, 3:]),
            ("block_offsets", wide.double().to(card)),
            ("elect_min", t(cand).to(card)),
            ("elect_min", t(cand.astype(np.int32)).to(card)),
        ]
        for name, x in cases:
            pk.reset_launches()
            got = getattr(pk, name)(x)
            want = getattr(pk, f"{name}_plain")(x)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(a.dtype == x.dtype for a in got), name
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            assert pk.LAUNCH_SHAPES[name] == {
                (tuple(x.shape), x.dtype, x.stride()): 1
            }

    def test_unsupported_input_raises_without_launch(self, card):
        x = torch.arange(24, device=card).view(2, 3, 4)
        pk.reset_launches()
        for bad in (x[:, 0].T, x[:, :, 0], x[:, 0].to(torch.int32),
                    x[:, 0].float()):
            with pytest.raises(ValueError, match="block_offsets: want"):
                pk.block_offsets(bad)
        for bad in (x.transpose(1, 2), x.float()):
            with pytest.raises(ValueError, match="elect_min: want"):
                pk.elect_min(bad)
        assert pk.launches() == {name: 0 for name in pk.LAUNCH_SHAPES}

    def test_fused_election_under_graph_capture(self, card):
        """Captured in a CUDA graph, the election reads the carry in place
        at each replay: a change to `rank_free` and `node_ids` after the
        capture shows in the replayed result, and the kernel writes
        neither."""
        rng = np.random.default_rng(11)
        args = tuple(t(a).to(card)
                     for a in election_inputs(rng, 8, 1280, 4, 1024))
        prop, node_ids, rank_free = args
        pk.reset_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = pk.fused_election(*args)
        assert pk.launches()["fused_election"] == 1
        rank_free.add_(1)
        node_ids.add_(1)
        before = [a.clone() for a in args]
        graph.replay()
        torch.cuda.synchronize()
        want = pk.fused_election_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(captured, want))
        assert all(torch.equal(a, b) for a, b in zip(args, before))

    def test_launches_on_the_current_stream(self, card):
        """A user stream and a captured CUDA graph both see the kernels on
        the stream PyTorch makes current."""
        rng = np.random.default_rng(7)
        x = t(rng.integers(0, 1 << 40, (8, 1024))).to(card)
        want = pk.block_offsets_plain(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            got = pk.block_offsets(x)
        side.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = pk.block_offsets(x)
        x.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        want = pk.block_offsets_plain(x)
        assert all(torch.equal(a, b) for a, b in zip(captured, want))
