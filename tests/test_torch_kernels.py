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
    """`fn` per shard over the leading axis of `x` on an S-device mesh."""
    mesh = Mesh(np.asarray(jax.devices()[:S]), (AXIS,))
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=P(AXIS),
                          out_specs=out_specs, check_rep=False))
    return f(jnp.asarray(x))


def t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def election_inputs(rng, S, W, H, sentinel):
    """Per-block keys (S, W) unique across blocks, the shared sentinel
    where a block does not propose (zero payload there), payload
    (S, H, W); the last columns are all-sentinel (the tie edge)."""
    keys = np.full((S, W), sentinel, np.int32)
    payload = np.zeros((S, H, W), np.int32)
    for s in range(S):
        propose = rng.random(W) < 0.5
        propose[-3:] = False
        keys[s, propose] = s * 1000 + rng.integers(0, 1000, int(propose.sum()))
        payload[s][:, propose] = rng.integers(1, 1 << 18, (H, int(propose.sum())))
    return keys, payload


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
        rng = np.random.default_rng(30 + S)
        W, H = 45, 13  # node id + 1 and four resources as three limbs
        sentinel = S * 1000
        keys, payload = election_inputs(rng, S, W, H, sentinel)
        flat = np.concatenate([keys[:, None, :], payload], axis=1)

        def body(xs):
            k, p = jk.fused_election(xs[0, 0], xs[0, 1:], AXIS, S,
                                     interpret=True)
            return jnp.concatenate([k[None], p], axis=0)

        want = np.asarray(shard_run(body, S, flat, P()))
        key, pay = pk.fused_election(t(keys), t(payload.astype(np.int64)))
        assert np.array_equal(key.numpy(), want[0])
        assert np.array_equal(pay.numpy(), want[1:])
        # the all-sentinel columns elect the sentinel with a zero payload
        assert (key.numpy()[-3:] == sentinel).all()
        assert (pay.numpy()[:, -3:] == 0).all()


class TestPlainEdges:
    def test_one_block_is_the_identity(self):
        x = torch.tensor([[3, 5, 7]])
        excl, tot = pk.block_offsets(x)
        assert excl.tolist() == [[0, 0, 0]] and tot.tolist() == [3, 5, 7]
        assert pk.elect_min(x[:, None].to(torch.int32)).tolist() == [[3, 5, 7]]
        key, pay = pk.fused_election(x.to(torch.int32), x[:, None])
        assert key.tolist() == [3, 5, 7] and pay.tolist() == [[3, 5, 7]]

    def test_tie_takes_the_first_block(self):
        keys = torch.tensor([[4, 9], [4, 2], [1, 2]], dtype=torch.int32)
        payload = torch.arange(6).view(3, 1, 2)
        key, pay = pk.fused_election(keys, payload)
        assert key.tolist() == [1, 2] and pay.tolist() == [[4, 3]]


class TestWrappers:
    def test_cpu_tensors_take_the_plain_version_uncounted(self):
        pk.reset_launches()
        x = torch.arange(12).view(3, 4)
        assert all(torch.equal(a, b) for a, b in
                   zip(pk.block_offsets(x), pk.block_offsets_plain(x)))
        pk.elect_min(x[:, None].to(torch.int32))
        pk.fused_election(x.to(torch.int32), x[:, None])
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
        with pytest.raises(ValueError, match="keys: want"):
            pk.fused_election(x[:, 0], x)

    def test_no_kernel_for_other_devices(self):
        x = torch.empty((2, 4), dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            pk.block_offsets(x)
        with pytest.raises(ValueError, match="different devices"):
            pk.fused_election(torch.zeros((2, 4), dtype=torch.int32),
                              torch.empty((2, 1, 4), device="meta"))


class TestCallSites:
    def test_blocked_solve_passes_producer_dtypes_in_place(self, monkeypatch):
        """During a small blocked solve on the CPU, the lite wave hands
        `block_offsets` its float64 block totals as a strided view (no cast,
        no copy) and `elect_min` its int64 candidate ranks; the rescue wave
        hands `block_offsets` its int64 feasible counts."""
        from scheduler_plugins_tpu_torch.models import allocatable_scenario
        from scheduler_plugins_tpu_torch.parallel import solver

        calls = []

        def recording(name):
            kernel = getattr(pk, name)

            def wrapper(x):
                caller = sys._getframe(1).f_code.co_name
                calls.append((name, caller, x.dtype, x.stride(),
                              x.is_contiguous()))
                return kernel(x)
            return wrapper

        for name in ("block_offsets", "elect_min"):
            monkeypatch.setattr(pk, name, recording(name))
        cluster = allocatable_scenario(12, 400)
        snap, meta = cluster.snapshot(cluster.pending_pods(), device="cpu")
        S = 3
        _, _, _, stats = solver.sharded_wave_solve(
            snap, meta.index.encode({"cpu": 1 << 20, "memory": 1}), S,
            rescue_window=16, collect_stats=True,
        )
        _, BS, R = stats["rank_free"].shape
        assert BS > 1
        kinds = {(name, caller, dtype) for name, caller, dtype, _, _ in calls}
        assert kinds == {
            ("block_offsets", "lite_choice", torch.float64),
            ("elect_min", "lite_choice", torch.int64),
            ("block_offsets", "rescue_choice", torch.int64),
        }
        for name, caller, dtype, strides, contiguous in calls:
            if name == "block_offsets" and caller == "lite_choice":
                assert strides == (BS * R, 1) and not contiguous
            else:
                assert contiguous


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
                t(a.astype(d)) for a, d in zip(
                    election_inputs(rng, S, W, 1 + R, S * W),
                    (np.int32, np.int64))
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
