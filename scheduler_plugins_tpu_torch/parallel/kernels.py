"""Cross-block exchange kernels of the blocked wave solve (port of
`scheduler_plugins_tpu.parallel.kernels`).

The JAX package runs these exchanges as Pallas ring programs between TPU
shards (`_ring_call`, scheduler_plugins_tpu/parallel/kernels.py:272). Here
the S node blocks are the leading dimension of one tensor on one card, and
each exchange is one launch of a CUDA kernel from `csrc/election.cu`:

- `block_offsets(x (S, L) int64 | float64)` -> (exclusive prefix (S, L),
  total (L)) replaces `ring_offsets_i32` and `ring_offsets_f64`. `x` may
  be a strided view: any row stride, last stride 1;
- `elect_min(x (S, H, L) int32 | int64, contiguous)` -> (H, L) replaces
  `elect_min`;
- `fused_election(prop (S, W) int64, node_ids (S, BS) int32, rank_free
  (S, BS, R) int64, all contiguous)` -> (rank (W), node id + 1 (W), free
  row (W, R)) replaces `fused_election` together with the payload its
  caller builds: the winner's id and row are read by index from the
  solve's resident tensors, in place.

Each kernel takes the dtype its producer in `ops/assign.py` gives it, so a
call needs no cast or copy launch around it; any other dtype or layout
raises, on the CPU as on the card. Beside each wrapper sits its plain
PyTorch version (`*_plain`). A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises —
there is no fallback.

At the solve's shapes a kernel's device work is a few microseconds, so a
call costs what the host does to dispatch it. The launch path is kept short:
the C entry points are bound once, at the first launch; a call allocates
its output once, reads the current stream's raw handle and makes one
ctypes call with plain integers.

Each wrapper counts its kernel launches in `LAUNCH_SHAPES`, by the
problem's shape ((S, L), (S, H, L), or (S, BS, R, W) for fused_election)
and the dtype and strides of its first input; `launches()` gives the
totals.
"""

from __future__ import annotations

import ctypes

import torch

#: kernel launches since the last `reset_launches()`, by wrapper and input:
#: {kernel: {(shape, dtype, strides): count}}
LAUNCH_SHAPES: dict = {"block_offsets": {}, "elect_min": {},
                       "fused_election": {}}

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: each kernel's C entry point by input dtype, and its argument types
#: (pointers and the stream as c_void_p, so ctypes never cuts them to 32
#: bits)
_ENTRY = {
    "block_offsets": ({torch.int64: "spt_block_offsets_i64",
                       torch.float64: "spt_block_offsets_f64"},
                      [_VP, _I64, _VP, _I32, _I64, _VP]),
    "elect_min": ({torch.int32: "spt_elect_min_i32",
                   torch.int64: "spt_elect_min_i64"},
                  [_VP, _VP, _I32, _I64, _VP]),
    "fused_election": ({torch.int64: "spt_fused_election"},
                       [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I64, _VP]),
}

#: {kernel: {dtype: bound C function}}, filled at the first launch
_FN: dict = {}
#: the current CUDA stream's raw handle by device index, set with `_FN`
_raw_stream = None


def reset_launches() -> None:
    for shapes in LAUNCH_SHAPES.values():
        shapes.clear()


def launches() -> dict:
    """{kernel: launches since the last `reset_launches()`}."""
    return {name: sum(shapes.values())
            for name, shapes in LAUNCH_SHAPES.items()}


def _count(name: str, key: tuple) -> None:
    shapes = LAUNCH_SHAPES[name]
    shapes[key] = shapes.get(key, 0) + 1


def _bind() -> dict:
    """Build and load the election library, bind every entry point once,
    and take PyTorch's reader of the current stream's raw handle (the
    stream a graph capture or a user's `torch.cuda.stream` makes current),
    so that no call builds a `torch.cuda.Stream`."""
    global _raw_stream
    from scheduler_plugins_tpu_torch import _build

    lib = _build.load("election")
    bound = {}
    for name, (symbols, argtypes) in _ENTRY.items():
        bound[name] = {}
        for dtype, symbol in symbols.items():
            fn = bound[name][dtype] = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _FN.update(bound)  # last: a non-empty `_FN` means all of it is bound
    return _FN


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); raises for any other device."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def _bad(name: str, x: torch.Tensor, want: str):
    return ValueError(
        f"{name}: want {want}, got {tuple(x.shape)} {x.dtype} "
        f"strides {x.stride()}"
    )


def _check(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise _bad(name, t, f"a contiguous {ndim}-D {dtype} tensor")
    if t.shape[0] < 1:
        raise ValueError(f"{name}: the block axis is empty")


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def block_offsets_plain(x: torch.Tensor):
    """(exclusive prefix over dim 0, total over dim 0) of `x`."""
    csum = torch.cumsum(x, dim=0)
    return csum - x, csum[-1]


def elect_min_plain(x: torch.Tensor) -> torch.Tensor:
    """Minimum over dim 0."""
    return torch.amin(x, dim=0)


def fused_election_plain(prop: torch.Tensor, node_ids: torch.Tensor,
                         rank_free: torch.Tensor):
    """(min of `prop` over dim 0, node id + 1 and free row of that rank in
    the first block holding it; zeros where that rank is not a real rank of
    that block)."""
    S, BS = node_ids.shape
    rank, src = torch.min(prop, dim=0)  # first minimal index on ties
    local = rank - src * BS
    has = (rank < S * BS) & (local >= 0) & (local < BS)
    safe = torch.clamp(local, 0, BS - 1)
    node_plus = torch.where(has, node_ids[src, safe].to(torch.int64) + 1, 0)
    win_row = torch.where(has[:, None], rank_free[src, safe], 0)
    return rank, node_plus, win_row


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def block_offsets(x: torch.Tensor):
    """(exclusive prefix (S, L), total (L)) of `x` (S, L) over the block
    axis, in `x`'s dtype: int64 (`ring_offsets_i32`,
    scheduler_plugins_tpu/parallel/kernels.py:357) or float64 holding exact
    integers (`ring_offsets_f64`, :370). `x` may have any row stride; its
    last stride must be 1. On the card both results are views of one
    (S + 1, L) buffer."""
    on_card = _on_card(x)
    dtype, strides = x.dtype, x.stride()
    if (dtype not in _ENTRY["block_offsets"][0] or len(strides) != 2
            or strides[1] != 1 or x.shape[0] < 1):
        raise _bad("block_offsets", x,
                   "a 2-D int64 or float64 tensor with last stride 1 and "
                   "a non-empty block axis")
    if not on_card:
        return block_offsets_plain(x)
    S, L = x.shape
    out = x.new_empty((S + 1, L))
    rc = (_FN or _bind())["block_offsets"][dtype](
        x.data_ptr(), strides[0], out.data_ptr(), S, L,
        _raw_stream(x.get_device()),
    )
    _raise_on(rc, "block_offsets")
    _count("block_offsets", ((S, L), dtype, strides))
    return out[:S], out[S]


def elect_min(x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of contiguous int32 or int64 `x` (S, H, L) over
    the block axis. Replaces `elect_min`
    (scheduler_plugins_tpu/parallel/kernels.py:387)."""
    on_card = _on_card(x)
    dtype = x.dtype
    if (dtype not in _ENTRY["elect_min"][0] or x.dim() != 3
            or not x.is_contiguous() or x.shape[0] < 1):
        raise _bad("elect_min", x,
                   "a contiguous 3-D int32 or int64 tensor with a "
                   "non-empty block axis")
    if not on_card:
        return elect_min_plain(x)
    S, H, L = x.shape
    out = x.new_empty((H, L))
    rc = (_FN or _bind())["elect_min"][dtype](
        x.data_ptr(), out.data_ptr(), S, H * L, _raw_stream(x.get_device())
    )
    _raise_on(rc, "elect_min")
    _count("elect_min", ((S, H, L), dtype, x.stride()))
    return out


def fused_election(prop: torch.Tensor, node_ids: torch.Tensor,
                   rank_free: torch.Tensor):
    """Min-rank election with the winner's node and free row. `prop`
    (S, W) int64 holds each block's proposed global rank or the sentinel
    N = S*BS; `node_ids` (S, BS) int32 and `rank_free` (S, BS, R) int64 are
    the solve's own tensors, read in place and never written. Returns
    (rank (W,), node id + 1 (W,), free row (W, R)) of the first block
    holding each column's minimum, the last two zero where that rank is not
    a real rank of that block. Replaces `fused_election`
    (scheduler_plugins_tpu/parallel/kernels.py:411) with the payload its
    caller builds (scheduler_plugins_tpu/ops/assign.py:910). On the card the
    three results are views of one buffer."""
    if not prop.device == node_ids.device == rank_free.device:
        raise ValueError(
            f"tensors on different devices: {prop.device}, "
            f"{node_ids.device}, {rank_free.device}"
        )
    on_card = _on_card(prop)
    _check(prop, torch.int64, 2, "fused_election prop")
    _check(node_ids, torch.int32, 2, "fused_election node_ids")
    _check(rank_free, torch.int64, 3, "fused_election rank_free")
    S, W = prop.shape
    BS = node_ids.shape[1]
    R = rank_free.shape[2]
    if node_ids.shape[0] != S or rank_free.shape[:2] != (S, BS) or BS < 1:
        raise ValueError(
            f"fused_election: prop {tuple(prop.shape)}, node_ids "
            f"{tuple(node_ids.shape)} and rank_free "
            f"{tuple(rank_free.shape)} do not share S blocks of BS >= 1"
        )
    if not on_card:
        return fused_election_plain(prop, node_ids, rank_free)
    out = prop.new_empty((2 + R) * W)
    rc = (_FN or _bind())["fused_election"][torch.int64](
        prop.data_ptr(), node_ids.data_ptr(), rank_free.data_ptr(),
        out.data_ptr(), S, BS, R, W, _raw_stream(prop.get_device()),
    )
    _raise_on(rc, "fused_election")
    _count("fused_election", ((S, BS, R, W), torch.int64, prop.stride()))
    # `split_with_sizes` is bound in C++; `Tensor.split` wraps it in Python
    rank, node_plus, rows = out.split_with_sizes((W, W, R * W))
    return rank, node_plus, rows.view(W, R)
