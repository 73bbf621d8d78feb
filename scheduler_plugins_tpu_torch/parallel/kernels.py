"""Cross-block exchange kernels of the blocked wave solve (port of
`scheduler_plugins_tpu.parallel.kernels`).

The JAX package runs these exchanges as Pallas ring programs between TPU
shards (`_ring_call`, scheduler_plugins_tpu/parallel/kernels.py:272). Here
the S node blocks are the leading dimension of one tensor on one card, and
each exchange is one launch of a CUDA kernel from `csrc/election.cu`:

- `block_offsets(x (S, L) int64)` -> (exclusive prefix (S, L), total (L))
  replaces `ring_offsets_f64` and `ring_offsets_i32`;
- `elect_min(x (S, H, L) int32)` -> (H, L) replaces `elect_min`;
- `fused_election(keys (S, L) int32, payload (S, H, L) int64)` ->
  (min key (L), winner payload (H, L)) replaces `fused_election`.

Beside each wrapper sits its plain PyTorch version (`*_plain`). A wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises — there is no fallback. Each wrapper counts
its kernel launches, by input shape, in `LAUNCH_SHAPES`; `launches()`
gives the totals.
"""

from __future__ import annotations

import ctypes

import torch

#: kernel launches since the last `reset_launches()`, by wrapper and input
#: shape: {kernel: {shape: count}}
LAUNCH_SHAPES: dict = {"block_offsets": {}, "elect_min": {},
                       "fused_election": {}}

_BOUND = False


def reset_launches() -> None:
    for shapes in LAUNCH_SHAPES.values():
        shapes.clear()


def launches() -> dict:
    """{kernel: launches since the last `reset_launches()`}."""
    return {name: sum(shapes.values())
            for name, shapes in LAUNCH_SHAPES.items()}


def _count(name: str, shape: tuple) -> None:
    shapes = LAUNCH_SHAPES[name]
    shapes[shape] = shapes.get(shape, 0) + 1


def _lib():
    """The election kernels' library, built on first use, with argtypes
    bound (pointers and the stream as c_void_p, so ctypes never truncates
    them to 32 bits)."""
    global _BOUND
    from scheduler_plugins_tpu_torch import _build

    lib = _build.load("election")
    if not _BOUND:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.spt_block_offsets.argtypes = [vp, vp, vp, i32, i64, vp]
        lib.spt_elect_min.argtypes = [vp, vp, i32, i64, vp]
        lib.spt_fused_election.argtypes = [vp, vp, vp, vp, i32, i32, i64, vp]
        for fn in (lib.spt_block_offsets, lib.spt_elect_min,
                   lib.spt_fused_election):
            fn.restype = ctypes.c_int
        _BOUND = True
    return lib


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version path);
    False when every tensor lies on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _check(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {ndim}-D {dtype} tensor, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
        )
    if t.shape[0] < 1:
        raise ValueError(f"{name}: the block axis is empty")


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def block_offsets_plain(x: torch.Tensor):
    """(exclusive prefix over dim 0, total over dim 0) of int64 `x`."""
    csum = torch.cumsum(x, dim=0)
    return csum - x, csum[-1]


def elect_min_plain(x: torch.Tensor) -> torch.Tensor:
    """Minimum over dim 0."""
    return torch.amin(x, dim=0)


def fused_election_plain(keys: torch.Tensor, payload: torch.Tensor):
    """(min key over dim 0, payload column of the first block holding it)."""
    key, src = torch.min(keys, dim=0)  # first minimal index on ties
    H = payload.shape[1]
    win = torch.gather(payload, 0, src[None, None, :].expand(1, H, -1))
    return key, win[0]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def block_offsets(x: torch.Tensor):
    """(exclusive prefix (S, L), total (L)) of int64 `x` (S, L) over the
    block axis. Replaces `ring_offsets_f64`/`ring_offsets_i32`
    (scheduler_plugins_tpu/parallel/kernels.py:370 / :357)."""
    if _on_cpu(x):
        return block_offsets_plain(x)
    _check(x, torch.int64, 2, "block_offsets")
    S, L = x.shape
    excl = torch.empty_like(x)
    total = torch.empty(L, dtype=x.dtype, device=x.device)
    rc = _lib().spt_block_offsets(
        x.data_ptr(), excl.data_ptr(), total.data_ptr(), S, L, _stream()
    )
    _raise_on(rc, "block_offsets")
    _count("block_offsets", (S, L))
    return excl, total


def elect_min(x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum of int32 `x` (S, H, L) over the block axis.
    Replaces `elect_min` (scheduler_plugins_tpu/parallel/kernels.py:387)."""
    if _on_cpu(x):
        return elect_min_plain(x)
    _check(x, torch.int32, 3, "elect_min")
    S, H, L = x.shape
    out = torch.empty((H, L), dtype=x.dtype, device=x.device)
    rc = _lib().spt_elect_min(
        x.data_ptr(), out.data_ptr(), S, H * L, _stream()
    )
    _raise_on(rc, "elect_min")
    _count("elect_min", (S, H, L))
    return out


def fused_election(keys: torch.Tensor, payload: torch.Tensor):
    """Min-key election with the winner's payload: `keys` (S, L) int32,
    `payload` (S, H, L) int64 -> (min key (L), payload of the first block
    holding the minimum (H, L)). Replaces `fused_election`
    (scheduler_plugins_tpu/parallel/kernels.py:411)."""
    if _on_cpu(keys, payload):
        return fused_election_plain(keys, payload)
    _check(keys, torch.int32, 2, "fused_election keys")
    _check(payload, torch.int64, 3, "fused_election payload")
    S, L = keys.shape
    H = payload.shape[1]
    if payload.shape != (S, H, L):
        raise ValueError(
            f"fused_election: payload {tuple(payload.shape)} does not "
            f"match keys {tuple(keys.shape)}"
        )
    key_out = torch.empty(L, dtype=keys.dtype, device=keys.device)
    pay_out = torch.empty((H, L), dtype=payload.dtype, device=payload.device)
    rc = _lib().spt_fused_election(
        keys.data_ptr(), payload.data_ptr(), key_out.data_ptr(),
        pay_out.data_ptr(), S, H, L, _stream(),
    )
    _raise_on(rc, "fused_election")
    _count("fused_election", (S, H, L))
    return key_out, pay_out
