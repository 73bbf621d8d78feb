"""Go-faithful integer helpers (port of `scheduler_plugins_tpu.utils.intmath`)."""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.utils import sanitize


def go_div(a: torch.Tensor, b) -> torch.Tensor:
    """Integer division truncating toward zero (Go semantics), b > 0.

    `torch.div(..., rounding_mode="trunc")` is Go's truncation; Python's
    and PyTorch's `//` floor, which differs for negative numerators (the
    Least-mode allocatable scores are negative). Inside a checked call
    (`utils.sanitize`) a zero tensor divisor is reported and divides as 1
    (an integer division by zero raises on the CPU and is undefined on
    the card)."""
    check = sanitize.current()
    if check is not None:
        b = check.divisor(b, "go_div")
    return torch.div(a, b, rounding_mode="trunc")


def floordiv_exact(a, b) -> torch.Tensor:
    """Exact floor(a/b) in floating point for integer-valued inputs, b > 0.

    Runs in `a`'s dtype when it is floating (callers guarantee the values
    and intermediate products are exactly representable there), else
    float64: a correctly-rounded division, then a one-step correction,
    since the float quotient can land one off across an integer boundary
    (the remainder check is exact at these magnitudes). For non-negative
    `a` this equals Go's truncating division."""
    a = torch.as_tensor(a)
    dt = a.dtype if a.is_floating_point() else torch.float64
    af = a.to(dt)
    bf = torch.as_tensor(b, device=a.device).to(dt)
    q = torch.floor(af / bf)
    r = af - q * bf  # exact: |r| < 2b
    q = torch.where(r < 0, q - 1.0, q)
    return torch.where(r >= bf, q + 1.0, q)


def floordiv_recip(a, b, brecip) -> torch.Tensor:
    """`floordiv_exact` with a precomputed reciprocal `brecip` ~= 1/b: one
    multiply, then two exact remainder corrections, since the estimate
    can be a unit or two off (brecip's rounding error scaled by a). The
    same caller contract as `floordiv_exact`: products exact in the
    working dtype, so the result is floor(a/b) whatever brecip's last
    bit."""
    a = torch.as_tensor(a)
    dt = a.dtype if a.is_floating_point() else torch.float64
    af = a.to(dt)
    bf = torch.as_tensor(b, device=a.device).to(dt)
    q = torch.floor(af * brecip.to(dt))
    for _ in range(2):
        r = af - q * bf  # exact at the callers' magnitudes
        q = torch.where(r < 0, q - 1.0, q)
        q = torch.where(r >= bf, q + 1.0, q)
    return q


def round_half_away(x) -> torch.Tensor:
    """Go `math.Round`: round half away from zero, as int64 (exact for
    |x| < 2^53). `torch.round` rounds half to even. The fractional part is
    compared exactly against 0.5 (`x - floor(x)` is exact), never through
    the `floor(x + 0.5)` idiom, whose addition itself rounds."""
    x = torch.as_tensor(x)
    f = torch.floor(x)
    pos = torch.where(x - f >= 0.5, f + 1, f)
    c = torch.ceil(x)
    neg = torch.where(c - x >= 0.5, c - 1, c)
    return torch.where(x >= 0, pos, neg).to(torch.int64)


def saturating_int64(x: torch.Tensor) -> torch.Tensor:
    """Float to int64 as XLA converts: values at or past +-2^63 saturate
    to the int64 bounds and NaN becomes 0. A plain `.to(torch.int64)` is
    undefined out of range (INT64_MIN on x86)."""
    big = 2.0 ** 63
    out = torch.where(torch.isnan(x) | (x >= big) | (x < -big), 0.0,
                      x).to(torch.int64)
    out = torch.where(x >= big, torch.iinfo(torch.int64).max, out)
    return torch.where(x < -big, torch.iinfo(torch.int64).min, out)


def _dtype_bounds(dtype):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min, info.max


def masked_min(scores: torch.Tensor, mask, dim: int = -1,
               keepdim: bool = False) -> torch.Tensor:
    """Min over `mask`-selected entries; the dtype's max where the mask is
    empty (the reference's `lowest := math.MaxInt64` loop start)."""
    _, sentinel = _dtype_bounds(scores.dtype)
    return torch.where(mask, scores, sentinel).amin(dim=dim, keepdim=keepdim)


def masked_max(scores: torch.Tensor, mask, dim: int = -1,
               keepdim: bool = False) -> torch.Tensor:
    """Max over `mask`-selected entries; the dtype's min where the mask is
    empty."""
    sentinel, _ = _dtype_bounds(scores.dtype)
    return torch.where(mask, scores, sentinel).amax(dim=dim, keepdim=keepdim)


def bucket_size(n: int, minimum: int = 8) -> int:
    """Static-shape padding bucket: powers of two up to 1024, then
    multiples of 1024 — the JAX package's rule, kept so both packages pad
    a snapshot to the same shape."""
    size = minimum
    while size < n and size < 1024:
        size *= 2
    if n <= size:
        return size
    return ((n + 1023) // 1024) * 1024


def add_rows(target: torch.Tensor, index: torch.Tensor,
             src: torch.Tensor) -> torch.Tensor:
    """`torch.index_add(target, 0, index, src)` as a new tensor: `src`'s
    rows added into `target`'s rows `index` ((M,) int64), duplicates
    accumulating. Written as one `scatter_add` because under
    `torch.func.vmap` (the lane solve, `parallel.lanes`) `index_add`'s
    batching rule loops over the batch, one kernel a lane, while
    `scatter_add`'s is one op. Exact for integer dtypes in any order.
    Inside a checked call (`utils.sanitize`) an index outside `target`'s
    rows is reported and its row adds nothing."""
    check = sanitize.current()
    if check is not None:
        index, src = check.rows(index, target.shape[0], "add_rows", src)
    if target.dim() > 1:
        index = index[:, None].expand(-1, *target.shape[1:])
    return torch.scatter_add(target, 0, index, src)
