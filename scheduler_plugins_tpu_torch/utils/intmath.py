"""Go-faithful integer helpers (port of `scheduler_plugins_tpu.utils.intmath`)."""

from __future__ import annotations

import torch


def go_div(a: torch.Tensor, b) -> torch.Tensor:
    """Integer division truncating toward zero (Go semantics), b > 0.

    `torch.div(..., rounding_mode="trunc")` is Go's truncation; Python's
    and PyTorch's `//` floor, which differs for negative numerators (the
    Least-mode allocatable scores are negative)."""
    return torch.div(a, b, rounding_mode="trunc")


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
