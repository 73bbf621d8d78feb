"""NodeResourcesAllocatable score (port of `scheduler_plugins_tpu.ops.allocatable`).

Per node (upstream pkg/noderesources/allocatable.go:117-168):

    nodeScore = ( sum_r sign * allocatable_r * weight_r ) / sum_r weight_r

with sign = -1 for Least mode, Go integer division (truncation toward
zero). The score depends only on node allocatables, so it is one static
ranking per solve.
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.utils.intmath import go_div

MODE_LEAST = -1
MODE_MOST = 1


def allocatable_scores(alloc: torch.Tensor, weights: torch.Tensor,
                       mode_sign: int = MODE_LEAST) -> torch.Tensor:
    """(N, R) allocatable x (R,) weights -> (N,) raw int64 scores."""
    weights = weights.to(torch.int64)
    weight_sum = torch.clamp(weights.sum(), min=1)
    node_score = (mode_sign * alloc * weights[None, :]).sum(dim=-1)
    return go_div(node_score, weight_sum)


def demote_scores_int32(raw: torch.Tensor) -> torch.Tensor:
    """Order-preserving demotion of int64 scores to int32: an arithmetic
    right shift by max(ceil(log2(max|raw| + 1)) - 23, 0) squeezes the
    magnitudes under 2^23. The shift count comes from float64 `log2`, as
    in the JAX package, so the two agree at exact powers of two."""
    max_abs = raw.abs().max()
    bits = torch.ceil(torch.log2(max_abs.to(torch.float64) + 1.0))
    shift = torch.clamp(bits - 23, min=0).to(torch.int64)
    return (raw >> shift).to(torch.int32)
