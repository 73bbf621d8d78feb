"""Score normalization (port of `scheduler_plugins_tpu.ops.normalize`).

`minmax_normalize` mirrors NodeResourcesAllocatable.NormalizeScore
(upstream pkg/noderesources/allocatable.go:143-168) bit for bit. It runs
row-wise on (..., N) scores with an (..., N) validity mask (which nodes
made it into the NodeScoreList); entries outside the mask come back 0.
`default_normalize` and `peaks_normalize` come with the plugins that use
them.
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.ops import MAX_NODE_SCORE, MIN_NODE_SCORE
from scheduler_plugins_tpu_torch.utils.intmath import masked_max, masked_min


def minmax_normalize(scores: torch.Tensor, mask) -> torch.Tensor:
    """((score - lowest) * 100 / oldRange) + MinNodeScore; all
    MinNodeScore when every score is equal (allocatable.go:155-166). The
    operands of `//` are non-negative wherever the mask holds, so floor
    division is Go's truncating division there; int64 throughout."""
    lo = masked_min(scores, mask, keepdim=True)
    hi = masked_max(scores, mask, keepdim=True)
    old_range = hi - lo
    new_range = MAX_NODE_SCORE - MIN_NODE_SCORE
    out = torch.where(
        old_range == 0,
        MIN_NODE_SCORE,
        (scores - lo) * new_range // torch.clamp(old_range, min=1)
        + MIN_NODE_SCORE,
    )
    return torch.where(mask, out, 0)
