"""Score normalization (port of `scheduler_plugins_tpu.ops.normalize`).

Each mirrors one reference normalizer bit for bit, integer truncation
included:

- `minmax_normalize`  NodeResourcesAllocatable.NormalizeScore (upstream
  pkg/noderesources/allocatable.go:143-168);
- `default_normalize` upstream helper.DefaultNormalizeScore (reverse for
  the SySched and PodState flavors);
- `peaks_normalize`   the Peaks inversion (trimaran peaks.go:152-168).

Each runs row-wise on (..., N) scores with an (..., N) validity mask
(which nodes made it into the NodeScoreList); entries outside the mask
come back 0.
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.ops import MAX_NODE_SCORE, MIN_NODE_SCORE
from scheduler_plugins_tpu_torch.utils.intmath import (
    masked_max,
    masked_min,
    saturating_int64,
)


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


def default_normalize(scores: torch.Tensor, mask, reverse: bool = False
                      ) -> torch.Tensor:
    """Upstream helper.DefaultNormalizeScore: scale by the max to [0, 100];
    all 0 when the max is 0 (all 100 when `reverse`)."""
    max_count = torch.clamp(masked_max(scores, mask, keepdim=True), min=0)
    scaled = scores * MAX_NODE_SCORE // torch.clamp(max_count, min=1)
    out = torch.where(max_count == 0, 0, scaled)
    if reverse:
        out = MAX_NODE_SCORE - out
    return torch.where(mask, out, 0)


def peaks_normalize(scores: torch.Tensor, mask) -> torch.Tensor:
    """The Peaks inverted min-max: the lowest power jump wins
    (peaks.go:152-168). The Go code's float64 multiply and int64
    truncation are kept."""
    lo = masked_min(scores, mask, keepdim=True)
    hi = masked_max(scores, mask, keepdim=True)
    all_zero = (lo == 0) & (hi == 0)
    shifted = (scores - lo).to(torch.float64)
    norm = saturating_int64(torch.where(
        hi != lo,
        torch.trunc(MAX_NODE_SCORE * shifted
                    / torch.clamp(hi - lo, min=1).to(torch.float64)),
        shifted,
    ))
    out = torch.where(all_zero, scores, MAX_NODE_SCORE - norm)
    return torch.where(mask, out, 0)
