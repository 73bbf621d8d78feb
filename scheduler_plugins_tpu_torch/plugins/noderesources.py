"""NodeResourcesAllocatable (port of `scheduler_plugins_tpu.plugins.noderesources`).

Score-only: favours nodes with the least (or most) total allocatable,
weighted per resource (upstream pkg/noderesources/allocatable.go:42-168,
resource_allocation.go:30-48). The raw score rates the node, never the
pod, so the solve computes it once (`prepare_solve`) and min-max
normalizes it over each pod's feasible set.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import CPU, MEMORY
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops.allocatable import (
    MODE_LEAST,
    MODE_MOST,
    allocatable_scores,
)
from scheduler_plugins_tpu_torch.ops.normalize import minmax_normalize

#: default weights: a millicore weighs as much as 1 MiB
#: (resource_allocation.go:36)
DEFAULT_RESOURCES = ((CPU, 1 << 20), (MEMORY, 1))


class NodeResourcesAllocatable(Plugin):
    name = "NodeResourcesAllocatable"
    #: the step scores from the presolve alone (`_weights` is read by
    #: `prepare_solve`, outside the loop)
    step_reads_inputs_only = True

    def __init__(
        self,
        resources: Sequence[tuple[str, int]] = DEFAULT_RESOURCES,
        mode: str = "Least",
    ):
        if mode not in ("Least", "Most"):
            raise ValueError(f"invalid mode {mode!r}")  # validation_pluginargs.go:60-75
        for _, weight in resources:
            if weight <= 0:
                raise ValueError("resource weight must be positive")
        self.resources = tuple(resources)
        self.mode_sign = MODE_LEAST if mode == "Least" else MODE_MOST
        self._weights: Optional[torch.Tensor] = None

    def prepare(self, meta):
        w = np.zeros(len(meta.index), np.int64)
        for name, weight in self.resources:
            if name in meta.index:
                w[meta.index.position(name)] = weight
        self._weights = torch.tensor(w, device=meta.device)

    def aux(self):
        return self._weights

    def bind_aux(self, aux):
        self._weights = aux

    def static_node_scores(self, snap):
        # allocatable scores rate the NODE, never the pod
        # (resource_allocation.go:49-76)
        return allocatable_scores(
            snap.nodes.alloc, self._weights.to(snap.device), self.mode_sign
        )

    def prepare_solve(self, snap):
        return self.static_node_scores(snap)

    def score(self, state, snap, p):
        if self._presolve is None:
            return self.static_node_scores(snap)
        return self._presolve

    def normalize(self, scores, feasible):
        return minmax_normalize(scores, feasible)
