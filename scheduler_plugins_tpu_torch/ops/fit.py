"""Resource fit (port of `scheduler_plugins_tpu.ops.fit`): a pod fits a node
iff `demand <= free` on every resource, the pods slot counting 1 per pod."""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.ops import PODS_I


def free_capacity(alloc: torch.Tensor, requested: torch.Tensor) -> torch.Tensor:
    """(N, R) leftover allocatable."""
    return alloc - requested


def pod_fit_demand(req: torch.Tensor) -> torch.Tensor:
    """The effective request with the pod-count slot set to 1."""
    demand = req.clone()
    demand[..., PODS_I] = 1
    return demand
