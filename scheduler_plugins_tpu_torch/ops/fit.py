"""Resource fit (port of `scheduler_plugins_tpu.ops.fit`): a pod fits a node
iff `demand <= free` on every resource, the pods slot counting 1 per pod."""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.ops import PODS_I


def free_capacity(alloc: torch.Tensor, requested: torch.Tensor) -> torch.Tensor:
    """(N, R) leftover allocatable."""
    return alloc - requested


def pod_fit_demand(req: torch.Tensor) -> torch.Tensor:
    """The effective request with the pod-count slot set to 1 (a fill on
    the device: item assignment of a Python number would copy it from the
    host and wait for the card)."""
    demand = req.clone()
    demand[..., PODS_I].fill_(1)
    return demand


def fits(req, free, pod_mask=None, node_mask=None) -> torch.Tensor:
    """(P, R) requests vs (N, R) free capacity -> (P, N) feasibility.
    `free` must already account for assigned pods (alloc - requested)."""
    demand = pod_fit_demand(req)
    ok = torch.all(demand[:, None, :] <= free[None, :, :], dim=-1)
    if pod_mask is not None:
        ok &= pod_mask[:, None]
    if node_mask is not None:
        ok &= node_mask[None, :]
    return ok


def fits_one(req, free, node_mask=None) -> torch.Tensor:
    """(R,) single-pod request vs (N, R) free -> (N,) feasibility (the
    sequential step's built-in Filter)."""
    ok = torch.all(pod_fit_demand(req)[None, :] <= free, dim=-1)
    if node_mask is not None:
        ok = ok & node_mask
    return ok
