"""Carry JAX-package solver inputs across to the port.

`snapshot_from_numpy(tree, device)` takes the JAX `ClusterSnapshot` as a
nested dict of numpy arrays — `{"nodes": {"alloc": ..., ...}, "pods":
{...}, "gangs": {...} or None, "quota": {...} or None, "nominees": {...}
or None, "metrics": {...} or None, "numa": {...} or None, "network":
{...} or None, "syscalls": {...} or None, "scheduling": {...} or None}`
— and returns the port's `ClusterSnapshot` on `device`, so both
packages can solve the very same tensors. Fields the port's slice does not
carry are ignored; a field the port needs and the tree lacks raises
`KeyError`; an absent table is None. The NUMA table's `pack_scales` is a
static tuple of ints (None when the float64 path rules), whatever array
the tree holds for it.

`state_from_numpy(tree, device)` does the same for a JAX `SolverState`
(`Scheduler.initial_state`) given as a dict of numpy arrays or None, so
both solves can start from the very same carry.

`rank_gang_state_from_numpy(tree, device)` turns a JAX
`gangs.topology.RankGangState` given as a dict of numpy arrays into the
port's, each field in the port's dtype.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.framework.plugin import SolverState
from scheduler_plugins_tpu_torch.gangs.topology import RankGangState
from scheduler_plugins_tpu_torch.state.snapshot import (
    ClusterSnapshot,
    GangState,
    MetricsState,
    NetworkState,
    NodeState,
    NomineeState,
    NumaState,
    PodState,
    QuotaState,
    SyscallState,
)
from scheduler_plugins_tpu_torch.state.scheduling import SchedulingState

_TABLES = {
    "nodes": NodeState,
    "pods": PodState,
    "gangs": GangState,
    "quota": QuotaState,
    "nominees": NomineeState,
    "metrics": MetricsState,
    "numa": NumaState,
    "network": NetworkState,
    "syscalls": SyscallState,
    "scheduling": SchedulingState,
}


def snapshot_from_numpy(tree: dict, device=None) -> ClusterSnapshot:
    device = resolve_device(device)
    parts = {}
    for name, cls in _TABLES.items():
        table = tree.get(name)
        if table is None:
            parts[name] = None
            continue
        if cls is SchedulingState:
            parts[name] = _scheduling(table)
            continue
        parts[name] = cls(**{
            f.name: _static(table.get(f.name)) if f.name == "pack_scales"
            else np.asarray(table[f.name])
            for f in fields(cls)
        })
    return ClusterSnapshot(**parts).to(device)


def _scheduling(table: dict) -> SchedulingState:
    out = {}
    for f in fields(SchedulingState):
        value = table.get(f.name)
        if f.name == "spread_needs_node_counts":
            out[f.name] = bool(value)
        elif value is not None:
            value = np.asarray(value)
            out[f.name] = (value.astype(np.int64)
                           if value.dtype == np.int32 else value)
    return SchedulingState(**out)


def _static(scales):
    return None if scales is None else tuple(
        int(x) for x in np.asarray(scales).ravel()
    )


def state_from_numpy(tree: dict, device=None) -> SolverState:
    device = resolve_device(device)
    return SolverState(**{
        f.name: torch.tensor(np.asarray(tree[f.name]), device=device)
        for f in fields(SolverState) if tree.get(f.name) is not None
    })


def rank_gang_state_from_numpy(tree: dict, device=None) -> RankGangState:
    """The port's `RankGangState` on `device` from a JAX one as a dict of
    numpy arrays (every field required)."""
    device = resolve_device(device)
    return RankGangState(**{
        f.name: np.asarray(tree[f.name]) for f in fields(RankGangState)
    }).to(device)
