"""Carry a JAX-package snapshot across to the port.

`snapshot_from_numpy(tree, device)` takes the JAX `ClusterSnapshot` as a
nested dict of numpy arrays — `{"nodes": {"alloc": ..., ...}, "pods":
{...}, "gangs": {...} or None, "quota": {...} or None}` — and returns the
port's `ClusterSnapshot` on `device`, so both packages can solve the very
same tensors. Fields the port's slice does not carry are ignored; a field
the port needs and the tree lacks raises `KeyError`.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.state.snapshot import (
    ClusterSnapshot,
    GangState,
    NodeState,
    PodState,
    QuotaState,
)

_TABLES = {
    "nodes": NodeState,
    "pods": PodState,
    "gangs": GangState,
    "quota": QuotaState,
}


def snapshot_from_numpy(tree: dict, device=None) -> ClusterSnapshot:
    device = resolve_device(device)
    parts = {}
    for name, cls in _TABLES.items():
        table = tree.get(name)
        if table is None:
            parts[name] = None
            continue
        parts[name] = cls(**{
            f.name: np.asarray(table[f.name]) for f in fields(cls)
        })
    return ClusterSnapshot(**parts).to(device)
