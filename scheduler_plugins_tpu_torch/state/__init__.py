"""Cluster state: the dense-tensor snapshot and the host-side store."""

from scheduler_plugins_tpu_torch.state.cluster import Cluster  # noqa: F401
from scheduler_plugins_tpu_torch.state.snapshot import (  # noqa: F401
    ClusterSnapshot,
    SnapshotMeta,
    build_snapshot,
)
