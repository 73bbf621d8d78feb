"""The resident-state serving engine: the snapshot's node columns kept on
the device across cycles, fed O(changed) deltas from the store (port of
`scheduler_plugins_tpu.serving`)."""

from scheduler_plugins_tpu_torch.serving.deltas import (  # noqa: F401
    DeltaSink,
    NodeUpserts,
    UsageDeltas,
    apply_node_deltas,
    compact_node_rows,
    pod_usage_vectors,
)
from scheduler_plugins_tpu_torch.serving.engine import (  # noqa: F401
    ServeEngine,
    StreamingServeEngine,
)
