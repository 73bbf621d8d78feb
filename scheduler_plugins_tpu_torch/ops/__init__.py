"""Scheduling math on tensors (port of `scheduler_plugins_tpu.ops`).

- fit.py          free capacity, per-pod fit demand and the fit Filter
- allocatable.py  NodeResourcesAllocatable raw scores + int32 demotion
- normalize.py    score normalization (min-max, default, Peaks)
- gang.py         PodGroup admission checks and in-cycle commits
- quota.py        ElasticQuota admission checks and the Reserve commit
- assign.py       targeted waterfill wave placement, unblocked and over
                  node rank blocks
- trimaran.py     the Trimaran load-aware score curves
"""

from scheduler_plugins_tpu_torch.api.resources import (
    CANONICAL,
    CPU,
    MEMORY,
    PODS,
)

#: slots on the resource axis, from the single source of truth
CPU_I = CANONICAL.index(CPU)
MEMORY_I = CANONICAL.index(MEMORY)
PODS_I = CANONICAL.index(PODS)

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0
