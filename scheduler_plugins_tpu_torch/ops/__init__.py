"""Scheduling math on tensors (port of `scheduler_plugins_tpu.ops`).

- fit.py          free capacity, per-pod fit demand and the fit Filter
- allocatable.py  NodeResourcesAllocatable raw scores + int32 demotion
- normalize.py    score normalization (min-max)
- gang.py         PodGroup admission checks and in-cycle commits
- quota.py        ElasticQuota admission checks and the Reserve commit
- assign.py       targeted waterfill wave placement, unblocked and over
                  node rank blocks
"""

from scheduler_plugins_tpu_torch.api.resources import CANONICAL, PODS

#: the pods slot on the resource axis, from the single source of truth
PODS_I = CANONICAL.index(PODS)

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0
