"""Scheduling math on tensors (port of `scheduler_plugins_tpu.ops`).

- fit.py          free capacity and per-pod fit demand
- allocatable.py  NodeResourcesAllocatable raw scores + int32 demotion
- gang.py         PodGroup admission checks
- quota.py        ElasticQuota admission checks
- assign.py       targeted waterfill wave placement, unblocked and over
                  node rank blocks
"""

from scheduler_plugins_tpu_torch.api.resources import CANONICAL, PODS

#: the pods slot on the resource axis, from the single source of truth
PODS_I = CANONICAL.index(PODS)
