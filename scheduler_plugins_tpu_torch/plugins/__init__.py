"""The plugin suite (port of `scheduler_plugins_tpu.plugins`): the flagship
profile's three plugins. The other families come with their slices."""

from scheduler_plugins_tpu_torch.plugins.capacityscheduling import (  # noqa: F401
    CapacityScheduling,
)
from scheduler_plugins_tpu_torch.plugins.coscheduling import Coscheduling  # noqa: F401
from scheduler_plugins_tpu_torch.plugins.noderesources import (  # noqa: F401
    NodeResourcesAllocatable,
)
