"""The plugin framework: the plugin trait layer and the sequential parity
solve (port of `scheduler_plugins_tpu.framework`)."""

from scheduler_plugins_tpu_torch.framework.plugin import (  # noqa: F401
    Plugin,
    SolverState,
)
from scheduler_plugins_tpu_torch.framework.runtime import (  # noqa: F401
    Profile,
    Scheduler,
    SolveResult,
)
