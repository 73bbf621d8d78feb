"""The plugin framework: the plugin trait layer, the sequential parity
solve, the preemption engine and the scheduling cycle (port of
`scheduler_plugins_tpu.framework`)."""

from scheduler_plugins_tpu_torch.framework.cycle import (  # noqa: F401
    CycleReport,
    run_cycle,
)
from scheduler_plugins_tpu_torch.framework.plugin import (  # noqa: F401
    Plugin,
    SolverState,
)
from scheduler_plugins_tpu_torch.framework.runtime import (  # noqa: F401
    Profile,
    Scheduler,
    SolveResult,
)
