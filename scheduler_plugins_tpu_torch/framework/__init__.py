"""The plugin framework: the plugin trait layer, the sequential parity
solve, the preemption engine, the scheduling cycle, the pipelined cycle
engine and the K-lane cycle engine (port of
`scheduler_plugins_tpu.framework`)."""

from scheduler_plugins_tpu_torch.framework.cycle import (  # noqa: F401
    CycleReport,
    run_cycle,
)
from scheduler_plugins_tpu_torch.framework.laned_cycle import (  # noqa: F401
    LanedCycle,
)
from scheduler_plugins_tpu_torch.framework.pipeline_cycle import (  # noqa: F401
    CycleTimeline,
    PipelinedCycle,
)
from scheduler_plugins_tpu_torch.framework.plugin import (  # noqa: F401
    Plugin,
    SolverState,
)
from scheduler_plugins_tpu_torch.framework.runtime import (  # noqa: F401
    PackingConfig,
    Profile,
    Scheduler,
    SolveResult,
)
