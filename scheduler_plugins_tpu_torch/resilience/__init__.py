"""Runtime resilience (port of `scheduler_plugins_tpu.resilience`): fault
injection, the solve watchdog, degraded-mode failover and the host-side
parity solve.

- `resilience.faults`: seeded deterministic fault plans fired at named
  sites (no cost when no plan is installed).
- `resilience.watchdog`: `SolveWatchdog` (deadline and seeded-jitter
  retries in a worker thread) and `Resilience` (the fast / degraded state
  machine `framework.cycle.run_cycle(resilience=...)` drives).
- `resilience.hostsolve`: the numpy sequential parity solve that degraded
  mode serves from, bit-identical to `Scheduler.solve` on the supported
  profile surface.
"""

from scheduler_plugins_tpu_torch.resilience import faults
from scheduler_plugins_tpu_torch.resilience.hostsolve import (
    host_sequential_solve,
    supports as supports_host_solve,
)
from scheduler_plugins_tpu_torch.resilience.watchdog import (
    BackendUnavailable,
    GarbageOutput,
    Resilience,
    SolveWatchdog,
    call_with_deadline,
    solve_output_anomaly,
)

__all__ = [
    "faults",
    "host_sequential_solve",
    "supports_host_solve",
    "BackendUnavailable",
    "GarbageOutput",
    "Resilience",
    "SolveWatchdog",
    "call_with_deadline",
    "solve_output_anomaly",
]
