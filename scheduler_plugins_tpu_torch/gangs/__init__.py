"""Rank-aware gang placement (port of `scheduler_plugins_tpu.gangs`).

- `gangs.topology`: the topology-block waterfill gang solve on the device
  and its bit-identical numpy sequential twin, with the block-cost
  lowering and the placement-cost scoring.
- `gangs.elastic`: elastic (min, desired, max) gangs: the
  highest-cost-first shrink selection and the satisfaction objective.
- `gangs.waves`: the wave-batched gang solve with its host validator.
- `gangs.phase`: the host `GangPhase` that `framework.cycle.run_cycle`
  runs ahead of the per-pod solve.

The JAX package's jitted constructors `gang_solve_fn` / `wave_solve_fn`
are the plain functions `gang_solve` (around `gang_solve_body`) /
`wave_solve_body` here.
"""

from scheduler_plugins_tpu_torch.gangs.elastic import (  # noqa: F401
    elastic_bounds,
    elastic_satisfaction,
    shrink_select,
    shrink_select_np,
)
from scheduler_plugins_tpu_torch.gangs.phase import (  # noqa: F401
    GangPhase,
    RANK_GANG_PLACEMENT,
    build_rank_gang_problem,
)
from scheduler_plugins_tpu_torch.gangs.topology import (  # noqa: F401
    RankGangState,
    build_block_cost,
    gang_cost_stats,
    gang_solve,
    gang_solve_body,
    gang_solve_np,
    pair_costs,
    place_gang_one,
)
from scheduler_plugins_tpu_torch.gangs.waves import (  # noqa: F401
    wave_gang_solve,
    wave_solve_body,
)
