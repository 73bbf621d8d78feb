"""The tuning observatory (port of `scheduler_plugins_tpu.tuning`).

- `tuning.quality`: the placement-quality objectives (fragmentation,
  utilization imbalance, packed utilization, gang wait, unplaced
  fraction, drift) as tensor math, their numpy twin that `run_cycle`
  stamps on every report, and the multi-cycle accumulators.
- `tuning.gates`: numpy hard-constraint replay oracles (fit, mask,
  queue-order quota, gang quorum).
- `tuning.sweep`: K candidate weight vectors replayed through ONE vmapped
  sequential solve.
- `tuning.promotion`: THE one promotion-gate body (sweep a corpus, rank,
  disqualify, accept) shared by the offline tuner and the shadow lane.
- `tuning.shadow`: the online shadow lane, `ShadowTuner`: deadlined
  sweeps over the flight-recorder ring, gated live promotion, probation
  auto-rollback.

Drivers: `tools/tune.py` (corpus sweep and gated profile emission),
`tools/replay.py quality`, `run_cycle(tuner=)`.
"""

from scheduler_plugins_tpu_torch.tuning import (
    gates,
    promotion,
    quality,
    shadow,
    sweep,
)

__all__ = ["gates", "promotion", "quality", "shadow", "sweep"]
