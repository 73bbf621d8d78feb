"""Counterfactual weight sweep over recorded cycles (port of
`scheduler_plugins_tpu.tuning.sweep`).

A recorded cycle (the flight recorder's full solver inputs) replays under
K candidate plugin-weight vectors in one vmapped sequential solve
(`parallel.solver.sweep_solve_fn`): the candidate weights are a (K, L)
tensor the step multiplies each plugin's normalized column by, so every
candidate runs the same ATen ops at every K. Candidate generation is
seeded and deterministic: row 0 is the recorded profile's own weights
(the in-band baseline), then the one-knob grid emphasis rows, then
Dirichlet perturbations of the current profile, the same rows as the JAX
package's for the same base and seed.

The JAX package pads K to a power of two (`pad_candidates`) so XLA
compiles one program per bucket; eager PyTorch compiles nothing, and on
the card a padded lane is real work, so `sweep_cycle` runs K as given.

`sweep_cycle` is the one-cycle engine; corpus aggregation, ranking and
gating live in `tuning.promotion`.
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import (
    finish_fetch,
    resolve_device,
    start_fetch,
    to_device,
)

#: one-knob grid multipliers: for each plugin, emphasis (w*m) and
#: de-emphasis (max(1, w//m)) rows at these factors
GRID_FACTORS = (2, 4, 8)

#: integer budgets per plugin for Dirichlet rows: candidates live on the
#: simplex scaled to L*budget, so a ratio like 1.86:1 survives integer
#: rounding; several scales keep the distinct-candidate pool large even
#: for two-plugin profiles
WEIGHT_BUDGETS = (10, 20, 40)

#: Dirichlet concentration: alpha = normalized current weights * this,
#: so samples cluster around the current profile (perturbation, not
#: random search)
CONCENTRATION = 8.0


def candidate_weights(base, k: int, seed: int = 0) -> np.ndarray:
    """(K, L) int64 candidate weight matrix: row 0 = `base` (the current
    profile), then the one-knob grid, then seeded Dirichlet perturbations
    until `k` rows exist (duplicates dropped, so every lane is a distinct
    counterfactual). All weights >= 1 (the solve contracts require
    positive weights)."""
    base = np.asarray(base, np.int64)
    L = base.shape[0]
    if (base < 1).any():
        raise ValueError("candidate sweep requires positive base weights")
    rows = [tuple(base)]
    seen = {tuple(base)}

    def add(row):
        row = tuple(int(max(w, 1)) for w in row)
        if row not in seen:
            seen.add(row)
            rows.append(row)

    for m in GRID_FACTORS:
        for i in range(L):
            up = base.copy()
            up[i] *= m
            add(up)
            down = base.copy()
            down[i] = max(1, int(down[i]) // m)
            add(down)
    rng = np.random.default_rng(seed)
    alpha = base / base.sum() * CONCENTRATION
    guard = 0
    while len(rows) < k and guard < 64 * k:
        budget = L * WEIGHT_BUDGETS[guard % len(WEIGHT_BUDGETS)]
        guard += 1
        w = rng.dirichlet(alpha) * budget
        add(np.maximum(np.rint(w), 1).astype(np.int64))
    return np.asarray(rows[:k], np.int64)


def sweep_cycle(scheduler, snap, W, auxes=None, *, device=None):
    """Replay one cycle under every row of `W` ((K, L) int64) in one
    vmapped solve on `device` (None = the CUDA card; the snapshot moves
    there if it lives elsewhere). Returns (assignment (K, P) int32,
    admitted (K, P), wait (K, P)) as host numpy, one host copy. `auxes`
    (tensors on `device`) binds a recorded cycle's configuration for the
    call, as a replay does; None solves with the plugins' own."""
    from scheduler_plugins_tpu_torch.parallel.solver import sweep_solve_fn

    device = resolve_device(device)
    if snap.device != device:
        snap = snap.to(device)
    W = np.asarray(W, np.int64)
    plugins = tuple(scheduler.profile.plugins)
    if W.ndim != 2 or W.shape[1] != len(plugins):
        raise ValueError(
            f"candidate width {W.shape[-1]} != plugin count {len(plugins)}"
        )
    fn = sweep_solve_fn(scheduler)
    out = fn(snap, scheduler.initial_state(snap), auxes,
             to_device(W, device, torch.int64))
    return tuple(finish_fetch(start_fetch(out, device)))
