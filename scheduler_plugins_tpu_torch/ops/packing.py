"""Packing refinement (port of `scheduler_plugins_tpu.ops.packing`).

The packing solve mode places pods as the wave path does, then runs
consolidation rounds over the placement. Per round:

1. **Donor.** The emptiest still-occupied schedulable node (float64
   cpu/memory fill fraction) that holds batch pods and was not frozen by a
   round that moved nothing; the lowest index wins a tie.
2. **Bids.** Each of the donor's first `mover_cap` batch pods (queue
   order) bids for every other occupied node it fits:
   ``score_frac(n) + price_weight * fill(n)``, with `score_frac` the static
   node ranking min-max normalized over schedulable nodes. A target must
   be at least `theta` fuller than the donor; `theta` starts at
   `temperature` and is multiplied by `decay` once a round. The highest
   bid wins, the lowest index on a tie.
3. **Commit.** The movers' choices go through the queue-order admission
   (`ops.assign._queue_order_admission_choice`) against the round-start
   free rows, so fit holds at every step; admitted movers move their
   demand off the donor onto their target. A donor that moves nothing is
   frozen.

Moves never change which pods are placed, so quota and gang quorum are the
caller's tail's (`parallel.solver.finalize_assignment`) as on the wave
path.

The JAX `lax.while_loop` stops after the round that finds no donor. Here
the round count `floor(iterations)` is a host value (the knobs are host
floats, `pack_aux_vector`), so the loop runs that many rounds as a Python
loop and a device-side `done` flag masks every round after that one: no
round reads anything on the host. `rounds` counts the rounds JAX runs.

`packing_refine_np` and `_queue_order_admission_choice_np` are the numpy
twins (the JAX package's, kept here as the port's own copies): identical
float64 arithmetic and tie-breaks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scheduler_plugins_tpu_torch.ops import CPU_I, MEMORY_I, PODS_I
from scheduler_plugins_tpu_torch.ops.assign import (
    _first_max,
    _first_min,
    _queue_order_admission_choice,
)
from scheduler_plugins_tpu_torch.ops.fit import pod_fit_demand

F64 = torch.float64

#: pack_aux slots: the layout of `pack_aux_vector`, shared by
#: `framework.runtime.PackingConfig` and the solvers
PACK_AUX_SLOTS = ("iterations", "price_weight", "temperature", "decay")


def pack_aux_vector(iterations, price_weight, temperature, decay):
    """The (4,) float64 knob vector `packing_refine` consumes, a host numpy
    array (JAX's is a traced device vector; here the loop reads the knobs
    without touching the device)."""
    return np.array(
        [float(iterations), float(price_weight), float(temperature),
         float(decay)],
        np.float64,
    )


def _alloc_columns(alloc):
    """Per core resource (cpu, memory): (slot, float64 allocatable, whether
    it is positive, the divisor max(allocatable, 1)) — static over the
    rounds."""
    out = []
    for r in (CPU_I, MEMORY_I):
        allocf = alloc[:, r].to(F64)
        out.append((r, allocf, allocf > 0, torch.clamp(allocf, min=1.0)))
    return out


def _fill_fraction(free, columns, node_mask):
    """(N,) float64 cpu/memory fill fraction (used / allocatable, 0 where
    nothing is allocatable), the mean of the two; -1.0 on masked rows, so
    they are never donor nor priced as a target. `columns` is
    `_alloc_columns(alloc)`."""
    (r0, a0, pos0, div0), (r1, a1, pos1, div1) = columns
    util0 = torch.where(pos0, (a0 - free[:, r0].to(F64)) / div0, 0.0)
    util1 = torch.where(pos1, (a1 - free[:, r1].to(F64)) / div1, 0.0)
    return torch.where(node_mask, (util0 + util1) / 2.0, -1.0)


def _score_fraction(raw_scores, node_mask):
    """(N,) float64 min-max normalization of the static node ranking to
    [0, 1] over schedulable nodes: the score term of the bid."""
    raw = raw_scores.to(F64)
    lo = torch.where(node_mask, raw, math.inf).min()
    hi = torch.where(node_mask, raw, -math.inf).max()
    span = torch.clamp(hi - lo, min=1.0)
    return torch.where(node_mask, (raw - lo) / span, 0.0)


def packing_refine(raw_scores, req, pod_mask, alloc, node_mask, free0,
                   assignment0, pack_aux, mover_cap: int = 128):
    """Refine a wave placement by consolidation rounds (module docstring).

    `raw_scores` (N,) int64 static node ranking, `req` (P, R) requests,
    `pod_mask` (P,) admitted batch rows, `alloc` (N, R), `node_mask` (N,)
    schedulable, `free0` (N, R) free after the wave placement,
    `assignment0` (P,) the wave placements, `pack_aux` the host knob
    vector (`pack_aux_vector`), `mover_cap` the per-round mover window.

    Returns (assignment (P,) int32, free (N, R), stats) with stats =
    {"rounds", "moves", "emptied"} as int32 device scalars. Budget 0
    returns the inputs. Nothing is read on the host."""
    n_iters, price_weight, temperature, decay = (
        float(v) for v in pack_aux)
    P = req.shape[0]
    N = free0.shape[0]
    W = min(mover_cap, P)
    device = req.device
    demand = pod_fit_demand(req)
    score_frac = _score_fraction(raw_scores, node_mask)
    columns = _alloc_columns(alloc)
    node_index = torch.arange(N, device=device)
    pod_index = torch.arange(P, device=device)
    mover_index = node_index.expand(W, N)
    ones_p = torch.ones(P, dtype=torch.int32, device=device)
    # alloc pods-slot minus free pods-slot counts resident pods
    alloc_pods = alloc[:, PODS_I]

    def occupied_of(free):
        return node_mask & (alloc_pods - free[:, PODS_I] > 0)

    free = free0
    assignment = assignment0.to(torch.int64)
    frozen = torch.zeros(N, dtype=torch.bool, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    rounds = torch.zeros((), dtype=torch.int32, device=device)
    moves = torch.zeros((), dtype=torch.int32, device=device)
    occupied0 = occupied_of(free0)
    # theta decays by one float64 multiply a round, never a pow(), as
    # JAX's carry and the numpy twin do
    theta = temperature
    for _ in range(int(math.floor(n_iters))):
        fill = _fill_fraction(free, columns, node_mask)
        occupied = occupied_of(free)
        placed = (assignment >= 0) & pod_mask
        batch_count = torch.zeros(N + 1, dtype=torch.int32, device=device)
        batch_count.index_add_(0, torch.where(placed, assignment, N),
                               ones_p)
        eligible = occupied & ~frozen & (batch_count[:N] > 0)
        # JAX's loop ends after the round with no donor; here that round
        # and every later one are masked
        active = eligible.any() & ~done
        d = _first_min(torch.where(eligible, fill, math.inf), node_index)
        fill_d = fill[d]  # (1,)

        # mover window: the first W batch pods on the donor, queue order
        # (the `_straggler_window` rank-compaction scatter)
        on_donor = (assignment == d) & pod_mask & active
        rank = torch.cumsum(on_donor.to(torch.int64), dim=0) - 1
        slot = torch.where(on_donor & (rank < W), rank, W)
        idx = torch.full((W + 1,), P, dtype=torch.int64, device=device)
        idx.scatter_reduce_(0, slot, pod_index, reduce="amin")
        idx = idx[:W]
        valid = idx < P
        safe_idx = torch.clamp(idx, max=P - 1)
        dem_w = torch.where(valid[:, None], demand[safe_idx], 0)

        # bids over occupied fitting targets past the fill-edge guard
        target_ok = occupied & (node_index != d) & (fill >= fill_d + theta)
        fit = torch.all(dem_w[:, None, :] <= free[None, :, :], dim=2)
        cand = fit & target_ok[None, :] & valid[:, None]
        bid = score_frac + price_weight * fill
        masked_bid = torch.where(cand, bid[None, :], -math.inf)
        best = _first_max(masked_bid, mover_index, dim=1)[:, 0]
        choice = torch.where(cand.any(dim=1), best, -1)

        # queue-order admission against the round-start free rows (the
        # movers' demand still sits on the donor, never a target)
        admitted = _queue_order_admission_choice(choice, dem_w, free)

        placed_plus = torch.zeros(P, dtype=torch.int64, device=device)
        placed_plus.index_add_(0, safe_idx,
                               torch.where(admitted, choice + 1, 0))
        assignment = torch.where(placed_plus > 0, placed_plus - 1,
                                 assignment)
        moved_dem = torch.where(admitted[:, None], dem_w, 0)
        used_t = torch.zeros_like(free)
        used_t.index_add_(0, torch.where(admitted, choice, N - 1),
                          moved_dem)
        free = free - used_t
        free = free.index_add(0, d, moved_dem.sum(dim=0, keepdim=True))
        n_moved = admitted.sum(dtype=torch.int32)
        # an eligible donor is unfrozen, so JAX's set is an or here
        frozen = frozen | ((node_index == d) & active & (n_moved == 0))
        rounds = rounds + (~done).to(torch.int32)
        moves = moves + n_moved
        done = done | ~active
        theta *= decay
    emptied = (occupied0 & ~occupied_of(free)).sum(dtype=torch.int32)
    stats = {"rounds": rounds, "moves": moves, "emptied": emptied}
    return assignment.to(torch.int32), free, stats


# ---------------------------------------------------------------------------
# numpy twins (identical float64 arithmetic and tie-breaks)
# ---------------------------------------------------------------------------


def _queue_order_admission_choice_np(choice, demand, free):
    """Numpy twin of `ops.assign._queue_order_admission_choice`: the
    sorted-segment queue-order admission with the same float64 prefix
    arithmetic (cumsum minus own value, cummax rebase)."""
    P = choice.shape[0]
    N = free.shape[0]
    seg_choice = np.where(choice >= 0, choice, N)
    order = np.argsort(seg_choice.astype(np.int64) * P + np.arange(P))
    seg = seg_choice[order]
    first = np.concatenate([[True], seg[1:] != seg[:-1]])
    dem_sorted = demand[order].astype(np.float64)
    csum = np.cumsum(dem_sorted, axis=0)
    exclusive = csum - dem_sorted
    base = np.maximum.accumulate(
        np.where(first[:, None], exclusive, -1.0), axis=0
    )
    within = csum - base
    free_row = free[np.minimum(seg, N - 1)].astype(np.float64)
    ok_sorted = np.all(within <= free_row, axis=1) & (seg < N)
    out = np.zeros(P, bool)
    out[order] = ok_sorted
    return out


def packing_refine_np(raw_scores, req, pod_mask, alloc, node_mask, free0,
                      assignment0, pack_aux, mover_cap: int = 128):
    """Numpy sequential twin of `packing_refine`: the same rounds,
    elections and commits, one mover at a time."""
    raw_scores = np.asarray(raw_scores)
    req = np.asarray(req)
    pod_mask = np.asarray(pod_mask).astype(bool)
    alloc = np.asarray(alloc)
    node_mask = np.asarray(node_mask).astype(bool)
    free = np.asarray(free0).copy()
    assignment = np.asarray(assignment0).copy()
    pack_aux = np.asarray(pack_aux, np.float64)
    P, R = req.shape
    N = free.shape[0]
    W = min(mover_cap, P)
    demand = req.copy()
    demand[:, PODS_I] = 1
    n_iters, price_weight, temperature, decay = (
        float(pack_aux[0]), float(pack_aux[1]), float(pack_aux[2]),
        float(pack_aux[3]),
    )

    def fill_fraction(free):
        allocf = alloc[:, (CPU_I, MEMORY_I)].astype(np.float64)
        freef = free[:, (CPU_I, MEMORY_I)].astype(np.float64)
        util = np.where(
            allocf > 0, (allocf - freef) / np.maximum(allocf, 1.0), 0.0
        )
        fill = (util[:, 0] + util[:, 1]) / 2.0
        return np.where(node_mask, fill, -1.0)

    raw = raw_scores.astype(np.float64)
    lo = np.min(np.where(node_mask, raw, np.inf))
    hi = np.max(np.where(node_mask, raw, -np.inf))
    span = max(hi - lo, 1.0)
    score_frac = np.where(node_mask, (raw - lo) / span, 0.0)
    alloc_pods = alloc[:, PODS_I]

    def occupied_of(free):
        return node_mask & (alloc_pods - free[:, PODS_I] > 0)

    occupied0 = occupied_of(free)
    frozen = np.zeros(N, bool)
    moves = 0
    rounds = 0
    theta = temperature
    while rounds < int(n_iters):
        fill = fill_fraction(free)
        occupied = occupied_of(free)
        placed = (assignment >= 0) & pod_mask
        batch_count = np.zeros(N + 1, np.int32)
        np.add.at(batch_count, np.where(placed, assignment, N), 1)
        eligible = occupied & ~frozen & (batch_count[:N] > 0)
        if not eligible.any():
            rounds += 1
            break
        d = int(np.argmin(np.where(eligible, fill, np.inf)))
        fill_d = fill[d]
        on_donor = np.nonzero((assignment == d) & pod_mask)[0][:W]
        dem_w = demand[on_donor]
        target_ok = (
            occupied & (np.arange(N) != d) & (fill >= fill_d + theta)
        )
        fit = np.all(dem_w[:, None, :] <= free[None, :, :], axis=2)
        cand = fit & target_ok[None, :]
        bid = score_frac + price_weight * fill
        masked_bid = np.where(cand, bid[None, :], -np.inf)
        best = np.argmax(masked_bid, axis=1).astype(np.int32)
        choice = np.where(cand.any(axis=1), best, -1)
        admitted = (choice >= 0) & _queue_order_admission_choice_np(
            choice, dem_w, free
        )
        for j, p in enumerate(on_donor):
            if admitted[j]:
                assignment[p] = choice[j]
                free[choice[j]] -= demand[p]
                free[d] += demand[p]
                moves += 1
        if not admitted.any():
            frozen[d] = True
        theta *= decay
        rounds += 1
    emptied = int((occupied0 & ~occupied_of(free)).sum())
    return assignment, free, {
        "rounds": rounds, "moves": moves, "emptied": emptied,
    }


__all__ = [
    "PACK_AUX_SLOTS",
    "pack_aux_vector",
    "packing_refine",
    "packing_refine_np",
]
