"""Waterfill wave placement (port of `scheduler_plugins_tpu.ops.assign`).

`waterfill_assign_stateful` is the profile-generic waterfill of the
batched profile solve (the JAX `waterfill_assign_stateful`,
ops/assign.py:247): (P, N) feasibility and score rows from the caller,
re-filtered every wave against a plugin carry, with exact within-wave
guards, plugin capacity estimates, and sparse straggler waves that
escalate to a dense wave when they stall.

The targeted waterfill, for static per-node scores, comes in two
formulations returning identical placements:

- `waterfill_assign_targeted` — the whole node axis in one (N, R) tensor
  (the JAX `waterfill_assign_targeted`, ops/assign.py:557);
- `waterfill_targeted_sharded` — the node axis in GLOBAL SCORE-RANK ORDER,
  cut into S contiguous rank blocks held as one (S, BS, R) tensor (the JAX
  shard_map body `waterfill_targeted_sharded`, ops/assign.py:804, in its
  kernel formulation). Each cross-block exchange is one launch of a
  `parallel.kernels` CUDA kernel.

Per solve: one whole-queue lite wave, then lite waves over straggler
windows of `lite_window` pods, then rescue waves over windows of
`rescue_window` pods, each phase to quiescence or `max_waves`. The JAX
`lax.while_loop`s are Python loops here; each wave's loop condition costs
one device-to-host sync.

Every float64 sum below is of exact integers below 2^53, so its value does
not depend on summation order: the two formulations, and the JAX package,
agree bit for bit.
"""

from __future__ import annotations

import time

import torch

from scheduler_plugins_tpu_torch.ops.fit import pod_fit_demand
from scheduler_plugins_tpu_torch.parallel import kernels as pk

#: next-fit probe depth of a lite wave (the JAX `LITE_PROBES`)
LITE_PROBES = 4

F64 = torch.float64


def _segment_prefix(values_sorted: torch.Tensor, first: torch.Tensor):
    """Inclusive per-segment prefix sums of non-negative (P, R) float64
    values: one cumsum over the sorted axis, rebased per segment with a
    running maximum of the segment-start exclusive sums (`torch.cummax`)."""
    csum = torch.cumsum(values_sorted, dim=0)
    exclusive = csum - values_sorted
    base = torch.cummax(
        torch.where(first[:, None], exclusive, -1.0), dim=0
    ).values
    return csum - base


def _segment_layout(choice: torch.Tensor, n_sentinel: int):
    """(order, seg, first) of the queue-order admission: `order` sorts by
    (chosen node, queue position), `seg` is the sorted choice with
    `n_sentinel` for "no choice", `first` marks each segment's start."""
    W = choice.shape[0]
    seg_choice = torch.where(choice >= 0, choice, n_sentinel).to(torch.int64)
    order = torch.argsort(
        seg_choice * W + torch.arange(W, device=choice.device), stable=True
    )
    seg = seg_choice[order]
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    return order, seg, first


def _segments(choice: torch.Tensor, dem: torch.Tensor, n_sentinel: int):
    """(order, seg, within): `_segment_layout` with `within` the inclusive
    per-segment float64 demand prefix."""
    order, seg, first = _segment_layout(choice, n_sentinel)
    within = _segment_prefix(dem[order].to(F64), first)
    return order, seg, within


def _scatter_verdicts(order, ok_sorted, choice):
    admitted = torch.zeros_like(ok_sorted)
    admitted[order] = ok_sorted
    return (choice >= 0) & admitted


def _queue_order_admission_choice(choice, demand, free):
    """(W,) bool: a pod is admitted iff its chosen node still fits after all
    earlier same-wave choosers of that node (exact float64 prefix sums)."""
    N = free.shape[0]
    order, seg, within = _segments(choice, demand, N)
    free_row = free[torch.clamp(seg, max=N - 1)].to(F64)
    ok_sorted = torch.all(within <= free_row, dim=1) & (seg < N)
    return _scatter_verdicts(order, ok_sorted, choice)


def _cumulative_demand_positions(dem, free, order_n):
    """(W,) first score-ordered node index whose cumulative free capacity
    covers each row's inclusive cumulative demand, max over resources."""
    cumdem = torch.cumsum(dem.to(F64), dim=0)  # (W, R)
    cumfree = torch.cumsum(torch.clamp(free[order_n], min=0).to(F64), dim=0)
    pos = torch.searchsorted(
        cumfree.T.contiguous(), cumdem.T.contiguous(), right=False
    )  # (R, W)
    return pos.max(dim=0).values


def _straggler_window(demand, pod_mask, assignment, hopeless, W: int):
    """First W still-active pods in queue order: (idx (W,), valid (W,),
    dem (W, R)). A rank-compaction scatter (`scatter_reduce_` amin) into a
    W+1 buffer whose last slot takes the overflow."""
    P = pod_mask.shape[0]
    device = pod_mask.device
    active = (assignment == -1) & pod_mask & ~hopeless
    rank = torch.cumsum(active.to(torch.int64), dim=0) - 1
    slot = torch.where(active & (rank < W), rank, W)
    idx = torch.full((W + 1,), P, dtype=torch.int64, device=device)
    idx.scatter_reduce_(
        0, slot, torch.arange(P, device=device), reduce="amin"
    )
    idx = idx[:W]
    valid = idx < P
    dem_w = torch.where(
        valid[:, None], demand[torch.clamp(idx, max=P - 1)], 0
    )
    return idx, valid, dem_w


def _commit(assignment, hopeless, idx, admitted, node_plus, hopeless_w):
    """Write a wave's placements (`node_plus` = node id + 1 of admitted
    window pods) and hopeless retirements into the pod-axis state, in
    place. Window fill rows (idx == P) clamp to P - 1 and add zero."""
    P = assignment.shape[0]
    safe_idx = torch.clamp(idx, max=P - 1)
    placed_plus = torch.zeros(P, dtype=torch.int64, device=idx.device)
    placed_plus.index_add_(0, safe_idx, torch.where(admitted, node_plus, 0))
    assignment.copy_(torch.where(placed_plus > 0, placed_plus - 1, assignment))
    hop_add = torch.zeros(P, dtype=torch.int64, device=idx.device)
    hop_add.index_add_(0, safe_idx, hopeless_w.to(torch.int64))
    hopeless |= hop_add > 0


def _run_phases(wave, P, max_waves, lite_window, rescue_window,
                lite_choice, rescue_choice):
    """The three wave phases shared by both formulations. `wave(W,
    choice_fn)` runs one wave and returns (admitted, retired, still
    active) counts as one device tensor, so each wave costs one sync."""
    adm, _, remaining = wave(P, lite_choice).tolist()
    occupancy = [adm]
    for W, choice_fn in ((min(P, lite_window), lite_choice),
                         (min(P, rescue_window), rescue_choice)):
        for _ in range(max_waves):
            if remaining == 0:
                break
            adm, retired, remaining = wave(W, choice_fn).tolist()
            occupancy.append(adm)
            if adm + retired == 0:
                break
    return {"waves": len(occupancy), "occupancy": occupancy}


def waterfill_assign_targeted(raw_scores, req, pod_mask, free0,
                              max_waves: int = 8, rescue_window: int = 512,
                              lite_window: int = 1024):
    """Waterfill for static per-node scores, the whole node axis in one
    tensor — plain PyTorch, no kernels. Returns (assignment (P,) int32,
    free (N, R), stats). `free0` is not modified.

    Per wave each window pod checks fit against a few target nodes (the
    cumulative-demand bucket node and the next probes) in O(W*R) gathers;
    rescue waves build a dense (W, N) feasibility row per window pod and
    spread pods round-robin over their own feasible sets, retiring pods
    with no feasible node as hopeless."""
    P = req.shape[0]
    N = free0.shape[0]
    device = req.device
    demand = pod_fit_demand(req)
    order_n = torch.argsort(-raw_scores, stable=True)  # static ranking
    free = free0.clone()
    assignment = torch.full((P,), -1, dtype=torch.int64, device=device)
    hopeless = torch.zeros(P, dtype=torch.bool, device=device)

    def lite_choice(idx, valid, dem_w):
        pos = _cumulative_demand_positions(dem_w, free, order_n)
        choice = torch.full_like(idx, -1)
        for probe in range(LITE_PROBES):
            cand = order_n[torch.clamp(pos + probe, max=N - 1)]
            fit = torch.all(dem_w <= free[cand], dim=1)
            choice = torch.where((choice < 0) & valid & fit, cand, choice)
        return choice, torch.zeros_like(valid)

    def rescue_choice(idx, valid, dem_w):
        W = idx.shape[0]
        feasible = torch.all(
            dem_w[:, None, :] <= free[None, :, :], dim=2
        ) & valid[:, None]
        counts = torch.cumsum(feasible[:, order_n].to(torch.int32), dim=1)
        total = counts[:, -1]
        k = torch.where(
            total > 0,
            torch.arange(W, device=device, dtype=torch.int32)
            % torch.clamp(total, min=1),
            0,
        )
        pos = torch.searchsorted(counts, k[:, None], right=True)[:, 0]
        choice = torch.where(
            valid & (total > 0), order_n[torch.clamp(pos, max=N - 1)], -1
        )
        return choice, valid & (total == 0)

    def wave(W, choice_fn):
        idx, valid, dem_w = _straggler_window(
            demand, pod_mask, assignment, hopeless, W
        )
        choice, hopeless_w = choice_fn(idx, valid, dem_w)
        admitted = _queue_order_admission_choice(choice, dem_w, free)
        _commit(assignment, hopeless, idx, admitted, choice + 1, hopeless_w)
        # the free carry is updated in place
        free.index_add_(
            0, torch.where(admitted, choice, 0),
            -torch.where(admitted[:, None], dem_w, 0),
        )
        remaining = ((assignment == -1) & pod_mask & ~hopeless).sum()
        return torch.stack([admitted.sum(), hopeless_w.sum(), remaining])

    stats = _run_phases(
        wave, P, max_waves, lite_window, rescue_window, lite_choice,
        rescue_choice,
    )
    return assignment.to(torch.int32), free, stats


def waterfill_targeted_sharded(rank_free, node_ids, req, pod_mask,
                               n_real: int, max_waves: int = 8,
                               rescue_window: int = 512,
                               lite_window: int = 1024):
    """The targeted waterfill with the node axis in S rank blocks.

    `rank_free` (S, BS, R) is free capacity in global score-rank order
    (block s owns ranks [s*BS, (s+1)*BS)); it is the resident carry and is
    UPDATED IN PLACE. `node_ids` (S, BS) maps each rank row back to its
    node index (-1 = padding). `n_real` is the pre-padding rank count: probe
    clamps saturate at the worst real rank, as the unblocked path's do.
    Returns (assignment (P,) int32 node indices, stats).

    The five exchange points of the JAX shard_map body (ops/assign.py:944,
    :961, :984, :1011, :1034) are kernel launches: `block_offsets` for the
    cumulative-free bases and the rescue feasible-count offsets,
    `elect_min` for the bucket position, `fused_election` for the first-fit
    and rescue winners. The fused election reads the winner's node id and
    pre-wave free row by index from `node_ids` and the resident `rank_free`,
    so queue-order admission runs on the elected rows with no further
    exchange. Padding rows have zero capacity and node id -1; every valid
    pod's demand has a pods slot of 1, so they never win."""
    S, BS, R = rank_free.shape
    P = req.shape[0]
    N = S * BS  # padded global rank count: the "no candidate" sentinel
    device = req.device
    demand = pod_fit_demand(req)
    block_start = torch.arange(S, device=device) * BS  # (S,)
    flat_free = rank_free.view(N, R)
    assignment = torch.full((P,), -1, dtype=torch.int64, device=device)
    hopeless = torch.zeros(P, dtype=torch.bool, device=device)

    def local_rows(rank):
        """(owned (S, ...), local row (S, ...)) of global `rank` (...)
        in each block."""
        local = rank[None] - block_start.view((S,) + (1,) * rank.dim())
        owned = (local >= 0) & (local < BS)
        return owned, torch.clamp(local, 0, BS - 1)

    def lite_choice(idx, valid, dem_w):
        W = idx.shape[0]
        cumfree = torch.cumsum(torch.clamp(rank_free, min=0).to(F64), dim=1)
        # the block totals, read in place (row stride BS*R)
        base, _ = pk.block_offsets(cumfree[:, -1, :])
        abs_cf = cumfree + base[:, None, :]  # (S, BS, R)
        cumdem = torch.cumsum(dem_w.to(F64), dim=0)  # (W, R)
        loc = torch.searchsorted(
            abs_cf.transpose(1, 2).contiguous(),
            cumdem.T[None].expand(S, R, W).contiguous(),
            right=False,
        )  # (S, R, W) local positions
        cand = torch.where(loc < BS, block_start[:, None, None] + loc, N)
        pos = pk.elect_min(cand).max(dim=0).values  # (W,)
        ranks = torch.clamp(
            pos[None, :] + torch.arange(LITE_PROBES, device=device)[:, None],
            max=n_real - 1,
        )  # (LP, W): saturate at the worst real rank, never the padding
        owned, local = local_rows(ranks)  # (S, LP, W)
        row = rank_free[
            torch.arange(S, device=device)[:, None, None], local
        ]  # (S, LP, W, R)
        fit = owned & valid & torch.all(dem_w <= row, dim=3)
        # first fitting probe == min fitting rank (ranks are nondecreasing
        # in probe order): each block proposes its min fitting owned rank
        prop = torch.where(fit, ranks[None], N).min(dim=1).values  # (S, W)
        rank, nid, win_row = pk.fused_election(prop, node_ids, rank_free)
        choice = torch.where(valid & (rank < N), rank, -1)
        # lite misses prove nothing about feasibility: no hopeless delta
        return choice, torch.zeros_like(valid), nid, win_row

    def rescue_choice(idx, valid, dem_w):
        W = idx.shape[0]
        feasible = torch.all(
            dem_w[None, :, None, :] <= rank_free[:, None, :, :], dim=3
        ) & valid[None, :, None]  # (S, W, BS)
        counts = feasible.sum(dim=2)  # (S, W) int64
        base, total = pk.block_offsets(counts)
        k = torch.where(
            total > 0,
            torch.arange(W, device=device) % torch.clamp(total, min=1),
            0,
        )
        k_local = k[None, :] - base  # (S, W)
        c = torch.cumsum(feasible.to(torch.int32), dim=2)  # (S, W, BS)
        locpos = torch.searchsorted(
            c, k_local.to(torch.int32)[:, :, None], right=True
        )[:, :, 0]  # first local index with count > k_local
        mine = (k_local >= 0) & (k_local < counts)
        prop = torch.where(
            mine & valid & (total > 0), block_start[:, None] + locpos, N
        )
        # whenever total > 0 exactly one block proposes the k-th feasible
        # rank, a real node, so the n_real clamp is a no-op there
        rank, nid, win_row = pk.fused_election(prop, node_ids, rank_free)
        choice = torch.where(
            valid & (total > 0), torch.clamp(rank, max=n_real - 1), -1
        )
        return choice, valid & (total == 0), nid, win_row

    def wave(W, choice_fn):
        idx, valid, dem_w = _straggler_window(
            demand, pod_mask, assignment, hopeless, W
        )
        choice, hopeless_w, nid, win_row = choice_fn(idx, valid, dem_w)
        order, seg, within = _segments(choice, dem_w, N)
        ok_sorted = (seg < N) & torch.all(
            within <= win_row[order].to(F64), dim=1
        )
        admitted = _scatter_verdicts(order, ok_sorted, choice)
        _commit(assignment, hopeless, idx, admitted, nid, hopeless_w)
        # commit into the owning block's rows of the resident carry, in
        # place (flat_free is a view of rank_free in global rank order)
        flat_free.index_add_(
            0, torch.where(admitted, choice, 0),
            -torch.where(admitted[:, None], dem_w, 0),
        )
        remaining = ((assignment == -1) & pod_mask & ~hopeless).sum()
        return torch.stack([admitted.sum(), hopeless_w.sum(), remaining])

    stats = _run_phases(
        wave, P, max_waves, lite_window, rescue_window, lite_choice,
        rescue_choice,
    )
    return assignment.to(torch.int32), stats


def waterfill_assign_stateful(batch_fn, commit_fn, guards, guard_demands,
                              req, pod_mask, free0, state0,
                              max_waves: int = 4, validate_fn=None,
                              validate_commit_fn=None, capacity_fns=(),
                              initial_batch=None, sub_batch_fn=None,
                              straggler_cap: int = 256,
                              collect_stats: bool = False):
    """The waterfill with a plugin carry for state-dependent filters (NUMA
    zone availability): the carries the sequential solve threads from pod
    to pod are re-evaluated once a WAVE here, so hard plugin constraints
    hold against the committed placements.

    - `batch_fn(free, state, active) -> (feasible (P, N), scores (P, N))`
      re-filters every dense wave against the carry.
    - `commit_fn(state, placed (P,) bool, choice (P,) int32) -> state`
      folds a wave's placements into the carry (order-independent sums).
    - `guards` / `guard_demands`: exact within-wave admission. Each guard
      is `fn(state, pods (S,), nodes (S,), prefix (S, R_g)) -> (S,) bool`,
      `prefix` being each pod's exclusive sum of `guard_demands[i]` (P,
      R_g) over the earlier same-wave choosers of its node (rejected ones
      included: conservative, a pod at worst retries next wave).
    - `validate_fn(state, q (1,), node (1,)) -> (1,) bool` /
      `validate_commit_fn(state, q, node) -> state`: a sequential re-check
      of hard constraints that span nodes (topology-domain counting).
      After the guards, the wave's rows are walked one at a time in queue
      order against the live carry; a kept winner commits at once through
      `validate_commit_fn` (a row that was not admitted, or fails, commits
      node -1, which changes nothing), so later rows of the same wave see
      it; a demoted pod retries next wave. `commit_fn` must then leave out
      the carries `validate_commit_fn` keeps. The walk covers every row of
      the wave, as the JAX `while_loop` does, with one-element slices: it
      reads nothing on the host.
    - `capacity_fns`: `fn(state, active (P,)) -> (N,) pods-per-node
      estimate or None`, refining the bucketing the resource cumsums
      cannot see.
    - `initial_batch`: (feasible0, scores0) the caller computed against
      `state0`; wave 0 reuses them.
    - `sub_batch_fn(free, state, idx (S,), active_sub (S,)) -> (feasible
      (S, N), scores (S, N))`: sparse straggler waves over the first
      `straggler_cap` active pods in queue order (requires
      `initial_batch`). A sparse wave that places nothing escalates to
      one dense wave over every active pod; only a stalled dense wave
      ends the loop, or the wave budget `max_waves` (both kinds counted).

    The JAX `lax.while_loop` is a Python loop here; each wave's continue
    test reads one (2,) tensor on the host (admitted, still active), the
    wave's only host read. Returns
    (assignment (P,) int32, free, state), plus `{"occupancy": (max_waves,)
    int32 admitted per wave, "waves": int, "wave_of": (P,) int32 the wave
    that admitted each pod, -1 for none, "walk": [(rows, host seconds)]
    of each wave's validator walk, empty without validators}` when
    `collect_stats` (the JAX stats have the first two; `wave_of` gives a
    host oracle the order in which the placements were committed, `walk`
    the rows each walk visited and the host time it took to enqueue
    them)."""
    P, R = req.shape
    N = free0.shape[0]
    device = req.device
    demand = pod_fit_demand(req)
    S = min(straggler_cap, P)
    if sub_batch_fn is not None and initial_batch is None:
        raise ValueError("sub_batch_fn requires initial_batch (dense wave 0)")
    dense_idx = torch.arange(P, device=device)

    wave_of = torch.full((P,), -1, dtype=torch.int32, device=device)
    walk = []

    def wave_core(free, assignment, state, idx, feasible, scores):
        """One wave over the pod rows `idx` (ascending: queue order), with
        their (S, N) feasibility and score rows."""
        nonlocal wave_of
        Ssub = idx.shape[0]
        active_full = (assignment == -1) & pod_mask
        active = active_full[idx]
        dem = demand[idx]
        feasible = feasible & active[:, None]
        neg_inf = torch.iinfo(scores.dtype).min // 2
        mean_score = torch.where(active[:, None], scores, 0).sum(
            dim=0, dtype=torch.int64)
        order_n = torch.argsort(-mean_score, stable=True)
        pos = _cumulative_demand_positions(
            torch.where(active[:, None], dem, 0), free, order_n)
        rank = torch.cumsum(active.to(torch.int64), dim=0) - 1
        for cap_fn in capacity_fns:
            extra = cap_fn(state, active_full)
            if extra is not None:
                cap = torch.clamp(extra.to(torch.int64), 0, Ssub)
                ccap = torch.cumsum(cap[order_n], dim=0)
                pos = torch.maximum(
                    pos, torch.searchsorted(ccap, rank, right=True))
        target = order_n[torch.clamp(pos, max=N - 1)]
        target_ok = feasible.gather(1, target[:, None]).squeeze(1)
        fallback = torch.where(feasible, scores, neg_inf).argmax(dim=1)
        choice = torch.where(
            target_ok, target,
            torch.where(feasible.any(dim=1), fallback, -1),
        )
        choice = torch.where(active, choice, -1)

        order, seg, first = _segment_layout(choice, N)
        dem_sorted = dem[order].to(F64)
        within = _segment_prefix(dem_sorted, first)
        node_sorted = torch.clamp(seg, max=N - 1)
        free_row = free[node_sorted].to(F64)
        ok_sorted = torch.all(within <= free_row, dim=1) & (seg < N)
        for guard, gdem in zip(guards, guard_demands):
            gd_sorted = gdem[idx][order].to(F64)
            g_excl = _segment_prefix(gd_sorted, first) - gd_sorted
            ok_sorted = ok_sorted & guard(state, idx[order], node_sorted,
                                          g_excl)
        admitted = _scatter_verdicts(order, ok_sorted, choice)

        if validate_fn is not None:
            t0 = time.perf_counter()
            with torch.profiler.record_function("validate_wave"):
                kept = []
                for j in range(Ssub):
                    q, node = idx[j:j + 1], choice[j:j + 1]
                    ok = admitted[j:j + 1] & validate_fn(state, q, node)
                    state = validate_commit_fn(state, q,
                                               torch.where(ok, node, -1))
                    kept.append(ok)
                admitted = torch.cat(kept)
            walk.append((Ssub, time.perf_counter() - t0))

        if collect_stats:
            wave_of = wave_of.index_copy(0, idx, torch.where(
                admitted, len(occupancy), wave_of[idx]).to(torch.int32))
        assignment = assignment.index_copy(
            0, idx, torch.where(admitted, choice, assignment[idx]))
        used = torch.zeros((N + 1, R), dtype=free.dtype, device=device)
        used.index_add_(0, torch.where(admitted, choice, N),
                        torch.where(admitted[:, None], dem, 0))
        placed_full = torch.zeros(P, dtype=torch.bool,
                                  device=device).index_copy(0, idx, admitted)
        choice_full = torch.full((P,), -1, dtype=torch.int64,
                                 device=device).index_copy(0, idx, choice)
        state = commit_fn(state, placed_full, choice_full.to(torch.int32))
        left = ((assignment == -1) & pod_mask).sum()
        return free - used[:N], assignment, state, torch.stack(
            [admitted.sum(), left])

    def dense_wave(free, assignment, state):
        active = (assignment == -1) & pod_mask
        feasible, scores = batch_fn(free, state, active)
        return wave_core(free, assignment, state, dense_idx, feasible,
                         scores)

    def sparse_wave(free, assignment, state):
        active = (assignment == -1) & pod_mask
        # the first S active pods in queue order (stable: inactive rows
        # sink with key P, in queue order behind them)
        idx = torch.argsort(torch.where(active, dense_idx, P),
                            stable=True)[:S]
        feasible, scores = sub_batch_fn(free, state, idx, active[idx])
        return wave_core(free, assignment, state, idx, feasible, scores)

    free, state = free0, state0
    assignment = torch.full((P,), -1, dtype=torch.int64, device=device)
    occupancy = []
    if initial_batch is not None:
        free, assignment, state, counts = wave_core(
            free, assignment, state, dense_idx, *initial_batch)
        n, left = counts.tolist()
        occupancy.append(n)
    else:
        n, left = 1, int(pod_mask.any())
    if sub_batch_fn is None:
        # dense waves to quiescence, a stalled wave, or the wave budget
        while len(occupancy) < max_waves and n > 0 and left > 0:
            free, assignment, state, counts = dense_wave(free, assignment,
                                                         state)
            n, left = counts.tolist()
            occupancy.append(n)
    else:
        # the mode machine: a productive wave of either kind goes back to
        # sparse; a stalled sparse wave escalates to one dense wave; a
        # stalled dense wave (wave 0 included) stops
        mode = "sparse" if n > 0 else "stop"
        while len(occupancy) < max_waves and mode != "stop" and left > 0:
            wave = sparse_wave if mode == "sparse" else dense_wave
            free, assignment, state, counts = wave(free, assignment, state)
            n, left = counts.tolist()
            occupancy.append(n)
            mode = ("sparse" if n > 0
                    else "dense" if mode == "sparse" else "stop")
    assignment = assignment.to(torch.int32)
    if collect_stats:
        occ = torch.zeros(max_waves, dtype=torch.int32)
        occ[:len(occupancy)] = torch.tensor(occupancy[:max_waves],
                                            dtype=torch.int32)
        return assignment, free, state, {"occupancy": occ,
                                         "waves": len(occupancy),
                                         "wave_of": wave_of, "walk": walk}
    return assignment, free, state
