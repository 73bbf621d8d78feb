"""Rank-aware gang placement: the topology-block waterfill on tensors (port
of `scheduler_plugins_tpu.gangs.topology`).

For gang jobs, WHICH nodes host the ranks dominates runtime: the
inter-rank network distance is the objective. Nodes group into topology
blocks (zone codes); a rank pair sits on one node (cost 0), in one block
(`SAME_ZONE_COST`) or across blocks (`block_cost[b_i, b_j]`, the
NetworkTopology CR's zone and region weights lowered once into one (B, B)
matrix by `build_block_cost`). A gang of up to M ranks carries per-rank
demand vectors; its placement obeys the same hard constraints as the
per-pod solve: fit, ElasticQuota max per namespace, and quorum (at least
`min_ranks` ranks place, or none do).

Per gang, in queue order (`gang_solve`):

1. **Score blocks by packed-rank capacity**: the inclusive float64
   cumulative rank demand (exact below 2^53) searched against each
   block's free totals: how many queue-ordered ranks the block covers.
   The primary block is the first maximum; a gang with resident ranks
   (elastic growth) anchors on the block holding most residents.
2. **Spill order**: the other blocks by `block_cost[primary, b]`, index
   breaking ties (the key `cost * B + b` is unique); unblocked nodes come
   after every block.
3. **Exact rank scan**: ranks place one at a time, each on the first node
   in block-first order with capacity and quota headroom; the first rank
   that fits nowhere kills the rest (placements are a prefix).
4. **Quorum revert**: residents + new ranks below `min_ranks` roll the
   gang's commits back: zero partial ranks.

The JAX package writes steps 3 and the gang loop as two nested
`lax.scan`s; here they are Python loops over device tensors whose steps
issue device work only (the verdicts stay (1,)- or (W,)-shaped device
booleans inside `torch.where`), so a solve never waits for the card. The
per-gang body `place_lanes` takes a leading lane axis: the sequential
solve runs it with one lane against the live carry (`place_gang_one`),
the wave solve (`gangs.waves`) with W lanes against the wave-start
state.

`gang_solve_np` is the numpy sequential twin, bit-identical to
`gang_solve`; `pair_costs` / `gang_cost_stats` score a placement for the
bench and the quality objectives (`tuning.quality.rank_gang_quality`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import resolve_device, to_device
from scheduler_plugins_tpu_torch.ops.network import MAX_COST, SAME_ZONE_COST

I64 = np.int64
I32 = np.int32

#: node-order sentinel for "never place here" (a masked node)
_FAR = np.iinfo(np.int32).max

#: the dtype of each `RankGangState` field
_DTYPES = {
    "rank_req": torch.int64,
    "rank_mask": torch.bool,
    "prev_assigned": torch.int32,
    "min_ranks": torch.int32,
    "gang_ns": torch.int32,
    "gang_mask": torch.bool,
    "node_block": torch.int32,
    "block_cost": torch.int32,
    "quota_max": torch.int64,
    "quota_has": torch.bool,
}


def _np(x):
    """A host numpy view of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(x, dtype, device):
    """`x` (a numpy array or a tensor) as a `dtype` tensor on `device`; a
    host array goes to the card pinned and non-blocking, so staging never
    waits for it."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.to(device=device, dtype=dtype)
    return to_device(x, device, dtype)


@dataclass
class RankGangState:
    """The tensors of one gang-phase solve. Rank slots are per-gang rows:
    slot m of gang g is that gang's rank m (residents first, then pending
    members in queue order, the order `gangs.phase
    .build_rank_gang_problem` fixes). Fields hold numpy arrays on the host
    (the phase's lowering, the numpy twin) or tensors (`to`)."""

    rank_req: object  # (G, M, R) int64 per-rank fit demand (pods slot 1)
    rank_mask: object  # (G, M) bool: real rank slots this cycle
    #: (G, M) int32 resident rank -> node (-1 = pending). The snapshot
    #: counterpart of the `SolverState.rank_nodes` carry: the solve
    #: threads its placements through the carry, never writes this
    prev_assigned: object
    min_ranks: object  # (G,) int32 quorum (elastic min)
    gang_ns: object  # (G,) int32 namespace code (-1 = no quota scope)
    gang_mask: object  # (G,) bool
    node_block: object  # (N,) int32 topology-block (zone) code, -1 none
    block_cost: object  # (B, B) int32 inter-block cost, diag SAME_ZONE
    quota_max: object  # (Q, R) int64 ElasticQuota max per namespace
    quota_has: object  # (Q,) bool: the namespace carries a quota

    def to(self, device) -> "RankGangState":
        """The same state as tensors on `device`, each field in its
        dtype."""
        device = torch.device(device)
        return RankGangState(**{
            f.name: _tensor(getattr(self, f.name), _DTYPES[f.name], device)
            for f in dataclasses.fields(self)
        })

    def numpy(self) -> "RankGangState":
        """The same state as host numpy arrays."""
        return RankGangState(**{f.name: _np(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


# ---------------------------------------------------------------------------
# block cost lowering (host)
# ---------------------------------------------------------------------------


def build_block_cost(zones, regions, zone_region, zone_cost, region_cost):
    """(B, B) int32 inter-block cost matrix over zone codes, composed as
    NetworkOverhead's pair tables are: one block -> SAME_ZONE_COST; a
    known zone-cost pair -> that cost; else both regions known and
    different with a region-cost pair -> that cost; anything else ->
    MAX_COST. `zone_region` maps zone code -> region code (-1 unknown);
    `zone_cost` / `region_cost` are dense -1-for-missing matrices."""
    B = max(len(zones), 1)
    zone_cost = np.asarray(zone_cost)
    region_cost = np.asarray(region_cost)
    zone_region = np.asarray(zone_region)
    out = np.full((B, B), MAX_COST, I32)
    for a in range(B):
        for b in range(B):
            if a == b:
                out[a, b] = SAME_ZONE_COST
                continue
            if a < zone_cost.shape[0] and b < zone_cost.shape[1] and \
                    zone_cost[a, b] >= 0:
                out[a, b] = zone_cost[a, b]
                continue
            ra = zone_region[a] if a < zone_region.shape[0] else -1
            rb = zone_region[b] if b < zone_region.shape[0] else -1
            if ra >= 0 and rb >= 0:
                if ra == rb:
                    # one region, no zone pair in the CR: the reference's
                    # missing-zone-lookup MaxCost path
                    out[a, b] = MAX_COST
                elif region_cost[ra, rb] >= 0:
                    out[a, b] = region_cost[ra, rb]
    return out


# ---------------------------------------------------------------------------
# the device solve
# ---------------------------------------------------------------------------


def packed_rank_capacity(cumdem, block_free):
    """(W, B) int32 packed-rank capacity per lane and block: how many
    queue-ordered ranks each block's free totals cover, the minimum over
    resources of the count of m with `cumdem[w, m, r] <= block_free[b,
    r]`. `cumdem` (W, M, R) float64 inclusive cumulative rank demand;
    `block_free` (B, R) non-negative block free totals. One
    `searchsorted(right=True)` over contiguous (W, R, M) rows, exact for
    values below 2^53."""
    W, _, R = cumdem.shape
    rows = cumdem.permute(0, 2, 1).contiguous()  # (W, R, M)
    values = block_free.to(torch.float64).t().expand(W, R, -1).contiguous()
    counts = torch.searchsorted(rows, values, right=True)  # (W, R, B)
    return counts.amin(dim=1).to(torch.int32)


def _first_max(x, index):
    """(W,) index of the first maximum along dim 1 (the JAX `argmax`
    tie-break, written out)."""
    best = x.amax(dim=1, keepdim=True)
    return torch.where(x == best, index, x.shape[1]).amin(dim=1)


@dataclass
class _Lanes:
    """The per-gang rows of W lanes: views of one gang's rows for the
    sequential solve, gathers for a wave."""

    rank_req: torch.Tensor  # (W, M, R)
    rank_mask: torch.Tensor  # (W, M)
    prev: torch.Tensor  # (W, M)
    min_ranks: torch.Tensor  # (W,)
    gang_ns: torch.Tensor  # (W,)
    gang_mask: torch.Tensor  # (W,)

    @classmethod
    def rows(cls, gangs: RankGangState, g: int) -> "_Lanes":
        sl = slice(g, g + 1)
        return cls(gangs.rank_req[sl], gangs.rank_mask[sl],
                   gangs.prev_assigned[sl], gangs.min_ranks[sl],
                   gangs.gang_ns[sl], gangs.gang_mask[sl])

    @classmethod
    def gather(cls, gangs: RankGangState, ids) -> "_Lanes":
        return cls(gangs.rank_req[ids], gangs.rank_mask[ids],
                   gangs.prev_assigned[ids], gangs.min_ranks[ids],
                   gangs.gang_ns[ids], gangs.gang_mask[ids])


def place_lanes(gangs: RankGangState, lanes: _Lanes, free, eq_used,
                node_mask):
    """The topology-block waterfill of W gangs, each solved alone against
    the same (`free` (N, R), `eq_used` (Q, R)): the shared per-gang body
    of the sequential solve (W = 1, the live carry) and of the wave solve
    (W lanes, the wave-start state). Device work only.

    Returns (choices (W, M) int32, admitted (W,), q_new (W,) int32,
    free_l (W, N, R), eq_delta (W, R), resident (W, M), primary (W,),
    has_res (W,)): `choices` are the PRE-revert tentative placements,
    `free_l` each lane's free capacity after its own placements and
    `eq_delta` what they add to the lane's quota row (zero without a
    quota); callers apply the quorum verdict themselves."""
    W, M, R = lanes.rank_req.shape
    N = free.shape[0]
    B = gangs.block_cost.shape[0]
    device = free.device
    node_block = gangs.node_block
    block_cost = gangs.block_cost.to(torch.int32)
    blk = torch.clamp(node_block, min=0).long()
    blocked = (node_block >= 0) & node_mask
    node_index = torch.arange(N, device=device)
    block_index = torch.arange(B, device=device)

    pending = lanes.rank_mask & (lanes.prev < 0)  # (W, M)
    resident = lanes.rank_mask & (lanes.prev >= 0)
    dem = torch.where(pending[:, :, None], lanes.rank_req, 0)  # (W, M, R)

    # 1. block scoring: packed-rank capacity over each lane's pending
    # demand prefix; the block free totals are the same for every lane
    freec = torch.where(node_mask[:, None], torch.clamp(free, min=0), 0)
    block_free = torch.zeros((B, R), dtype=free.dtype, device=device)
    block_free = block_free.index_add(
        0, blk, torch.where(blocked[:, None], freec, 0))
    cumdem = torch.cumsum(dem.to(torch.float64), dim=1)  # (W, M, R)
    packed = packed_rank_capacity(cumdem, block_free)  # (W, B)
    res_nodes = torch.clamp(lanes.prev, min=0).long()  # (W, M)
    res_ok = resident & (node_block[res_nodes] >= 0)
    res_cnt = torch.zeros((W, B), dtype=torch.int32, device=device)
    res_cnt = res_cnt.scatter_add(1, blk[res_nodes], res_ok.to(torch.int32))
    has_res = res_cnt.sum(dim=1) > 0
    primary = torch.where(has_res, _first_max(res_cnt, block_index),
                          _first_max(packed, block_index))  # (W,)

    # 2. spill order: cost from the primary ascending, index tie-break
    # (unique keys); the primary pinned first
    cost_from = block_cost[primary].to(torch.int64)  # (W, B), a gather
    cost_from = cost_from.scatter(1, primary[:, None], -1)
    block_order = torch.argsort(cost_from * B + block_index, dim=1)
    block_pos = torch.zeros((W, B), dtype=torch.int64, device=device)
    block_pos = block_pos.scatter(
        1, block_order, block_index.expand(W, B).contiguous())
    node_pos = torch.where(
        blocked,
        block_pos[:, blk] * N + node_index,
        torch.where(node_mask, B * N + node_index, _FAR),
    )  # (W, N): unique finite positions for usable nodes

    ns = lanes.gang_ns
    nsc = torch.clamp(ns, min=0).long()
    has_quota = (ns >= 0) & gangs.quota_has[nsc]  # (W,)
    qmax = gangs.quota_max[nsc]  # (W, R)
    eq_row = eq_used[nsc]  # (W, R): a gather, fresh

    # 3. exact rank scan: first fit in block-first order, dead after the
    # first unplaceable rank. Each lane's capacity is a fresh copy whose
    # commit subtracts at the chosen node only
    free_l = free.expand(W, N, R).clone()
    eq_delta = torch.zeros_like(eq_row)
    lane_index = torch.arange(W, device=device)
    dead = torch.zeros(W, dtype=torch.bool, device=device)
    choices = []
    for m in range(M):
        d = dem[:, m]  # (W, R)
        fits = (free_l >= d[:, None, :]).all(dim=2) & node_mask
        qok = ~has_quota | (eq_row + eq_delta + d <= qmax).all(dim=1)
        lane_ok = pending[:, m] & ~dead & qok  # (W,)
        feasible = fits & lane_ok[:, None]
        pos = torch.where(feasible, node_pos, _FAR)
        low = pos.amin(dim=1, keepdim=True)
        first = torch.where(pos == low, node_index, N).amin(dim=1)
        choice = torch.where(feasible.any(dim=1), first, -1).to(torch.int32)
        placed = choice >= 0
        step = torch.where(placed[:, None], d, 0)
        # one row a lane: lane w's chosen node (row w * N + node)
        free_l.view(W * N, R).index_add_(
            0, lane_index * N + torch.clamp(choice, min=0).long(), -step)
        eq_delta = eq_delta + torch.where(has_quota[:, None], step, 0)
        dead = dead | (pending[:, m] & ~placed)
        choices.append(choice)
    choices = torch.stack(choices, dim=1)  # (W, M)

    # 4. quorum verdict: zero partial ranks below min (callers revert)
    q_new = (choices >= 0).sum(dim=1).to(torch.int32)
    q_total = q_new + resident.sum(dim=1).to(torch.int32)
    admitted = lanes.gang_mask & (q_total >= lanes.min_ranks)
    return (choices, admitted, q_new, free_l, eq_delta, resident, primary,
            has_res)


def place_gang_one(gangs: RankGangState, g: int, free, eq_used, node_mask):
    """ONE gang's topology-block waterfill step against the live (`free`
    (N, R), `eq_used` (Q, R)): `place_lanes` with the gang's rows as one
    lane. Returns (choices (M,) int32, admitted (1,), q_new (1,),
    free_l (N, R), eq_l (Q, R), resident (M,), primary (1,), has_res
    (1,)): the PRE-revert state; the caller applies the quorum verdict."""
    lanes = _Lanes.rows(gangs, g)
    (choices, admitted, q_new, free_l, eq_delta, resident, primary,
     has_res) = place_lanes(gangs, lanes, free, eq_used, node_mask)
    nsc = torch.clamp(lanes.gang_ns, min=0).long()
    eq_l = eq_used.index_add(0, nsc, eq_delta)  # a fresh tensor
    return (choices[0], admitted, q_new, free_l[0], eq_l, resident[0],
            primary, has_res)


def gang_solve_body(gangs: RankGangState, state0, node_mask):
    """The topology-block waterfill over every gang in queue order, the
    inputs on one device. `state0` is a `framework.plugin.SolverState`
    with `free` (N, R), `eq_used` (Q, R) and `rank_nodes` (G, M), the last
    initialized from `gangs.prev_assigned` (the live copy; the snapshot
    tensor is never written). Returns (rank_nodes (G, M) int32, admitted
    (G,), placed_new (G,) int32, state) with the final carries. Device
    work only: the verdicts stay (1,) device booleans."""
    G = gangs.rank_req.shape[0]
    free, eq_used = state0.free, state0.eq_used
    if not G:
        empty = torch.zeros(0, dtype=torch.int32, device=free.device)
        return state0.rank_nodes, empty.bool(), empty, state0
    rows, admitted, placed_new = [], [], []
    for g in range(G):
        (choices, ok, q_new, free_l, eq_l, resident, _primary,
         _has_res) = place_gang_one(gangs, g, free, eq_used, node_mask)
        free = torch.where(ok, free_l, free)
        eq_used = torch.where(ok, eq_l, eq_used)
        rows.append(torch.where(resident, gangs.prev_assigned[g],
                                torch.where(ok, choices, -1)))
        admitted.append(ok)
        placed_new.append(torch.where(ok, q_new, 0))
    rank_nodes = torch.stack(rows).to(torch.int32)
    state = state0.replace(free=free, eq_used=eq_used, rank_nodes=rank_nodes)
    return rank_nodes, torch.cat(admitted), torch.cat(placed_new), state


def gang_solve(gangs: RankGangState, state0, node_mask, *, device=None):
    """`gang_solve_body` on `device` (None = the CUDA card; inputs that
    live elsewhere move there): the plain counterpart of the JAX
    package's jitted `gang_solve_fn()`. Nothing is read on the host and
    no input is written."""
    device = resolve_device(device)
    if gangs.rank_req.device != device:
        gangs = gangs.to(device)
    return gang_solve_body(gangs, state0.to(device), node_mask.to(device))


# ---------------------------------------------------------------------------
# placement cost scoring (host)
# ---------------------------------------------------------------------------


def pair_costs(rank_nodes, rank_mask, node_block, block_cost):
    """(G, M, M) int32 inter-rank pair costs (-1 = an invalid pair: an
    unplaced or padded slot, or the diagonal). Same-node pairs cost 0;
    otherwise `block_cost[b_i, b_j]`, MAX_COST when either block is
    unknown. Host numpy."""
    rank_nodes = _np(rank_nodes)
    rank_mask = _np(rank_mask)
    node_block = _np(node_block)
    block_cost = _np(block_cost)
    live = rank_mask & (rank_nodes >= 0)  # (G, M)
    nb = np.where(live, node_block[np.maximum(rank_nodes, 0)], -1)
    known = nb >= 0
    nb0 = np.maximum(nb, 0)
    bc = block_cost[nb0[:, :, None], nb0[:, None, :]]
    cost = np.where(
        known[:, :, None] & known[:, None, :], bc, MAX_COST
    ).astype(I32)
    same_node = rank_nodes[:, :, None] == rank_nodes[:, None, :]
    cost = np.where(same_node, 0, cost)
    valid = live[:, :, None] & live[:, None, :]
    M = rank_nodes.shape[1]
    valid &= ~np.eye(M, dtype=bool)[None]
    return np.where(valid, cost, -1)


def gang_cost_stats(rank_nodes, rank_mask, node_block, block_cost):
    """Per-gang placement cost: (max_cost (G,), sum_cost (G,)) int64 over
    valid rank pairs (the sum counts each unordered pair once; gangs with
    fewer than 2 placed ranks score 0)."""
    pc = pair_costs(rank_nodes, rank_mask, node_block, block_cost)
    valid = pc >= 0
    max_cost = np.where(
        valid.any(axis=(1, 2)), np.max(np.where(valid, pc, 0), axis=(1, 2)), 0
    ).astype(I64)
    sum_cost = (np.sum(np.where(valid, pc, 0), axis=(1, 2)) // 2).astype(I64)
    return max_cost, sum_cost


# ---------------------------------------------------------------------------
# the numpy sequential twin
# ---------------------------------------------------------------------------


def packed_rank_capacity_np(cumdem, block_free):
    """Host twin of `packed_rank_capacity` for one gang: (B,) int32 from
    `cumdem` (M, R) and `block_free` (B, R), the same float64
    searchsorted. Shared by `gang_solve_np` and the wave validator
    (`gangs.waves`), so the validator's primary-block recomputation IS
    the solve's own scoring."""
    R = cumdem.shape[1]
    counts = np.stack(
        [
            np.searchsorted(
                cumdem[:, r], block_free[:, r].astype(np.float64),
                side="right",
            )
            for r in range(R)
        ],
        axis=1,
    )  # (B, R)
    return np.min(counts, axis=1).astype(I32)


def place_gang_np(gangs: RankGangState, g: int, free, eq_used, node_mask):
    """Host twin of the per-gang body for ONE gang against the live
    (`free`, `eq_used`): the same operation order and tie-breaks.
    `gang_solve_np` loops it in queue order, and the wave solve resolves
    its conflicted lanes with it. Returns (choices (M,) int32, ok, q_new,
    free_l, eq_l, resident): PRE-revert state like the device body."""
    rank_req = _np(gangs.rank_req)
    rank_mask = _np(gangs.rank_mask)
    prev = _np(gangs.prev_assigned)
    node_block = _np(gangs.node_block)
    block_cost = _np(gangs.block_cost)
    quota_max = _np(gangs.quota_max)
    quota_has = _np(gangs.quota_has)
    node_mask = _np(node_mask)

    G, M, R = rank_req.shape
    N = free.shape[0]
    B = block_cost.shape[0]
    blk = np.maximum(node_block, 0)
    blocked = (node_block >= 0) & node_mask

    pending = rank_mask[g] & (prev[g] < 0)
    resident = rank_mask[g] & (prev[g] >= 0)
    dem = np.where(pending[:, None], rank_req[g], 0)

    freec = np.where(node_mask[:, None], np.clip(free, 0, None), 0)
    block_free = np.zeros((B, R), I64)
    np.add.at(block_free, blk[blocked], freec[blocked])
    cumdem = np.cumsum(dem.astype(np.float64), axis=0)
    packed = packed_rank_capacity_np(cumdem, block_free)
    res_cnt = np.zeros(B, I32)
    res_nodes = np.maximum(prev[g], 0)
    res_ok = resident & (node_block[res_nodes] >= 0)
    np.add.at(res_cnt, blk[res_nodes[res_ok]], 1)
    primary = int(np.argmax(res_cnt) if res_cnt.sum() > 0
                  else np.argmax(packed))

    cost_from = block_cost[primary].astype(I64).copy()
    cost_from[primary] = -1
    block_order = np.argsort(cost_from * B + np.arange(B))
    block_pos = np.zeros(B, I64)
    block_pos[block_order] = np.arange(B)
    node_pos = np.where(
        blocked,
        block_pos[blk] * N + np.arange(N),
        np.where(node_mask, I64(B) * N + np.arange(N), I64(_FAR)),
    )

    ns = int(_np(gangs.gang_ns)[g])
    nsc = max(ns, 0)
    has_quota = ns >= 0 and bool(quota_has[nsc])

    free_l = free.copy()
    eq_l = eq_used.copy()
    choices = np.full(M, -1, I32)
    dead = False
    for m in range(M):
        if not pending[m] or dead:
            continue
        d = dem[m]
        fits = np.all(free_l >= d[None, :], axis=1) & node_mask
        qok = (not has_quota) or bool(
            np.all(eq_l[nsc] + d <= quota_max[nsc])
        )
        feasible = fits & qok
        if not feasible.any():
            dead = True
            continue
        pos = np.where(feasible, node_pos, I64(_FAR))
        choice = int(np.argmin(pos))
        choices[m] = choice
        free_l[choice] -= d
        if has_quota:
            eq_l[nsc] += d

    q_new = int((choices >= 0).sum())
    q_total = q_new + int(resident.sum())
    ok = bool(_np(gangs.gang_mask)[g]) and \
        q_total >= int(_np(gangs.min_ranks)[g])
    return choices, ok, q_new, free_l, eq_l, resident


def gang_solve_np(gangs: RankGangState, free0, eq_used0, node_mask):
    """Host twin of `gang_solve`: `place_gang_np` looped in queue order,
    bit-identical to the device solve. Returns (rank_nodes (G, M) int32,
    admitted (G,) bool, placed_new (G,) int32, free (N, R), eq_used
    (Q, R))."""
    prev = _np(gangs.prev_assigned)
    G = prev.shape[0]

    free = _np(free0).astype(I64).copy()
    eq_used = _np(eq_used0).astype(I64).copy()
    rank_nodes = prev.astype(I32).copy()
    admitted = np.zeros(G, bool)
    placed_new = np.zeros(G, I32)

    for g in range(G):
        choices, ok, q_new, free_l, eq_l, resident = place_gang_np(
            gangs, g, free, eq_used, node_mask
        )
        if ok:
            free = free_l
            eq_used = eq_l
        admitted[g] = ok
        placed_new[g] = q_new if ok else 0
        rank_nodes[g] = np.where(resident, prev[g], choices if ok else -1)
    return rank_nodes, admitted, placed_new, free, eq_used


def initial_state(gangs: RankGangState, free0, eq_used0,
                  device=None):
    """The `SolverState` a `gang_solve` starts from: `free0`, `eq_used0`
    and `rank_nodes` initialized from the resident assignment, on
    `device` (None = the CUDA card)."""
    from scheduler_plugins_tpu_torch.framework.plugin import SolverState

    device = resolve_device(device)
    return SolverState(
        free=_tensor(free0, torch.int64, device),
        eq_used=_tensor(eq_used0, torch.int64, device),
        rank_nodes=_tensor(gangs.prev_assigned, torch.int32, device))
