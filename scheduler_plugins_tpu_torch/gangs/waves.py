"""Wave-batched gang solve: independent gangs solved together, bit-exact
(port of `scheduler_plugins_tpu.gangs.waves`).

The sequential gang solve (`gangs.topology.gang_solve`) walks the gangs
one at a time. This module batches them into **waves**: one device call
solves a whole wave of W gangs against the wave-start state
(`wave_solve_body`: the same per-gang body, `topology.place_lanes`, with
a leading lane axis), then a host validator walks the wave in queue
order, committing every lane whose speculative result is provably the
sequential solve's and resolving conflicted lanes in place with the
numpy twin's own step (`topology.place_gang_np`). A wave costs one device
call and one host copy of its outputs; G gangs take ceil(G / W) waves.

Why an accepted lane is exact: commits only DECREASE free capacity and
only INCREASE quota usage, so the first-fit scan is monotone. Two host
checks per gang, against the commits accepted earlier in the wave:

1. **Primary-block invariance**: the spill order depends only on the
   primary block. Resident-anchored gangs pick it from `prev_assigned`
   (free-independent); for the rest the validator recomputes packed-rank
   capacity under the accepted block-level deltas
   (`topology.packed_rank_capacity_np`) and requires the same argmax,
   which pins the whole node order.
2. **Choice replay**: with the order pinned, every node ordered before a
   chosen node was infeasible at the wave start and stays infeasible
   under smaller free capacity, so the sequential scan can only pick the
   same node or fail. The replay re-checks, rank by rank, that each
   chosen node still fits and the quota row still clears.

The first gang of a wave validates trivially. A conflicted lane is
re-solved on the host against the committed state and validation goes
on, so the worst case is the numpy twin plus G / W device calls.

`wave_gang_solve` is bit-identical to `gang_solve_np` (and so to
`gang_solve`). With a ("gangs",) rank `mesh` (`parallel.mesh
.make_axis_mesh(GANGS_AXIS)`) the wave axis splits over the ranks: the
wave width rounds up to a multiple of the ranks, each rank solves its W / S
lanes against the replicated problem and state, and one gather of the lane
outputs gives every rank the whole wave, so every rank runs the same host
validator and returns the same result (JAX's shard_map over a ("gangs",)
device mesh).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.gangs import topology as T
from scheduler_plugins_tpu_torch.parallel.mesh import GANGS_AXIS, all_gather
from scheduler_plugins_tpu_torch.serving.deltas import stage

I64 = np.int64
I32 = np.int32

#: default wave width: lanes solved per device call
DEFAULT_WAVE = 64


def wave_solve_body(gangs: T.RankGangState, free, eq_used, node_mask, ids):
    """One wave: solve the gangs `ids` (W,) independently against the SAME
    (`free`, `eq_used`) wave-start state, the lane axis leading. Returns
    per lane (choices (W, M) int32, admitted (W,), q_new (W,) int32,
    primary (W,), has_res (W,)); each lane's own post-placement capacity
    stays inside (the host validator recommits accepted lanes exactly).
    Device work only."""
    lanes = T._Lanes.gather(gangs, ids)
    (choices, admitted, q_new, _free_l, _eq_delta, _resident, primary,
     has_res) = T.place_lanes(gangs, lanes, free, eq_used, node_mask)
    return choices, admitted, q_new, primary, has_res


def _primary_invariant(gangs, g, block_free, packed_dev_primary):
    """True when gang g's primary block is unchanged under the accepted
    commits' block deltas: packed-rank capacity recomputed with the
    solve's own scoring, its argmax against the device's wave-start
    primary."""
    dem = np.where(
        (gangs.rank_mask[g] & (gangs.prev_assigned[g] < 0))[:, None],
        gangs.rank_req[g], 0,
    )
    cumdem = np.cumsum(dem.astype(np.float64), axis=0)
    packed = T.packed_rank_capacity_np(cumdem, block_free)
    return int(np.argmax(packed)) == int(packed_dev_primary)


def wave_gang_solve(gangs: T.RankGangState, free0, eq_used0, node_mask,
                    wave: int = DEFAULT_WAVE, mesh=None,
                    stats: Optional[dict] = None, *, device=None):
    """Wave-batched gang solve on `device` (None = the CUDA card),
    bit-identical to `gang_solve_np` / `gang_solve`. Returns (rank_nodes
    (G, M) int32, admitted (G,) bool, placed_new (G,) int32, free (N, R)
    int64, eq_used (Q, R) int64) as numpy: the twin's exact contract.
    `stats`, when given, collects {"waves", "accepted" (per-wave
    acceptance counts), "host_solves"}. With a ("gangs",) rank `mesh` every
    rank of it calls this with the same problem; each solves its share of
    each wave's lanes and all return the same result."""
    device = resolve_device(device)
    gangs_np = gangs.numpy()
    rank_req = gangs_np.rank_req
    rank_mask = gangs_np.rank_mask
    prev = gangs_np.prev_assigned
    gang_ns = gangs_np.gang_ns
    gang_mask = gangs_np.gang_mask
    node_block = gangs_np.node_block
    quota_has = gangs_np.quota_has
    quota_max = gangs_np.quota_max
    node_mask_np = T._np(node_mask).astype(bool)

    G, M, R = rank_req.shape
    B = gangs_np.block_cost.shape[0]
    blocked = (node_block >= 0) & node_mask_np
    blk = np.maximum(node_block, 0)

    free = T._np(free0).astype(I64).copy()
    eq_used = T._np(eq_used0).astype(I64).copy()
    rank_nodes = prev.astype(I32).copy()
    admitted = np.zeros(G, bool)
    placed_new = np.zeros(G, I32)

    # queue order over the REAL gangs; pad slots never solve in the
    # sequential scan either: their rows stay resident-only
    order = [g for g in range(G) if gang_mask[g]]
    for g in range(G):
        if not gang_mask[g]:
            rank_nodes[g] = np.where(rank_mask[g] & (prev[g] >= 0),
                                     prev[g], -1)

    W = wave
    n_ranks = 1 if mesh is None else mesh.axis_size(GANGS_AXIS)
    if n_ranks > 1:
        W = max(W, n_ranks)
        W = ((W + n_ranks - 1) // n_ranks) * n_ranks
    lanes = W // n_ranks
    first = lanes * (0 if mesh is None else mesh.coordinate(GANGS_AXIS))
    # the problem goes to the card once; every wave re-reads it
    gangs_dev = gangs.to(device)
    (mask_dev,) = stage((node_mask_np,), device)

    i = 0
    n_waves = 0
    accepts: list[int] = []
    host_solves = 0
    while i < len(order):
        batch = order[i:i + W]
        ids = np.zeros(W, I64)  # pad lanes re-solve gang batch[0]: ignored
        ids[:len(batch)] = batch  # by the host acceptance loop
        ids[len(batch):] = batch[0]
        free_dev, eq_dev, ids_dev = stage(
            (free, eq_used, ids[first:first + lanes]), device)
        choices_t, adm_t, qn_t, prim_t, res_t = wave_solve_body(
            gangs_dev, free_dev, eq_dev, mask_dev, ids_dev)
        packed = torch.cat((choices_t.to(torch.int64),
                            torch.stack((adm_t.to(torch.int64),
                                         qn_t.to(torch.int64),
                                         prim_t.to(torch.int64),
                                         res_t.to(torch.int64)), dim=1)),
                           dim=1)
        if n_ranks > 1:
            # every rank's lanes, in lane order
            packed = all_gather(packed, mesh, GANGS_AXIS).flatten(0, 1)
        # the wave's one host copy
        packed = packed.cpu().numpy()
        choices = packed[:, :M]
        adm, q_new, primary, has_res = (packed[:, M + k] for k in range(4))
        n_waves += 1

        # wave-start block free totals (the scoring input), kept under
        # accepted commits for the primary-invariance check
        freec = np.where(node_mask_np[:, None], np.clip(free, 0, None), 0)
        block_free = np.zeros((B, R), I64)
        np.add.at(block_free, blk[blocked], freec[blocked])

        accepted = 0
        dirty = False  # any placement committed since the wave's call
        for j, g in enumerate(batch):
            tentative = [
                (m, int(choices[j, m])) for m in range(M)
                if choices[j, m] >= 0
            ]
            ns = int(gang_ns[g])
            has_quota = ns >= 0 and bool(quota_has[ns])
            valid = True
            if dirty:  # the first lane of a wave validates trivially
                # 1. primary-block invariance pins the node order
                if not bool(has_res[j]) and not _primary_invariant(
                    gangs_np, g, block_free, primary[j]
                ):
                    valid = False
                else:
                    # 2. choice replay: each chosen node must still fit
                    # its rank under the committed state (and this gang's
                    # earlier ranks), and the quota row must still clear
                    sim_free: dict[int, np.ndarray] = {}
                    sim_eq = eq_used[ns].copy() if has_quota else None
                    for m, n in tentative:
                        d = rank_req[g, m]
                        fvec = sim_free.get(n)
                        if fvec is None:
                            fvec = free[n].copy()
                        if not (fvec >= d).all() or (
                            has_quota
                            and not (sim_eq + d <= quota_max[ns]).all()
                        ):
                            valid = False
                            break
                        sim_free[n] = fvec - d
                        if has_quota:
                            sim_eq = sim_eq + d
            if not valid:
                # a conflicted lane: resolve THIS gang exactly with the
                # twin's own step against the committed state, and keep
                # consuming the wave
                host_solves += 1
                c_np, ok, qn, free_l, eq_l, resident = T.place_gang_np(
                    gangs_np, g, free, eq_used, node_mask_np
                )
                admitted[g] = ok
                placed_new[g] = qn if ok else 0
                row = np.where(resident, prev[g], c_np if ok else -1)
                rank_nodes[g] = row.astype(I32)
                if ok:
                    placed = [
                        (m, int(c_np[m])) for m in range(M) if c_np[m] >= 0
                    ]
                    free = free_l
                    eq_used = eq_l
                    for m, n in placed:
                        if blocked[n]:
                            block_free[blk[n]] -= rank_req[g, m]
                    if placed:
                        dirty = True
                continue
            # a validated lane: commit the device solve, the sequential
            # semantics (revert on a quorum failure: zero partial ranks)
            ok = bool(adm[j])
            admitted[g] = ok
            placed_new[g] = int(q_new[j]) if ok else 0
            resident = rank_mask[g] & (prev[g] >= 0)
            row = np.where(
                resident, prev[g],
                choices[j].astype(I32) if ok else I32(-1),
            )
            rank_nodes[g] = row
            if ok:
                for m, n in tentative:
                    d = rank_req[g, m]
                    free[n] -= d
                    if blocked[n]:
                        block_free[blk[n]] -= d
                    if has_quota:
                        eq_used[ns] += d
                if tentative:
                    dirty = True
            accepted += 1
        accepts.append(accepted)
        i += len(batch)

    if stats is not None:
        stats["waves"] = n_waves
        stats["accepted"] = accepts
        stats["host_solves"] = host_solves
    return rank_nodes, admitted, placed_new, free, eq_used
