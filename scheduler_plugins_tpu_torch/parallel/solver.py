"""The batched scheduling step (port of the flagship half of
`scheduler_plugins_tpu.parallel.solver`).

    PreFilter (gang + elastic quota admission, batched over pods)
 -> static allocatable ranking
 -> targeted waterfill wave placement
 -> queue-order namespace quota prefix
 -> gang quorum Permit

`batch_solve` places with the whole node axis in one tensor;
`sharded_wave_solve` places with the node axis in S rank blocks whose
every cross-block exchange is a CUDA kernel launch (`parallel.kernels`).
The two give bit-identical results. Hard constraints (fit, queue-order node
admission, quota caps, gang quorum) hold in both.

Across the ranks of a `parallel.mesh.Mesh` (one process each), the JAX
package's mesh solves: `sharded_wave_solve(snap, mesh, weights)` and its
chunk program `sharded_wave_chunk_solver`, `sharded_batch_solve` and
`sharded_profile_batch_solve`. Each rank holds its block of the node axis
and every exchange gathers the ranks' rows through the process group
(`ops.assign.waterfill_targeted_ranked`); every rank gets the one-process
result.

`fast_path_scoring` and `fast_solve_head` are the profile-driven head the
streamed solve (`parallel.pipeline.streamed_profile_solve`) runs instead
of the fixed allocatable head of the two solvers above.

`packing_solve` and `packing_profile_solve` append the packing
refinement (`ops.packing.packing_refine`) to the targeted waterfill: the
packing solve mode, which a profile selects with `solveMode: packing`.

`profile_batch_solve` is the batched solve of ANY profile the port
loads: the targeted waterfill when the profile passes `fast_path_scoring`,
else the (P, N) filter and score rows of every plugin against the
cycle-initial state, placed by the stateful waterfill
(`ops.assign.waterfill_assign_stateful`), which re-filters the
state-dependent plugins (NUMA, network, spread, inter-pod affinity) every
wave against the committed carry and re-checks the winners of the
cross-node constraints in queue order (`validate_at`).

`batch_explain_rows` explains pods through the whole-batch row hooks
(`collapsed_batch_rows`); `profile_initial_scores` is the independent
(P, N) objective the explain tables are held against.

`sweep_solve_fn` is the weight sweep's solve: the sequential parity body
under `torch.func.vmap` over K candidate weight vectors
(`tuning.sweep.sweep_cycle`).
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.ops.allocatable import (
    MODE_LEAST,
    allocatable_scores,
    demote_scores_int32,
)
from scheduler_plugins_tpu_torch.ops.assign import (
    _segment_prefix,
    waterfill_assign_stateful,
    waterfill_assign_targeted,
    waterfill_targeted_ranked,
    waterfill_targeted_sharded,
)
from scheduler_plugins_tpu_torch.ops.fit import fits, free_capacity
from scheduler_plugins_tpu_torch.ops.gang import gang_admit
from scheduler_plugins_tpu_torch.ops.packing import packing_refine
from scheduler_plugins_tpu_torch.ops.quota import nominee_sums, quota_admit
from scheduler_plugins_tpu_torch.ops.selectors import commit_tracks
from scheduler_plugins_tpu_torch.parallel import mesh as rank_mesh
from scheduler_plugins_tpu_torch.parallel.mesh import (
    NODES_AXIS,
    PODS_AXIS,
    Mesh,
    pad_to_shards,
)
from scheduler_plugins_tpu_torch.utils import sanitize

F64 = torch.float64

#: the sparse straggler window of the batched profile solve: the rows a
#: straggler wave re-filters (the JAX `PROFILE_STRAGGLER_CAP`)
PROFILE_STRAGGLER_CAP = 128


def nominated_aggregates_batch(quota):
    """(P, R) nominee aggregates from the (M, P) masks x (M, R) requests."""
    return (nominee_sums(quota.nom_in_eq_mask, quota.nom_req),
            nominee_sums(quota.nom_total_mask, quota.nom_req))


def batch_admission(snap, free, eq_used=None, rows=None):
    """(P,) PreFilter verdicts for the batch against the carried state;
    with `rows` (a slice), the verdicts of those pod rows only."""
    pods = snap.pods
    if rows is not None:
        pods = pods.replace(**{k: getattr(pods, k)[rows] for k in (
            "mask", "gated", "gang", "ns", "req")})
    ok = pods.mask & ~pods.gated
    if snap.gangs is not None:
        ok &= gang_admit(snap.gangs, free, pods.gang)
    if snap.quota is not None:
        used = eq_used if eq_used is not None else snap.quota.used
        nom_in_eq, nom_total = nominated_aggregates_batch(snap.quota)
        if rows is not None:
            nom_in_eq, nom_total = nom_in_eq[rows], nom_total[rows]
        ok &= quota_admit(
            used, snap.quota.min, snap.quota.max, snap.quota.has_quota,
            pods.ns, pods.req, nom_in_eq, nom_total,
        )
    return ok


def _namespace_quota_prefix_ok(assignment_order_ok, snap, eq_used):
    """(P,) queue-order quota admission as a reject-first-violator
    fixpoint (the JAX `_namespace_quota_prefix_ok`, solver.py:140).

    Every pod's Max / aggregate-Min checks are evaluated against prefix
    sums over the currently assumed admitted set; the queue-first violator
    sees an exact prefix, so its rejection is final. Each loop trip drops
    one true rejection; the trip count is the number of quota-rejected
    pods (typically 0). Float64 cumsums are exact below 2^53."""
    quota = snap.quota
    ns = snap.pods.ns.long()
    P = ns.shape[0]
    device = ns.device
    has_q = quota.has_quota[ns]
    cand = assignment_order_ok & has_q
    reqf = snap.pods.req.to(F64)
    used0_ns = eq_used[ns].to(F64)
    max_ns = quota.max[ns].to(F64)
    agg_min = torch.where(quota.has_quota[:, None], quota.min, 0).sum(0).to(F64)
    agg_used0 = torch.where(
        quota.has_quota[:, None], eq_used, 0
    ).sum(0).to(F64)

    # queue-stable namespace grouping: per-namespace prefixes become
    # 1-D segment cumsums
    idx = torch.arange(P, device=device)
    order = torch.argsort(ns * P + idx, stable=True)
    ns_sorted = ns[order]
    first = torch.ones(P, dtype=torch.bool, device=device)
    first[1:] = ns_sorted[1:] != ns_sorted[:-1]

    def verdicts(admitted):
        charge = torch.where(admitted[:, None], reqf, 0.0)
        incl_own_sorted = _segment_prefix(charge[order], first)
        excl_own = torch.zeros_like(charge)
        excl_own[order] = incl_own_sorted - charge[order]
        excl_agg = torch.cumsum(charge, dim=0) - charge
        own_ok = torch.all(used0_ns + excl_own + reqf <= max_ns, dim=1)
        agg_ok = torch.all(agg_used0 + excl_agg + reqf <= agg_min, dim=1)
        return own_ok & agg_ok

    def first_violator(admitted):
        viol = admitted & ~verdicts(admitted)
        return int(torch.where(viol, idx, P).min())

    admitted = cand
    v = first_violator(admitted)
    while v < P:
        admitted = admitted & (idx != v)
        v = first_violator(admitted)
    return ~has_q | verdicts(admitted)


def finalize_assignment(assignment, snap):
    """Shared tail: queue-order namespace quota enforcement + gang quorum
    Permit over the final placements. Returns (assignment, wait)."""
    if snap.quota is not None:
        placed = assignment >= 0
        quota_ok = _namespace_quota_prefix_ok(placed, snap, snap.quota.used)
        assignment = torch.where(placed & ~quota_ok, -1, assignment)
    wait = torch.zeros(snap.num_pods, dtype=torch.bool, device=snap.device)
    if snap.gangs is not None:
        placed = (assignment >= 0).to(torch.int32)
        gang = snap.pods.gang.long()
        in_gang = gang >= 0
        G = snap.gangs.min_member.shape[0]
        sched = torch.zeros(G, dtype=torch.int32, device=snap.device)
        sched.index_add_(
            0, torch.clamp(gang, min=0), torch.where(in_gang, placed, 0)
        )
        quorum = snap.gangs.assigned + sched >= snap.gangs.min_member
        pod_quorum = torch.where(
            in_gang, quorum[torch.clamp(gang, min=0)], True
        )
        wait = (assignment >= 0) & ~pod_quorum
    return assignment, wait


def _solve_head(snap, weights):
    """(free0, admitted, raw int64 scores) — the part both solvers share."""
    weights = torch.as_tensor(weights, dtype=torch.int64, device=snap.device)
    free0 = free_capacity(snap.nodes.alloc, snap.nodes.requested)
    admitted = batch_admission(snap, free0)
    raw = demote_scores_int32(
        allocatable_scores(snap.nodes.alloc, weights, MODE_LEAST)
    ).to(torch.int64)
    return free0, admitted, raw


def fast_path_scoring(plugins):
    """The single scoring plugin of the targeted fast path, or None when
    the profile does not qualify: no Filter and no state-dependent filter
    in the profile, and exactly one scoring plugin, rating nodes
    pod-invariantly (`static_node_scores`) with a positive weight (only
    then is the raw order the normalized-weighted order)."""
    from scheduler_plugins_tpu_torch.framework.plugin import Plugin

    plugins = tuple(plugins)
    scoring = [p for p in plugins if type(p).score is not Plugin.score]
    filtering = [p for p in plugins if type(p).filter is not Plugin.filter]
    ok = (
        not any(p.state_dependent_filter for p in plugins)
        and not filtering
        and len(scoring) == 1
        and type(scoring[0]).static_node_scores
        is not Plugin.static_node_scores
        and scoring[0].weight > 0
    )
    return scoring[0] if ok else None


def fast_solve_head(plugins, scoring, snap, state0):
    """The head of the targeted fast path over a profile: each plugin's
    presolve bound, the batched PreFilter against `state0`, the scoring
    plugin's full int64 static node ranking (not demoted: the profile's
    own weights and mode), and the free capacity with masked nodes
    zeroed. Returns (admitted (P,), raw (N,) int64, free0 (N, R))."""
    for plugin in plugins:
        plugin.bind_presolve(plugin.prepare_solve(snap))
    admitted = snap.pods.mask & ~snap.pods.gated
    rows = torch.arange(snap.num_pods, device=snap.device)
    for plugin in plugins:
        verdict = plugin.admit_rows(state0, snap, rows)
        if verdict is not None:
            admitted = admitted & verdict
    raw = scoring.static_node_scores(snap).to(torch.int64)
    free0 = torch.where(snap.nodes.mask[:, None], state0.free, 0)
    return admitted, raw, free0


def _chunks(P: int, chunk):
    chunk = P if chunk is None else min(chunk, P)
    if P % chunk != 0:
        raise ValueError(f"pod count {P} not a multiple of chunk {chunk}")
    return range(0, P, chunk), chunk


def batch_solve(snap, weights, max_waves: int = 8, rescue_window: int = 512,
                chunk=None):
    """Full batched step with the node axis in one tensor: admission ->
    allocatable ranking -> targeted waterfill -> quota prefix -> gang
    quorum. Pods go through in queue-order chunks of `chunk` (None = one
    chunk, the JAX `batch_solve`) with the free carry threading from chunk
    to chunk. Unschedulable nodes get zero free capacity for the solve, so
    they can never admit a pod. Returns (assignment, admitted, wait)."""
    free0, admitted, raw = _solve_head(snap, weights)
    free = torch.where(snap.nodes.mask[:, None], free0, 0)
    P = snap.num_pods
    starts, chunk = _chunks(P, chunk)
    parts = []
    for lo in starts:
        a, free, _ = waterfill_assign_targeted(
            raw, snap.pods.req[lo:lo + chunk], admitted[lo:lo + chunk], free,
            max_waves=max_waves, rescue_window=rescue_window,
        )
        parts.append(a)
    assignment, wait = finalize_assignment(torch.cat(parts), snap)
    return assignment, admitted, wait


def _packing_body(snap, raw, admitted, free0, pack_aux, max_waves: int,
                  mover_cap: int):
    """The packing solve after its head: the targeted waterfill from
    `free0` (masked nodes zeroed), the refinement, the shared tail.
    Returns (assignment, wait, waterfill stats, refinement stats)."""
    assignment, free_w, wstats = waterfill_assign_targeted(
        raw, snap.pods.req, admitted, free0, max_waves=max_waves,
    )
    assignment, _, pstats = packing_refine(
        raw, snap.pods.req, admitted, snap.nodes.alloc, snap.nodes.mask,
        free_w, assignment, pack_aux, mover_cap=mover_cap,
    )
    assignment, wait = finalize_assignment(assignment, snap)
    return assignment, wait, wstats, pstats


def packing_solve(snap, weights, pack_aux, max_waves: int = 8,
                  mover_cap: int = 128, collect_stats: bool = False):
    """`batch_solve`'s flagship semantics with the packing refinement
    appended (the JAX `packing_solve`, parallel/solver.py:253): admission,
    the static allocatable ranking and the targeted waterfill, then
    `ops.packing.packing_refine` rounds over the wave placement, then the
    shared `finalize_assignment` tail. `pack_aux` is the host knob vector
    (`ops.packing.pack_aux_vector`); budget 0 is `batch_solve` bit for bit.
    Refinement never changes which pods are placed, so the quota prefix
    and gang quorum see the wave path's placed set. Returns (assignment,
    admitted, wait[, stats]) with stats = the waterfill's plus
    "packing": {rounds, moves, emptied} (int32 device scalars)."""
    free0, admitted, raw = _solve_head(snap, weights)
    assignment, wait, wstats, pstats = _packing_body(
        snap, raw, admitted, torch.where(snap.nodes.mask[:, None], free0, 0),
        pack_aux, max_waves, mover_cap)
    if collect_stats:
        return assignment, admitted, wait, {**wstats, "packing": pstats}
    return assignment, admitted, wait


class PackingSolveView:
    """The (assignment, admitted, wait) a packing-mode solve returns to
    the cycle: not a `SolveResult` (no carry, no per-pod failure codes,
    so the cycle attributes failures from the cycle-initial verdicts).
    `stats` carries the refinement counters as host ints."""

    __slots__ = ("assignment", "admitted", "wait", "failed_plugin", "stats")

    def __init__(self, assignment, admitted, wait, stats=None):
        self.assignment = assignment
        self.admitted = admitted
        self.wait = wait
        self.failed_plugin = None
        self.stats = stats


@sanitize.checked_call("profile_packing")
def packing_profile_solve(scheduler, snap, mover_cap: int = 128,
                          max_waves: int = 8, *, device=None):
    """The packing-mode profile solve, `Scheduler.solve(mode="packing")`
    (the JAX `packing_profile_solve` with `packing_profile_fn`'s body,
    parallel/solver.py:339-430), on `device` (None = the CUDA card; the
    snapshot moves there if it lives elsewhere): the fast-path head
    (PreFilter and the one scoring plugin's static ranking,
    `fast_solve_head`), the targeted waterfill, the refinement with the
    profile's `packing` knobs, and the shared tail. Returns a
    `PackingSolveView`; reading its stats is the one host read.

    The profile must pass `fast_path_scoring` (one pod-invariant scoring
    plugin, no filters): refinement re-places pods on any fitting node,
    sound only when fit is the sole per-node constraint. Other profiles
    raise TypeError (`load_profile` refuses them at config time). Under
    `SPT_PACK_CERTIFY=1` the placements are replayed through the
    `tuning.gates` oracles, and any violation raises AssertionError.
    Under `SPT_SANITIZE=1` the call is the checked program
    "profile_packing" (`utils.sanitize`)."""
    import os

    device = resolve_device(device)
    if snap.device != device:
        snap = snap.to(device)
    plugins = tuple(scheduler.profile.plugins)
    scoring = fast_path_scoring(plugins)
    if scoring is None:
        raise TypeError(
            "packing solve mode requires a profile on the targeted "
            "fast path (one pod-invariant scoring plugin, no filters) — "
            f"profile {scheduler.profile.name!r} does not qualify"
        )
    admitted, raw, free0 = fast_solve_head(
        plugins, scoring, snap, scheduler.initial_state(snap))
    assignment, wait, _, pstats = _packing_body(
        snap, raw, admitted, free0, scheduler.profile.packing.aux(),
        max_waves, mover_cap)
    names = tuple(pstats)
    values = torch.stack([pstats[k] for k in names]).tolist()
    view = PackingSolveView(assignment, admitted, wait,
                            stats=dict(zip(names, values)))
    if os.environ.get("SPT_PACK_CERTIFY") == "1":
        from scheduler_plugins_tpu_torch.tuning.gates import hard_violations

        verdict = hard_violations(snap, assignment, wait)
        if verdict["total"]:
            raise AssertionError(
                f"packing solve violated hard constraints: {verdict}"
            )
    return view


def rank_order_inputs(raw_scores, free0, node_mask, n_shards: int):
    """(node_ids (N',) int32, rank_free (N', R)) — the node axis permuted
    into global score-rank order (stable argsort: the lowest index wins a
    tie) and padded to a multiple of `n_shards` with zero-capacity rows of
    node id -1. Masked nodes get zero capacity."""
    N, R = free0.shape
    order_n = torch.argsort(-raw_scores, stable=True)
    rank_free = torch.where(node_mask[:, None], free0, 0)[order_n]
    node_ids = order_n.to(torch.int32)
    pad = pad_to_shards(N, n_shards) - N
    if pad:
        rank_free = torch.cat(
            [rank_free, rank_free.new_zeros((pad, R))]
        )
        node_ids = torch.cat([node_ids, node_ids.new_full((pad,), -1)])
    return node_ids, rank_free.contiguous()


def _rank_head(snap, mesh: Mesh, weights):
    """(admitted (P,), node ids (BS,), free block (BS, R), n_real) of this
    rank: `batch_solve`'s head with the node axis split over `mesh`'s
    "nodes" ranks and the pod axis over its "pods" ranks. Each rank lowers
    its own node rows (free capacity, raw allocatable score, schedulable
    mask) and its own pod rows' PreFilter verdicts; one gather along each
    axis assembles the columns the global score ranking and the gang
    capacity check read. Every rank then holds the same ranking
    (`rank_order_inputs`) and keeps its block of it."""
    view = rank_mesh.shard_snapshot(snap, mesh)
    N, R = snap.nodes.alloc.shape
    w = torch.as_tensor(weights, dtype=torch.int64, device=snap.device)
    cols = torch.cat([
        free_capacity(view.nodes.alloc, view.nodes.requested),
        allocatable_scores(view.nodes.alloc, w, MODE_LEAST)[:, None],
        view.nodes.mask[:, None].to(torch.int64),
    ], dim=1)
    cols = rank_mesh.gather_blocks(cols, N, mesh, NODES_AXIS)
    free0, mask = cols[:, :R], cols[:, R + 1] > 0
    raw = demote_scores_int32(cols[:, R]).to(torch.int64)
    P = snap.num_pods
    lo, hi = rank_mesh.block_bounds(P, mesh.axis_size(PODS_AXIS),
                                    mesh.coordinate(PODS_AXIS))
    admitted = rank_mesh.gather_blocks(
        batch_admission(snap, free0, rows=slice(lo, hi)), P, mesh,
        PODS_AXIS)
    return (admitted, *_rank_block(raw, free0, mask, mesh), N)


def _rank_block(raw, free0, node_mask, mesh: Mesh):
    """(node ids (BS,), free rows (BS, R)): this rank's block of the
    rank-ordered carry (`rank_order_inputs` over `mesh`'s "nodes" ranks),
    copied so that the rank's solve updates its own rows only."""
    S = mesh.axis_size(NODES_AXIS)
    node_ids, rank_free = rank_order_inputs(raw, free0, node_mask, S)
    BS = rank_free.shape[0] // S
    rows = slice(mesh.coordinate(NODES_AXIS) * BS,
                 (mesh.coordinate(NODES_AXIS) + 1) * BS)
    return node_ids[rows].clone(), rank_free[rows].clone()


def sharded_wave_chunk_solver(mesh: Mesh, n_nodes: int, max_waves: int = 8,
                              rescue_window: int = 512,
                              lite_window: int = 1024,
                              collect_stats: bool = True):
    """The rank-split wave chunk solve over `mesh`'s "nodes" ranks (the JAX
    `sharded_wave_chunk_solver`, parallel/solver.py:1164), with the
    pipeline calling convention:

        fn(node_ids, req_chunk, mask_chunk, rank_free)
            -> ((assignment[, stats]), rank_free)

    `node_ids` (BS,) and `rank_free` (BS, R) are this rank's block of the
    rank-ordered carry (`rank_order_inputs`, padded to the rank count),
    updated in place; `n_nodes` is the pre-padding node count; the chunks
    are replicated. Every rank of the line calls it with its own block and
    gets the same assignment (`ops.assign.waterfill_targeted_ranked`)."""
    S = mesh.axis_size(NODES_AXIS)
    s = mesh.coordinate(NODES_AXIS)

    def gather(t):
        return rank_mesh.all_gather(t, mesh, NODES_AXIS)

    def sharded_wave_chunk(node_ids, req_chunk, mask_chunk, rank_free):
        assignment, stats = waterfill_targeted_ranked(
            rank_free, node_ids, req_chunk, mask_chunk, n_nodes, gather, s,
            S, max_waves=max_waves, rescue_window=rescue_window,
            lite_window=lite_window,
        )
        out = (assignment, stats) if collect_stats else (assignment,)
        return out, rank_free

    return sharded_wave_chunk


def _ranked_targeted(raw, req, admitted, free0, node_mask, mesh: Mesh,
                     max_waves: int):
    """`waterfill_assign_targeted`'s (assignment, stats) from the
    rank-split waterfill over `mesh`'s "nodes" ranks, every rank holding
    the whole (replicated) head."""
    node_ids, rank_free = _rank_block(raw, free0, node_mask, mesh)
    solve = sharded_wave_chunk_solver(mesh, free0.shape[0],
                                      max_waves=max_waves)
    (assignment, stats), _ = solve(node_ids, req, admitted, rank_free)
    return assignment, stats


def _ranked_wave_solve(snap, mesh: Mesh, weights, chunk, max_waves: int,
                       rescue_window: int, collect_stats: bool):
    admitted, node_ids, rank_free, n_real = _rank_head(snap, mesh, weights)
    solve_chunk = sharded_wave_chunk_solver(
        mesh, n_real, max_waves=max_waves, rescue_window=rescue_window)
    P = snap.num_pods
    starts, chunk = _chunks(P, chunk)
    parts, stats = [], []
    for lo in starts:
        (a, st), rank_free = solve_chunk(
            node_ids, snap.pods.req[lo:lo + chunk], admitted[lo:lo + chunk],
            rank_free)
        parts.append(a)
        stats.append(st)
    assignment, wait = finalize_assignment(torch.cat(parts), snap)
    if collect_stats:
        return assignment, admitted, wait, {
            "waves": sum(st["waves"] for st in stats),
            "chunks": stats,
            "rank_free": rank_free,
            "node_ids": node_ids,
        }
    return assignment, admitted, wait


@sanitize.checked_call("sharded_wave_solve")
def sharded_wave_solve(snap, weights_or_mesh, n_blocks_or_weights,
                       chunk=None, max_waves: int = 8,
                       rescue_window: int = 512,
                       collect_stats: bool = False):
    """`batch_solve`'s semantics with the node axis in S rank blocks, in
    one of two forms. Pods go through in queue-order chunks with the free
    carry threading from chunk to chunk. Returns (assignment, admitted,
    wait[, stats]).

    - `sharded_wave_solve(snap, weights, n_blocks, ...)`: one card, the
      `n_blocks` blocks the leading dimension of one (S, BS, R) carry,
      updated in place; each exchange is one kernel launch
      (`ops.assign.waterfill_targeted_sharded`).
    - `sharded_wave_solve(snap, mesh, weights, ...)`: the JAX signature
      (parallel/solver.py:1248), across the ranks of a
      `parallel.mesh.Mesh`: each rank of the "nodes" axis holds one block
      and every exchange gathers the ranks' window rows through the
      process group before the same kernels run on every rank
      (`ops.assign.waterfill_targeted_ranked`). Every rank calls it with
      the same snapshot (`parallel.launch.broadcast_snapshot`) and gets
      the same outputs; its stats hold its own block.

    Both forms give `batch_solve`'s placements bit for bit. Under
    `SPT_SANITIZE=1` either is the checked program "sharded_wave_solve"
    (`utils.sanitize`): the CUDA kernels stay, and the data around each
    launch is checked."""
    if isinstance(weights_or_mesh, Mesh):
        return _ranked_wave_solve(
            snap, weights_or_mesh, n_blocks_or_weights, chunk, max_waves,
            rescue_window, collect_stats)
    weights, n_blocks = weights_or_mesh, n_blocks_or_weights
    free0, admitted, raw = _solve_head(snap, weights)
    n_real = free0.shape[0]
    node_ids, rank_free = rank_order_inputs(
        raw, free0, snap.nodes.mask, n_blocks
    )
    BS = rank_free.shape[0] // n_blocks
    rank_free = rank_free.view(n_blocks, BS, -1)
    node_ids = node_ids.view(n_blocks, BS)
    P = snap.num_pods
    starts, chunk = _chunks(P, chunk)
    parts, stats = [], []
    for lo in starts:
        a, st = waterfill_targeted_sharded(
            rank_free, node_ids, snap.pods.req[lo:lo + chunk],
            admitted[lo:lo + chunk], n_real, max_waves=max_waves,
            rescue_window=rescue_window,
        )
        parts.append(a)
        stats.append(st)
    assignment, wait = finalize_assignment(torch.cat(parts), snap)
    if collect_stats:
        return assignment, admitted, wait, {
            "waves": sum(s["waves"] for s in stats),
            "chunks": stats,
            "rank_free": rank_free,
            "node_ids": node_ids,
        }
    return assignment, admitted, wait


def sharded_batch_solve(snap, mesh: Mesh, weights, max_waves: int = 8):
    """`batch_solve` with the node axis split over `mesh`'s ranks (the JAX
    `sharded_batch_solve`, parallel/solver.py:1095, where XLA partitions
    `batch_solve`): the head lowers each rank's node rows and pod rows and
    gathers them once (`_rank_head`), then the placement runs as the
    rank-split waterfill over the "nodes" axis (the "pods" lines solve the
    same placement side by side). Every rank passes the same snapshot and
    gets `batch_solve`'s (assignment, admitted, wait)."""
    return _ranked_wave_solve(snap, mesh, weights, None, max_waves, 512,
                              False)


def sharded_profile_batch_solve(scheduler, snap, mesh: Mesh,
                                max_waves: int = 8, *, device=None):
    """`profile_batch_solve` across `mesh`'s ranks (the JAX
    `sharded_profile_batch_solve`, parallel/solver.py:1109): the profile's
    per-pod Filter and Score rows are built with the pod axis split over
    every rank of the mesh and gathered, the whole-batch hooks run on
    every rank (a plugin's batch rows read across nodes: spread domains,
    network dependencies), and a profile on the targeted fast path places
    through the rank-split waterfill over the "nodes" axis. Every rank
    passes the same snapshot and gets `profile_batch_solve`'s
    (assignment, admitted, wait)."""
    return profile_batch_solve(scheduler, snap, max_waves=max_waves,
                               device=device, mesh=mesh)


def collapsed_batch_rows(plugins, state0, snap):
    """(filter_rows, score_rows): plugin position -> whole-batch (P, N)
    rows from the `batch_rows` / `filter_batch` / `score_batch` hooks
    against the cycle-initial state, the one copy of the hook dispatch.
    The flagship plugins have no such rows, so both dicts stay empty for
    them."""
    from scheduler_plugins_tpu_torch.framework.plugin import Plugin

    filter_rows, score_rows = {}, {}
    for i, plugin in enumerate(plugins):
        # fused filter + score rows when offered: one pass for both
        if type(plugin).batch_rows is not Plugin.batch_rows:
            fused = plugin.batch_rows(state0, snap)
            if fused is not None:
                f_row, s_row = fused
                if f_row is not None:
                    filter_rows[i] = f_row
                if s_row is not None:
                    score_rows[i] = s_row
                continue
        if type(plugin).filter_batch is not Plugin.filter_batch:
            m = plugin.filter_batch(state0, snap)
            if m is not None:
                filter_rows[i] = m
        if type(plugin).score_batch is not Plugin.score_batch:
            row = plugin.score_batch(state0, snap)
            if row is not None:
                score_rows[i] = row
    return filter_rows, score_rows


def batch_explain_rows(scheduler, snap, indices, auxes=None, *,
                       device=None):
    """The batched twin of `Scheduler.explain_rows`: the same outputs,
    with the per-plugin filter verdicts and raw scores taken from the
    whole-batch rows (`collapsed_batch_rows`) and fed to the same explain
    body, so the two explains cannot drift."""
    from scheduler_plugins_tpu_torch.framework.runtime import (
        _explain_rows,
        run_explain_rows,
    )

    def explain(plugins, state0, snap, idx, rows):
        filter_rows, score_rows = collapsed_batch_rows(plugins, state0, snap)
        return _explain_rows(plugins, state0, snap, idx, rows,
                             filter_rows=filter_rows, score_rows=score_rows)

    return run_explain_rows(scheduler, snap, indices, auxes, explain, device)


def profile_initial_scores(scheduler, snap, auxes=None, *, device=None):
    """((P, N) int64 weighted normalized score totals, (P, N) bool
    feasibility) against the CYCLE-INITIAL state, on `device` (None = the
    CUDA card): the objective the solve modes rank nodes by, computed
    independently of the explain body (built-in fit against the initial
    free capacity, no PreFilter, no nominee holds, the static `weight`).
    `auxes` binds a recorded cycle's `aux()` tensors for the call."""
    from scheduler_plugins_tpu_torch.framework.runtime import (
        _fits_rows,
        bound_auxes,
    )

    device = resolve_device(device)
    if snap.device != device:
        snap = snap.to(device)
    plugins = tuple(scheduler.profile.plugins)
    state0 = scheduler.initial_state(snap)
    with bound_auxes(plugins, auxes):
        for plugin in plugins:
            plugin.bind_presolve(plugin.prepare_solve(snap))
        fit = _fits_rows(snap.pods.req, state0.free, snap.nodes.mask)
        totals, feasibles = [], []
        for p in range(snap.num_pods):
            feasible = fit[p]
            for plugin in plugins:
                mask = plugin.filter(state0, snap, p)
                if mask is not None:
                    feasible = feasible & mask
            total = torch.zeros(snap.num_nodes, dtype=torch.int64,
                                device=snap.device)
            for plugin in plugins:
                raw = plugin.score(state0, snap, p)
                if raw is not None:
                    total = total + plugin.weight * plugin.normalize(
                        raw, feasible
                    )
            totals.append(total)
            feasibles.append(feasible)
    return torch.stack(totals), torch.stack(feasibles)


def sweep_solve_fn(scheduler):
    """The counterfactual weight sweep's solve: a function

        fn(snap, state0, auxes, W (K, L) int64 tensor) ->
            (assignment (K, P) int32, admitted (K, P), wait (K, P))

    that runs the sequential parity body
    (`framework.runtime.sequential_solve_body`) once per candidate weight
    row under `torch.func.vmap` over the leading K axis. The carry (each
    live `SolverState` field, expanded to K rows without a copy) and the
    weight rows are batched; the snapshot, the auxes (bound for the call,
    None = the plugins' own) and the pod index are shared, and so are the
    presolves, computed once from the unbatched snapshot. Lane k equals
    `Scheduler.solve` on a profile whose static weights are W[k]. The
    built-in commit and the gang and quota plugins' commits scatter
    (`utils.intmath.add_rows`), so a sweep step of those profiles (and of
    the load-aware ones, which commit nothing) issues the same ATen ops at
    every K: one program a step, not one a lane. A commit through
    `index_add` (the selector carries, the NUMA plugin's) is still
    exact, its batching rule looping over the lanes. The outputs stay on
    the device; nothing is read on the host."""
    from dataclasses import fields

    from scheduler_plugins_tpu_torch.framework.plugin import SolverState
    from scheduler_plugins_tpu_torch.framework.runtime import (
        bound_auxes,
        sequential_solve_body,
    )

    plugins = tuple(scheduler.profile.plugins)

    def sweep(snap, state0, auxes, W):
        K = W.shape[0]
        carry = {
            f.name: getattr(state0, f.name).expand(
                K, *getattr(state0, f.name).shape)
            for f in fields(SolverState)
            if getattr(state0, f.name) is not None
        }

        def lane(w, carry):
            r = sequential_solve_body(plugins, snap, SolverState(**carry),
                                      weights=w)
            return r.assignment, r.admitted, r.wait

        with bound_auxes(plugins, auxes):
            return torch.func.vmap(lane, in_dims=(0, 0))(W, carry)

    return sweep


def _per_pod_rows(method, plugins, state, snap, skip=(), mesh=None):
    """plugin position -> the plugin's per-pod `method` ("filter" or
    "score") stacked over the pods, for the plugins outside `skip` that
    override it and do not opt out with None on pod 0: the JAX package's
    vmap of the per-pod hook. With a rank `mesh`, each rank calls the hook
    for its block of the pods and the blocks are gathered from every rank
    of the mesh."""
    from scheduler_plugins_tpu_torch.framework.plugin import Plugin

    P = snap.num_pods
    lo, hi = 0, P
    if mesh is not None:
        lo, hi = rank_mesh.block_bounds(P, mesh.size, mesh.rank)
    out = {}
    for i, plugin in enumerate(plugins):
        if i in skip or (getattr(type(plugin), method)
                         is getattr(Plugin, method)):
            continue
        call = getattr(plugin, method)
        first = call(state, snap, 0)
        if first is None:
            continue
        if mesh is None:
            out[i] = torch.stack([first] + [
                call(state, snap, p) for p in range(1, P)])
            continue
        rows = [call(state, snap, p) for p in range(lo, hi)]
        block = (torch.stack(rows) if rows
                 else first.new_zeros((0,) + tuple(first.shape)))
        out[i] = rank_mesh.gather_blocks(block, P, mesh, None)
    return out


@sanitize.checked_call("profile_batch")
def profile_batch_solve(scheduler, snap, max_waves: int = 8,
                        collect_stats: bool = False, *, device=None,
                        mesh=None):
    """The batched solve of the scheduler's profile on `device` (None =
    the CUDA card; the snapshot moves there if it lives elsewhere): the
    JAX `profile_batch_solve` (parallel/solver.py:433). Returns
    (assignment, admitted, wait), plus the wave stats (`occupancy`,
    `waves`) when `collect_stats`. The snapshot is not modified.

    Semantics against the sequential solve: hard constraints hold (fit,
    queue-order node admission, quota prefix, gang quorum, and the
    state-dependent filters re-evaluated every wave with the NUMA plugin's
    exact within-wave zone guard); scores stay cycle-initial, so
    tie-breaking and packing order may differ (the wave trade-off).

    A profile that passes `fast_path_scoring` takes the targeted
    waterfill (stats over its 2 * max_waves + 1 slots). Otherwise every
    plugin's PreFilter (`admit_rows`), Filter and Score rows are built
    once against the cycle-initial state (the whole-batch hooks where a
    plugin has them, else its per-pod hook stacked), each Score row
    normalized over the pod's feasible row, and the stateful waterfill
    places the batch. A state-dependent plugin without `commit_batch` or
    `validate_at` raises TypeError. The plugins with `validate_at`
    (topology spread, inter-pod affinity: constraints that span nodes)
    re-check each wave's winners in queue order against the live carry,
    committing the selector carries (`ops.selectors.commit_tracks`) pod
    by pod; the other state-dependent plugins commit the kept winners in
    one `commit_batch`.

    With a rank `mesh` (`sharded_profile_batch_solve`) the per-pod rows
    are built with the pod axis split over the ranks and the targeted
    waterfill runs split over the "nodes" ranks; the result is the same.

    Under `SPT_SANITIZE=1` the call is the checked program
    "profile_batch" (`utils.sanitize`): the commit scatters' indices, NaN
    in a float score row and zero integer divisors are reported."""
    from scheduler_plugins_tpu_torch.framework.plugin import Plugin
    from scheduler_plugins_tpu_torch.framework.runtime import _fits_rows

    device = resolve_device(device)
    if snap.device != device:
        snap = snap.to(device)
    plugins = tuple(scheduler.profile.plugins)
    dyn = [i for i, p in enumerate(plugins) if p.state_dependent_filter]
    for i in dyn:
        p = plugins[i]
        if (type(p).commit_batch is Plugin.commit_batch
                and p.validate_at is None):
            raise TypeError(
                f"{p.name}: state_dependent_filter requires commit_batch "
                "or validate_at"
            )
    # the carry starts as views of snapshot tables (`net_placed` is the
    # snapshot's `placed_node`); no commit writes in place, so unlike
    # JAX's donated state (`_donation_safe_state`) it needs no copy
    state0 = scheduler.initial_state(snap)

    scoring = fast_path_scoring(plugins)
    if scoring is not None:
        admitted, raw, free0 = fast_solve_head(plugins, scoring, snap,
                                               state0)
        if mesh is None:
            assignment, _, stats = waterfill_assign_targeted(
                raw, snap.pods.req, admitted, free0, max_waves=max_waves)
        else:
            assignment, stats = _ranked_targeted(
                raw, snap.pods.req, admitted, free0, snap.nodes.mask, mesh,
                max_waves)
        assignment, wait = finalize_assignment(assignment, snap)
        if not collect_stats:
            return assignment, admitted, wait
        occ = torch.zeros(2 * max_waves + 1, dtype=torch.int32)
        occ[:stats["waves"]] = torch.tensor(stats["occupancy"],
                                            dtype=torch.int32)
        return assignment, admitted, wait, {"occupancy": occ,
                                            "waves": stats["waves"]}

    for plugin in plugins:
        plugin.bind_presolve(plugin.prepare_solve(snap))
    filter0, score_rows = collapsed_batch_rows(plugins, state0, snap)
    # the per-pod hooks stand in for the plugins without whole-batch rows
    filter0.update(_per_pod_rows("filter", plugins, state0, snap,
                                 skip=filter0, mesh=mesh))

    # PreFilter against the cycle-initial state
    rows = torch.arange(snap.num_pods, device=device)
    admitted = snap.pods.mask & ~snap.pods.gated
    for plugin in plugins:
        verdict = plugin.admit_rows(state0, snap, rows)
        if verdict is not None:
            admitted = admitted & verdict
    # the state-independent filters hold for every wave; the score rows
    # normalize over the cycle-initial feasible set, as the sequential
    # step's do
    static_feasible = torch.ones((snap.num_pods, snap.num_nodes),
                                 dtype=torch.bool, device=device)
    for i, mask in filter0.items():
        if i not in dyn:
            static_feasible = static_feasible & mask
    feasible0 = _fits_rows(snap.pods.req, state0.free,
                           snap.nodes.mask) & static_feasible
    for i, mask in filter0.items():
        if i in dyn:
            feasible0 = feasible0 & mask
    feasible0 = feasible0 & admitted[:, None]

    # score rows with the identity normalize fold into one weighted
    # total; the rest normalize per pod row over feasible0 (each
    # normalizer works row by row over (P, N))
    pre_ids = [i for i in sorted(score_rows)
               if type(plugins[i]).normalize is Plugin.normalize]
    score_rows.update(_per_pod_rows("score", plugins, state0, snap,
                                    skip=score_rows, mesh=mesh))
    check = sanitize.current()
    if check is not None:
        for i, raw in score_rows.items():
            check.nan(raw, f"{plugins[i].name} score rows")
    total = torch.zeros((snap.num_pods, snap.num_nodes), dtype=torch.int64,
                        device=device)
    for i, plugin in enumerate(plugins):
        if i in pre_ids:
            continue
        raw = score_rows.get(i)
        if raw is not None:
            total = total + plugin.weight * plugin.normalize(raw, feasible0)
    # int32: normalized scores are <= 100 * sum(weights)
    scores0 = total.to(torch.int32)
    for i in pre_ids:
        scores0 = scores0 + plugins[i].weight * score_rows[i].to(torch.int32)

    def dyn_rows(state, idx=None):
        """The state-dependent filters' rows against `state`: filter_rows
        (sparse waves), filter_batch, or the per-pod filter stacked."""
        out = None
        for i in dyn:
            plugin = plugins[i]
            m = None
            if idx is not None:
                m = plugin.filter_rows(state, snap, idx)
            if m is None:
                m = plugin.filter_batch(state, snap)
                if m is None:
                    m = _per_pod_rows("filter", [plugin], state, snap).get(0)
                if m is not None and idx is not None:
                    m = m[idx]
            if m is not None:
                out = m if out is None else out & m
        return out

    def batch_fn(free, state, active):
        feasible = fits(snap.pods.req, free, pod_mask=active,
                        node_mask=snap.nodes.mask) & static_feasible
        m = dyn_rows(state)
        return (feasible if m is None else feasible & m), scores0

    def sub_batch_fn(free, state, idx, act_sub):
        feasible = fits(snap.pods.req[idx], free, pod_mask=act_sub,
                        node_mask=snap.nodes.mask) & static_feasible[idx]
        m = dyn_rows(state, idx)
        return (feasible if m is None else feasible & m), scores0[idx]

    # hard DOMAIN constraints (topology spread, inter-pod anti-affinity)
    # span nodes, so neither the per-wave re-filter nor the same-node
    # guard sees a same-wave conflict across nodes: their validators
    # re-check the winners in queue order, committing the selector
    # carries pod by pod; every other dynamic carry commits the kept
    # winners at once
    validators = [plugins[i] for i in dyn
                  if plugins[i].validate_at is not None]
    batch_committers = [plugins[i] for i in dyn
                        if plugins[i].validate_at is None]

    def commit_fn(state, placed, choice):
        for plugin in batch_committers:
            state = plugin.commit_batch(state, snap, placed, choice)
        return state

    validate_fn = validate_commit_fn = None
    if validators:
        def validate_fn(state, q, node):
            ok = None
            for plugin in validators:
                verdict = plugin.validate_at(state, snap, q, node)
                ok = verdict if ok is None else ok & verdict
            return ok

        def validate_commit_fn(state, q, node):
            if snap.scheduling is not None:
                state = commit_tracks(state, snap.scheduling, q, node)
            for plugin in validators:
                state = plugin.commit(state, snap, q, node)
            return state

    guards, guard_demands = [], []
    for i in dyn:
        gdem = plugins[i].wave_guard_demand(snap)
        if gdem is not None:
            guards.append(
                lambda state, pods, nodes, pre, _pl=plugins[i]:
                _pl.wave_guard_rows(state, snap, pods, nodes, pre))
            guard_demands.append(gdem)
    capacity_fns = tuple(
        (lambda state, active, _pl=plugins[i]:
         _pl.wave_capacity(state, snap, active))
        for i in dyn
        if type(plugins[i]).wave_capacity is not Plugin.wave_capacity
    )
    out = waterfill_assign_stateful(
        batch_fn, commit_fn, tuple(guards), tuple(guard_demands),
        snap.pods.req, admitted, state0.free, state0, max_waves=max_waves,
        validate_fn=validate_fn, validate_commit_fn=validate_commit_fn,
        capacity_fns=capacity_fns, initial_batch=(feasible0, scores0),
        sub_batch_fn=sub_batch_fn, straggler_cap=PROFILE_STRAGGLER_CAP,
        collect_stats=collect_stats,
    )
    assignment, wait = finalize_assignment(out[0], snap)
    if collect_stats:
        return assignment, admitted, wait, out[3]
    return assignment, admitted, wait


def score_drift_vs_sequential(scheduler, snap, seq_assignment,
                              bat_assignment, *, device=None):
    """Relative drift of the batched placements' score sum from the
    sequential solve's on the shared cycle-initial objective
    (`profile_initial_scores`), unplaced rows (-1) excluded: the JAX
    `score_drift_vs_sequential` (parallel/solver.py:1072). Returns
    (drift, placed_seq, placed_bat)."""
    import numpy as np

    scores = profile_initial_scores(scheduler, snap,
                                    device=device)[0].cpu().numpy()
    seq = np.asarray(seq_assignment)
    bat = np.asarray(bat_assignment)

    def score_sum(a):
        placed = a >= 0
        return int(scores[np.nonzero(placed)[0], a[placed]].sum())

    s_seq, s_bat = score_sum(seq), score_sum(bat)
    drift = (s_bat - s_seq) / max(abs(s_seq), 1)
    return drift, int((seq >= 0).sum()), int((bat >= 0).sum())
