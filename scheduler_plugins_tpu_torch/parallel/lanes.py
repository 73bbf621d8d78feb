"""Optimistic-concurrency K-lane solve: speculate in parallel, commit
through one conflict fence (port of `scheduler_plugins_tpu.parallel.lanes`).

The reference runs as a second scheduler beside kube-scheduler against
shared cluster state: several actors solve optimistically and the
apiserver's bind serializes them. This module reproduces that model inside
one process, against one snapshot:

1. **Partition** (`partition_segments`): the sorted pending queue groups
   into SEGMENTS by a deterministic key (the PodGroup full name for gang
   members, so a gang never splits across lanes; else the namespace, or
   the pod's admission serial in "hash" mode), and the segments pack onto
   K lanes by deterministic LPT. Each lane keeps its pods' global queue
   positions, so every lane is an order-preserving subsequence of the
   serial order.
2. **Speculate** (`lane_solve`): every lane runs the sequential solve's
   one step body (`framework.runtime._solve_step`) over ITS pods against
   the same cycle-initial state. Under `dispatch="fused"` the K lanes run
   as one program over a leading lane axis (`torch.func.vmap` of the step
   loop): a cycle of P pods takes about P / K steps, each about as many
   device calls as one serial step. "threads" and "sequential" run the
   same program K times at (1, L_j), on worker threads or one after
   another with each lane's wall time recorded.
3. **Fence** (`lane_screen` + `_fence_refine`): pods commit in the
   DEFINED SERIAL ORDER, the order the sequential solve commits. A
   monotone screen over the snapshot's device columns proves most pods
   order-independent wholesale; the (usually empty) remainder is
   re-checked exactly, in order, on host int64 twins of the device math.
   The first pod whose step would diverge triggers ONE re-solve of the
   whole suffix against the committed state through the same program, so
   the result equals the serial solve's at every K.

Why the fence is exact: under the fence-exact gate (`fence_exact`) no
profile Filter is live and no Score reads the carried state, so a pod's
step is a function of its admit verdicts and its built-in fit mask, the
step SIGNATURE. Commits move the carries monotonically (`free` only
shrinks, `eq_used` and `gang_inflight` only grow), and the two states a
pod is compared under lie between the cycle-initial and the all-lanes-
final carries, so a signature component that agrees at those two
extremes, restricted to nodes and tables other lanes touched, is constant
between them (`lane_screen`); only flagged pods pay the exact per-pod
twins (`_fence_refine`).

The JAX package compiles the lane program, the screens and the repair
once per shape and pads the lane axis to half-octave buckets
(`_bucket`) so a new queue length seldom recompiles. Eager PyTorch
compiles nothing: "fused" pads to the longest lane, "sequential" and
"threads" run each lane at its own length, the repair at the suffix's,
and the screens take the segment table at its own size. On the card a
padded step costs as many launches as a real one.
"""

from __future__ import annotations

import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import (
    finish_fetch,
    resolve_device,
    start_fetch,
    to_device,
)
from scheduler_plugins_tpu_torch.framework.plugin import Plugin, SolverState
from scheduler_plugins_tpu_torch.framework.runtime import _Hoisted, _solve_step
from scheduler_plugins_tpu_torch.ops.fit import pod_fit_demand
from scheduler_plugins_tpu_torch.state.snapshot import PodState
from scheduler_plugins_tpu_torch.tuning.gates import pod_fit_demand_np
from scheduler_plugins_tpu_torch.utils import observability as obs

#: lane partition modes: gang members ALWAYS key on their PodGroup full
#: name (quorum accounting is per-gang state: a gang split across lanes
#: would let two lanes each count a partial quorum); other pods key on
#: the namespace (tenant traffic is naturally disjoint) or on the
#: admission serial (a uniform spray, for single-tenant rosters)
PARTITION_MODES = ("namespace", "hash")

#: lane solver dispatch: "fused" = one program over a leading lane axis;
#: "threads" = K calls of the (1, L_j) program, K - 1 of them on named
#: worker threads ("spt-lane-w*"); "sequential" = the same K calls one
#: after another on the caller thread, each lane's wall time recorded in
#: `LaneStats.lane_ms` (the per-lane critical-path attribution mode)
DISPATCH_MODES = ("fused", "threads", "sequential")


def lane_key(pod, cluster, mode: str = "namespace") -> str:
    """The deterministic partition key for one pending pod."""
    pg = cluster.pod_group_of(pod) if cluster is not None else None
    if pg is not None:
        return "gang:" + pg.full_name
    if mode == "namespace":
        return "ns:" + pod.namespace
    serial = cluster.admission_serial(pod.uid) if cluster is not None else -1
    return "serial:%d" % serial


def lane_of(key: str, k: int) -> int:
    """Stable key -> lane hash (blake2b, not `hash()`: PYTHONHASHSEED must
    never affect it). `partition_segments` packs segments by balanced LPT
    rather than this modulo; the hash stays the run-independent spray an
    external sharder (a per-scheduler watch filter) would use."""
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % k


def partition_segments(pending, cluster, k: int, mode: str = "namespace",
                       key_cache: dict | None = None):
    """(lanes, seg_of_pod, lane_of_seg, seg_keys, fresh): the K lane index
    lists (each ascending) plus the partition-key segmentation beneath
    them. Pods with one key share a segment, and every segment lives
    wholly inside one lane; segment ids are first-seen ordered.

    Segments pack onto lanes by deterministic LPT (longest first, ties by
    first-seen order, each to the least-loaded lane, ties to the lowest
    index): the fence makes lane membership semantically irrelevant, so
    the partition is free to chase balance.

    `key_cache` (optional, caller-owned uid -> key) memoizes the per-pod
    key across cycles. A pod carrying a pod-group label whose PodGroup is
    not registered yet is never cached: its key must flip to `gang:` the
    moment the group appears. `fresh` lists the positions that missed the
    cache (all positions without one)."""
    if mode not in PARTITION_MODES:
        raise ValueError(
            f"unknown lane partition mode {mode!r}; expected one of "
            f"{PARTITION_MODES}"
        )
    n = len(pending)
    seg_ids: dict = {}
    seg_list: list = []
    seg_keys: list = []
    fresh: list = []
    cache_get = key_cache.get if key_cache is not None else None
    seg_get = seg_ids.get
    append = seg_list.append
    for i, pod in enumerate(pending):
        key = cache_get(pod.uid) if cache_get is not None else None
        if key is None:
            key = lane_key(pod, cluster, mode)
            if key_cache is not None and (
                key.startswith("gang:") or not pod.pod_group()
            ):
                key_cache[pod.uid] = key
            fresh.append(i)
        s = seg_get(key)
        if s is None:
            s = seg_ids[key] = len(seg_keys)
            seg_keys.append(key)
        append(s)
    S = len(seg_keys)
    seg_of_pod = (
        np.asarray(seg_list, np.int32) if n else np.zeros(0, np.int32)
    )
    lane_of_seg = np.zeros(max(1, S), np.int32)
    if k > 1 and S:
        sizes = np.bincount(seg_of_pod, minlength=S)
        load = [0] * k
        for s in np.argsort(-sizes, kind="stable"):
            j = min(range(k), key=load.__getitem__)
            lane_of_seg[s] = j
            load[j] += int(sizes[s])
    lane_of_pod = lane_of_seg[seg_of_pod]
    lanes = [np.flatnonzero(lane_of_pod == j).tolist() for j in range(k)]
    return lanes, seg_of_pod, lane_of_seg, seg_keys, fresh


def partition_lanes(pending, cluster, k: int, mode: str = "namespace"):
    """K lists of global queue positions, each ascending."""
    return partition_segments(pending, cluster, k, mode)[0]


def fence_exact(scheduler, snap):
    """(ok, reason): whether the conflict fence's host validation is EXACT
    for this profile and snapshot. Outside the gate the laned path falls
    back to the sequential parity solve, never to a weaker fence:

    - side tables that arm profile Filters or state-dependent commits
      (scheduling / network / NUMA) break the "step is a function of
      (admit, fit)" argument;
    - preemption nominees make the built-in fit read nominee holds keyed
      on `placed_mask`, cross-lane state the fence does not carry;
    - an admit plugin without a host twin here cannot be validated.

    The quota nominee check reads three flags from the snapshot's device
    in one host copy."""
    if snap.scheduling is not None:
        return False, "scheduling"
    if snap.network is not None:
        return False, "network"
    if snap.numa is not None:
        return False, "numa"
    if snap.nominees is not None:
        return False, "nominees"
    if snap.quota is not None:
        # the nominee axis is padded to M >= 1; only LIVE rows (a nonzero
        # request or a set contribution mask) couple the quota admit to
        # the cross-lane placed_mask carry
        q = snap.quota
        live = torch.stack([
            q.nom_req.any(), q.nom_in_eq_mask.any(), q.nom_total_mask.any()
        ])
        if live.any().item():
            return False, "quota_nominees"
    from scheduler_plugins_tpu_torch.plugins import (
        CapacityScheduling,
        Coscheduling,
    )

    for p in scheduler.profile.plugins:
        if type(p).admit is Plugin.admit:
            continue
        if not isinstance(p, (Coscheduling, CapacityScheduling)):
            return False, f"admit:{p.name}"
    return True, None


# ---------------------------------------------------------------------------
# The lane program
# ---------------------------------------------------------------------------


def lane_solve(plugins, snap, state0: SolverState, auxes, idx, live):
    """The speculative lane solve: the sequential solve's step body over a
    leading lane axis. `idx` and `live` are (K, L) device tensors (the
    lanes' queue positions, and which slots hold a pod); returns (K, L)
    int32 choice, bool admitted and int32 fail code.

    Each lane's pod rows are gathered ONCE into (K, L) columns with `live`
    folded into `mask`, so a padded slot is a masked pod: a no-op carry
    emitting the (-1, False, 0) the serial solve gives padded rows. The
    plugins' presolves are bound from the FULL snapshot; then L steps of
    `_solve_step` run on a one-pod view (`p = 0`) under `torch.func.vmap`
    over the lanes, the carry a dict of the live `SolverState` fields
    (None fields stay out) shared by every lane at the start. One copy of
    the step body, shared with `Scheduler.solve`, so a lane cannot drift
    from the serial scan. The same program repairs a conflict at (1, L')
    from the committed state.

    Exactness of the one-pod view rests on the fence-exact gate: every
    table a plugin indexes by a pod axis lives in `snap.pods` (gathered
    here) or is pinned off. `SolverState.placed_mask` is written at the
    view-local index but never read under the gate."""
    for plugin, aux in zip(plugins, auxes):
        plugin.bind_aux(aux)
    for plugin in plugins:
        plugin.bind_presolve(plugin.prepare_solve(snap))
    rows = {f.name: getattr(snap.pods, f.name)[idx] for f in fields(PodState)}
    rows["mask"] = rows["mask"] & live
    carry = {f.name: getattr(state0, f.name) for f in fields(SolverState)
             if getattr(state0, f.name) is not None}
    node_index = torch.arange(snap.num_nodes, device=snap.device)
    steps = idx.shape[1]

    def lane(lane_rows, carry):
        state = SolverState(**carry)
        outs = []
        for t in range(steps):
            pods = PodState(**{name: col[t:t + 1]
                               for name, col in lane_rows.items()})
            hoisted = _Hoisted(ok0=pods.mask & ~pods.gated,
                               node_index=node_index)
            state, out = _solve_step(plugins, state, 0,
                                     snap.replace(pods=pods), hoisted)
            outs.append(out)
        return tuple(torch.cat(col) for col in zip(*outs))

    return torch.func.vmap(lane, in_dims=(0, None))(rows, carry)


# ---------------------------------------------------------------------------
# The conflict fence: the screen, then host twins of the admit/commit math
# ---------------------------------------------------------------------------


def _lane_deficits(req, free0, assignment, lane_of_pod, k: int):
    """Shared screen prelude: per-lane speculative node deficits and the
    two state extremes. Sums ride float64 through `index_add_` (exact
    below 2^53 in any order of the atomics); compares stay exact because
    every quantity is an integer-valued float64."""
    f64 = torch.float64
    demand = pod_fit_demand(req)
    placed = assignment >= 0
    choice = torch.clamp(assignment, min=0).long()
    free0f = free0.to(f64)
    N, R = free0f.shape
    demf = demand.to(f64)
    w = demf * placed[:, None]
    flat = lane_of_pod.long() * N + choice
    lanedef = torch.zeros(k * N, R, dtype=f64, device=req.device)
    lanedef.index_add_(0, flat, w)
    lanedef = lanedef.reshape(k, N, R)
    alldef = lanedef.sum(dim=0)
    othersdef = alldef[None] - lanedef
    free_fin = free0f - alldef
    return demf, placed, free0f, free_fin, othersdef, alldef


def _segment_sum(values, segments, num: int):
    """`jax.ops.segment_sum` over the leading axis: float64 `index_add_`."""
    out = torch.zeros((num,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, segments.long(), values)


def lane_screen(k: int, core, quota, gang_args):
    """Fence stage 1, the vectorized monotone screen over the snapshot's
    device columns: per-lane speculative deficits -> the two state
    extremes (cycle-initial, all-lanes-final) -> a pod is flagged iff some
    signature component (fit row, quota admit, gang min-res admit)
    disagrees between the extremes, restricted to nodes and tables OTHER
    lanes touched.

    The built-in fit component runs at SEGMENT grain here: `fit_unsafe`
    is False when, for every (segment, node) pair, one of three sufficient
    conditions pins every segment pod's fit bit:

    - no OTHER lane committed onto the node;
    - the segment's axiswise MAX demand fits the node's final free;
    - the segment's axiswise MIN demand exceeds the node's initial free on
      some axis (a foreign zone's extended-resource column is 0).

    The (S, R) demand extremes (`seg_mx` / `seg_mn`) come in from the host
    (`LaneSolver._segment_extremes`), a conservative superset of the live
    pods. The per-pod fit screen (`lane_screen_fit`) runs only when
    `fit_unsafe` is True.

    Args are three flat tuples (`core`, `quota`, `gang_args`; the latter
    two empty when the branch is off). Returns (fit_unsafe 0-d bool,
    flagged (P,) bool, the quota | gang component over live pods)."""
    (req, pod_mask, gated, free0, node_mask, assignment,
     lane_of_pod, seg_mx, seg_mn, lane_of_seg) = core
    f64 = torch.float64
    ok0 = pod_mask & ~gated
    demf, placed, free0f, free_fin, othersdef, alldef = _lane_deficits(
        req, free0, assignment, lane_of_pod, k
    )

    # segment-level fit certificates (see the docstring)
    touched = (othersdef > 0).any(dim=2)  # (K, N)
    max_fits = (seg_mx[:, None, :] <= free_fin[None]).all(dim=2)
    min_fails = (seg_mn[:, None, :] > free0f[None]).any(dim=2)
    fit_unsafe = (
        touched[lane_of_seg.long()] & ~max_fits & ~min_fails
        & node_mask[None]
    ).any()

    flagged = torch.zeros(assignment.shape[0], dtype=torch.bool,
                          device=req.device)
    if quota:
        ns, qm, q_min, q_max, eq_used0 = quota
        ns = ns.long()
        reqf = req.to(f64)
        hasq = qm[ns]
        contrib = placed & hasq
        eq0 = eq_used0.to(f64)
        eq_fin = eq0 + _segment_sum(reqf * contrib[:, None], ns,
                                    eq0.shape[0])
        eq_min = q_min.to(f64)
        eq_max = q_max.to(f64)
        agg_min = (eq_min * qm[:, None]).sum(dim=0)
        agg_hi = (eq0 * qm[:, None]).sum(dim=0)
        agg_lo = (eq_fin * qm[:, None]).sum(dim=0)
        pass_hi = (
            ~(eq0[ns] + reqf > eq_max[ns]).any(dim=1)
            & ~(agg_hi[None] + reqf > agg_min[None]).any(dim=1)
        )
        pass_lo = (
            ~(eq_fin[ns] + reqf > eq_max[ns]).any(dim=1)
            & ~(agg_lo[None] + reqf > agg_min[None]).any(dim=1)
        )
        lane_q = _segment_sum(contrib.to(f64), lane_of_pod, k)
        others_q = lane_q.sum() - lane_q
        flagged = flagged | (
            hasq & (others_q[lane_of_pod.long()] > 0) & (pass_hi != pass_lo)
        )

    if gang_args:
        gang, g_slack, g_min_res, g_has_min_res, infl_used0 = gang_args
        g = torch.clamp(gang, min=0).long()
        total0 = free0f.sum(dim=0)
        total_fin = total0 - alldef.sum(dim=0)
        infl0 = infl_used0.to(f64)
        ing = placed & (gang >= 0)
        infl_fin = infl0 + _segment_sum(demf * ing[:, None], g,
                                        infl0.shape[0])
        lane_n = _segment_sum(placed.to(f64), lane_of_pod, k)
        others_n = lane_n.sum() - lane_n
        slack = g_slack.to(f64)
        min_res = g_min_res.to(f64)
        cap_hi = total0[None] + slack[g] + infl0[g]
        cap_lo = total_fin[None] + slack[g] + infl_fin[g]
        pass_hi = (min_res[g] <= cap_hi).all(dim=1)
        pass_lo = (min_res[g] <= cap_lo).all(dim=1)
        flagged = flagged | (
            (gang >= 0) & g_has_min_res[g]
            & (others_n[lane_of_pod.long()] > 0) & (pass_hi != pass_lo)
        )

    # dead pods (masked / gated) decide (-1, False, 0) under ANY state
    return fit_unsafe, flagged & ok0


def lane_screen_fit(k: int, req, pod_mask, gated, free0, node_mask,
                    assignment, lane_of_pod):
    """The per-pod fit screen, the O(P·N·R) refinement of the segment
    certificate: a pod is flagged iff its fit bit flips between the
    extremes on a live node some OTHER lane committed onto."""
    ok0 = pod_mask & ~gated
    demf, _, free0f, free_fin, othersdef, _ = _lane_deficits(
        req, free0, assignment, lane_of_pod, k
    )
    fits_hi = (demf[:, None, :] <= free0f[None]).all(dim=2)
    fits_lo = (demf[:, None, :] <= free_fin[None]).all(dim=2)
    flipable = (othersdef > 0).any(dim=2)  # (K, N)
    flagged = (
        (fits_hi & ~fits_lo) & flipable[lane_of_pod.long()] & node_mask[None]
    ).any(dim=1)
    return flagged & ok0


@dataclass
class _FenceState:
    """One actor's view of the in-cycle carried state, on host int64: the
    committed truth, or one lane's speculative mirror. Mutations mirror
    `_solve_step`'s commits bit-exactly (int64 adds)."""

    free: np.ndarray  # (N, R)
    total_free: np.ndarray  # (R,) raw per-node sum, negatives included
    eq_used: np.ndarray | None  # (Q, R)
    gang_inflight: np.ndarray | None  # (G, R)

    def clone(self) -> "_FenceState":
        return _FenceState(
            self.free.copy(), self.total_free.copy(),
            None if self.eq_used is None else self.eq_used.copy(),
            None if self.gang_inflight is None else self.gang_inflight.copy(),
        )

    def commit(self, t: "_FenceTables", p: int, choice: int) -> None:
        if choice < 0:
            return  # failed pods mutate nothing
        d = t.demand[p]
        self.free[choice] -= d
        self.total_free -= d
        if self.eq_used is not None and t.has_quota[t.ns[p]]:
            self.eq_used[t.ns[p]] += t.req[p]
        g = t.gang[p]
        if self.gang_inflight is not None and g >= 0:
            self.gang_inflight[g] += d


@dataclass
class _FenceTables:
    """Host copies of the static snapshot columns the fence reads."""

    req: np.ndarray  # (P, R)
    demand: np.ndarray  # (P, R): req with the pods slot forced to 1
    ns: np.ndarray  # (P,)
    gang: np.ndarray  # (P,)
    ok0: np.ndarray  # (P,) mask & ~gated
    node_mask: np.ndarray  # (N,)
    has_quota: np.ndarray | None  # (Q,)
    eq_min: np.ndarray | None  # (Q, R)
    eq_max: np.ndarray | None  # (Q, R)
    g_min_member: np.ndarray | None
    g_total: np.ndarray | None
    g_gated: np.ndarray | None
    g_backed_off: np.ndarray | None
    g_slack: np.ndarray | None  # (G, R)
    g_min_res: np.ndarray | None  # (G, R)
    g_has_min_res: np.ndarray | None
    g_assigned: np.ndarray | None
    #: admit twins in PROFILE ORDER ("gang" | "quota"): verdicts are
    #: compared per plugin, in order, or the attribution could differ
    admit_plugins: list = field(default_factory=list)


def _fence_tables(scheduler, snap) -> _FenceTables:
    """The fence's host tables: one host copy of the columns it reads."""
    from scheduler_plugins_tpu_torch.plugins import (
        CapacityScheduling,
        Coscheduling,
    )

    cols = {
        "req": snap.pods.req, "ns": snap.pods.ns, "gang": snap.pods.gang,
        "mask": snap.pods.mask, "gated": snap.pods.gated,
        "node_mask": snap.nodes.mask,
    }
    if snap.quota is not None:
        cols.update(has_quota=snap.quota.has_quota, eq_min=snap.quota.min,
                    eq_max=snap.quota.max)
    if snap.gangs is not None:
        g = snap.gangs
        cols.update(
            g_min_member=g.min_member, g_total=g.total_members,
            g_gated=g.gated, g_backed_off=g.backed_off,
            g_slack=g.cluster_slack, g_min_res=g.min_resources,
            g_has_min_res=g.has_min_resources, g_assigned=g.assigned,
        )
    h = finish_fetch(start_fetch(cols, snap.device))
    t = _FenceTables(
        req=h["req"], demand=pod_fit_demand_np(h["req"]), ns=h["ns"],
        gang=h["gang"], ok0=h["mask"] & ~h["gated"],
        node_mask=h["node_mask"],
        has_quota=h.get("has_quota"), eq_min=h.get("eq_min"),
        eq_max=h.get("eq_max"), g_min_member=h.get("g_min_member"),
        g_total=h.get("g_total"), g_gated=h.get("g_gated"),
        g_backed_off=h.get("g_backed_off"), g_slack=h.get("g_slack"),
        g_min_res=h.get("g_min_res"), g_has_min_res=h.get("g_has_min_res"),
        g_assigned=h.get("g_assigned"),
    )
    for p in scheduler.profile.plugins:
        if isinstance(p, Coscheduling) and snap.gangs is not None:
            t.admit_plugins.append("gang")
        elif isinstance(p, CapacityScheduling) and snap.quota is not None:
            t.admit_plugins.append("quota")
    return t


def _gang_admit_np(t: _FenceTables, s: _FenceState, p: int) -> bool:
    """Numpy twin of `ops.gang.gang_admit` (gang_scheduled plays no role
    in admission; it feeds only the post-loop quorum reduction)."""
    g = int(t.gang[p])
    if g < 0:
        return True
    if t.g_total[g] < t.g_min_member[g]:
        return False
    if t.g_backed_off[g]:
        return False
    if t.g_total[g] - t.g_gated[g] < t.g_min_member[g]:
        return False
    if not t.g_has_min_res[g]:
        return True
    capacity = s.total_free + t.g_slack[g]
    if s.gang_inflight is not None:
        capacity = capacity + s.gang_inflight[g]
    return bool(np.all(t.g_min_res[g] <= capacity))


def _quota_admit_np(t: _FenceTables, s: _FenceState, p: int) -> bool:
    """Numpy twin of `ops.quota.quota_admit` with empty nominee aggregates
    (the fence-exact gate pins the nominee rows inert)."""
    ns = int(t.ns[p])
    if not t.has_quota[ns]:
        return True
    req = t.req[p]
    if np.any(s.eq_used[ns] + req > t.eq_max[ns]):
        return False
    agg_used = s.eq_used[t.has_quota].sum(axis=0)
    agg_min = t.eq_min[t.has_quota].sum(axis=0)
    return not np.any(agg_used + req > agg_min)


def _step_signature(t: _FenceTables, s: _FenceState, p: int):
    """Everything pod p's step depends on through the carried state under
    the fence-exact gate: the per-plugin admit verdicts (profile order)
    and the built-in fit mask. Two states with equal signatures replay the
    step identically."""
    verdicts = []
    for kind in t.admit_plugins:
        if kind == "gang":
            verdicts.append(_gang_admit_np(t, s, p))
        else:
            verdicts.append(_quota_admit_np(t, s, p))
    fit = np.all(t.demand[p] <= s.free, axis=1) & t.node_mask
    return verdicts, fit


def _fence_refine(t: _FenceTables, free0, eq0, infl0, assignment,
                  lane_of_pod, candidates, k: int):
    """Fence stage 2: exact serial-order validation of the screen's
    candidates. Every pod up to the last candidate replays its int64
    delta commits (the committed truth and each lane's speculative
    mirror); the per-pod signature twins run only at candidates. Returns
    (conflict_at, committed state at the conflict), or (-1, None) when
    every candidate validates."""
    committed = _FenceState(
        free=free0.copy(), total_free=free0.sum(axis=0),
        eq_used=None if eq0 is None else eq0.copy(),
        gang_inflight=None if infl0 is None else infl0.copy(),
    )
    lane_states = [committed.clone() for _ in range(k)]
    cand = {int(c) for c in candidates}
    for p in range(max(cand) + 1):
        j = int(lane_of_pod[p])
        mine = lane_states[j]
        if p in cand:
            sig_lane = _step_signature(t, mine, p)
            sig_comm = _step_signature(t, committed, p)
            if sig_lane[0] != sig_comm[0] or not np.array_equal(
                sig_lane[1], sig_comm[1]
            ):
                return p, committed
        choice = int(assignment[p])
        committed.commit(t, p, choice)
        mine.commit(t, p, choice)
    return -1, None


# ---------------------------------------------------------------------------
# The orchestrator
# ---------------------------------------------------------------------------


@dataclass
class LaneStats:
    """One cycle's lane attribution (rides `CycleReport.lanes`)."""

    k: int
    path: str  # "laned" | "serial"
    sizes: list = field(default_factory=list)
    #: verbatim-committed pods per lane
    committed: list = field(default_factory=list)
    #: fence conflicts per lane (the lane whose pod first failed
    #: validation; at most one a cycle: the repair covers the rest)
    conflicts: list = field(default_factory=list)
    #: pods re-resolved against committed state by the repair solve
    re_resolved: int = 0
    serial_fallback_reason: str | None = None
    solve_ms: float = 0.0
    fence_ms: float = 0.0
    #: partition and segment-stat upkeep wall (ms), inside solve_ms
    partition_ms: float = 0.0
    #: per-lane dispatch wall (ms), the lane's host copy included (so the
    #: card has finished it): "sequential" times each lane alone on the
    #: caller thread; "threads" records the same spans, overlapping; empty
    #: under "fused" (one program, no per-lane boundary)
    lane_ms: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "k": self.k,
            "path": self.path,
            "sizes": list(self.sizes),
            "committed": list(self.committed),
            "conflicts": list(self.conflicts),
            "re_resolved": self.re_resolved,
            "serial_fallback_reason": self.serial_fallback_reason,
            "solve_ms": round(self.solve_ms, 3),
            "fence_ms": round(self.fence_ms, 3),
            "partition_ms": round(self.partition_ms, 3),
            "lane_ms": [round(m, 3) for m in self.lane_ms],
        }


class LaneSolver:
    """K speculative solver lanes over one scheduler, committed through
    the single conflict fence, on `device` (None = the CUDA card, raising
    without one). `solve(snap, pending, cluster)` returns (assignment,
    admitted, wait, fail_codes) host arrays equal to `Scheduler.solve`'s
    sequential solve, plus a `LaneStats`."""

    def __init__(self, scheduler, k: int = 4, partition: str = "namespace",
                 dispatch: str = "fused", *, device=None):
        if k < 1:
            raise ValueError(f"lane count must be >= 1, got {k}")
        if dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"unknown lane dispatch mode {dispatch!r}; expected one "
                f"of {DISPATCH_MODES}"
            )
        if partition not in PARTITION_MODES:
            raise ValueError(
                f"unknown lane partition mode {partition!r}; expected "
                f"one of {PARTITION_MODES}"
            )
        self.scheduler = scheduler
        self.k = k
        self.partition = partition
        self.dispatch = dispatch
        self.device = resolve_device(device)
        # cross-cycle partition and screen-input caches (pods persist
        # until placed, so steady-state upkeep is arrivals-only): uid ->
        # partition key, and key -> (axiswise max, axiswise min) float64
        # (R,) demand extremes over every pod EVER folded into the key, a
        # conservative superset of any cycle's live pods. A pod folds
        # exactly when it misses the key cache, so the two caches prune
        # together. Dropped wholesale when the resource axis changes.
        self._key_cache: dict = {}
        self._seg_stats: dict = {}
        self._axis_sig = None
        self._pool = None
        if dispatch == "threads" and k > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=k - 1, thread_name_prefix="spt-lane-w"
            )

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- speculation -----------------------------------------------------
    def _program(self, snap, state0, auxes, idx, live):
        """The lane program on (K', L') host index rows: their device
        copies, the solve, one host copy of the three outputs."""
        plugins = tuple(self.scheduler.profile.plugins)
        out = lane_solve(plugins, snap, state0, auxes,
                         to_device(idx, self.device),
                         to_device(live, self.device))
        return finish_fetch(start_fetch(out, self.device))

    def _dispatch(self, snap, state0, auxes, idx2d, live2d, stats):
        """Runs the lane program and returns PER-LANE output rows: a list
        of (choice, ok, fail) host arrays, one per lane, each at least the
        lane's length."""
        if self.dispatch == "fused" or self.k == 1:
            with obs.tracer.span("Lane/solve", tid="Lane/solve",
                                 k=self.k, bucket=int(idx2d.shape[1])):
                out = self._program(snap, state0, auxes, idx2d, live2d)
                return [tuple(o[j] for o in out) for j in range(self.k)]
        # threads / sequential: K calls of the (1, L_j) program, each lane
        # at its own length. Each call binds the plugins' presolve on its
        # own thread (the per-thread plugin context); lane_ms writes are
        # per-index disjoint.
        stats.lane_ms = [0.0] * self.k
        sizes = live2d.sum(axis=1)

        def one(j):
            t0 = time.perf_counter()
            n = int(sizes[j])
            with obs.tracer.span("Lane/solve", tid=f"Lane/{j}", pods=n,
                                 bucket=n):
                if n:
                    out = self._program(snap, state0, auxes,
                                        idx2d[j:j + 1, :n],
                                        live2d[j:j + 1, :n])
                    out = tuple(o[0] for o in out)
                else:
                    out = (np.zeros(0, np.int32), np.zeros(0, bool),
                           np.zeros(0, np.int32))
            stats.lane_ms[j] = (time.perf_counter() - t0) * 1000.0
            return out

        if self._pool is None:
            return [one(j) for j in range(self.k)]
        futures = [self._pool.submit(one, j) for j in range(1, self.k)]
        first = one(0)
        return [first] + [f.result() for f in futures]

    def _repair(self, snap, auxes, committed: _FenceState, suffix,
                quota_present: bool, gangs_present: bool):
        """Re-solve the whole remaining suffix in ONE call, seeded with the
        committed state: from the first conflict on, this IS the serial
        solve (same step body, same state, same order)."""
        device = self.device
        state = SolverState(
            free=to_device(committed.free, device),
            eq_used=(to_device(committed.eq_used, device)
                     if quota_present else None),
            gang_scheduled=(
                torch.zeros(self._num_gangs(snap), dtype=torch.int32,
                            device=device)
                if gangs_present else None
            ),
            gang_inflight=(to_device(committed.gang_inflight, device)
                           if gangs_present else None),
            placed_mask=(
                torch.zeros(snap.num_pods, dtype=torch.bool, device=device)
                if quota_present else None
            ),
        )
        idx = np.asarray(suffix, np.int64)[None]
        live = np.ones(idx.shape, bool)
        with obs.tracer.span("Lane/repair", tid="Lane/fence",
                             pods=len(suffix)):
            out = self._program(snap, state, auxes, idx, live)
            return tuple(o[0] for o in out)

    @staticmethod
    def _num_gangs(snap) -> int:
        return int(snap.gangs.min_member.shape[0])

    # -- screen inputs ---------------------------------------------------
    def _segment_extremes(self, snap, pending, seg_of_pod, seg_keys,
                          fresh, meta):
        """(S, R) float64 axiswise per-segment demand extremes for the
        screen's fit certificate, accumulated on the host across cycles
        over every pod ever folded into the key (a conservative superset
        of this cycle's live segment pods). A pod folds exactly when it
        misses the partition's key cache (`fresh`), so the (P, R) demand
        is copied to the host only on cycles with arrivals.
        `meta.index.names` fingerprints the resource axis (its length
        without meta): a changed axis drops both caches."""
        R = int(snap.pods.req.shape[1])
        sig = tuple(meta.index.names) if meta is not None else ("R", R)
        if sig != self._axis_sig:
            self._axis_sig = sig
            self._key_cache.clear()
            self._seg_stats.clear()
            fresh = range(len(pending))
        stats = self._seg_stats
        dem = None

        def demand():
            return pod_fit_demand_np(
                finish_fetch(start_fetch(snap.pods.req, snap.device))
            ).astype(np.float64)

        def fold(i, key):
            row = dem[i]
            cur = stats.get(key)
            if cur is None:
                stats[key] = (row.copy(), row.copy())
            else:
                np.maximum(cur[0], row, out=cur[0])
                np.minimum(cur[1], row, out=cur[1])

        if len(fresh):
            dem = demand()
            for i in fresh:
                fold(i, seg_keys[seg_of_pod[i]])
        missing = {
            s for s, key in enumerate(seg_keys) if key not in stats
        }
        if missing:
            # backstop (an externally mutated cache): a key whose pods all
            # hit the uid cache yet has no stats folds every pod of its
            # segment, so the certificate stays sound
            if dem is None:
                dem = demand()
            for i in range(len(pending)):
                s = int(seg_of_pod[i])
                if s in missing:
                    fold(i, seg_keys[s])
        if len(self._key_cache) > 4 * len(pending) + 1024:
            # bound the caches on long-lived solvers: keep live uids and
            # live keys only (a dropped uid re-folds harmlessly)
            live = {p.uid for p in pending}
            self._key_cache = {
                u: key for u, key in self._key_cache.items() if u in live
            }
            keep = set(seg_keys)
            self._seg_stats = {
                key: v for key, v in self._seg_stats.items()
                if key in keep
            }
        S = max(1, len(seg_keys))
        seg_mx = np.full((S, R), -np.inf)
        seg_mn = np.full((S, R), np.inf)
        for s, key in enumerate(seg_keys):
            mx, mn = stats[key]
            seg_mx[s] = mx
            seg_mn[s] = mn
        return seg_mx, seg_mn

    # -- the solve and the fence ----------------------------------------
    def solve(self, snap, pending, cluster, meta=None):
        """Returns (assignment, admitted, wait, fail_codes, stats): host
        arrays over the snapshot's (padded) pod axis, equal to the
        sequential parity solve's, and the cycle's `LaneStats`. Falls back
        to `Scheduler.solve(mode="sequential")` (the parity path itself)
        when K == 1 or the fence-exact gate rejects the profile or the
        snapshot. `meta` (the snapshot's `SnapshotMeta`, optional) lets
        the cross-cycle screen-input cache fingerprint the resource axis.
        The snapshot moves to the solver's device if it lives
        elsewhere."""
        device = self.device
        if snap.device != device:
            snap = snap.to(device)
        stats = LaneStats(k=self.k, path="laned")
        exact, reason = fence_exact(self.scheduler, snap)
        if self.k == 1 or not exact:
            stats.path = "serial"
            stats.serial_fallback_reason = reason if not exact else "k=1"
            if not exact:
                obs.metrics.inc(obs.LANE_SERIAL_FALLBACKS)
            t0 = time.perf_counter()
            result = self.scheduler.solve(snap, device=device,
                                          mode="sequential")
            assignment, admitted, wait, codes = finish_fetch(start_fetch(
                (result.assignment, result.admitted, result.wait,
                 result.failed_plugin), device,
            ))
            stats.solve_ms = (time.perf_counter() - t0) * 1000.0
            return assignment, admitted, wait, codes, stats

        t0 = time.perf_counter()
        lanes, seg_of_pod, lane_of_seg, seg_keys, fresh = (
            partition_segments(
                pending, cluster, self.k, self.partition, self._key_cache
            )
        )
        seg_mx, seg_mn = self._segment_extremes(
            snap, pending, seg_of_pod, seg_keys, fresh, meta
        )
        stats.partition_ms = (time.perf_counter() - t0) * 1000.0
        stats.sizes = [len(lane) for lane in lanes]
        stats.committed = [0] * self.k
        stats.conflicts = [0] * self.k
        P_live = len(pending)
        P = snap.num_pods
        # "fused" pads every lane to the longest one
        width = max(1, max(stats.sizes))
        idx2d = np.zeros((self.k, width), np.int64)
        live2d = np.zeros((self.k, width), bool)
        lane_of_pod = lane_of_seg[seg_of_pod]
        for j, lane in enumerate(lanes):
            idx2d[j, : len(lane)] = lane
            live2d[j, : len(lane)] = True

        state0 = self.scheduler.initial_state(snap)
        auxes = tuple(p.aux() for p in self.scheduler.profile.plugins)
        outs = self._dispatch(snap, state0, auxes, idx2d, live2d, stats)
        stats.solve_ms = (time.perf_counter() - t0) * 1000.0

        # scatter lane outputs back to pod order. Padded snapshot rows
        # (>= P_live) belong to no lane and keep the masked-pod outputs
        # (-1 / False / 0), what the serial solve emits for them
        assignment = np.full(P, -1, np.int32)
        admitted = np.zeros(P, bool)
        codes = np.zeros(P, np.int32)
        for j in range(self.k):
            n = len(lanes[j])
            assignment[idx2d[j, :n]] = outs[j][0][:n]
            admitted[idx2d[j, :n]] = outs[j][1][:n]
            codes[idx2d[j, :n]] = outs[j][2][:n]

        # the conflict fence: the monotone screen (one host read), then
        # the exact serial-order refine over its (usually empty)
        # candidate set. The host fence tables are built only when there
        # are candidates
        t0 = time.perf_counter()
        from scheduler_plugins_tpu_torch.plugins import (
            CapacityScheduling,
            Coscheduling,
        )

        quota_on = snap.quota is not None and any(
            isinstance(p, CapacityScheduling)
            for p in self.scheduler.profile.plugins
        )
        gang_on = snap.gangs is not None and any(
            isinstance(p, Coscheduling)
            for p in self.scheduler.profile.plugins
        )
        lane_full = np.zeros(P, np.int32)
        lane_full[:P_live] = lane_of_pod
        seg_lanes = np.zeros(seg_mx.shape[0], np.int32)
        seg_lanes[: lane_of_seg.shape[0]] = lane_of_seg
        conflict_at, committed = -1, None
        gang_col = None
        with obs.tracer.span("Lane/fence", tid="Lane/fence", pods=P_live):
            assign_dev = to_device(assignment, device)
            lane_dev = to_device(lane_full, device)
            core = (
                snap.pods.req, snap.pods.mask, snap.pods.gated,
                state0.free, snap.nodes.mask, assign_dev, lane_dev,
                to_device(seg_mx, device), to_device(seg_mn, device),
                to_device(seg_lanes, device),
            )
            quota_args = (
                (snap.pods.ns, snap.quota.has_quota, snap.quota.min,
                 snap.quota.max, state0.eq_used)
                if quota_on else ()
            )
            gang_args = (
                (snap.pods.gang, snap.gangs.cluster_slack,
                 snap.gangs.min_resources,
                 snap.gangs.has_min_resources, state0.gang_inflight)
                if gang_on else ()
            )
            fit_unsafe, flagged = finish_fetch(start_fetch(
                lane_screen(self.k, core, quota_args, gang_args), device
            ))
            if bool(fit_unsafe):
                flagged = flagged | finish_fetch(start_fetch(
                    lane_screen_fit(
                        self.k, snap.pods.req, snap.pods.mask,
                        snap.pods.gated, state0.free, snap.nodes.mask,
                        assign_dev, lane_dev,
                    ), device,
                ))
            candidates = np.flatnonzero(flagged[:P_live])
            if candidates.size:
                tables = _fence_tables(self.scheduler, snap)
                gang_col = tables.gang
                free0, eq0, infl0 = finish_fetch(start_fetch(
                    (state0.free, state0.eq_used, state0.gang_inflight),
                    device,
                ))
                conflict_at, committed = _fence_refine(
                    tables, free0, eq0, infl0, assignment, lane_of_pod,
                    candidates, self.k,
                )
        if conflict_at >= 0:
            j = int(lane_of_pod[conflict_at])
            stats.conflicts[j] += 1
            obs.metrics.inc(obs.LANE_CONFLICTS, lane=str(j))
            stats.committed = [
                int(c) for c in
                np.bincount(lane_of_pod[:conflict_at], minlength=self.k)
            ]
            suffix = list(range(conflict_at, P_live))
            stats.re_resolved = len(suffix)
            obs.metrics.inc(obs.LANE_RERESOLVES, len(suffix))
            r_choice, r_ok, r_fail = self._repair(
                snap, auxes, committed, suffix,
                quota_present=snap.quota is not None,
                gangs_present=snap.gangs is not None,
            )
            assignment[suffix] = r_choice
            admitted[suffix] = r_ok
            codes[suffix] = r_fail
        else:
            stats.committed = list(stats.sizes)

        # Permit quorum, after the solve (`sequential_solve_body`'s
        # reduction), recomputed from the FINAL assignment: the per-gang
        # placement counts are the gang_commit tallies the loop carries
        wait = np.zeros(P, bool)
        if snap.gangs is not None:
            gang, g_assigned, g_min_member = finish_fetch(start_fetch(
                (snap.pods.gang if gang_col is None else None,
                 snap.gangs.assigned, snap.gangs.min_member), device,
            ))
            if gang_col is not None:
                gang = gang_col
            placed_in_gang = (assignment >= 0) & (gang >= 0)
            sched = np.bincount(
                gang[placed_in_gang], minlength=self._num_gangs(snap)
            )
            quorum = (g_assigned + sched) >= g_min_member
            in_gang = gang >= 0
            pod_quorum = np.where(in_gang, quorum[np.maximum(gang, 0)], True)
            wait = (assignment >= 0) & ~pod_quorum
        stats.fence_ms = (time.perf_counter() - t0) * 1000.0
        obs.metrics.observe_ms(obs.LANE_COMMIT, stats.fence_ms)
        for j in range(self.k):
            with obs.tracer.span("Lane/commit", tid=f"Lane/{j}",
                                 committed=stats.committed[j],
                                 conflicts=stats.conflicts[j]):
                pass
        return assignment, admitted, wait, codes, stats
