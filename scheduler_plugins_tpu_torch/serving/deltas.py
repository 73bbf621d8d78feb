"""The delta taxonomy and the O(changed) scatter-add apply (port of
`scheduler_plugins_tpu.serving.deltas`).

The serving engine (`serving.engine.ServeEngine`) keeps the snapshot's
node columns resident on the device across cycles. The store's mutators
push typed events into a `DeltaSink` (installed as `Cluster.delta_sink`);
once a cycle the engine drains them, coalesces them into two packed
groups, and folds them into the resident columns with scatter-adds, so a
cycle costs O(changed), not O(cluster).

- `NodeUpserts` (Node/Add, Node/Update): row overwrites of the static node
  columns (alloc, capacity, mask, region, zone), applied as an add of
  `new - current` under the valid mask, so pad rows add nothing. The host
  coalesces to one upsert a slot a batch, which makes the add exact.
- `UsageDeltas` (a pod assigned, unassigned or turning terminating):
  signed contributions to the usage columns (requested,
  nonzero_requested, limits, pod_count, terminating), the per-pod sums
  `state.snapshot.build_snapshot` accumulates. A slot may repeat; the
  adds sum.
- Node/Delete, a region or zone change and an extended resource rebuild
  from a full snapshot instead (`api.events.SERVE_REBASE_EVENTS`), except
  under `StreamingServeEngine`, which compacts a deleted node's row out
  with `compact_node_rows`.

There is no jit and no donation: `apply_node_deltas` and
`apply_side_deltas` add in place into the resident tensors they are given
(`index_add_`, exact for integers in any order) and return the carry,
which the engine rebinds. The packed batches reach the card through
pinned memory with `non_blocking=True` (`stage`), so an apply reads
nothing on the host.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import PODS, ResourceIndex
from scheduler_plugins_tpu_torch.resilience import faults as _faults
from scheduler_plugins_tpu_torch.state.snapshot import (
    NodeState,
    nonzero_request,
)
from scheduler_plugins_tpu_torch.utils import sanitize
from scheduler_plugins_tpu_torch.utils.intmath import bucket_size

#: serve mode pins the resource axis to the canonical four; a pod or node
#: naming an extended resource disengages the engine until a rebase
CANON_INDEX = ResourceIndex(())
PODS_I = CANON_INDEX.position(PODS)

I64 = np.int64
I32 = np.int32

#: shared zero vector for events without a resource payload (terminating
#: flips); read-only
ZERO_R = np.zeros(len(CANON_INDEX), I64)
ZERO_R.setflags(write=False)


class UnsupportedResource(ValueError):
    """An object names a resource outside the canonical axis: the packed
    delta vectors cannot carry it (serve falls back or rebuilds)."""


def _encode(quantities: dict) -> np.ndarray:
    try:
        return CANON_INDEX.encode(quantities)
    except KeyError as exc:
        raise UnsupportedResource(str(exc)) from exc


def pod_quota_vector(pod) -> np.ndarray:
    """One assigned pod's contribution to its namespace's ElasticQuota
    `used` row: the raw effective-request encode (`build_snapshot` sums
    it verbatim, no pods slot)."""
    return _encode(pod.effective_request())


def pod_usage_vectors(pod) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(requested, nonzero_requested, limits) contribution of one assigned
    pod to its node's usage columns, as `build_snapshot` accumulates them:
    the non-zero defaults applied, limits clamped to at least the requests
    (SetMaxLimits), and the requested and non-zero pods slots carrying the
    count contribution 1 (the snapshot writes pod_count there). Raises
    `UnsupportedResource` on an extended resource."""
    req = _encode(pod.effective_request())
    nz = nonzero_request(req, CANON_INDEX)
    lim = np.maximum(_encode(pod.effective_limits()), req)
    req = req.copy()
    req[PODS_I] = 1
    nz[PODS_I] = 1
    return req, nz, lim


# ---------------------------------------------------------------------------
# the delta sink: the store's mutation hooks push typed events here
# ---------------------------------------------------------------------------

# event tuples: (kind, payload...). Pod objects are kept by reference and
# their resource vectors derived at drain time (an upsert replaces the
# object, so a reference's requests are stable), but the terminating flag
# is taken at event time: `mark_terminating` flips the live pod in place
# AND queues its own delta, so a drain-time read would count a flip twice
# when it lands in the same window as the pod's assign
NODE_UPSERT = "node_upsert"
NODE_DELETE = "node_delete"
POD_ASSIGN = "pod_assign"
POD_UNASSIGN = "pod_unassign"
POD_TERMINATING = "pod_terminating"
#: an unbound, scheduling-gated gang member appeared (+1) or left that
#: state (-1): the full snapshot counts such pods into the gang's gated
#: and total counts, and no node-column event fires for them
GANG_GATED = "gang_gated"


class DeltaSink:
    """Typed event queue installed as `Cluster.delta_sink`: the store's
    mutators push the transitions that change node columns, and `drain()`
    hands the batch to the engine once a cycle. One list append a
    mutation, under a lock: the pipelined engine's flusher thread runs
    mutators while a caller on another thread may drain, and an append
    must land either in the drained batch or in the next one."""

    #: backstop for a sink nobody drains: past this many events the queue
    #: collapses to an `overflowed` mark (the next refresh rebuilds)
    #: instead of pinning Pod references without bound
    MAX_EVENTS = 1 << 18

    def __init__(self):
        self.events: list[tuple] = []
        self.overflowed = False
        #: drain generation, bumped by every `drain()`: the pipelined
        #: engine compares it around a bind flush to tell whether the
        #: flush crossed an ingest boundary (a late bind)
        self.drains = 0
        self._lock = threading.Lock()
        #: unbound pods carrying a NominatedNodeName the pending batch
        #: cannot show (scheduling-gated pods arrive through `add_pod`):
        #: any entry keeps `ServeEngine.compatible` False, since the full
        #: snapshot counts them into the nominated column and the nominee
        #: holds, which the resident columns do not carry
        self.nominated_unbound: set[str] = set()

    def _push(self, ev: tuple) -> None:
        if _faults.ACTIVE is not None:
            # fault injection only: drop, duplicate or corrupt this event;
            # the store never sees it, so only the engine's anti-entropy
            # digest can
            for mutated in _faults.mutate_delta(ev):
                self._push_one(mutated)
            return
        self._push_one(ev)

    def _push_one(self, ev: tuple) -> None:
        with self._lock:
            if len(self.events) >= self.MAX_EVENTS:
                self.events.clear()
                self.overflowed = True
            self.events.append(ev)

    # -- node lifecycle --------------------------------------------------
    def node_upsert(self, node) -> None:
        self._push((NODE_UPSERT, node))

    def node_delete(self, name: str) -> None:
        self._push((NODE_DELETE, name))

    # -- pod usage transitions ------------------------------------------
    def pod_assigned(self, pod, node_name: str) -> None:
        """The pod now holds capacity on `node_name`, bound or
        permit-reserved (a reservation counts like a binding in the
        snapshot's assigned view); its terminating flag rides along."""
        self._push((POD_ASSIGN, pod, node_name, bool(pod.terminating)))

    def pod_unassigned(self, pod, node_name: str) -> None:
        self._push((POD_UNASSIGN, pod, node_name, bool(pod.terminating)))

    def pod_terminating(self, pod, node_name: str) -> None:
        """The terminating flag flipped on a held (bound or reserved)
        pod."""
        self._push((POD_TERMINATING, pod, node_name))

    # -- gang side-table transitions ------------------------------------
    def gang_gated(self, gang_full_name: str, delta: int) -> None:
        """An unbound gated member of `gang_full_name` appeared (+1) or
        left (-1); the delta is taken at event time, since the gate and
        terminating flags change in place."""
        self._push((GANG_GATED, gang_full_name, delta))

    # -- sticky compatibility flags -------------------------------------
    def note_nomination(self, pod) -> None:
        """Track or untrack an upserted pod's nomination."""
        if pod.node_name is None and pod.nominated_node_name is not None:
            self.nominated_unbound.add(pod.uid)
        else:
            self.nominated_unbound.discard(pod.uid)

    def forget_nomination(self, uid: str) -> None:
        self.nominated_unbound.discard(uid)

    def drain(self) -> list[tuple]:
        with self._lock:
            events, self.events = self.events, []
            self.drains += 1
        return events

    def consume_overflow(self) -> bool:
        """True once if the queue overflowed since the last drain: the
        surviving events are partial, so the caller must rebuild."""
        with self._lock:
            overflowed, self.overflowed = self.overflowed, False
        return overflowed


# ---------------------------------------------------------------------------
# packed delta batches (bucket-padded host numpy)
# ---------------------------------------------------------------------------


class NodeUpserts:
    """Packed node-row overwrites, one row a slot (host-coalesced), padded
    to a bucket with valid=False rows."""

    __slots__ = ("idx", "valid", "alloc", "capacity", "mask", "region",
                 "zone")

    def __init__(self, idx, valid, alloc, capacity, mask, region, zone):
        self.idx = idx
        self.valid = valid
        self.alloc = alloc
        self.capacity = capacity
        self.mask = mask
        self.region = region
        self.zone = zone

    @classmethod
    def pack(cls, rows: list[tuple], R: int) -> "NodeUpserts":
        """`rows`: [(slot, alloc_vec, cap_vec, schedulable, region_code,
        zone_code)] with unique slots."""
        U = bucket_size(max(len(rows), 1))
        idx = np.zeros(U, I64)
        valid = np.zeros(U, bool)
        alloc = np.zeros((U, R), I64)
        capacity = np.zeros((U, R), I64)
        mask = np.zeros(U, I32)
        region = np.full(U, -1, I32)
        zone = np.full(U, -1, I32)
        for j, (slot, a, c, sched, r, z) in enumerate(rows):
            idx[j] = slot
            valid[j] = True
            alloc[j] = a
            capacity[j] = c
            mask[j] = 1 if sched else 0
            region[j] = r
            zone[j] = z
        return cls(idx, valid, alloc, capacity, mask, region, zone)

    def as_args(self) -> tuple:
        return (self.idx, self.valid, self.alloc, self.capacity, self.mask,
                self.region, self.zone)


class UsageDeltas:
    """Packed signed usage contributions; slots may repeat (the adds sum),
    pad rows are zero."""

    __slots__ = ("idx", "requested", "nonzero", "limits", "pod_count",
                 "terminating")

    #: bucket floor: steady churn wobbles around its Poisson mean, and one
    #: 64-row floor keeps a single shape for typical cycles
    MIN_BUCKET = 64

    def __init__(self, idx, requested, nonzero, limits, pod_count,
                 terminating):
        self.idx = idx
        self.requested = requested
        self.nonzero = nonzero
        self.limits = limits
        self.pod_count = pod_count
        self.terminating = terminating

    @classmethod
    def pack(cls, rows: list[tuple], R: int) -> "UsageDeltas":
        """`rows`: [(slot, req_vec, nz_vec, lim_vec, d_count, d_term)],
        the vectors already carrying the event's sign."""
        K = bucket_size(max(len(rows), 1), minimum=cls.MIN_BUCKET)
        idx = np.zeros(K, I64)
        requested = np.zeros((K, R), I64)
        nonzero = np.zeros((K, R), I64)
        limits = np.zeros((K, R), I64)
        pod_count = np.zeros(K, I32)
        terminating = np.zeros(K, I32)
        for j, (slot, req, nz, lim, d_count, d_term) in enumerate(rows):
            idx[j] = slot
            requested[j] = req
            nonzero[j] = nz
            limits[j] = lim
            pod_count[j] = d_count
            terminating[j] = d_term
        return cls(idx, requested, nonzero, limits, pod_count, terminating)

    def as_args(self) -> tuple:
        return (self.idx, self.requested, self.nonzero, self.limits,
                self.pod_count, self.terminating)


def stage(arrays, device) -> tuple:
    """Host numpy arrays as tensors on `device`. On the card the arrays
    of each dtype go as one pinned buffer in one `non_blocking` copy and
    are split into views there: no host read, one copy a dtype."""
    if device.type != "cuda":
        return tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays)
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.dtype, []).append(i)
    out = [None] * len(arrays)
    for members in groups.values():
        flat = np.concatenate([arrays[i].ravel() for i in members])
        on_card = torch.from_numpy(flat).pin_memory().to(
            device, non_blocking=True)
        start = 0
        for i in members:
            n = arrays[i].size
            out[i] = on_card[start:start + n].view(arrays[i].shape)
            start += n
    return tuple(out)


# ---------------------------------------------------------------------------
# the apply
# ---------------------------------------------------------------------------


@sanitize.checked_call("serve_delta_apply")
def apply_node_deltas(nodes: NodeState,
                      up_idx, up_valid, up_alloc, up_capacity, up_mask,
                      up_region, up_zone,
                      d_idx, d_requested, d_nonzero, d_limits, d_pod_count,
                      d_terminating) -> NodeState:
    """Fold one packed delta batch into the resident `NodeState` columns,
    in place; the caller treats `nodes` as consumed and rebinds the
    result.

    Upserts add `new - current` (gathered first) times the valid mask, so
    pad rows (index 0, invalid) add nothing and the only write is a
    scatter-add. The bool mask goes through int32 arithmetic and comes
    back as a new tensor. Usage deltas are plain scatter-adds of signed
    contributions. The nominated column is zeroed: serve mode owns the
    snapshot only while no nomination exists anywhere
    (`ServeEngine.compatible`). Under `SPT_SANITIZE=1` the call is the
    checked program "serve_delta_apply": a slot outside the resident rows
    is reported and adds nothing."""
    gi = up_idx
    keep = up_valid
    di = d_idx
    check = sanitize.current()
    if check is not None:
        n = nodes.alloc.shape[0]
        gi, ok = check.index(gi, n, "apply_node_deltas upserts")
        keep = keep & ok
        (di, d_requested, d_nonzero, d_limits, d_pod_count,
         d_terminating) = check.rows(
            di, n, "apply_node_deltas usage", d_requested, d_nonzero,
            d_limits, d_pod_count, d_terminating)

    def overwrite(cur, new):
        weight = keep[:, None] if cur.dim() == 2 else keep
        cur.index_add_(0, gi, (new - cur[gi]) * weight)

    overwrite(nodes.alloc, up_alloc)
    overwrite(nodes.capacity, up_capacity)
    overwrite(nodes.region, up_region)
    overwrite(nodes.zone, up_zone)
    mask = nodes.mask.to(torch.int32)
    overwrite(mask, up_mask)
    nodes.nominated.zero_()
    nodes.requested.index_add_(0, di, d_requested)
    nodes.nonzero_requested.index_add_(0, di, d_nonzero)
    nodes.limits.index_add_(0, di, d_limits)
    nodes.pod_count.index_add_(0, di, d_pod_count)
    nodes.terminating.index_add_(0, di, d_terminating)
    return nodes.replace(mask=mask.bool())


@sanitize.checked_call("serve_node_compact")
def compact_node_rows(nodes: NodeState, gather_idx, valid) -> NodeState:
    """Delete node rows: gather the surviving rows into their shifted
    slots (`gather_idx`, (npad,) int64 built on the host) and re-pad the
    freed tail (`valid` False) with the values a fresh `build_snapshot`
    pad row carries (zeros; mask False; region and zone -1), so the
    compacted columns equal a rebuild's byte for byte and the
    anti-entropy digest cannot tell them apart. Row order is kept (a
    shift, never a swap with the last row): the store's dict pop keeps the
    order of the remaining nodes, and score ties break to the lowest
    index. This turns the Node/Delete rebuild into an O(N) gather on the
    device (`StreamingServeEngine`).

    Every column comes back as a NEW tensor (the gathers allocate), so a
    snapshot an earlier cycle still reads keeps its rows; the JAX package
    donates the carry to the same gather instead. Under `SPT_SANITIZE=1`
    the call is the checked program "serve_node_compact": a gather index
    outside the rows is reported and its slot re-padded."""
    check = sanitize.current()
    if check is not None:
        gather_idx, ok = check.index(gather_idx, nodes.alloc.shape[0],
                                     "compact_node_rows")
        valid = valid & ok

    def take(cur, pad=0):
        out = cur.index_select(0, gather_idx)
        keep = valid.view((-1,) + (1,) * (out.dim() - 1))
        return torch.where(keep, out, torch.full_like(out, pad))

    return nodes.replace(
        alloc=take(nodes.alloc),
        capacity=take(nodes.capacity),
        requested=take(nodes.requested),
        nonzero_requested=take(nodes.nonzero_requested),
        limits=take(nodes.limits),
        mask=take(nodes.mask, False),
        region=take(nodes.region, -1),
        zone=take(nodes.zone, -1),
        pod_count=take(nodes.pod_count),
        terminating=take(nodes.terminating),
        # zero while serve mode owns the snapshot (the compatibility gate
        # excludes nominations)
        nominated=torch.zeros_like(nodes.nominated),
    )


# ---------------------------------------------------------------------------
# resident gang/quota side tables
# ---------------------------------------------------------------------------


@dataclass
class SideTables:
    """Device-resident gang and quota aggregates in engine-stable row
    order (first-seen gang / namespace; each cycle's assembly permutes
    host copies into that cycle's interning order). These are the per-pod
    sums a fresh `build_snapshot` loops over every pod for, kept
    O(changed) from the drained deltas by `apply_side_deltas`:

    - gang_assigned (G,) int32 / gang_slack (G, R) int64: bound and
      reserved members and their request sums (pods slot 1) a gang, the
      `GangState.assigned` / `cluster_slack` sums;
    - gang_gated (G,) int32: unbound scheduling-gated members;
    - quota_used (Q, R) int64: each namespace's assigned request sums
      (`QuotaState.used`, raw encodes);
    - ns_assigned (Q,) int32: assigned pods a namespace, read on the host
      to reproduce the fresh snapshot's namespace interning tail.
    """

    gang_assigned: torch.Tensor
    gang_gated: torch.Tensor
    gang_slack: torch.Tensor
    quota_used: torch.Tensor
    ns_assigned: torch.Tensor

    def replace(self, **changes) -> "SideTables":
        return dataclasses.replace(self, **changes)


def zero_side_tables(G: int, Q: int, R: int, device) -> SideTables:
    return SideTables(
        gang_assigned=torch.zeros(G, dtype=torch.int32, device=device),
        gang_gated=torch.zeros(G, dtype=torch.int32, device=device),
        gang_slack=torch.zeros((G, R), dtype=torch.int64, device=device),
        quota_used=torch.zeros((Q, R), dtype=torch.int64, device=device),
        ns_assigned=torch.zeros(Q, dtype=torch.int32, device=device),
    )


class SideDeltas:
    """Packed side-table deltas: gang rows (engine-stable row, d_assigned,
    d_gated, d_slack) and namespace rows (row, d_used, d_count), padded
    with zero rows."""

    __slots__ = ("g_idx", "g_assigned", "g_gated", "g_slack",
                 "q_idx", "q_used", "q_count")

    MIN_BUCKET = 16

    def __init__(self, g_idx, g_assigned, g_gated, g_slack, q_idx, q_used,
                 q_count):
        self.g_idx = g_idx
        self.g_assigned = g_assigned
        self.g_gated = g_gated
        self.g_slack = g_slack
        self.q_idx = q_idx
        self.q_used = q_used
        self.q_count = q_count

    @classmethod
    def pack(cls, gang_rows: list[tuple], ns_rows: list[tuple],
             R: int) -> "SideDeltas":
        """`gang_rows`: [(row, d_assigned, d_gated, d_slack_vec)];
        `ns_rows`: [(row, d_used_vec, d_count)]. Repeated rows sum."""
        Ug = bucket_size(max(len(gang_rows), 1), minimum=cls.MIN_BUCKET)
        Uq = bucket_size(max(len(ns_rows), 1), minimum=cls.MIN_BUCKET)
        g_idx = np.zeros(Ug, I64)
        g_assigned = np.zeros(Ug, I32)
        g_gated = np.zeros(Ug, I32)
        g_slack = np.zeros((Ug, R), I64)
        for j, (row, da, dg, ds) in enumerate(gang_rows):
            g_idx[j] = row
            g_assigned[j] = da
            g_gated[j] = dg
            g_slack[j] = ds
        q_idx = np.zeros(Uq, I64)
        q_used = np.zeros((Uq, R), I64)
        q_count = np.zeros(Uq, I32)
        for j, (row, du, dc) in enumerate(ns_rows):
            q_idx[j] = row
            q_used[j] = du
            q_count[j] = dc
        return cls(g_idx, g_assigned, g_gated, g_slack, q_idx, q_used,
                   q_count)

    def as_args(self) -> tuple:
        return (self.g_idx, self.g_assigned, self.g_gated, self.g_slack,
                self.q_idx, self.q_used, self.q_count)


@sanitize.checked_call("serve_side_apply")
def apply_side_deltas(tables: SideTables, g_idx, g_assigned, g_gated,
                      g_slack, q_idx, q_used, q_count) -> SideTables:
    """Fold one packed side-table batch into the resident gang and quota
    sums, in place (pad rows add zero at row 0); returns the carry. Under
    `SPT_SANITIZE=1` the call is the checked program "serve_side_apply": a
    row outside the tables is reported and adds nothing."""
    check = sanitize.current()
    if check is not None:
        g_idx, g_assigned, g_gated, g_slack = check.rows(
            g_idx, tables.gang_assigned.shape[0], "apply_side_deltas gangs",
            g_assigned, g_gated, g_slack)
        q_idx, q_used, q_count = check.rows(
            q_idx, tables.quota_used.shape[0], "apply_side_deltas quotas",
            q_used, q_count)
    tables.gang_assigned.index_add_(0, g_idx, g_assigned)
    tables.gang_gated.index_add_(0, g_idx, g_gated)
    tables.gang_slack.index_add_(0, g_idx, g_slack)
    tables.quota_used.index_add_(0, q_idx, q_used)
    tables.ns_assigned.index_add_(0, q_idx, q_count)
    return tables
