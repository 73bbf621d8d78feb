"""GangPhase: the host side of the rank-aware gang solve (port of
`scheduler_plugins_tpu.gangs.phase`).

`framework.cycle.run_cycle(gangs=GangPhase(...))` runs this phase AFTER
QueueSort and BEFORE the snapshot and the per-pod solve: rank-aware gangs
(`PodGroup.rank_aware`) leave the pending batch, are solved as whole
gangs by the topology-block waterfill (`gangs.topology`), and their
placements are bound through the store, so the per-pod snapshot built
afterwards sees the committed capacity and quota usage. Every store
change rides the `api.events` kind table (binds are Pod/Update, elastic
deletes Pod/Delete, growth Pod/Add).

Each cycle:

1. `reconcile` elastic gangs (`gangs.elastic`): a shrink deletes the
   highest-cost ranks, growth clones member pods from the gang's rank
   template, both through `Cluster.remove_pod` / `add_pod`.
2. Lower the `RankGangState` from one snapshot (the store's, or the
   serving engine's resident columns): the node axis, quota tables and
   zone / region codes the per-pod path trusts.
3. Solve on the device (`gang_solve`, or `wave_gang_solve` with
   `wave=True`); `host_twin=True` runs the numpy twin instead, and
   `check_twin=True` runs both and records their disagreement in
   `last_drift` / `max_drift` (0.0 = bit-equal).
4. Bind the placed ranks, reject quorum-failed gangs whole (zero partial
   ranks: the members park unschedulable with the standard backoff), and
   keep the resident rank ledger O(changed).

`annotate_record` attaches the cycle's gang solve, inputs and outputs,
to the flight recorder's record, so a recorded gang cycle replays bit for
bit through `gangs.topology.gang_solve_np`; the elastic desired-width
transitions the reconcile observed ride along.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import PODS
from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.gangs import elastic as E
from scheduler_plugins_tpu_torch.gangs import topology as T
from scheduler_plugins_tpu_torch.utils.intmath import bucket_size

I64 = np.int64
I32 = np.int32

#: attribution name stamped into `CycleReport.failed_by` for pods a
#: quorum-failed rank gang parks (the phase is framework machinery, not a
#: profile plugin, so it owns its name as the built-in fit does)
RANK_GANG_PLACEMENT = "RankGangPlacement"

DEFAULT_WEIGHTS_NAME = "UserDefined"
DEFAULT_NETWORK_TOPOLOGY_NAME = "nt-default"


def _host(t):
    return t.cpu().numpy()


def rank_gang_groups(cluster):
    """The rank-aware PodGroups of a cluster, in name order."""
    return [
        pg for _, pg in sorted(cluster.pod_groups.items())
        if getattr(pg, "rank_aware", False)
    ]


def _zone_region_costs(meta, cluster, weights_name, nt_name):
    """Dense (ZC, ZC) / (RC, RC) cost matrices over this snapshot's zone
    and region codes: the lowering NetworkOverhead's `prepare_cluster`
    performs (networkoverhead.go:448-497), here feeding
    `topology.build_block_cost`."""
    ZC = max(len(meta.zones), 1)
    RC = max(len(meta.regions), 1)
    zone_cost = np.full((ZC, ZC), -1, I64)
    region_cost = np.full((RC, RC), -1, I64)
    nt = None
    for cand in cluster.network_topologies.values():
        if cand.name == nt_name:
            nt = cand
            break
    if nt is not None:
        weights = nt.weights.get(weights_name, {})
        for (orig, dest), cost in weights.get("zone", {}).items():
            if orig in meta.zones and dest in meta.zones:
                zone_cost[meta.zones.index(orig), meta.zones.index(dest)] = cost
        for (orig, dest), cost in weights.get("region", {}).items():
            if orig in meta.regions and dest in meta.regions:
                region_cost[
                    meta.regions.index(orig), meta.regions.index(dest)
                ] = cost
    return zone_cost, region_cost


def _block_cost_from_snapshot(meta, cluster, zones, regions,
                              weights_name, nt_name):
    """THE zone / region -> block_cost derivation, shared by the solve's
    lowering, the shrink reconcile and the placement audit."""
    zone_cost, region_cost = _zone_region_costs(
        meta, cluster, weights_name, nt_name
    )
    ZC = max(len(meta.zones), 1)
    zone_region = np.full(ZC, -1, I32)
    for ni in range(len(meta.node_names)):
        if zones[ni] >= 0 and regions[ni] >= 0:
            zone_region[zones[ni]] = regions[ni]
    return T.build_block_cost(
        meta.zones or [""], meta.regions, zone_region, zone_cost,
        region_cost,
    )


def block_cost_view(cluster, weights_name=DEFAULT_WEIGHTS_NAME,
                    nt_name=DEFAULT_NETWORK_TOPOLOGY_NAME):
    """(node_pos, zones (N,) int32, block_cost) from ONE empty-batch store
    snapshot: the audit-side lowering (the placement cost audit, the
    elastic shrink). A host lowering: the snapshot is built on the CPU."""
    snap, meta = cluster.snapshot([], now_ms=0, device="cpu")
    zones = _host(snap.nodes.zone).astype(I32)
    regions = _host(snap.nodes.region)
    node_pos = {name: i for i, name in enumerate(meta.node_names)}
    return node_pos, zones, _block_cost_from_snapshot(
        meta, cluster, zones, regions, weights_name, nt_name
    )


def build_rank_gang_problem(cluster, pending, now,
                            weights_name=DEFAULT_WEIGHTS_NAME,
                            nt_name=DEFAULT_NETWORK_TOPOLOGY_NAME,
                            serve=None, *, device=None):
    """Lower the cluster's rank-aware gangs into a solvable problem, or
    None when no rank-aware gang has pending members. The node, quota and
    code lowering comes from one snapshot of every consumed member on
    `device` (None = the CUDA card): the serving engine's refresh when
    `serve` (a `serving.engine.ServeEngine` attached to this cluster) can
    own the state, else `Cluster.snapshot`.

    Returns a dict: the `RankGangState` (numpy), the initial free /
    eq_used / node mask arrays, `uids` (G lists of per-slot uids),
    `gang_names` (G,), `node_names` and `consumed` (the pending Pod
    objects the phase takes out of the batch). Rank order per gang:
    residents by (creation_ms, uid), then pending members in queue
    order."""
    groups = rank_gang_groups(cluster)
    if not groups:
        return None
    by_gang_pending: dict[str, list] = {}
    consumed = []
    for pod in pending:
        pg = cluster.pod_group_of(pod)
        if pg is not None and getattr(pg, "rank_aware", False):
            by_gang_pending.setdefault(pg.full_name, []).append(pod)
            consumed.append(pod)
    active = [pg for pg in groups if by_gang_pending.get(pg.full_name)]
    if not active:
        return None

    # one lowering over EVERY consumed member, so the resource axis covers
    # any extended resource a rank requests (the pod tensors themselves
    # are unused: the gang solve builds its own rank rows)
    device = resolve_device(device)
    refreshed = None
    if serve is not None:
        refreshed = serve.refresh(cluster, consumed, now_ms=now,
                                  device=device)
    if refreshed is None:
        refreshed = cluster.snapshot(consumed, now_ms=now, device=device)
    snap, meta = refreshed
    alloc = _host(snap.nodes.alloc)
    requested = _host(snap.nodes.requested)
    node_mask = _host(snap.nodes.mask)
    zones = _host(snap.nodes.zone)
    regions = _host(snap.nodes.region)
    free0 = (alloc - requested).astype(I64)
    R = alloc.shape[1]
    node_pos = {name: i for i, name in enumerate(meta.node_names)}
    node_block = zones.astype(I32)

    block_cost = _block_cost_from_snapshot(
        meta, cluster, zones, regions, weights_name, nt_name,
    )

    if snap.quota is not None:
        eq_used0 = _host(snap.quota.used).astype(I64)
        quota_max = _host(snap.quota.max).astype(I64)
        quota_has = _host(snap.quota.has_quota)
    else:
        eq_used0 = np.zeros((1, R), I64)
        quota_max = np.full((1, R), np.iinfo(I64).max, I64)
        quota_has = np.zeros(1, bool)

    pods_i = meta.index.position(PODS)
    G = bucket_size(len(active))
    max_members = 1
    rows = []
    for pg in active:
        pend = by_gang_pending[pg.full_name]
        residents = sorted(
            (
                p for p in cluster.gang_members(pg)
                if p.node_name is not None and p.node_name in node_pos
            ),
            key=lambda p: (p.creation_ms, p.uid),
        )
        members = residents + pend
        max_members = max(max_members, len(members))
        rows.append((pg, residents, pend, members))
    M = bucket_size(max_members)

    rank_req = np.zeros((G, M, R), I64)
    rank_mask = np.zeros((G, M), bool)
    prev_assigned = np.full((G, M), -1, I32)
    min_ranks = np.ones(G, I32)
    gang_ns = np.full(G, -1, I32)
    gang_mask = np.zeros(G, bool)
    uids: list[list] = []
    gang_names = []
    for g, (pg, residents, pend, members) in enumerate(rows):
        gang_names.append(pg.full_name)
        gang_mask[g] = True
        lo, _desired, _hi = E.elastic_bounds(pg)
        min_ranks[g] = lo
        try:
            gang_ns[g] = meta.namespaces.index(pg.namespace)
        except ValueError:
            gang_ns[g] = -1
        slot_uids = []
        for m, pod in enumerate(members[:M]):
            vec = meta.index.encode(pod.effective_request())
            vec[pods_i] = 1
            rank_req[g, m] = vec
            rank_mask[g, m] = True
            slot_uids.append(pod.uid)
            if pod.node_name is not None:
                prev_assigned[g, m] = node_pos[pod.node_name]
        uids.append(slot_uids)
    uids.extend([] for _ in range(G - len(rows)))
    gang_names.extend("" for _ in range(G - len(rows)))

    gangs = T.RankGangState(
        rank_req=rank_req,
        rank_mask=rank_mask,
        prev_assigned=prev_assigned,
        min_ranks=min_ranks,
        gang_ns=gang_ns,
        gang_mask=gang_mask,
        node_block=node_block,
        block_cost=block_cost,
        quota_max=quota_max,
        quota_has=quota_has,
    )
    return {
        "gangs": gangs,
        "free0": free0,
        "eq_used0": eq_used0,
        "node_mask": node_mask,
        "uids": uids,
        "gang_names": gang_names,
        "node_names": list(meta.node_names),
        "consumed": consumed,
    }


class GangPhase:
    """The long-lived gang phase of one cluster (see the module
    doc)."""

    def __init__(self, host_twin: bool = False, check_twin: bool = False,
                 weights_name: str = DEFAULT_WEIGHTS_NAME,
                 network_topology_name: str = DEFAULT_NETWORK_TOPOLOGY_NAME,
                 wave: bool = False, wave_width: Optional[int] = None):
        self.host_twin = host_twin
        self.check_twin = check_twin
        #: the wave-batched solve (`gangs.waves`), bit-identical to the
        #: sequential one
        self.wave = wave
        self.wave_width = wave_width
        self.weights_name = weights_name
        self.network_topology_name = network_topology_name
        #: gang full_name -> {uid: node}: the resident rank ledger, kept
        #: O(changed) from this phase's own binds and releases
        self.resident: dict[str, dict] = {}
        #: 0.0 when the device solve and the numpy twin agreed bit for bit
        #: on the last solved cycle (check_twin), else the mismatch share
        self.last_drift: Optional[float] = None
        #: the WORST drift over every solved cycle of this phase
        self.max_drift: Optional[float] = None
        self._grow_serial = 0
        #: the last solved cycle's problem and outputs (`annotate_record`)
        self._last: Optional[dict] = None
        #: gang full_name -> the desired width the reconcile last saw
        self._desired_seen: dict[str, int] = {}
        #: this pass's desired-width transitions (`annotate_record`)
        self._elastic_transitions: list = []

    # -- elastic reconcile ----------------------------------------------
    def reconcile(self, cluster, now) -> dict:
        """Apply elastic grow / shrink transitions. Returns {gang:
        {"created": [uids], "released": [uids]}} for gangs that moved.
        Over-width gangs shed PENDING members first (the newest clones:
        nothing placed yet), then live ranks by the highest-cost-first
        selection. The block-cost view is lowered at most once a pass."""
        moved: dict[str, dict] = {}
        view = None  # (node_pos, zones, block_cost), lowered lazily once
        self._elastic_transitions = []
        for pg in rank_gang_groups(cluster):
            lo, desired, hi = E.elastic_bounds(pg)
            prev = self._desired_seen.get(pg.full_name)
            if prev != desired:
                # the first sighting records from=None: the initial width
                # belongs to the width timeline too
                self._elastic_transitions.append({
                    "gang": pg.full_name, "from": prev, "to": desired,
                    "min": lo, "max": hi,
                })
                self._desired_seen[pg.full_name] = desired
            members = cluster.gang_members(pg)
            live = [p for p in members if p.node_name is not None]
            total = len(members)
            released: list = []
            if total > desired:
                # pending extras above desired leave first, newest first
                spare = sorted(
                    (p for p in members if p.node_name is None),
                    key=lambda p: (p.creation_ms, p.uid), reverse=True,
                )[: total - desired]
                for p in spare:
                    cluster.remove_pod(p.uid)  # Pod/Delete
                    released.append(p.uid)
            if len(live) > desired:
                if view is None:
                    view = block_cost_view(
                        cluster, self.weights_name,
                        self.network_topology_name,
                    )
                released += self._shrink(
                    cluster, pg, live, len(live) - desired, view
                )
            if released:
                moved[pg.full_name] = {"created": [], "released": released}
            elif total < desired and members:
                created = self._grow(cluster, pg, members, desired - total,
                                     now)
                moved[pg.full_name] = {"created": created, "released": []}
        return moved

    def _shrink(self, cluster, pg, live, n_release, view):
        """Delete the `n_release` highest-cost live ranks (max inter-rank
        pair cost descending, rank index descending)."""
        node_pos, zones, block_cost = view
        ordered = sorted(live, key=lambda p: (p.creation_ms, p.uid))
        M = len(ordered)
        rank_nodes = np.asarray(
            [[node_pos.get(p.node_name, -1) for p in ordered]], I32
        )
        live_mask = rank_nodes >= 0
        release = E.shrink_select_np(
            rank_nodes, live_mask, zones, block_cost,
            np.asarray([n_release], I32),
        )[0]
        released = []
        ledger = self.resident.setdefault(pg.full_name, {})
        for m in range(M):
            if release[m]:
                uid = ordered[m].uid
                cluster.remove_pod(uid)  # Pod/Delete
                ledger.pop(uid, None)
                released.append(uid)
        return released

    def _grow(self, cluster, pg, members, n_new, now):
        """Clone `n_new` member pods from the gang's rank template (its
        first member in rank order); the clones arrive as Pod/Add events
        and place anchored on the gang's resident block."""
        from scheduler_plugins_tpu_torch.api.objects import Pod

        template = sorted(members, key=lambda p: (p.creation_ms, p.uid))[0]
        created = []
        for _ in range(n_new):
            self._grow_serial += 1
            name = f"{pg.name}-g{self._grow_serial:04d}"
            uid = f"{pg.namespace}/{name}"
            if uid in cluster.pods:
                continue
            cluster.add_pod(Pod(
                name=name,
                namespace=pg.namespace,
                containers=list(template.containers),
                init_containers=list(template.init_containers),
                priority=template.priority,
                labels=dict(template.labels),
                creation_ms=now + self._grow_serial,
            ))  # Pod/Add
            created.append(uid)
        return created

    # -- the per-cycle entry --------------------------------------------
    def run(self, scheduler, cluster, pending, now, report, serve=None, *,
            device=None):
        """Solve and bind this cycle's rank gangs on `device` (None = the
        CUDA card); returns the pending list with every rank-gang member
        removed (placed, parked or waiting: rank pods never fall through
        to the per-pod solve). `serve` routes the problem's lowering
        through the serving engine's resident state."""
        device = resolve_device(device)
        self._last = None
        moved = self.reconcile(cluster, now)
        if moved:
            # growth clones join THIS cycle's batch; shrink deletions
            # leave it. The rest stays exactly as the requeue gate
            # admitted it (re-deriving pending from the store would
            # smuggle parked pods past their backoff)
            created = [
                cluster.pods[uid]
                for m in moved.values() for uid in m["created"]
                if uid in cluster.pods
            ]
            pending = [p for p in pending if p.uid in cluster.pods]
            if created:
                pending = scheduler.sort_pending(pending + created, cluster)
        prob = build_rank_gang_problem(
            cluster, pending, now, self.weights_name,
            self.network_topology_name, serve=serve, device=device,
        )
        if prob is None:
            return pending
        gangs = prob["gangs"]
        rank_nodes, admitted, placed_new = self._solve(prob, device)

        consumed = {p.uid for p in prob["consumed"]}
        remaining = [p for p in pending if p.uid not in consumed]
        max_cost, sum_cost = T.gang_cost_stats(
            rank_nodes, gangs.rank_mask, gangs.node_block, gangs.block_cost
        )
        stats = {}
        for g, name in enumerate(prob["gang_names"]):
            if not name:
                continue
            slot_uids = prob["uids"][g]
            pg = cluster.pod_groups.get(name)
            ledger = self.resident.setdefault(name, {})
            newly_bound = {}
            failed_uids = []
            for m, uid in enumerate(slot_uids):
                node_i = int(rank_nodes[g, m])
                if int(gangs.prev_assigned[g, m]) >= 0:
                    ledger[uid] = prob["node_names"][node_i]
                    continue
                if node_i >= 0:
                    newly_bound[uid] = prob["node_names"][node_i]
                else:
                    failed_uids.append(uid)
            if bool(admitted[g]):
                for uid, node_name in newly_bound.items():
                    cluster.bind(uid, node_name, now)  # Pod/Update
                    report.bound[uid] = node_name
                    ledger[uid] = node_name
                # elastic stragglers above quorum retry next cycle
                for uid in failed_uids:
                    report.failed.append(uid)
                    report.failed_by[uid] = RANK_GANG_PLACEMENT
                    cluster.mark_unschedulable(uid, now)
            else:
                # whole-gang rejection: zero partial ranks, the standard
                # backoff parking (the PostFilter shape, on the host)
                for uid in list(newly_bound) + failed_uids:
                    report.failed.append(uid)
                    report.failed_by[uid] = RANK_GANG_PLACEMENT
                    cluster.mark_unschedulable(uid, now)
                if pg is not None:
                    cluster.gang_last_failure_ms[name] = now
                report.rejected_gangs.append(name)
            # prune ledger entries the store no longer backs (external
            # deletes or unbinds): O(gang members)
            for uid in list(ledger):
                p = cluster.pods.get(uid)
                if p is None or p.node_name is None:
                    ledger.pop(uid, None)
            _lo, desired, _ = (E.elastic_bounds(pg) if pg is not None
                               else (0, 0, 0))
            stats[name] = {
                "admitted": bool(admitted[g]),
                "placed_new": int(placed_new[g]),
                "resident": int((gangs.prev_assigned[g] >= 0).sum()),
                "desired": desired,
                "max_cost": int(max_cost[g]),
                "sum_cost": int(sum_cost[g]),
            }
        report.rank_gangs = stats
        self._last = {
            "gangs": gangs,
            "free0": prob["free0"],
            "eq_used0": prob["eq_used0"],
            "node_mask": prob["node_mask"],
            "rank_nodes": rank_nodes,
            "admitted": admitted,
        }
        return remaining

    def annotate_record(self, rec) -> None:
        """Attach this cycle's gang solve, inputs and outputs, to a
        flight-recorder record: re-running `gangs.topology.gang_solve_np`
        on the captured arrays reproduces `rank_nodes` exactly. The
        elastic desired-width transitions ride the manifest even on a
        cycle with no gang solve (a shrink-only reconcile)."""
        if rec is None:
            return
        if self._elastic_transitions:
            rec.manifest["elastic_transitions"] = [
                dict(t) for t in self._elastic_transitions
            ]
        if self._last is None:
            return
        from scheduler_plugins_tpu_torch.utils.flightrec import pack_pytree

        gangs = self._last["gangs"]
        spec = {
            "gangs": {f.name: getattr(gangs, f.name)
                      for f in dataclasses.fields(gangs)},
            **{k: self._last[k] for k in ("free0", "eq_used0", "node_mask",
                                          "rank_nodes", "admitted")},
        }
        rec.manifest["rank_gangs"] = pack_pytree(spec, rec.blobs)

    def _solve(self, prob, device):
        """(rank_nodes, admitted, placed_new) as numpy from the device
        solve, the numpy twin, or both (`check_twin`, which records the
        drift)."""
        gangs = prob["gangs"]
        want_np = self.host_twin or self.check_twin
        want_dev = not self.host_twin
        np_out = dev_out = None
        if want_np:
            np_out = T.gang_solve_np(
                gangs, prob["free0"], prob["eq_used0"], prob["node_mask"]
            )[:3]
        if want_dev and self.wave:
            from scheduler_plugins_tpu_torch.gangs import waves as GW

            dev_out = GW.wave_gang_solve(
                gangs, prob["free0"], prob["eq_used0"], prob["node_mask"],
                wave=self.wave_width or GW.DEFAULT_WAVE, device=device,
            )[:3]
        elif want_dev:
            state0 = T.initial_state(gangs, prob["free0"], prob["eq_used0"],
                                     device=device)
            mask = T._tensor(prob["node_mask"], torch.bool, device)
            out = T.gang_solve(gangs.to(device), state0, mask, device=device)
            dev_out = tuple(_host(x) for x in out[:3])
        if want_dev and want_np:
            mismatches = int((dev_out[0] != np_out[0]).sum()) + int(
                (dev_out[1] != np_out[1]).sum())
            self.last_drift = 0.0 if mismatches == 0 else (
                mismatches / max(dev_out[0].size, 1)
            )
            self.max_drift = max(self.max_drift or 0.0, self.last_drift)
        return dev_out if want_dev else np_out
