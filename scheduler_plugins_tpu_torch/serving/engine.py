"""ServeEngine: the node state resident on the device across cycles, fed
O(changed) deltas (port of `scheduler_plugins_tpu.serving.engine`).

`framework.cycle.run_cycle(serve=engine)` swaps the per-cycle full
re-snapshot (`Cluster.snapshot`: an O(nodes + assigned pods) Python
lowering and a full host-to-device copy) for this engine's `refresh`: the
`NodeState` columns stay on the device and each refresh folds in only the
deltas the store's mutation hooks captured since the last one
(`serving.deltas`). The solve is untouched: the assembled snapshot feeds
the same sequential parity solve, so served placements equal a
fresh-snapshot cycle's.

Capacity policy:

- **grow**: node adds past the padded capacity pad the resident columns
  to the next `bucket_size` bucket on the device, keeping their usage;
- **rebase**: Node/Delete, a region or zone change of a known node, an
  extended resource, or a pod event against a node the engine never saw
  invalidate the row order or the packed axis, and the engine rebuilds
  from a fresh `Cluster.snapshot` at the bucket of the current node count.

Compatibility gate: the engine owns the snapshot while every side table
is None or one the resident state describes. Gang (PodGroup) and quota
(ElasticQuota) rosters are owned: their aggregates come from resident side
tables kept O(changed) from the same deltas (`serving.deltas.SideTables`).
NRTs, AppGroups, seccomp profiles, node metrics, selector-spec pods,
tainted nodes, nominations and extended resources still fall back. While
incompatible, `refresh` returns None (the cycle takes the full snapshot)
but keeps absorbing deltas, so serving resumes without a rebuild.

Checkpoint: `checkpoint_bytes` / `save_checkpoint` write the resident
columns and the slot and interning tables as one npz with a JSON header;
`restore_checkpoint` rebuilds the resident base from one and marks it for
an anti-entropy verify at the next refresh, so a stale checkpoint rebases
within one window and an exact one resumes with no rebase.

`StreamingServeEngine`, the pipelined cycle engine's serving engine,
compacts a deleted node's row out on the device instead of rebasing,
memoizes the per-pod encodes and verifies against columns summed from the
store.

Flight recorder: `annotate_record` attaches a served cycle's provenance
(the resident generation, the events since the base, the digest of the
base columns taken at the last rebase while the recorder was on, and the
packed deltas of this refresh) to the cycle's record.
"""

from __future__ import annotations

import io
import json
import os
from typing import Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.serving import deltas as D
from scheduler_plugins_tpu_torch.state.snapshot import (
    ClusterSnapshot,
    GangState,
    NodeState,
    QuotaState,
    SnapshotMeta,
    _Interner,
    build_pod_state,
    empty_quota_nominees,
    gang_object_tables,
    pad_rows,
    quota_object_tables,
)
from scheduler_plugins_tpu_torch.utils import flightrec
from scheduler_plugins_tpu_torch.utils import observability as obs
from scheduler_plugins_tpu_torch.utils.flightrec import pack_digest
from scheduler_plugins_tpu_torch.utils.intmath import bucket_size

#: the resident node columns the anti-entropy digest covers (every
#: column but `nominated`, which serve mode keeps zero)
NODE_COLUMNS = ("alloc", "capacity", "requested", "nonzero_requested",
                "limits", "mask", "region", "zone", "pod_count",
                "terminating")


class ServeEngine:
    """Long-lived serving engine for one `Cluster` store."""

    def __init__(self):
        self._sink = D.DeltaSink()
        self._cluster = None
        self._nodes = None  # resident NodeState on the device, or None
        self._npad = 0
        self._names: list[str] = []  # slot order == cluster.nodes order
        self._slots: dict[str, int] = {}
        # first-seen label interning, the snapshot's own convention
        self._regions: list[str] = []
        self._zones: list[str] = []
        self._regions_in = _Interner(self._regions)
        self._zones_in = _Interner(self._zones)
        self._node_labels: dict[str, tuple] = {}  # name -> (region, zone)
        self._tainted: set[str] = set()
        self._generation = 0
        self._rebases = 0
        self._staleness = 0  # delta events applied since the last rebase
        #: digest the resident columns against a fresh snapshot every N
        #: serving refreshes (0 = off); a divergence forces a rebase, so a
        #: corrupted or dropped delta poisons at most one window.
        #: SPT_SERVE_VERIFY_EVERY overrides.
        self.verify_every = self._verify_every_default()
        self._refreshes = 0
        #: verify at the next refresh (`note_fault`)
        self._verify_pending = False
        self.antientropy_divergences = 0
        self.last_fault: Optional[str] = None
        #: gang full_name -> {pod uid: node name}: the resident rank
        #: mirror, kept O(changed) from the drained deltas
        self.resident_ranks: dict[str, dict] = {}
        #: refreshes that fell back while the cluster carried PodGroups
        #: (a compatible gang roster serves from the side tables and
        #: keeps this 0); exported as `scheduler_serve_gang_fallbacks_total`
        self.gang_fallbacks = 0
        # -- resident gang/quota side tables -----------------------------
        #: `serving.deltas.SideTables` in engine-stable row order, None
        #: until first built
        self._side = None
        self._gang_rows: dict[str, int] = {}  # gang full_name -> row
        self._ns_rows: dict[str, int] = {}  # namespace -> row
        self._side_gpad = 0
        self._side_qpad = 0
        #: gang slack depends on node existence (a fresh snapshot drops
        #: pods bound to unknown nodes): a node name the engine never saw
        #: marks the tables dirty, and the next assembly rebuilds them
        #: with one O(pods) scan
        self._side_dirty = True
        #: quota sums are kept only once an ElasticQuota was seen, so a
        #: quota-less cluster pays no side rows
        self._quota_tracking = False
        # -- flight-recorder provenance ------------------------------------
        #: `pack_digest` of the base columns at the last rebase, taken only
        #: while the recorder is on
        self._base_digest: Optional[str] = None
        #: the last refresh's mode ("rebase", "delta", "compact") and its
        #: packed batch, or None when it served nothing
        self._last: Optional[dict] = None

    @staticmethod
    def _verify_every_default() -> int:
        try:
            return int(os.environ.get("SPT_SERVE_VERIFY_EVERY", "32"))
        except ValueError:
            return 32

    # -- wiring ---------------------------------------------------------
    def attach(self, cluster) -> "ServeEngine":
        """Install the delta sink on `cluster`; the resident base is built
        at the first `refresh`."""
        cluster.delta_sink = self._sink
        self._cluster = cluster
        self._nodes = None
        return self

    def detach(self) -> None:
        """Uninstall the sink and drop the resident base (otherwise every
        mutator keeps queueing events nobody drains)."""
        if (self._cluster is not None
                and self._cluster.delta_sink is self._sink):
            self._cluster.delta_sink = None
        self._cluster = None
        self._nodes = None
        self._sink.events.clear()
        self._sink.overflowed = False
        self._sink.nominated_unbound.clear()
        self._side = None
        self._side_dirty = True
        self._gang_rows.clear()
        self._ns_rows.clear()

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def rebases(self) -> int:
        """Full re-snapshots this engine performed (the global
        `scheduler_serve_rebases_total` sums every engine)."""
        return self._rebases

    @property
    def resident_nodes(self):
        """The live resident `NodeState` (None before the first refresh);
        the next `refresh` updates it in place."""
        return self._nodes

    @property
    def npad(self) -> int:
        return self._npad

    # -- compatibility gate ---------------------------------------------
    def compatible(self, cluster, pending) -> bool:
        """True when the engine can own this cycle's snapshot: every side
        table is None or one the resident state describes (gang and quota
        rosters on the canonical axis included)."""
        if (cluster.nrts or cluster.app_groups or cluster.seccomp_profiles
                or cluster.node_metrics is not None
                or cluster._selector_spec_pods or self._tainted):
            return False
        # gang or quota objects naming an extended resource widen the
        # fresh snapshot's axis past the canonical four
        for pg in cluster.pod_groups.values():
            if pg.min_resources and any(
                    r not in D.CANON_INDEX for r in pg.min_resources):
                return False
        for eq in cluster.quotas.values():
            if (any(r not in D.CANON_INDEX for r in eq.min)
                    or any(r not in D.CANON_INDEX for r in eq.max)):
                return False
        # nominations outside the pending batch still count into the full
        # snapshot's nominated column and nominee holds
        if self._sink.nominated_unbound:
            return False
        for uid in cluster.reserved:
            p = cluster.pods.get(uid)
            if p is not None and p.nominated_node_name is not None:
                return False
        # batch-local specs: node affinity feeds the scheduling tables,
        # nominations the nominee holds, extended resources the axis
        for pod in pending:
            if (pod.node_selector or pod.node_affinity_required
                    or pod.node_affinity_preferred
                    or pod.nominated_node_name is not None
                    or any(r not in D.CANON_INDEX
                           for r in pod.effective_request())
                    or any(r not in D.CANON_INDEX
                           for r in pod.effective_limits())):
                return False
        return True

    # -- the per-cycle entry --------------------------------------------
    def refresh(self, cluster, pending, now_ms: int = 0, *, device=None):
        """(snapshot, meta) for this cycle on `device` (None = the CUDA
        card), or None when the engine cannot own the state (the caller
        falls back to `Cluster.snapshot`). Drains the sink either way, so
        the resident columns never go stale. A steady-state refresh reads
        nothing on the host; `verify` reads the columns on purpose."""
        device = resolve_device(device)
        with obs.tracer.span("ServeRefresh/drain", tid="serve"):
            events = self._sink.drain()
        obs.metrics.set_gauge(obs.SERVE_PENDING_DELTAS, len(events))
        if cluster.quotas and not self._quota_tracking:
            # first ElasticQuota: start keeping the quota sums; the
            # rebuild picks up every pod assigned already
            self._quota_tracking = True
            self._side_dirty = True
        with obs.tracer.span("ServeRefresh/classify", tid="serve",
                             events=len(events)):
            upserts, usage, side, rebase = self._ingest(events)
        if self._sink.consume_overflow():
            # the queue collapsed undrained: the surviving events are a
            # partial window
            rebase = "sink-overflow"
            self._side_dirty = True
        if (self._nodes is not None
                and not _same_device(self._nodes.alloc.device, device)):
            rebase = rebase or "device-change"
        n_nodes = len(cluster.nodes)
        grow = self._nodes is not None and n_nodes > self._npad

        if not self.compatible(cluster, pending):
            if cluster.pod_groups:
                self.gang_fallbacks += 1
                obs.metrics.inc(obs.SERVE_GANG_FALLBACKS)
            # keep the columns in sync while incompatible; a rebase-class
            # event drops the base (rebuilt at the next compatible refresh)
            if rebase:
                self._nodes = None
                self._side_dirty = True
            elif self._nodes is not None:
                if grow:
                    self._grow(bucket_size(n_nodes))
                self._apply_batch(upserts, usage, side)
            self._last = None
            return None

        if rebase or self._nodes is None:
            return self._rebase(cluster, pending, now_ms, device)
        if grow:
            self._grow(bucket_size(n_nodes))
        self._apply_batch(upserts, usage, side)
        self._refreshes += 1
        if self._verify_pending or (
                self.verify_every
                and self._refreshes % self.verify_every == 0):
            if self.verify(cluster) is not None:
                return self._rebase(cluster, pending, now_ms, device)
        if ((cluster.pod_groups or cluster.quotas)
                and not self._ensure_side(cluster)):
            # the side tables could not be rebuilt (an extended-resource
            # assigned pod): serve this cycle from the full snapshot
            self._last = None
            return None
        return self._assemble(cluster, pending, now_ms)

    # -- event classification -------------------------------------------
    def _ingest(self, events):
        """Classification seam: the streaming engine splits the stream at
        node deletes (compacting rows); the base engine classifies the
        whole batch, a node delete forcing a rebase."""
        return self._classify(events)

    def _pod_vectors(self, pod, final=False):
        """One pod's (requested, nonzero, limits, quota) contribution
        vectors. The
        streaming engine memoizes them per pod object (`final` marks the
        pod's last event, releasing its entry)."""
        return D.pod_usage_vectors(pod) + (D.pod_quota_vector(pod),)

    def _row_cache(self):
        """The per-pod lowering memo handed to `build_pod_state` (None
        here: every cycle lowers its batch from scratch)."""
        return None

    def _gang_row(self, name: str) -> int:
        row = self._gang_rows.get(name)
        if row is None:
            row = self._gang_rows[name] = len(self._gang_rows)
        return row

    def _ns_row(self, name: str) -> int:
        row = self._ns_rows.get(name)
        if row is None:
            row = self._ns_rows[name] = len(self._ns_rows)
        return row

    def _classify(self, events):
        """Coalesce drained events into packed-row lists: (upsert_rows,
        usage_rows, (gang_rows, ns_rows), rebase reason or None). A node
        delete forces a rebase."""
        upserts: dict[int, tuple] = {}  # slot -> row (last write wins)
        usage: list[tuple] = []
        gang_acc: dict[int, list] = {}
        ns_acc: dict[int, list] = {}
        R = len(D.CANON_INDEX)
        rebase = None

        def fail(reason):
            nonlocal rebase
            if rebase is None:
                rebase = reason

        def gang_add(name, d_assigned, d_gated, d_slack):
            row = self._gang_row(name)
            acc = gang_acc.get(row)
            if acc is None:
                acc = gang_acc[row] = [0, 0, np.zeros(R, np.int64)]
            acc[0] += d_assigned
            acc[1] += d_gated
            if d_slack is not None:
                acc[2] = acc[2] + d_slack

        def ns_add(name, d_used, d_count):
            row = self._ns_row(name)
            acc = ns_acc.get(row)
            if acc is None:
                acc = ns_acc[row] = [np.zeros(R, np.int64), 0]
            acc[0] = acc[0] + d_used
            acc[1] += d_count

        for ev in events:
            kind = ev[0]
            if kind == D.GANG_GATED:
                gang_add(ev[1], 0, ev[2], None)
                continue
            if kind == D.NODE_DELETE:
                # the row order dies with the node, and so do its label and
                # taint entries (a deleted node must not pin `compatible`)
                name = ev[1]
                self._tainted.discard(name)
                self._node_labels.pop(name, None)
                fail("node-delete")
            elif kind == D.NODE_UPSERT:
                node = ev[1]
                if node.taints:
                    self._tainted.add(node.name)
                else:
                    self._tainted.discard(node.name)
                labels = (node.region or "", node.zone or "")
                prev = self._node_labels.get(node.name)
                if prev is not None and prev != labels:
                    # codes are first-seen in slot order: a relabel is not
                    # a row overwrite
                    fail("label-change")
                self._node_labels[node.name] = labels
                slot = self._slots.get(node.name)
                if slot is None:
                    slot = len(self._names)
                    self._slots[node.name] = slot
                    self._names.append(node.name)
                    if self._gang_rows:
                        # a new node name can revive gang slack of pods
                        # bound to it already
                        self._side_dirty = True
                try:
                    alloc = D._encode(node.allocatable)
                    cap = D._encode(node.capacity)
                except D.UnsupportedResource:
                    fail("extended-resource")
                    continue
                upserts[slot] = (
                    slot, alloc, cap, not node.unschedulable,
                    self._regions_in.code(node.region) if node.region
                    else -1,
                    self._zones_in.code(node.zone) if node.zone else -1,
                )
            else:  # pod usage transitions
                pod, node_name = ev[1], ev[2]
                gang = pod.pod_group()
                if gang:
                    # the rank mirror: assigns record the node, unassigns
                    # drop it (a terminating rank keeps its node)
                    key = f"{pod.namespace}/{gang}"
                    roster = self.resident_ranks.setdefault(key, {})
                    if kind == D.POD_ASSIGN:
                        roster[pod.uid] = node_name
                    elif kind != D.POD_TERMINATING:
                        roster.pop(pod.uid, None)
                        if not roster:
                            self.resident_ranks.pop(key, None)
                slot = self._slots.get(node_name)
                if kind == D.POD_TERMINATING:
                    if slot is None:
                        fail("unknown-node")
                        continue
                    usage.append((slot, D.ZERO_R, D.ZERO_R, D.ZERO_R, 0,
                                  1))
                    continue
                sign = 1 if kind == D.POD_ASSIGN else -1
                try:
                    req, nz, lim, qreq = self._pod_vectors(
                        pod, final=kind == D.POD_UNASSIGN)
                except D.UnsupportedResource:
                    fail("extended-resource")
                    continue
                # side rows first: the quota row and the gang count follow
                # the pod whatever its node; gang slack only on a known
                # node (a fresh snapshot drops unknown-node slack)
                if self._quota_tracking:
                    ns_add(pod.namespace, sign * qreq, sign)
                if gang:
                    gang_add(f"{pod.namespace}/{gang}", sign, 0,
                             sign * req if slot is not None else None)
                if slot is None:
                    # a pod on a node the engine never saw: the fresh
                    # snapshot skips it until the node arrives
                    fail("unknown-node")
                    continue
                # the event-time flag, not pod.terminating (see deltas)
                term = 1 if ev[3] else 0
                usage.append((slot, sign * req, sign * nz, sign * lim, sign,
                              sign * term))
        side = (
            [(row, a, g, s) for row, (a, g, s) in gang_acc.items()],
            [(row, u, c) for row, (u, c) in ns_acc.items()],
        )
        return list(upserts.values()), usage, side, rebase

    # -- state transitions ----------------------------------------------
    def _apply_batch(self, upsert_rows, usage_rows, side=None) -> None:
        with obs.tracer.span("ServeRefresh/apply", tid="serve",
                             upserts=len(upsert_rows),
                             usage=len(usage_rows)):
            R = len(D.CANON_INDEX)
            ups = D.NodeUpserts.pack(upsert_rows, R)
            use = D.UsageDeltas.pack(usage_rows, R)
            device = self._nodes.alloc.device
            self._nodes = D.apply_node_deltas(
                self._nodes, *D.stage(ups.as_args() + use.as_args(), device))
            side_packed = self._apply_side(side)
        self._generation += 1
        n_events = len(upsert_rows) + len(usage_rows)
        self._staleness += n_events
        self._last = {"mode": "delta", "events": n_events,
                      "upserts": _fields(ups), "usage": _fields(use)}
        if side_packed is not None:
            self._last["side"] = _fields(side_packed)
        self._observe()

    def _apply_side(self, side):
        """Fold this window's side-table rows into the resident gang and
        quota sums; skipped for windows without such rows and while the
        tables are dirty (the pending rebuild supersedes them). Returns
        the packed `SideDeltas` applied, or None."""
        if side is None:
            return None
        gang_rows, ns_rows = side
        if (not gang_rows and not ns_rows) or self._side_dirty:
            return None
        if self._side is None:
            self._side_dirty = True
            return None
        need_g = max((row for row, *_ in gang_rows), default=-1) + 1
        need_q = max((row for row, *_ in ns_rows), default=-1) + 1
        self._grow_side(need_g, need_q)
        packed = D.SideDeltas.pack(gang_rows, ns_rows, len(D.CANON_INDEX))
        self._side = D.apply_side_deltas(
            self._side,
            *D.stage(packed.as_args(), self._side.gang_slack.device))
        return packed

    def _grow_side(self, need_g: int, need_q: int) -> None:
        """Zero-pad the side tables to cover rows `need_g` / `need_q`."""
        new_g = bucket_size(max(need_g, self._side_gpad, 1))
        new_q = bucket_size(max(need_q, self._side_qpad, 1))
        if new_g == self._side_gpad and new_q == self._side_qpad:
            return
        side = self._side
        self._side = side.replace(
            gang_assigned=pad_rows(side.gang_assigned, new_g),
            gang_gated=pad_rows(side.gang_gated, new_g),
            gang_slack=pad_rows(side.gang_slack, new_g),
            quota_used=pad_rows(side.quota_used, new_q),
            ns_assigned=pad_rows(side.ns_assigned, new_q),
        )
        self._side_gpad = new_g
        self._side_qpad = new_q

    def _grow(self, new_npad: int) -> None:
        """Pad the resident columns to a larger bucket on the device with
        a fresh snapshot's pad values (zeros, mask False, region and zone
        -1), keeping their usage."""
        if new_npad <= self._npad:
            return
        n = self._nodes
        self._nodes = n.replace(
            alloc=pad_rows(n.alloc, new_npad),
            capacity=pad_rows(n.capacity, new_npad),
            requested=pad_rows(n.requested, new_npad),
            nonzero_requested=pad_rows(n.nonzero_requested, new_npad),
            limits=pad_rows(n.limits, new_npad),
            mask=pad_rows(n.mask, new_npad, False),
            region=pad_rows(n.region, new_npad, -1),
            zone=pad_rows(n.zone, new_npad, -1),
            pod_count=pad_rows(n.pod_count, new_npad),
            terminating=pad_rows(n.terminating, new_npad),
            nominated=pad_rows(n.nominated, new_npad),
        )
        self._npad = new_npad

    def _rebase(self, cluster, pending, now_ms: int, device):
        """Full re-snapshot: rebuild the resident base from the store at
        the bucket of the current node count, and reset the slot and
        interning tables to the store's order."""
        with obs.tracer.span("ServeRefresh/rebase", tid="serve",
                             nodes=len(cluster.nodes)):
            return self._rebase_inner(cluster, pending, now_ms, device)

    def _rebase_inner(self, cluster, pending, now_ms: int, device):
        npad = bucket_size(max(len(cluster.nodes), 1))
        snap, meta = cluster.snapshot(pending, now_ms=now_ms,
                                      pad_nodes=npad, device=device)
        self._generation += 1
        self._staleness = 0
        self._rebases += 1
        obs.metrics.inc(obs.SERVE_REBASES)
        if len(meta.index) != len(D.CANON_INDEX):
            # an extended resource somewhere in the store widens the axis
            # past what the deltas carry: serve this cycle from the fresh
            # snapshot and keep rebuilding until it goes
            self._nodes = None
            self._side_dirty = True
            self._last = None
            self._observe()
            return snap, meta
        self._nodes = snap.nodes
        self._npad = npad
        self._names = list(meta.node_names)
        self._slots = {n: i for i, n in enumerate(self._names)}
        self._regions = meta.regions  # shared: _assemble copies
        self._zones = meta.zones
        self._regions_in = _Interner(self._regions)
        self._zones_in = _Interner(self._zones)
        self._node_labels = {
            n.name: (n.region or "", n.zone or "")
            for n in cluster.nodes.values()
        }
        self._tainted = {n.name for n in cluster.nodes.values()
                         if n.taints}
        # a rebase is O(cluster) already: rebuild the side tables to match
        # the fresh snapshot it serves
        self._rebuild_side_tables(cluster)
        # the base a served record's deltas start from (a host read of the
        # columns, taken only while the recorder is on)
        self._base_digest = (
            pack_digest(self._node_columns(self._nodes))
            if flightrec.recorder.enabled else None)
        self._last = {"mode": "rebase", "events": 0}
        self._observe()
        return snap, meta

    # -- resident gang/quota side tables --------------------------------
    def _ensure_side(self, cluster) -> bool:
        """Side tables ready for assembly, rebuilt from one store scan
        when dirty or absent."""
        if self._side is not None and not self._side_dirty:
            return True
        return self._rebuild_side_tables(cluster)

    def _scan_side_aggregates(self, cluster):
        """One store scan giving the gang and quota sums a fresh
        `build_snapshot` accumulates: {gang: [assigned, gated, slack]} and
        {namespace: [used, count]}. Raises `UnsupportedResource` on an
        extended-resource assigned pod."""
        R = len(D.CANON_INDEX)
        gangs: dict[str, list] = {}
        namespaces: dict[str, list] = {}

        def gang_acc(name):
            acc = gangs.get(name)
            if acc is None:
                acc = gangs[name] = [0, 0, np.zeros(R, np.int64)]
            return acc

        for pod in cluster.pods.values():
            held = pod.node_name or cluster.reserved.get(pod.uid)
            gang = pod.pod_group()
            if held is not None:
                req, _nz, _lim, qreq = self._pod_vectors(pod)
                if self._quota_tracking:
                    acc = namespaces.get(pod.namespace)
                    if acc is None:
                        acc = namespaces[pod.namespace] = [
                            np.zeros(R, np.int64), 0]
                    acc[0] = acc[0] + qreq
                    acc[1] += 1
                if gang:
                    acc = gang_acc(f"{pod.namespace}/{gang}")
                    acc[0] += 1
                    if held in cluster.nodes:
                        acc[2] = acc[2] + req
            # gated follows `gated_pods()` (node_name None), whatever the
            # reservation: a reserved gated pod counts both ways in a
            # fresh snapshot, and the deltas mirror that
            if (gang and pod.node_name is None and pod.scheduling_gated
                    and not pod.terminating):
                gang_acc(f"{pod.namespace}/{gang}")[1] += 1
        return gangs, namespaces

    def _rebuild_side_tables(self, cluster) -> bool:
        """Rebuild the side tables from the store (O(pods), the rare
        path). False (tables stay dirty) when an extended-resource
        assigned pod makes the canonical sums unrepresentable."""
        with obs.tracer.span("ServeRefresh/side_rebuild", tid="serve",
                             pods=len(cluster.pods)):
            try:
                gangs, namespaces = self._scan_side_aggregates(cluster)
            except D.UnsupportedResource:
                self._side_dirty = True
                return False
            R = len(D.CANON_INDEX)
            self._gang_rows = {name: i for i, name in enumerate(gangs)}
            self._ns_rows = {name: i for i, name in enumerate(namespaces)}
            self._side_gpad = bucket_size(max(len(gangs), 1))
            self._side_qpad = bucket_size(max(len(namespaces), 1))
            ga = np.zeros(self._side_gpad, np.int32)
            gg = np.zeros(self._side_gpad, np.int32)
            gs = np.zeros((self._side_gpad, R), np.int64)
            qu = np.zeros((self._side_qpad, R), np.int64)
            qc = np.zeros(self._side_qpad, np.int32)
            for name, (assigned, gated, slack) in gangs.items():
                row = self._gang_rows[name]
                ga[row] = assigned
                gg[row] = gated
                gs[row] = slack
            for name, (used, count) in namespaces.items():
                row = self._ns_rows[name]
                qu[row] = used
                qc[row] = count
            self._side = D.SideTables(
                *D.stage((ga, gg, gs, qu, qc), self._nodes.alloc.device))
            self._side_dirty = False
            return True

    def _side_host(self) -> dict:
        """Host copies of the side tables (small: (G,) and (Q, R))."""
        side = self._side
        return {name: getattr(side, name).cpu().numpy() for name in (
            "gang_assigned", "gang_gated", "gang_slack", "quota_used",
            "ns_assigned")}

    def _side_verify_live(self, cluster) -> bool:
        """Whether the side tables hold state worth verifying."""
        return (self._side is not None and not self._side_dirty
                and bool(cluster.pod_groups or cluster.quotas
                         or self._quota_tracking))

    def _side_divergence(self, gangs: dict, namespaces: dict
                         ) -> Optional[str]:
        """Compare expected sums (a `_scan_side_aggregates` result)
        against the side tables; consumes the dicts."""
        host = self._side_host()
        R = len(D.CANON_INDEX)
        for name, row in self._gang_rows.items():
            exp = gangs.pop(name, None)
            if exp is None:
                exp = [0, 0, np.zeros(R, np.int64)]
            if (int(host["gang_assigned"][row]) != exp[0]
                    or int(host["gang_gated"][row]) != exp[1]
                    or not (host["gang_slack"][row] == exp[2]).all()):
                return "side-gang"
        if gangs:
            return "side-gang"  # expected rows the tables lack
        for name, row in self._ns_rows.items():
            exp = namespaces.pop(name, None)
            if exp is None:
                exp = [np.zeros(R, np.int64), 0]
            if (int(host["ns_assigned"][row]) != exp[1]
                    or not (host["quota_used"][row] == exp[0]).all()):
                return "side-quota"
        if namespaces:
            return "side-quota"
        return None

    def _verify_side(self, cluster) -> Optional[str]:
        """Anti-entropy over the side tables: recompute the sums from the
        store, independent of the deltas, and compare."""
        if not self._side_verify_live(cluster):
            return None
        try:
            gangs, namespaces = self._scan_side_aggregates(cluster)
        except D.UnsupportedResource:
            return None  # the axis-width rule owns this state
        return self._side_divergence(gangs, namespaces)

    # -- anti-entropy ----------------------------------------------------
    def note_fault(self, reason: Optional[str] = None) -> None:
        """Treat a runtime fault as possible corruption of the resident
        state: the next refresh digests it against a fresh snapshot
        before serving from it."""
        self._verify_pending = True
        self.last_fault = reason

    def verify(self, cluster) -> Optional[str]:
        """Anti-entropy: the blake2b digest of the resident node columns'
        canonical bytes (`utils.flightrec.pack_digest`) against the same
        columns of a snapshot built fresh on the host. Returns a
        divergence reason (the caller rebuilds) or None. Reads the
        columns to the host: O(cluster), every `verify_every` refreshes or
        after `note_fault`."""
        with obs.tracer.span("ServeRefresh/verify", tid="serve",
                             staleness=self._staleness):
            self._verify_pending = False
            obs.metrics.inc(obs.ANTIENTROPY_CHECKS)
            if self._nodes is None:
                return None
            fresh, meta = cluster.snapshot([], now_ms=0, pad_nodes=self._npad,
                                           device="cpu")
            reason = None
            if len(meta.index) != len(D.CANON_INDEX):
                reason = "axis-width"
            elif list(meta.node_names) != self._names:
                reason = "row-order"
            elif (pack_digest(self._node_columns(self._nodes))
                  != pack_digest(self._node_columns(fresh.nodes))):
                reason = "column-digest"
            if reason is None:
                reason = self._verify_side(cluster)
            if reason is not None:
                self.antientropy_divergences += 1
                obs.metrics.inc(obs.ANTIENTROPY_DIVERGENCE)
                obs.logger.warning(
                    "serve anti-entropy divergence (%s) after %d delta "
                    "events%s: re-basing", reason, self._staleness,
                    f" (last fault: {self.last_fault})"
                    if self.last_fault else "",
                )
            return reason

    @staticmethod
    def _node_columns(nodes) -> dict:
        return {k: getattr(nodes, k) for k in NODE_COLUMNS}

    # -- checkpoint / restore -------------------------------------------
    #: checkpoint format version (bumped on a layout change; restore
    #: refuses versions it does not know). The layout is the JAX
    #: package's, column for column, so either package reads the other's
    CHECKPOINT_VERSION = 1

    def checkpoint_bytes(self) -> Optional[bytes]:
        """A self-contained npz of the resident columns and the slot and
        interning tables, or None before the first refresh. A process
        killed after writing one resumes serving through
        `restore_checkpoint` without rebuilding the resident base from the
        store. Reads the columns to the host."""
        if self._nodes is None:
            return None
        cols = {k: t.cpu().numpy()
                for k, t in self._node_columns(self._nodes).items()}
        cols["nominated"] = self._nodes.nominated.cpu().numpy()
        header = {
            "version": self.CHECKPOINT_VERSION,
            "npad": self._npad,
            "generation": self._generation,
            "staleness": self._staleness,
            "names": self._names,
            "regions": self._regions,
            "zones": self._zones,
            "node_labels": {k: list(v) for k, v in
                            self._node_labels.items()},
            "tainted": sorted(self._tainted),
        }
        buf = io.BytesIO()
        np.savez(
            buf,
            header=np.frombuffer(
                json.dumps(header, sort_keys=True).encode(), np.uint8
            ),
            **cols,
        )
        return buf.getvalue()

    def save_checkpoint(self, path: str) -> bool:
        """Crash-safe checkpoint write (`obs.atomic_write`: a temporary
        file, then a rename). False when there is no resident base."""
        data = self.checkpoint_bytes()
        if data is None:
            return False
        obs.atomic_write(path, data)
        return True

    def restore_checkpoint(self, source, *, device=None) -> bool:
        """Rebuild the resident base from a checkpoint (`bytes` or a file
        path) on `device` (None = the CUDA card); call it AFTER `attach`.
        The restored state is not trusted blindly: `note_fault` marks it
        for an anti-entropy verify at the next refresh, so a checkpoint
        stale against the live store rebases within one window, while an
        exact one resumes serving with generation continuity and no
        rebase. The side tables are rebuilt lazily at their next use."""
        if isinstance(source, (str, bytes, bytearray)):
            data = source
            if isinstance(source, str):
                with open(source, "rb") as f:
                    data = f.read()
        else:
            raise TypeError(f"checkpoint source {type(source).__name__}")
        device = resolve_device(device)
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("version") != self.CHECKPOINT_VERSION:
                raise ValueError(
                    f"checkpoint version {header.get('version')} != "
                    f"{self.CHECKPOINT_VERSION}"
                )
            names = NODE_COLUMNS + ("nominated",)
            # copies: an npz member reads back read-only, and the refresh
            # adds into the resident columns in place
            columns = D.stage(tuple(np.array(z[k]) for k in names), device)
        self._nodes = NodeState(**dict(zip(names, columns)))
        self._npad = int(header["npad"])
        self._generation = int(header["generation"])
        self._staleness = int(header["staleness"])
        self._names = list(header["names"])
        self._slots = {n: i for i, n in enumerate(self._names)}
        self._regions = list(header["regions"])
        self._zones = list(header["zones"])
        self._regions_in = _Interner(self._regions)
        self._zones_in = _Interner(self._zones)
        self._node_labels = {
            k: tuple(v) for k, v in header["node_labels"].items()
        }
        self._tainted = set(header["tainted"])
        self._side = None
        self._side_dirty = True
        self._gang_rows = {}
        self._ns_rows = {}
        self._quota_tracking = False
        self._base_digest = None
        self._last = None
        self.note_fault("checkpoint-restore")
        self._observe()
        return True

    def _assemble(self, cluster, pending, now_ms: int = 0):
        """The cycle's snapshot: the resident node columns plus the pending
        batch, lowered by the `build_pod_state` the full snapshot uses (so
        the pod tensors are the same). Gang and quota rosters take their
        object columns from `gang_object_tables` / `quota_object_tables`
        (O(G + Q)) and their per-pod sums from the side tables, never from
        a loop over the cluster's pods."""
        with obs.tracer.span("ServeRefresh/assemble", tid="serve",
                             pending=len(pending)):
            return self._assemble_inner(cluster, pending, now_ms)

    def _assemble_inner(self, cluster, pending, now_ms: int = 0):
        device = self._nodes.alloc.device
        P = bucket_size(max(len(pending), 1))
        R = len(D.CANON_INDEX)
        meta = SnapshotMeta(index=D.CANON_INDEX, device=device)
        meta.node_names = list(self._names)
        meta.pod_names = [p.uid for p in pending]
        meta.regions = list(self._regions)
        meta.zones = list(self._zones)
        ns_in = _Interner(meta.namespaces)

        # gangs interned in pod_groups order, build_snapshot's rule
        pod_groups = list(cluster.pod_groups.values())
        gangs_in = _Interner(meta.gang_names)
        gang_pos = {pg.full_name: gangs_in.code(pg.full_name)
                    for pg in pod_groups}
        batch_counts: dict[int, int] = {}

        def gang_of(pod):
            name = pod.pod_group()
            if not name:
                return -1
            g = gang_pos.get(f"{pod.namespace}/{name}", -1)
            if g >= 0:
                batch_counts[g] = batch_counts.get(g, 0) + 1
            return g

        pod_state = build_pod_state(pending, P, D.CANON_INDEX, ns_in,
                                    gang_of, cluster.tlp_prediction,
                                    row_cache=self._row_cache())

        gang_state = quota_state = None
        side = self._side_host() if (pod_groups or cluster.quotas) else None
        if pod_groups:
            G = max(len(gang_pos), 1)
            backed_off = [
                name for name, until in cluster.gang_backoff_until_ms.items()
                if until > now_ms
            ]
            obj = gang_object_tables(pod_groups, gang_pos, D.CANON_INDEX, G,
                                     backed_off)
            assigned = np.zeros(G, np.int32)
            gated = np.zeros(G, np.int32)
            slack = np.zeros((G, R), np.int64)
            for pg in pod_groups:
                row = self._gang_rows.get(pg.full_name)
                if row is None:
                    continue
                g = gang_pos[pg.full_name]
                assigned[g] = side["gang_assigned"][row]
                gated[g] = side["gang_gated"][row]
                slack[g] = side["gang_slack"][row]
            # total = this batch's members + assigned + gated, the three
            # populations build_snapshot's pod loop walks
            total = (assigned + gated).astype(np.int32)
            for g, count in batch_counts.items():
                total[g] += count
            gang_state = GangState(total_members=total, assigned=assigned,
                                   gated=gated, cluster_slack=slack, **obj)
        if cluster.quotas:
            quotas = list(cluster.quotas.values())
            # the fresh interning order: batch namespaces (above), quota
            # namespaces, then assigned-pod namespaces, whose rows are all
            # default, so only the set matters
            for q in quotas:
                ns_in.code(q.namespace)
            for name, row in self._ns_rows.items():
                if side["ns_assigned"][row] > 0:
                    ns_in.code(name)
            Q = max(len(meta.namespaces), 1)
            qmin, qmax, qhas = quota_object_tables(quotas, D.CANON_INDEX,
                                                   ns_in, Q)
            qused = np.zeros((Q, R), np.int64)
            for q in quotas:
                row = self._ns_rows.get(q.namespace)
                if row is not None:
                    qused[ns_in.get(q.namespace)] = side["quota_used"][row]
            nom_req, nom_in_eq, nom_total, nom_batch = empty_quota_nominees(
                R, P)
            quota_state = QuotaState(
                min=qmin, max=qmax, used=qused, has_quota=qhas,
                nom_req=nom_req, nom_in_eq_mask=nom_in_eq,
                nom_total_mask=nom_total, nom_batch_idx=nom_batch,
            )
        snap = ClusterSnapshot(
            nodes=self._nodes,
            pods=_stage_struct(pod_state, device),
            gangs=_stage_struct(gang_state, device),
            quota=_stage_struct(quota_state, device),
        )
        return snap, meta

    def _observe(self) -> None:
        obs.metrics.set_gauge(obs.SERVE_GENERATION, self._generation)
        obs.metrics.set_gauge(obs.SERVE_STALENESS, self._staleness)

    # -- flight recorder ---------------------------------------------------
    def annotate_record(self, rec) -> None:
        """Attach the served cycle's provenance to a flight-recorder
        record: the resident generation, the events since the base, the
        base digest, the refresh's mode and, for a delta refresh, its
        packed batch (plain dicts of arrays, so `unpack_pytree` reads them
        back). The snapshot itself is captured in full, so the record
        replays through the standard path; this block ties it to the
        delta stream that made it."""
        if self._last is None:
            return
        serve = {
            "generation": self._generation,
            "staleness_events": self._staleness,
            "base_digest": self._base_digest,
            "mode": self._last["mode"],
            "events": self._last["events"],
        }
        if self._last["mode"] == "delta":
            packed = {"upserts": self._last["upserts"],
                      "usage": self._last["usage"]}
            if "side" in self._last:
                packed["side"] = self._last["side"]
            serve["deltas"] = flightrec.pack_pytree(packed, rec.blobs)
        rec.manifest["serve"] = serve


def _fields(packed) -> dict:
    """A packed delta batch (`NodeUpserts`, `UsageDeltas`, `SideDeltas`)
    as a dict of its host arrays."""
    return {name: getattr(packed, name) for name in type(packed).__slots__}


def _shift_gather_args(npad: int, slot: int, survivors: int):
    """(gather_idx, valid) for `compact_node_rows`: the rows above `slot`
    shift down one and the freed tail re-pads; `survivors` real rows
    remain."""
    idx = np.empty(npad, np.int64)
    idx[:slot] = np.arange(slot)
    idx[slot:npad - 1] = np.arange(slot + 1, npad)
    idx[npad - 1] = npad - 1
    valid = np.zeros(npad, bool)
    valid[:survivors] = True
    return idx, valid


class StreamingServeEngine(ServeEngine):
    """The serving engine of the pipelined cycle engine
    (`framework.pipeline_cycle.PipelinedCycle`): the base engine's
    exactness contract, with three streaming-ingest upgrades.

    - **Node-delete compaction.** A Node/Delete no longer forces the
      O(cluster) rebase: the resident rows are shift-compacted by one
      gather on the device (`serving.deltas.compact_node_rows`), keeping
      the row order (the store's dict order after the pop) and re-padding
      the freed tail exactly as a fresh snapshot pads. The event stream is
      cut at each delete so slot numbers stay exact within every applied
      batch. The other rebase-class events (a relabel, an extended
      resource, a pod on an unknown node, a sink overflow) rebase as
      before. The region and zone interning tables survive a compaction,
      so deleting the first-seen carrier of a label code can make the next
      anti-entropy digest diverge from a fresh interning: that divergence
      rebases (exact, only slower), never mis-serves.
    - **Usage-vector memo.** `pod_usage_vectors` is cached per pod object
      (a feed upsert replaces the object, so the identity check
      invalidates it); a pod's final unassign releases its entry.
    - **Pod-row memo.** `build_pod_state` runs with a per-pod row cache,
      so a retried pod is lowered once (a hit equals a cold lowering).

    `verify` digests the resident columns against columns accumulated
    straight from the store objects, O(nodes + assigned), instead of a
    fresh snapshot.

    The JAX engine compiles its compaction program at each rebase so the
    first delete pays no trace; eager PyTorch compiles nothing, so there
    is no warm-up here.
    """

    #: a safety valve on the memo tables, not a tuning knob: past this
    #: many entries a cache clears and refills from misses
    MAX_CACHE = 1 << 16

    def __init__(self):
        super().__init__()
        self._vec_cache: dict = {}
        self._rows: dict = {}
        #: node-delete row compactions performed (each one replaces what
        #: the base engine counts as a rebase)
        self.compactions = 0

    # -- memo seams ------------------------------------------------------
    def _row_cache(self):
        if len(self._rows) > self.MAX_CACHE:
            self._rows.clear()
        return self._rows

    def _pod_vectors(self, pod, final=False):
        ent = self._vec_cache.get(pod.uid)
        if ent is not None and ent[0] is pod:
            if final:
                del self._vec_cache[pod.uid]
            return ent[1]
        vecs = D.pod_usage_vectors(pod) + (D.pod_quota_vector(pod),)
        if final:
            self._vec_cache.pop(pod.uid, None)
        else:
            if len(self._vec_cache) > self.MAX_CACHE:
                self._vec_cache.clear()
            self._vec_cache[pod.uid] = (pod, vecs)
        return vecs

    def _rebase_inner(self, cluster, pending, now_ms: int, device):
        out = super()._rebase_inner(cluster, pending, now_ms, device)
        # prime the usage-vector memo for the whole assigned population: a
        # rebase is O(cluster) already, and the first fast verify then runs
        # at memo speed. Prime the real pod objects (never
        # `_assigned_pods`'s copies of reserved pods, which would never hit
        # the identity check)
        try:
            for pod in cluster.pods.values():
                if pod.node_name is not None or pod.uid in cluster.reserved:
                    self._pod_vectors(pod)
        except D.UnsupportedResource:
            pass  # extended resources: verify delegates to the base engine
        return out

    # -- segmented ingest -----------------------------------------------
    def _ingest(self, events):
        """Cut the drained stream at node deletes: classify and apply each
        segment before a delete (slot numbers are exact within a segment;
        a delete renumbers them), compact the deleted row, go on. Returns
        the delete-free tail for the base refresh. With no resident base
        to compact, the base engine's whole-batch classify (a delete
        rebases) runs instead."""
        if self._nodes is None or not any(
                ev[0] == D.NODE_DELETE for ev in events):
            return self._classify(events)
        segment: list = []
        rebase = None
        side_gang: list = []
        side_ns: list = []
        for ev in events:
            if ev[0] == D.NODE_DELETE and rebase is None:
                name = ev[1]
                # apply the segment before the delete FIRST: a node added
                # in this window gets its slot from the segment's upserts,
                # and looking the slot up earlier would skip the delete and
                # leave a ghost row (an add and a remove in one window)
                ups, use, side, rebase = self._classify(segment)
                segment = []
                if rebase is not None:
                    continue  # the resident base is rebuilt anyway
                side_gang.extend(side[0])
                side_ns.extend(side[1])
                if ups or use:
                    self._grow(bucket_size(max(len(self._names), 1)))
                    self._apply_batch(ups, use)
                slot = self._slots.get(name)
                if slot is None:
                    # a node the engine never saw: no resident row, only
                    # the bookkeeping goes
                    self._tainted.discard(name)
                    self._node_labels.pop(name, None)
                    continue
                self._compact_row(name, slot)
                continue
            segment.append(ev)
        ups, use, side, seg_rebase = self._classify(segment)
        side = (side_gang + side[0], side_ns + side[1])
        return ups, use, side, rebase if rebase is not None else seg_rebase

    def _compact_row(self, name: str, slot: int) -> None:
        with obs.tracer.span("ServeRefresh/compact", tid="serve", slot=slot):
            self._tainted.discard(name)
            self._node_labels.pop(name, None)
            idx, valid = _shift_gather_args(self._npad, slot,
                                            len(self._names) - 1)
            self._nodes = D.compact_node_rows(
                self._nodes,
                *D.stage((idx, valid), self._nodes.alloc.device))
            self._names.pop(slot)
            self._slots = {n: i for i, n in enumerate(self._names)}
            if self._gang_rows:
                # a fresh snapshot drops the gang slack of pods bound to a
                # deleted node: rebuild rather than drift
                self._side_dirty = True
            self.compactions += 1
            self._generation += 1
            self._staleness += 1
            self._last = {"mode": "compact", "events": 1}
            self._observe()

    # -- O(nodes + assigned) anti-entropy --------------------------------
    def verify(self, cluster) -> Optional[str]:
        """Anti-entropy without the snapshot rebuild: the expected node
        columns are summed straight from the store objects through the
        same per-pod encode (`pod_usage_vectors`, memoized) and per-node
        encode a fresh snapshot uses, then digest-compared with the
        resident columns (read to the host). The resident columns came
        through the sink and the device; the expectation comes from the
        store, so the check stays independent. An extended resource
        anywhere delegates to the base engine's fresh-snapshot verify."""
        if self._nodes is None:
            self._verify_pending = False
            obs.metrics.inc(obs.ANTIENTROPY_CHECKS)
            return None
        names = list(cluster.nodes)
        expected = side_exp = None
        if names == self._names:
            try:
                expected, side_exp = self._expected_columns(
                    cluster, names,
                    want_side=self._side_verify_live(cluster))
            except D.UnsupportedResource:
                # the axis is wider than the canonical four: the base
                # verify classifies it (one check, one count, one span)
                return super().verify(cluster)
        with obs.tracer.span("ServeRefresh/verify", tid="serve",
                             staleness=self._staleness, fast=True):
            self._verify_pending = False
            obs.metrics.inc(obs.ANTIENTROPY_CHECKS)
            reason = None
            if expected is None:
                reason = "row-order"
            elif (pack_digest(self._node_columns(self._nodes))
                  != pack_digest(expected)):
                reason = "column-digest"
            if reason is None and side_exp is not None:
                reason = self._side_divergence(*side_exp)
            if reason is not None:
                self.antientropy_divergences += 1
                obs.metrics.inc(obs.ANTIENTROPY_DIVERGENCE)
                obs.logger.warning(
                    "serve anti-entropy divergence (%s) after %d delta "
                    "events%s: re-basing", reason, self._staleness,
                    f" (last fault: {self.last_fault})"
                    if self.last_fault else "",
                )
            return reason

    def _expected_columns(self, cluster, names, want_side=False):
        """The node columns a fresh `build_snapshot` at this padding would
        give for the store's nodes in the order `names` (the store's own
        order for a fresh snapshot), summed O(nodes + assigned): the
        per-pod arithmetic is the
        shared `pod_usage_vectors` (its requested pods slot carries 1 a
        pod, so the sums equal the snapshot's pod_count overwrite). With
        `want_side` the same walk also sums the expected gang and quota
        aggregates (`_scan_side_aggregates`' rules). Returns (columns,
        (gangs, namespaces) or None)."""
        R = len(D.CANON_INDEX)
        side_gangs: dict = {}
        side_ns: dict = {}

        def side_gang_acc(name):
            acc = side_gangs.get(name)
            if acc is None:
                acc = side_gangs[name] = [0, 0, np.zeros(R, np.int64)]
            return acc

        def side_assigned(pod, held, req, qreq):
            if self._quota_tracking:
                acc = side_ns.get(pod.namespace)
                if acc is None:
                    acc = side_ns[pod.namespace] = [np.zeros(R, np.int64), 0]
                acc[0] = acc[0] + qreq
                acc[1] += 1
            gang = pod.pod_group()
            if gang:
                acc = side_gang_acc(f"{pod.namespace}/{gang}")
                acc[0] += 1
                if held in cluster.nodes:
                    acc[2] = acc[2] + req

        npad = self._npad
        alloc = np.zeros((npad, R), np.int64)
        capacity = np.zeros((npad, R), np.int64)
        requested = np.zeros((npad, R), np.int64)
        nonzero = np.zeros((npad, R), np.int64)
        limits = np.zeros((npad, R), np.int64)
        mask = np.zeros(npad, bool)
        region = np.full(npad, -1, np.int32)
        zone = np.full(npad, -1, np.int32)
        pod_count = np.zeros(npad, np.int32)
        terminating = np.zeros(npad, np.int32)
        # a fresh first-seen interning in store order (not the engine's
        # surviving tables), which keeps the label-drift check of the
        # fresh-snapshot verify: deleting a code's first-seen carrier
        # diverges here and rebases
        regions: dict = {}
        zones: dict = {}
        node_pos = {}
        for i, name in enumerate(names):
            node = cluster.nodes[name]
            node_pos[name] = i
            alloc[i] = D._encode(node.allocatable)
            capacity[i] = D._encode(node.capacity)
            mask[i] = not node.unschedulable
            if node.region:
                region[i] = regions.setdefault(node.region, len(regions))
            if node.zone:
                zone[i] = zones.setdefault(node.zone, len(zones))

        def count(i, pod, req, nz, lim):
            requested[i] += req
            nonzero[i] += nz
            limits[i] += lim
            pod_count[i] += 1
            if pod.terminating:
                terminating[i] += 1

        # the assigned view on the real pod objects: bound pods at their
        # node, reserved pods at their held node (`Cluster._assigned_pods`
        # without its copies, which would miss the memo's identity check)
        for pod in cluster.pods.values():
            if pod.node_name is None:
                if want_side:
                    # the `gated_pods()` predicate, whatever the
                    # reservation: a reserved gated pod counts gated here
                    # and assigned below, as in a fresh snapshot
                    gang = pod.pod_group()
                    if gang and pod.scheduling_gated and not pod.terminating:
                        side_gang_acc(f"{pod.namespace}/{gang}")[1] += 1
                continue
            i = node_pos.get(pod.node_name)
            if i is None:
                if want_side:
                    # bound to a node the store no longer has: still in
                    # quota used and the gang count (never the slack)
                    req, _nz, _lim, qreq = self._pod_vectors(pod)
                    side_assigned(pod, pod.node_name, req, qreq)
                continue
            req, nz, lim, qreq = self._pod_vectors(pod)
            count(i, pod, req, nz, lim)
            if want_side:
                side_assigned(pod, pod.node_name, req, qreq)
        for uid, node in cluster.reserved.items():
            pod = cluster.pods.get(uid)
            if pod is None or pod.node_name is not None:
                continue
            req, nz, lim, qreq = self._pod_vectors(pod)
            if want_side:
                side_assigned(pod, node, req, qreq)
            i = node_pos.get(node)
            if i is not None:
                count(i, pod, req, nz, lim)
        return {
            "alloc": alloc, "capacity": capacity, "requested": requested,
            "nonzero_requested": nonzero, "limits": limits, "mask": mask, "region": region, "zone": zone,
            "pod_count": pod_count, "terminating": terminating,
        }, ((side_gangs, side_ns) if want_side else None)


def _stage_struct(state, device):
    """A snapshot dataclass of host numpy (PodState, GangState, QuotaState)
    as the same dataclass of tensors on `device`, staged together."""
    if state is None:
        return None
    names = [f for f in state.__dataclass_fields__]
    tensors = D.stage(tuple(getattr(state, f) for f in names), device)
    return type(state)(**dict(zip(names, tensors)))


def _same_device(tensor_device, device) -> bool:
    """`tensor_device` is `device` ("cuda" meaning the current card)."""
    if tensor_device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return tensor_device.index == index
