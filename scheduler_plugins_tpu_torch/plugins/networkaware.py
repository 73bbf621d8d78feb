"""The network-aware plugins (port of
`scheduler_plugins_tpu.plugins.networkaware`): NetworkOverhead
(PreFilter / Filter / Score) and TopologicalSort (QueueSort).

Upstream pkg/networkaware: pods belong to an AppGroup CR (a microservice
DAG with a MaxNetworkCost per dependency); a NetworkTopology CR carries
origin -> destination costs per topology key (region / zone) per weights
profile. The per-node cost-map walk becomes dense gathers over (zone,
region) codes (`ops.network`):

- Filter rejects a node where violated > satisfied dependencies
  (networkoverhead.go:326-359).
- Score is the accumulated cost, normalized inverted (the lowest cost
  wins, networkoverhead.go:362-420: the Peaks transform).
- Pods without an AppGroup workload or without dependencies score equally:
  the Filter passes, the score is 0.

The per-pod hooks share one tally a step: the Filter and the Score of the
same pod against the same carry read the tallies computed once (`_tallies`
memoizes the last pod). TopologicalSort orders pods of the same AppGroup
by their index in AppGroup.Status.TopologyOrder and falls back to upstream
PrioritySort otherwise (topologicalsort.go:102-132), a pairwise comparator
(`queue_compare`).
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops.network import (
    class_dependency_counts,
    class_dependency_tallies,
    dependency_tallies,
    pair_tables,
    placed_commit,
)
from scheduler_plugins_tpu_torch.ops.normalize import peaks_normalize

DEFAULT_WEIGHTS_NAME = "UserDefined"  # defaults.go:232-244
DEFAULT_NETWORK_TOPOLOGY_NAME = "nt-default"


class NetworkOverhead(Plugin):
    name = "NetworkOverhead"
    #: the Filter's tallies read the carried in-cycle placement counts:
    #: the batched solve re-filters every wave (a counting heuristic, not
    #: a resource bound, so no within-wave guard)
    state_dependent_filter = True

    def __init__(self, weights_name: str = DEFAULT_WEIGHTS_NAME,
                 network_topology_name: str = DEFAULT_NETWORK_TOPOLOGY_NAME,
                 namespaces: tuple = ()):
        self.weights_name = weights_name
        self.network_topology_name = network_topology_name
        self.namespaces = namespaces
        self._zone_cost = self._region_cost = None
        self._memo = None

    def events_to_register(self):
        # dependency placements and deletions and CR updates change the
        # tallies (upstream registers none and relies on the default
        # rescan; these are the events the verdict depends on). Pod/Update
        # because the store records a bind as Pod/Update
        return (ev.POD_ADD, ev.POD_UPDATE, ev.POD_DELETE,
                ev.APP_GROUP_ADD, ev.APP_GROUP_UPDATE,
                ev.NETWORK_TOPOLOGY_ADD, ev.NETWORK_TOPOLOGY_UPDATE)

    def prepare_cluster(self, meta, cluster):
        """Lower the NetworkTopology CR's cost lists into dense (ZC, ZC) /
        (RC, RC) int64 matrices on this snapshot's zone / region codes, -1
        for a missing pair (networkoverhead.go:448-497), on
        `meta.device`."""
        ZC = max(len(meta.zones), 1)
        RC = max(len(meta.regions), 1)
        zone_cost = np.full((ZC, ZC), -1, np.int64)
        region_cost = np.full((RC, RC), -1, np.int64)
        nt = None
        if cluster is not None:
            for cand in cluster.network_topologies.values():
                if cand.name == self.network_topology_name:
                    nt = cand
                    break
        if nt is not None:
            weights = nt.weights.get(self.weights_name, {})
            zone_pos = {name: i for i, name in enumerate(meta.zones)}
            region_pos = {name: i for i, name in enumerate(meta.regions)}
            for (orig, dest), cost in weights.get("zone", {}).items():
                if orig in zone_pos and dest in zone_pos:
                    zone_cost[zone_pos[orig], zone_pos[dest]] = cost
            for (orig, dest), cost in weights.get("region", {}).items():
                if orig in region_pos and dest in region_pos:
                    region_cost[region_pos[orig], region_pos[dest]] = cost
        self._zone_cost = torch.as_tensor(zone_cost, device=meta.device)
        self._region_cost = torch.as_tensor(region_cost, device=meta.device)
        self._memo = None

    def aux(self):
        if self._zone_cost is None:
            return None
        return (self._zone_cost, self._region_cost)

    def bind_aux(self, aux):
        self._zone_cost, self._region_cost = aux or (None, None)
        self._memo = None

    def _ready(self, snap) -> bool:
        return snap.network is not None and self._zone_cost is not None

    def _tables(self, snap):
        """The pod-invariant pair tables: the solve's presolve, else built
        for this call."""
        if self._presolve is not None:
            return self._presolve
        return pair_tables(snap.nodes.zone, snap.nodes.region,
                           snap.network.zone_region, self._zone_cost,
                           self._region_cost)

    def prepare_solve(self, snap):
        self._memo = None
        if not self._ready(snap):
            return None
        return pair_tables(snap.nodes.zone, snap.nodes.region,
                           snap.network.zone_region, self._zone_cost,
                           self._region_cost)

    def _placed(self, state, snap):
        if state is not None and state.net_placed is not None:
            return state.net_placed
        return snap.network.placed_node

    def _tallies(self, state, snap, p: int):
        """Pod `p`'s (N,) tallies against the carry; the Filter and Score
        of one step share them (the last pod's are kept, keyed by the very
        snapshot and placement tensors, which the memo holds alive)."""
        placed = self._placed(state, snap)
        memo = self._memo
        if (memo is not None and memo[0] is snap and memo[1] is placed
                and memo[2] == p and memo[3] is self._presolve):
            return memo[4]
        net = snap.network
        out = dependency_tallies(
            net.dep_workload[p], net.dep_max_cost[p], net.dep_mask[p],
            placed, snap.nodes.zone, snap.nodes.region, net.zone_region,
            self._zone_cost, self._region_cost, tables=self._tables(snap),
        )
        self._memo = (snap, placed, p, self._presolve, out)
        return out

    def filter(self, state, snap, p):
        if not self._ready(snap):
            return None
        satisfied, violated, _ = self._tallies(state, snap, p)
        score_equally = ~snap.network.dep_mask[p].any()
        return score_equally | (violated <= satisfied)

    def score(self, state, snap, p):
        if not self._ready(snap):
            return None
        _, _, cost = self._tallies(state, snap, p)
        score_equally = ~snap.network.dep_mask[p].any()
        return torch.where(score_equally, 0, cost)

    # -- the class-collapsed whole-batch rows ----------------------------
    def _class_args(self, state, snap):
        net = snap.network
        return (net.cls_dep_workload, net.cls_dep_max_cost, net.cls_dep_mask,
                self._placed(state, snap), snap.nodes.zone,
                snap.nodes.region, net.zone_region, self._zone_cost,
                self._region_cost)

    @staticmethod
    def _rows_of_classes(net, sat, vio):
        """(P, N) verdicts from the (W, N) class counts, each pod
        gathering its workload's row, and each pod's class and
        score-equally flag."""
        cls = torch.clamp(net.pod_workload, min=0).long()
        # pods without a workload or without dependencies score equally
        score_equally = ~net.dep_mask.any(dim=1) | (net.pod_workload < 0)
        return score_equally[:, None] | (vio <= sat)[cls], cls, score_equally

    def batch_rows(self, state, snap):
        """(P, N) filter verdicts and int32 raw scores from the (W, N)
        class tallies, each pod gathering its workload's row: equal to the
        per-pod hooks row by row, with P / W times less work."""
        if not self._ready(snap):
            return None
        sat, vio, cost = class_dependency_tallies(
            *self._class_args(state, snap), tables=self._tables(snap))
        verdict, cls, score_equally = self._rows_of_classes(
            snap.network, sat, vio)
        return verdict, torch.where(score_equally[:, None], 0, cost[cls])

    def filter_batch(self, state, snap):
        """The verdict half of `batch_rows`, without the cost
        contractions: a re-filtering wave reads no score."""
        if not self._ready(snap):
            return None
        sat, vio = class_dependency_counts(
            *self._class_args(state, snap), tables=self._tables(snap))
        return self._rows_of_classes(snap.network, sat, vio)[0]

    def score_batch(self, state, snap):
        rows = self.batch_rows(state, snap)
        return None if rows is None else rows[1]

    def commit(self, state, snap, p, choice):
        if snap.network is None or state.net_placed is None:
            return state
        return state.replace(net_placed=placed_commit(
            state.net_placed, snap.network.pod_workload[p:p + 1], choice))

    def commit_batch(self, state, snap, placed, choice):
        """The wave's Reserve: the counts are sums, so one accumulation
        over the winners equals any order of `commit`s."""
        if snap.network is None or state.net_placed is None:
            return state
        return state.replace(net_placed=placed_commit(
            state.net_placed, snap.network.pod_workload,
            torch.where(placed, choice, -1)))

    def normalize(self, scores, feasible):
        return peaks_normalize(scores, feasible)


class TopologicalSort(Plugin):
    """QueueSort by AppGroup topology order (topologicalsort.go:102-132)."""

    name = "TopologicalSort"

    def __init__(self, namespaces: tuple = ()):
        self.namespaces = namespaces

    def queue_compare(self, p1, p2, cluster):
        """Pairwise Less(): the same AppGroup compares topology-order
        indices; otherwise (or on a tie) upstream PrioritySort: priority
        descending, then queue time, then uid."""
        ag1, ag2 = p1.app_group(), p2.app_group()
        if (ag1 and ag1 == ag2 and p1.namespace == p2.namespace
                and cluster is not None):
            ag = cluster.app_groups.get(f"{p1.namespace}/{ag1}")
            if ag is not None:
                o1 = ag.topology_order.get(p1.workload_selector(), 0)
                o2 = ag.topology_order.get(p2.workload_selector(), 0)
                if o1 != o2:
                    return -1 if o1 <= o2 else 1
        if p1.priority != p2.priority:
            return -1 if p1.priority > p2.priority else 1
        if p1.creation_ms != p2.creation_ms:
            return -1 if p1.creation_ms < p2.creation_ms else 1
        return -1 if p1.uid < p2.uid else 1
