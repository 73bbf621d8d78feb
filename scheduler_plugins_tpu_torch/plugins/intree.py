"""The in-tree companion plugins (port of `scheduler_plugins_tpu.plugins.intree`):
NodeAffinity, TaintToleration, PodTopologySpread and InterPodAffinity.

These are upstream kube-scheduler plugins (k8s.io/kubernetes
pkg/scheduler/framework/plugins/{nodeaffinity,tainttoleration,
podtopologyspread,interpodaffinity}) that real profiles enable beside the
reference's. All label and taint matching runs on the host at snapshot
build (`state.scheduling.build_scheduling` interns the unique specs and
evaluates each against every node once); the tensor methods are row
gathers and small scatters over the snapshot's tables and the selector
carries (`ops.selectors`).

- NodeAffinity: Filter = nodeSelector AND the required terms (AND the
  profile's addedAffinity); Score = the summed weights of the matching
  preferred terms, default-normalized.
- TaintToleration: Filter = no untolerated NoSchedule/NoExecute taint;
  Score = the untolerated PreferNoSchedule taints, reverse-normalized.
- PodTopologySpread: DoNotSchedule constraints filter (matchNum + self -
  globalMin <= maxSkew over the constraint key's domains), ScheduleAnyway
  ones score (the summed match counts, reverse-normalized); minDomains,
  matchLabelKeys and the node-inclusion policies are honoured.
- InterPodAffinity: required (anti-)affinity and the existing pods'
  anti-affinity (symmetry) filter; preferred terms and the existing
  pods' symmetric terms score, min-max normalized.

Every tensor method works on pod ROWS: a host int `p` reads the one-row
slice `p:p+1` of each per-pod table (a view, no launch), a (S,) int64
tensor reads those rows (the batched solve's `filter_rows`, its
validators' (1,) pod index on the device), so the per-pod, whole-batch and
validator forms are one computation and equal bit for bit. No method
reads a tensor on the host. The Filter and Score of one step share the
spread plugin's constraint state (`_memo`), as the network plugins share
their tallies.
"""

from __future__ import annotations

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops.normalize import (
    default_normalize,
    minmax_normalize,
)
from scheduler_plugins_tpu_torch.ops.selectors import node_column, pod_column

#: PodTopologySpread's "no eligible domain" minimum: the skew check then
#: passes (upstream CriticalPaths stay MaxInt32)
BIG = 1 << 62


def _rows(p):
    """The row selector of pod `p`: a one-row slice for a host int, else
    the (S,) int64 row tensor itself."""
    return slice(p, p + 1) if isinstance(p, int) else p


def _take(table, rows):
    """The `rows` (`_rows`) of a (P, ...) per-pod table, (S, ...)."""
    if isinstance(rows, slice):
        return table[rows]
    return table.index_select(0, rows)


def _all_rows(snap):
    return torch.arange(snap.num_pods, device=snap.device)


class NodeAffinity(Plugin):
    name = "NodeAffinity"

    def events_to_register(self):
        return (ev.NODE_ADD, ev.NODE_UPDATE)

    def __init__(self, added_affinity=None):
        #: NodeAffinityArgs.AddedAffinity (upstream): extra REQUIRED
        #: node-selector terms (OR over the terms) ANDed into every pod's
        #: node affinity, which fences the profile to a node subset.
        #: NodeSelectorTerm objects or their wire form
        #: (`NodeSelectorTerm.from_wire`).
        from scheduler_plugins_tpu_torch.api.objects import NodeSelectorTerm

        self.added_affinity = [
            t if isinstance(t, NodeSelectorTerm)
            else NodeSelectorTerm.from_wire(t)
            for t in added_affinity or []
        ]
        self._added_mask = None

    def prepare_cluster(self, meta, cluster):
        """The (n,) addedAffinity verdict of the snapshot's nodes, on
        `meta.device`; None without addedAffinity (or without a store)."""
        if not self.added_affinity or cluster is None:
            self._added_mask = None
            return
        ok = np.ones(max(len(meta.node_names), 1), bool)
        for i, name in enumerate(meta.node_names):
            node = cluster.nodes.get(name)
            ok[i] = node is not None and any(
                t.matches(node) for t in self.added_affinity
            )
        self._added_mask = torch.as_tensor(ok, device=meta.device)

    def aux(self):
        return self._added_mask

    def bind_aux(self, aux):
        self._added_mask = aux

    def _padded_added(self, snap):
        """The addedAffinity mask over the snapshot's N rows (pad nodes
        fail it), or None."""
        added = self._added_mask
        if added is None:
            return None
        if self._presolve is not None:
            return self._presolve
        padded = torch.zeros(snap.num_nodes, dtype=torch.bool,
                             device=snap.device)
        padded[:added.shape[0]] = added.to(snap.device)
        return padded

    def prepare_solve(self, snap):
        self._presolve = None
        return self._padded_added(snap)

    def _filter_rows(self, snap, rows):
        base = None
        s = snap.scheduling
        if s is not None:
            base = s.node_term_ok.index_select(
                0, _take(s.pod_node_term, rows))
        added = self._padded_added(snap)
        if added is not None:
            base = added[None, :] if base is None else base & added
        return base

    def filter(self, state, snap, p):
        out = self._filter_rows(snap, _rows(p))
        return None if out is None else out[0]

    def filter_batch(self, state, snap):
        out = self._filter_rows(snap, _all_rows(snap))
        if out is None:
            return None
        return out.expand(snap.num_pods, -1)

    def _score_rows(self, snap, rows):
        s = snap.scheduling
        if s is None:
            return None
        return s.pref_score.index_select(0, _take(s.pod_pref, rows))

    def score(self, state, snap, p):
        out = self._score_rows(snap, _rows(p))
        return None if out is None else out[0]

    def score_batch(self, state, snap):
        return self._score_rows(snap, _all_rows(snap))

    def normalize(self, scores, feasible):
        return default_normalize(scores, feasible)


class TaintToleration(Plugin):
    name = "TaintToleration"

    def events_to_register(self):
        return (ev.NODE_ADD, ev.NODE_UPDATE)

    def _rows_of(self, table_name, snap, rows):
        s = snap.scheduling
        if s is None:
            return None
        return getattr(s, table_name).index_select(
            0, _take(s.pod_tol, rows))

    def filter(self, state, snap, p):
        out = self._rows_of("tol_ok", snap, _rows(p))
        return None if out is None else out[0]

    def filter_batch(self, state, snap):
        return self._rows_of("tol_ok", snap, _all_rows(snap))

    def score(self, state, snap, p):
        out = self._rows_of("tol_prefer", snap, _rows(p))
        return None if out is None else out[0]

    def score_batch(self, state, snap):
        return self._rows_of("tol_prefer", snap, _all_rows(snap))

    def normalize(self, scores, feasible):
        # fewer intolerable PreferNoSchedule taints wins
        return default_normalize(scores, feasible, reverse=True)


class PodTopologySpread(Plugin):
    """maxSkew spreading over topology domains.

    Live counts are carried per (track, NODE) (`sel_counts`) when a
    node-inclusion policy excludes a keyed node, else per (track, DOMAIN)
    (`sel_dom_counts`); each pod aggregates them into (CT, D) domain
    counts under its policies. The check per node is then

        matchNum(node) = dc[constraint, domain(node)]
        verdict(node)  = has_key(node)
                         & (matchNum + selfMatch - globalMin <= maxSkew)

    with globalMin the minimum over the constraint's ELIGIBLE domains (0
    when fewer than minDomains exist). DoNotSchedule constraints filter;
    ScheduleAnyway ones score (the summed match counts, fewer = better).
    """

    name = "PodTopologySpread"
    #: the Filter reads the carried counts, and domains SPAN nodes, so the
    #: batched solve also re-checks each wave's winners (`validate_at`)
    state_dependent_filter = True
    step_reads_inputs_only = True

    def __init__(self):
        self._memo = None

    def events_to_register(self):
        return (ev.POD_ADD, ev.POD_UPDATE, ev.POD_DELETE, ev.NODE_ADD,
                ev.NODE_UPDATE)

    def bind_presolve(self, ctx) -> None:
        # the memo holds a snapshot and a carry alive: drop it with the
        # solve that made it
        self._memo = None
        self._presolve = ctx

    @staticmethod
    def _active(snap) -> bool:
        s = snap.scheduling
        return s is not None and s.spread_track is not None

    def _counts(self, state, snap):
        """The carry the constraint state reads: the (TR, N) node counts
        when a policy excludes a keyed node, else the (TR, D) domain
        mirror (the carry, or its snapshot base without one)."""
        s = snap.scheduling
        if s.spread_needs_node_counts:
            if state is not None and state.sel_counts is not None:
                return state.sel_counts
            return s.track_node_base
        if state is not None and state.sel_dom_counts is not None:
            return state.sel_dom_counts
        return s.track_base

    def _constraint_state(self, state, snap, rows):
        """Per-constraint live tensors shared by filter, score and
        validate_at, for the pod `rows`: (S, CT, D) eligible-node domain
        counts, the (S, CT) global minimum (minDomains applied), and the
        (S, CT, N) domain code and key-presence rows.

        Node inclusion mirrors upstream: a node's pods count toward a
        constraint's domains and minimum only when the node carries all the
        pod's constraint keys of the same class, matches the pod's node
        affinity (nodeAffinityPolicy Honor, the default) and tolerates its
        NoSchedule/NoExecute taints (nodeTaintsPolicy Honor). The masks are
        static host rows (`spread_elig`); when no row excludes a keyed node
        (`spread_needs_node_counts` False) the counting equals the domain
        mirror's and this reduces to row gathers. A host-int pod's result
        is kept for the next call on the same carry (`_memo`)."""
        counts = self._counts(state, snap)
        key = rows.start if isinstance(rows, slice) else None
        memo = self._memo
        if (key is not None and memo is not None and memo[0] is snap
                and memo[1] is counts and memo[2] == key):
            return memo[3]
        s = snap.scheduling
        topo = _take(s.spread_topo, rows)  # (S, CT)
        code = s.topo_code[topo]  # (S, CT, N)
        has = s.topo_has[topo]
        track = _take(s.spread_track, rows)
        if s.spread_needs_node_counts:
            dcn = counts[track]  # (S, CT, N)
            elig = s.spread_elig[_take(s.spread_elig_idx, rows)] & (code >= 0)
            S, CT, _ = code.shape
            D = s.domain_exists.shape[1]
            col = torch.clamp(code, min=0)
            dc = torch.zeros((S, CT, D), dtype=counts.dtype,
                             device=counts.device).scatter_add(
                2, col, torch.where(elig, dcn, 0))
            exists = torch.zeros((S, CT, D), dtype=torch.uint8,
                                 device=counts.device).scatter_reduce(
                2, col, elig.view(torch.uint8), "amax").view(torch.bool)
        else:
            dc = counts[track]  # (S, CT, D)
            exists = s.domain_exists[topo]
        # no eligible domain -> the minimum stays BIG and the skew check
        # passes trivially
        minm = torch.where(exists, dc, BIG).amin(dim=2)  # (S, CT)
        # minDomains (upstream minMatchNum): fewer eligible domains than
        # required -> the global minimum counts as 0
        dn = exists.sum(dim=2)
        md = _take(s.spread_min_domains, rows)
        minm = torch.where((md > 0) & (dn < md), 0, minm)
        out = (dc, minm, code, has)
        if key is not None:
            self._memo = (snap, counts, key, out)
        return out

    def _filter_rows(self, state, snap, rows):
        s = snap.scheduling
        dc, minm, code, has = self._constraint_state(state, snap, rows)
        match_at = dc.gather(2, torch.clamp(code, min=0))  # (S, CT, N)
        selfm = _take(s.spread_self, rows).to(torch.int64)
        ok = (match_at + (selfm - minm)[..., None]
              <= _take(s.spread_max_skew, rows)[..., None])
        applies = (_take(s.spread_mask, rows)
                   & _take(s.spread_hard, rows))[..., None]
        # a node missing a DoNotSchedule constraint's key is
        # unschedulable (upstream PreFilter node filtering)
        return torch.where(applies, has & ok, True).all(dim=1)

    def _score_rows(self, state, snap, rows):
        s = snap.scheduling
        dc, _, code, has = self._constraint_state(state, snap, rows)
        match_at = dc.gather(2, torch.clamp(code, min=0))
        applies = (_take(s.spread_mask, rows)
                   & ~_take(s.spread_hard, rows))[..., None] & has
        return torch.where(applies, match_at, 0).sum(dim=1)

    def filter(self, state, snap, p):
        if not self._active(snap):
            return None
        return self._filter_rows(state, snap, _rows(p))[0]

    def filter_batch(self, state, snap):
        if not self._active(snap):
            return None
        return self._filter_rows(state, snap, _all_rows(snap))

    def filter_rows(self, state, snap, idx):
        if not self._active(snap):
            return None
        return self._filter_rows(state, snap, idx)

    def score(self, state, snap, p):
        if not self._active(snap):
            return None
        return self._score_rows(state, snap, _rows(p))[0]

    def score_batch(self, state, snap):
        if not self._active(snap):
            return None
        return self._score_rows(state, snap, _all_rows(snap))

    def normalize(self, scores, feasible):
        # fewer matching pods in the node's domains = better spread
        return default_normalize(scores, feasible, reverse=True)

    def validate_at(self, state, snap, p, node):
        """The hard constraints of pod `p` ((1,) int64) at `node` ((1,)
        int64) against the live carry: (1,) bool."""
        if not self._active(snap):
            return torch.ones(1, dtype=torch.bool, device=p.device)
        s = snap.scheduling
        dc, minm, code, has = self._constraint_state(state, snap, p)
        code_n = node_column(code[0], node)  # (CT, 1)
        has_n = node_column(has[0], node)[:, 0]
        match_at = dc[0].gather(1, torch.clamp(code_n, min=0))[:, 0]
        selfm = _take(s.spread_self, p)[0].to(torch.int64)
        ok = match_at + selfm - minm[0] <= _take(s.spread_max_skew, p)[0]
        applies = _take(s.spread_mask, p)[0] & _take(s.spread_hard, p)[0]
        return torch.where(applies, has_n & ok, True).all(
            dim=0, keepdim=True)


class InterPodAffinity(Plugin):
    """Required and preferred pod (anti-)affinity over topology domains.

    The selector matching is host-precomputed into the track tables
    (`state.scheduling`); the live (TR, D) counts and (E, D) anti-domain
    bits are carried through the solve, so in-cycle placements are seen
    exactly as the reference's one-pod-per-cycle loop sees them. Per (pod,
    node):

    - a required affinity term: the node has the key AND (a matching pod
      is in the node's domain OR nobody matches cluster-wide and the pod
      matches its own term: the upstream first-pod escape);
    - the pod's own required anti term: no matching pod in the domain;
    - SYMMETRY: the node's domain hosts no pod CARRYING a required anti
      term whose selector matches the incoming pod;
    - preferred terms score weight x domain match count (anti negative),
      plus the existing pods' symmetric terms that match the incoming pod
      (their preferred ±weights, their required terms at
      `hard_pod_affinity_weight`), from the live `sym_counts`; min-max
      normalized.
    """

    name = "InterPodAffinity"
    state_dependent_filter = True

    def events_to_register(self):
        return (ev.POD_ADD, ev.POD_UPDATE, ev.POD_DELETE, ev.NODE_ADD,
                ev.NODE_UPDATE, ev.NAMESPACE_ADD, ev.NAMESPACE_UPDATE)

    def __init__(self, hard_pod_affinity_weight: int = 1,
                 ignore_preferred_terms_of_existing_pods: bool = False):
        if not 0 <= hard_pod_affinity_weight <= 100:
            raise ValueError(
                "hardPodAffinityWeight must be in [0, 100], got "
                f"{hard_pod_affinity_weight}"
            )
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.ignore_preferred = ignore_preferred_terms_of_existing_pods

    def static_key(self):
        return (self.hard_pod_affinity_weight, self.ignore_preferred)

    def _counts(self, state, snap):
        """(TR, D) domain-level counts: affinity has no node-inclusion
        policy, so it reads the domain mirror."""
        if state is not None and state.sel_dom_counts is not None:
            return state.sel_dom_counts
        return snap.scheduling.track_base

    def _anti_domains(self, state, snap):
        if state is not None and state.anti_domains is not None:
            return state.anti_domains
        return snap.scheduling.exist_anti_base

    def _sym_counts(self, state, snap):
        if state is not None and state.sym_counts is not None:
            return state.sym_counts
        return snap.scheduling.sym_base

    def prepare_solve(self, snap):
        """The pod-invariant code rows of the existing terms: (E, N) of
        the anti terms, (E2, N) of the symmetric score terms, and the
        (E2,) effective symmetric weights."""
        s = snap.scheduling
        if s is None or s.aff_track is None:
            return None
        return self._invariants(s)

    def _invariants(self, s) -> dict:
        out = {}
        if s.exist_anti_sel is not None:
            out["anti_code"] = s.topo_code[s.exist_anti_topo]
        if s.sym_sel is not None:
            out["sym_code"] = s.topo_code[s.sym_topo]
            out["sym_w"] = torch.where(
                s.sym_hard, self.hard_pod_affinity_weight * s.sym_weight,
                0 if self.ignore_preferred else s.sym_weight)
        return out

    def _inv(self, s) -> dict:
        return (self._presolve if self._presolve is not None
                else self._invariants(s))

    def _filter_rows(self, state, snap, rows):
        s = snap.scheduling
        counts = self._counts(state, snap)
        # required affinity
        topo = _take(s.aff_topo, rows)  # (S, AT)
        code = s.topo_code[topo]  # (S, AT, N)
        has = s.topo_has[topo]
        dc = counts[_take(s.aff_track, rows)]  # (S, AT, D)
        total = torch.where(s.domain_exists[topo], dc, 0).sum(dim=2)
        match_at = dc.gather(2, torch.clamp(code, min=0))
        ok = has & ((match_at > 0) | (
            (total == 0) & _take(s.aff_self, rows))[..., None])
        verdict = torch.where(_take(s.aff_mask, rows)[..., None], ok,
                              True).all(dim=1)
        # the incoming pod's own required anti terms
        topob = _take(s.anti_topo, rows)
        codeb = s.topo_code[topob]
        dcb = counts[_take(s.anti_track, rows)]
        match_b = dcb.gather(2, torch.clamp(codeb, min=0))
        okb = ~s.topo_has[topob] | (match_b == 0)
        verdict = verdict & torch.where(
            _take(s.anti_mask, rows)[..., None], okb, True).all(dim=1)
        # symmetry: carriers of matching anti terms block their domain
        if s.exist_anti_sel is not None:
            codee = self._inv(s)["anti_code"]  # (E, N)
            blocked = (self._anti_domains(state, snap).gather(
                1, torch.clamp(codee, min=0)) & (codee >= 0))
            m = pod_column(s.exist_anti_match, rows)  # (E, S)
            verdict = verdict & ~(m[:, :, None] & blocked[:, None, :]).any(
                dim=0)
        return verdict

    def filter(self, state, snap, p):
        s = snap.scheduling
        if s is None or s.aff_track is None:
            return None
        return self._filter_rows(state, snap, _rows(p))[0]

    def filter_batch(self, state, snap):
        s = snap.scheduling
        if s is None or s.aff_track is None:
            return None
        return self._filter_rows(state, snap, _all_rows(snap))

    def filter_rows(self, state, snap, idx):
        s = snap.scheduling
        if s is None or s.aff_track is None:
            return None
        return self._filter_rows(state, snap, idx)

    def _own_score(self, state, snap, rows):
        """(S, N) the incoming pods' own preferred terms."""
        s = snap.scheduling
        topo = _take(s.waff_topo, rows)
        code = s.topo_code[topo]  # (S, WT, N)
        dc = self._counts(state, snap)[_take(s.waff_track, rows)]
        match_at = dc.gather(2, torch.clamp(code, min=0))
        contrib = torch.where(
            _take(s.waff_mask, rows)[..., None] & s.topo_has[topo],
            _take(s.waff_weight, rows)[..., None] * match_at, 0)
        return contrib.sum(dim=1)

    def _sym_at(self, state, snap):
        """(E2, N) the existing terms' weighted carrier counts at each
        node's domain (0 where the node lacks the key)."""
        s = snap.scheduling
        inv = self._inv(s)
        codee = inv["sym_code"]
        at = self._sym_counts(state, snap).gather(
            1, torch.clamp(codee, min=0))
        return torch.where(codee >= 0, inv["sym_w"][:, None] * at, 0)

    def score(self, state, snap, p):
        s = snap.scheduling
        if s is None or s.waff_track is None:
            return None
        rows = _rows(p)
        total = self._own_score(state, snap, rows)[0]
        if s.sym_sel is not None:
            m = pod_column(s.pend_match, rows)[s.sym_sel]  # (E2, 1)
            total = total + torch.where(m, self._sym_at(state, snap),
                                        0).sum(dim=0)
        return total

    def score_batch(self, state, snap):
        """(P, N) `score` of every pod. The symmetric part contracts the
        (P, E2) matches with the (E2, N) weighted counts in float64:
        exact, every partial sum an integer far below 2^53."""
        s = snap.scheduling
        if s is None or s.waff_track is None:
            return None
        total = self._own_score(state, snap, _all_rows(snap))
        if s.sym_sel is not None:
            m = s.pend_match[s.sym_sel].T.to(torch.float64)  # (P, E2)
            total = total + (m @ self._sym_at(state, snap).to(
                torch.float64)).to(torch.int64)
        return total

    def normalize(self, scores, feasible):
        return minmax_normalize(scores, feasible)

    def validate_at(self, state, snap, p, node):
        """The hard constraints of pod `p` ((1,) int64) at `node` ((1,)
        int64) against the live carry: (1,) bool, a few gathers."""
        s = snap.scheduling
        if s is None or s.aff_track is None:
            return torch.ones(1, dtype=torch.bool, device=p.device)
        counts = self._counts(state, snap)
        code_n = node_column(s.topo_code, node)  # (K, 1)
        has_n = node_column(s.topo_has, node)
        topo = _take(s.aff_topo, p)[0]  # (AT,)
        dc = counts[_take(s.aff_track, p)[0]]  # (AT, D)
        total = torch.where(s.domain_exists[topo], dc, 0).sum(dim=1)
        code = code_n[topo]  # (AT, 1)
        match_at = dc.gather(1, torch.clamp(code, min=0))[:, 0]
        aff_ok = has_n[topo][:, 0] & (
            (match_at > 0) | ((total == 0) & _take(s.aff_self, p)[0]))
        ok = torch.where(_take(s.aff_mask, p)[0], aff_ok, True).all(
            dim=0, keepdim=True)

        topob = _take(s.anti_topo, p)[0]
        dcb = counts[_take(s.anti_track, p)[0]]
        match_b = dcb.gather(1, torch.clamp(code_n[topob], min=0))[:, 0]
        okb = ~has_n[topob][:, 0] | (match_b == 0)
        ok = ok & torch.where(_take(s.anti_mask, p)[0], okb, True).all(
            dim=0, keepdim=True)

        if s.exist_anti_sel is not None:
            codee = code_n[s.exist_anti_topo]  # (E, 1)
            blocked = (self._anti_domains(state, snap).gather(
                1, torch.clamp(codee, min=0)) & (codee >= 0))
            m = pod_column(s.exist_anti_match, p)  # (E, 1)
            ok = ok & ~(m & blocked).any(dim=0)
        return ok
