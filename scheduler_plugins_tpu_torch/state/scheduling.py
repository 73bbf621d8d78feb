"""In-tree scheduling-spec tables (port of `scheduler_plugins_tpu.state.scheduling`):
taints and tolerations, node affinity, and the pod-label selector and
topology-domain counts of topology spread and inter-pod affinity.

Label and taint matching is string work, so it runs on the host once a
snapshot, as in the JAX package:

- each pod's node-filter spec (nodeSelector + required node affinity),
  preferred terms and toleration set are interned into a few UNIQUE
  specs (replicas share them), each evaluated against every node once,
  and the solve gets dense lookup tables:

      node_term_ok  (T+1, N) bool   required-affinity verdict per spec
      pref_score    (U+1, N) int64  summed weights of matching preferred terms
      tol_ok        (T2, N) bool    no untolerated NoSchedule/NoExecute taint
      tol_prefer    (T2, N) int64   untolerated PreferNoSchedule taint count

  so a pod's Filter and Score are one row gather;

- the pod-label selectors of spread constraints and affinity terms are
  interned into S unique (namespace scope, selector) groups and the
  topology keys into K codes; matching ASSIGNED pods are counted per
  (track, node) and per (track, domain) on the host (`track_node_base`,
  `track_base`), and `pend_match` records which PENDING pods match each
  group, so the solve carries live counts through its placements
  (`SolverState.sel_counts` / `sel_dom_counts`, `ops.selectors`).

Row T (pad row) of `node_term_ok` is all-true: pods with no node
constraint index it. `pref_score` row U is all-zero. Toleration sets
always index a real row (the empty set tolerates nothing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from scheduler_plugins_tpu_torch.api.objects import (
    LabelSelector,
    LabelSelectorRequirement,
    Node,
    Pod,
)
from scheduler_plugins_tpu_torch.state.snapshot import _Tensors

I64 = np.int64
#: the index and code tables: int64 in the port, where torch's `gather`
#: and `scatter` take int64 indices (int32 in the JAX package; the values
#: are the same)
IDX = np.int64

#: The static scheduling-table bases with a live `SolverState` carry
#: (path from the snapshot root -> carry field): the selector and
#: topology-domain counts seeded on the host and then carried through the
#: solve's placements. A solve reads the carry, never the base, once the
#: carry exists.
TRACK_CARRY_COUNTERPARTS = {
    ".scheduling.track_node_base": "sel_counts",
    ".scheduling.track_base": "sel_dom_counts",
    ".scheduling.exist_anti_base": "anti_domains",
    ".scheduling.sym_base": "sym_counts",
}


@dataclass
class SchedulingState(_Tensors):
    """Dense lookup tables for the in-tree companion plugins (host numpy
    at build, device tensors after `to`)."""

    node_term_ok: np.ndarray  # (T+1, N) bool
    pod_node_term: np.ndarray  # (P,) int64 row index (T = unconstrained)
    pref_score: np.ndarray  # (U+1, N) int64
    pod_pref: np.ndarray  # (P,) int64 row index (U = no preferences)
    tol_ok: np.ndarray  # (T2, N) bool
    tol_prefer: np.ndarray  # (T2, N) int64
    pod_tol: np.ndarray  # (P,) int64 row index
    # --- selector/topology-domain counting (spread + inter-pod affinity);
    # None when no pending pod carries such constraints. A "track" is a
    # unique (selector group, topology key) pair; live counts are carried
    # per (track, domain) — (TR, D) — so the per-pod checks and per-
    # placement commits are O(constraints x domains), never O(N) ----------
    pend_match: Optional[np.ndarray] = None  # (S, P) bool pod in sel group
    topo_code: Optional[np.ndarray] = None  # (K, N) int64 domain code (-1)
    topo_has: Optional[np.ndarray] = None  # (K, N) bool key present
    domain_exists: Optional[np.ndarray] = None  # (K, D) bool
    track_sel: Optional[np.ndarray] = None  # (TR,) int64 selector group
    track_topo: Optional[np.ndarray] = None  # (TR,) int64 key code
    #: (TR, N) int64 matching ASSIGNED pods per NODE. Node-level (not
    #: domain-level) so PodTopologySpread's nodeAffinityPolicy /
    #: nodeTaintsPolicy can exclude ineligible nodes' pods per (pod,
    #: constraint) at aggregation time.
    track_node_base: Optional[np.ndarray] = None
    #: (TR, D) the same counts per topology domain (nodes with the key
    #: only) — InterPodAffinity's O(1)-gather view
    track_base: Optional[np.ndarray] = None
    # per-pod spread constraints, padded to CT
    spread_track: Optional[np.ndarray] = None  # (P, CT) int64 track index
    spread_topo: Optional[np.ndarray] = None  # (P, CT) int64 key code
    spread_max_skew: Optional[np.ndarray] = None  # (P, CT) int64
    spread_hard: Optional[np.ndarray] = None  # (P, CT) bool DoNotSchedule
    spread_self: Optional[np.ndarray] = None  # (P, CT) bool pod matches own sel
    spread_mask: Optional[np.ndarray] = None  # (P, CT) bool
    #: (P, CT) int64 minDomains (0 = unset): when fewer ELIGIBLE domains
    #: than this exist, the global minimum is treated as 0 (upstream
    #: podtopologyspread minMatchNum)
    spread_min_domains: Optional[np.ndarray] = None
    #: (P, CT) bool nodeAffinityPolicy == Honor: only nodes matching the
    #: pod's nodeSelector/required affinity count toward domains/minimum
    spread_policy_affinity: Optional[np.ndarray] = None
    #: (P, CT) bool nodeTaintsPolicy == Honor: only nodes whose
    #: NoSchedule/NoExecute taints the pod tolerates count
    spread_policy_taints: Optional[np.ndarray] = None
    #: (EL, N) bool interned node-eligibility rows (class-keys x policies),
    #: fully static -> precomputed host-side; (P, CT) row index
    spread_elig: Optional[np.ndarray] = None
    spread_elig_idx: Optional[np.ndarray] = None
    #: a host bool, never moved to the device: True only when some (pod,
    #: constraint) eligibility row actually excludes a node that carries
    #: the constraint's key. False -> the spread plugin reads the O(1)
    #: (TR, D) domain mirror and the (TR, N) node carry is not materialized
    spread_needs_node_counts: bool = False
    # per-pod inter-pod affinity terms, padded to AT/BT/WT. `*_self` marks
    # the upstream first-pod special case: the term matches the incoming
    # pod itself, so an otherwise-empty cluster does not deadlock.
    aff_track: Optional[np.ndarray] = None  # (P, AT) int64 required affinity
    aff_topo: Optional[np.ndarray] = None  # (P, AT) int64 key code
    aff_self: Optional[np.ndarray] = None  # (P, AT) bool
    aff_mask: Optional[np.ndarray] = None  # (P, AT) bool
    anti_track: Optional[np.ndarray] = None  # (P, BT) int64 required anti
    anti_topo: Optional[np.ndarray] = None  # (P, BT) int64
    anti_mask: Optional[np.ndarray] = None  # (P, BT) bool
    # preferred (anti-)affinity terms: weighted domain-count scoring
    waff_track: Optional[np.ndarray] = None  # (P, WT) int64
    waff_topo: Optional[np.ndarray] = None  # (P, WT) int64
    waff_weight: Optional[np.ndarray] = None  # (P, WT) int64 (negative=anti)
    waff_mask: Optional[np.ndarray] = None  # (P, WT) bool
    # EXISTING pods' required anti-affinity (symmetry): an incoming pod
    # matching group `exist_anti_sel[e]` is blocked on nodes whose domain
    # (under `exist_anti_topo[e]`) hosts a pod carrying term e. Domain
    # presence is carried live (`SolverState.anti_domains`) because pending
    # pods' own anti terms join E and their placements create new blocks.
    exist_anti_sel: Optional[np.ndarray] = None  # (E,) int64 selector group
    exist_anti_topo: Optional[np.ndarray] = None  # (E,) int64 key code
    exist_anti_base: Optional[np.ndarray] = None  # (E, D) bool assigned
    #: (E, P) which pending pods carry term e (their placement marks the
    #: domain) — identity, not selector match
    exist_anti_carrier: Optional[np.ndarray] = None
    #: (E, P) which pending pods MATCH term e's selector (they get blocked)
    exist_anti_match: Optional[np.ndarray] = None
    # Symmetric SCORE terms (upstream interpodaffinity PreScore): each
    # existing pod's preferred (anti-)affinity terms add +-weight, and its
    # REQUIRED affinity terms add HardPodAffinityWeight, to every node in
    # the existing pod's domain when the term's selector matches the
    # INCOMING pod. E2 axis = unique (selector, key, weight, hard) tuples.
    sym_sel: Optional[np.ndarray] = None  # (E2,) int64 selector group
    sym_topo: Optional[np.ndarray] = None  # (E2,) int64 key code
    sym_weight: Optional[np.ndarray] = None  # (E2,) int64 (+-w; hard rows 1)
    sym_hard: Optional[np.ndarray] = None  # (E2,) bool required-term rows
    sym_base: Optional[np.ndarray] = None  # (E2, D) int64 carrier counts
    #: (E2, P) how many of pending pod q's terms are row e2 — q's
    #: placement adds that many carriers to its domain
    sym_carrier: Optional[np.ndarray] = None


def _node_filter_key(pod: Pod):
    return (
        tuple(sorted(pod.node_selector.items())),
        tuple(
            (
                tuple(
                    (r.key, r.operator, tuple(r.values))
                    for r in term.match_expressions
                ),
                tuple(
                    (r.key, r.operator, tuple(r.values))
                    for r in term.match_fields
                ),
            )
            for term in pod.node_affinity_required
        ),
    )


def _pref_key(pod: Pod):
    return tuple(
        (
            t.weight,
            tuple(
                (r.key, r.operator, tuple(r.values))
                for r in t.preference.match_expressions
            ),
            tuple(
                (r.key, r.operator, tuple(r.values))
                for r in t.preference.match_fields
            ),
        )
        for t in pod.node_affinity_preferred
    )


def _tol_key(pod: Pod):
    return tuple(
        sorted(
            (t.key, t.operator, t.value, t.effect) for t in pod.tolerations
        )
    )


def _node_filter_matches(pod: Pod, node: Node) -> bool:
    """spec.nodeSelector AND (OR over required affinity terms) — upstream
    component-helpers nodeaffinity.GetRequiredNodeAffinity semantics."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    if pod.node_affinity_required:
        return any(t.matches(node) for t in pod.node_affinity_required)
    return True


def _has_selector_specs(pending, assigned) -> bool:
    # assigned pods' terms matter too: required anti (symmetry blocks) and
    # preferred/required affinity (symmetric score toward incoming pods)
    return any(
        p.topology_spread
        or p.pod_affinity_required
        or p.pod_anti_affinity_required
        or p.pod_affinity_preferred
        or p.pod_anti_affinity_preferred
        for p in pending
    ) or any(
        p.pod_anti_affinity_required
        or p.pod_affinity_required
        or p.pod_affinity_preferred
        or p.pod_anti_affinity_preferred
        for p in assigned
    )


def relevant(nodes, pending, assigned=()) -> bool:
    """Whether any spec exists that makes the tables non-trivial."""
    return (
        any(n.taints for n in nodes)
        or any(
            p.node_selector
            or p.node_affinity_required
            or p.node_affinity_preferred
            for p in pending
        )
        or _has_selector_specs(pending, assigned)
    )


def build_scheduling(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    N: int,
    P: int,
    assigned: Sequence[Pod] = (),
    namespaces: Sequence = (),
) -> Optional[SchedulingState]:
    """Lower specs into `SchedulingState`; None when nothing is relevant.
    `namespaces` are the cluster's Namespace objects — the
    PodAffinityTerm.namespaceSelector targets."""
    if not relevant(nodes, pending, assigned):
        return None

    term_rows: dict = {}
    pref_rows: dict = {}
    tol_rows: dict = {}
    pod_node_term = np.zeros(P, IDX)
    pod_pref = np.zeros(P, IDX)
    pod_tol = np.zeros(P, IDX)
    term_pods: list[Pod] = []
    pref_pods: list[Pod] = []
    tol_pods: list[Pod] = []
    for i, pod in enumerate(pending):
        if pod.node_selector or pod.node_affinity_required:
            k = _node_filter_key(pod)
            if k not in term_rows:
                term_rows[k] = len(term_rows)
                term_pods.append(pod)
            pod_node_term[i] = term_rows[k]
        else:
            pod_node_term[i] = -1  # remapped to the all-true pad row below
        if pod.node_affinity_preferred:
            k = _pref_key(pod)
            if k not in pref_rows:
                pref_rows[k] = len(pref_rows)
                pref_pods.append(pod)
            pod_pref[i] = pref_rows[k]
        else:
            pod_pref[i] = -1
        k = _tol_key(pod)
        if k not in tol_rows:
            tol_rows[k] = len(tol_rows)
            tol_pods.append(pod)
        pod_tol[i] = tol_rows[k]

    T, U, T2 = len(term_rows), len(pref_rows), max(len(tol_rows), 1)
    node_term_ok = np.zeros((T + 1, N), bool)
    node_term_ok[T] = True  # unconstrained row
    pref_score = np.zeros((U + 1, N), I64)
    tol_ok = np.ones((T2, N), bool)
    tol_prefer = np.zeros((T2, N), I64)

    for t, pod in enumerate(term_pods):
        for n, node in enumerate(nodes):
            node_term_ok[t, n] = _node_filter_matches(pod, node)
    for u, pod in enumerate(pref_pods):
        for n, node in enumerate(nodes):
            pref_score[u, n] = sum(
                t.weight
                for t in pod.node_affinity_preferred
                if t.preference.matches(node)
            )
    for s, pod in enumerate(tol_pods):
        for n, node in enumerate(nodes):
            for taint in node.taints:
                if any(t.tolerates(taint) for t in pod.tolerations):
                    continue
                if taint.effect in ("NoSchedule", "NoExecute"):
                    tol_ok[s, n] = False
                elif taint.effect == "PreferNoSchedule":
                    tol_prefer[s, n] += 1

    return SchedulingState(
        node_term_ok=node_term_ok,
        pod_node_term=np.where(pod_node_term < 0, T, pod_node_term).astype(IDX),
        pref_score=pref_score,
        pod_pref=np.where(pod_pref < 0, U, pod_pref).astype(IDX),
        tol_ok=tol_ok,
        tol_prefer=tol_prefer,
        pod_tol=pod_tol,
        **_build_selector_tables(
            nodes, pending, assigned, N, P, namespaces,
            pod_aff_rows=node_term_ok[
                np.where(pod_node_term < 0, T, pod_node_term)
            ],
            pod_tol_rows=tol_ok[pod_tol],
        ),
    )


def _merged_spread_selector(pod: Pod, tsc):
    """matchLabelKeys (upstream podtopologyspread): the incoming pod's
    values for the listed keys are appended to the selector as exact-match
    requirements; keys the pod lacks are ignored; a nil selector stays nil
    (matches nothing)."""
    sel = tsc.label_selector
    if sel is None or not tsc.match_label_keys:
        return sel
    extra = [
        k for k in tsc.match_label_keys if k in pod.labels
    ]
    if not extra:
        return sel
    return LabelSelector(
        match_labels=dict(sel.match_labels),
        match_expressions=list(sel.match_expressions)
        + [
            LabelSelectorRequirement(k, "In", (pod.labels[k],))
            for k in extra
        ],
    )


def _term_scope(pod: Pod, term, namespaces) -> tuple:
    """Effective namespace scope of a PodAffinityTerm: the explicit list
    plus namespaces matching namespaceSelector (EMPTY selector matches
    every namespace -> the "*" wildcard scope). The own-namespace fallback
    applies ONLY when the list is empty AND the selector is nil — a
    non-nil selector matching zero namespaces yields an empty scope that
    matches nothing (upstream GetNamespaceLabelsSnapshot semantics)."""
    scope = set(term.namespaces)
    sel = getattr(term, "namespace_selector", None)
    if sel is not None:
        if not sel.match_labels and not sel.match_expressions:
            return ("*",)
        scope.update(ns.name for ns in namespaces if sel.matches(ns.labels))
    elif not scope:
        scope = {pod.namespace}
    return tuple(sorted(scope))


def _build_selector_tables(
    nodes, pending, assigned, N, P, namespaces=(),
    pod_aff_rows=None, pod_tol_rows=None,
) -> dict:
    """Selector-group / topology-domain / track tables for PodTopologySpread
    and InterPodAffinity: a track = unique (selector group, topology key)
    pair; assigned pods aggregate into per-(track, domain) base counts;
    existing/pending required anti-affinity terms form the E axis."""
    if not _has_selector_specs(pending, assigned):
        return {}

    sels: dict = {}  # (ns scope, selector key) -> index
    sel_objs: list = []  # (ns tuple, LabelSelector-or-None)
    keys: dict = {}  # topology key -> index
    key_names: list[str] = []
    tracks: dict = {}  # (sel idx, key idx) -> track index

    def sel_id(ns_scope: tuple, selector) -> int:
        k = (ns_scope, None if selector is None else selector._key())
        if k not in sels:
            sels[k] = len(sels)
            sel_objs.append((ns_scope, selector))
        return sels[k]

    def key_id(name: str) -> int:
        if name not in keys:
            keys[name] = len(keys)
            key_names.append(name)
        return keys[name]

    def track_id(s: int, k: int) -> int:
        if (s, k) not in tracks:
            tracks[(s, k)] = len(tracks)
        return tracks[(s, k)]

    def term_ids(pod: Pod, term) -> tuple[int, int, int]:
        """(sel, key, track) for a PodAffinityTerm scoped to the pod."""
        scope = _term_scope(pod, term, namespaces)
        s = sel_id(scope, term.label_selector)
        k = key_id(term.topology_key)
        return s, k, track_id(s, k)

    CT = max((len(p.topology_spread) for p in pending), default=1) or 1
    spread_track = np.zeros((P, CT), IDX)
    spread_topo = np.zeros((P, CT), IDX)
    spread_max_skew = np.zeros((P, CT), I64)
    spread_hard = np.zeros((P, CT), bool)
    spread_self = np.zeros((P, CT), bool)
    spread_mask = np.zeros((P, CT), bool)
    spread_min_domains = np.zeros((P, CT), I64)
    spread_policy_affinity = np.zeros((P, CT), bool)
    spread_policy_taints = np.zeros((P, CT), bool)
    for i, pod in enumerate(pending):
        for c, tsc in enumerate(pod.topology_spread):
            sel = _merged_spread_selector(pod, tsc)
            s = sel_id((pod.namespace,), sel)
            k = key_id(tsc.topology_key)
            spread_track[i, c] = track_id(s, k)
            spread_topo[i, c] = k
            spread_max_skew[i, c] = tsc.max_skew
            spread_hard[i, c] = tsc.when_unsatisfiable == "DoNotSchedule"
            spread_self[i, c] = _sel_matches(sel, (pod.namespace,), pod)
            spread_mask[i, c] = True
            spread_min_domains[i, c] = tsc.min_domains or 0
            spread_policy_affinity[i, c] = (
                tsc.node_affinity_policy != "Ignore"
            )
            spread_policy_taints[i, c] = tsc.node_taints_policy == "Honor"

    # inter-pod affinity terms (incoming pod's own)
    AT = max((len(p.pod_affinity_required) for p in pending), default=1) or 1
    BT = (
        max((len(p.pod_anti_affinity_required) for p in pending), default=1)
        or 1
    )
    WT = (
        max(
            (
                len(p.pod_affinity_preferred)
                + len(p.pod_anti_affinity_preferred)
                for p in pending
            ),
            default=1,
        )
        or 1
    )
    aff_track = np.zeros((P, AT), IDX)
    aff_topo = np.zeros((P, AT), IDX)
    aff_self = np.zeros((P, AT), bool)
    aff_mask = np.zeros((P, AT), bool)
    anti_track = np.zeros((P, BT), IDX)
    anti_topo = np.zeros((P, BT), IDX)
    anti_mask = np.zeros((P, BT), bool)
    waff_track = np.zeros((P, WT), IDX)
    waff_topo = np.zeros((P, WT), IDX)
    waff_weight = np.zeros((P, WT), I64)
    waff_mask = np.zeros((P, WT), bool)
    # E axis: unique required anti-affinity (selector, key) pairs carried by
    # assigned OR pending pods (symmetry: carriers block matching pods)
    anti_terms: dict = {}  # (sel, key) -> e index

    def anti_term_id(s: int, k: int) -> int:
        if (s, k) not in anti_terms:
            anti_terms[(s, k)] = len(anti_terms)
        return anti_terms[(s, k)]

    pend_carriers: list[list[int]] = []  # per e, pending carrier indices
    for i, pod in enumerate(pending):
        for c, term in enumerate(pod.pod_affinity_required):
            s, k, t = term_ids(pod, term)
            aff_track[i, c] = t
            aff_topo[i, c] = k
            aff_self[i, c] = _sel_matches(
                term.label_selector, _term_scope(pod, term, namespaces), pod
            )
            aff_mask[i, c] = True
        for c, term in enumerate(pod.pod_anti_affinity_required):
            s, k, t = term_ids(pod, term)
            anti_track[i, c] = t
            anti_topo[i, c] = k
            anti_mask[i, c] = True
            e = anti_term_id(s, k)
            while len(pend_carriers) <= e:
                pend_carriers.append([])
            pend_carriers[e].append(i)
        w = 0
        for wt in pod.pod_affinity_preferred:
            s, k, t = term_ids(pod, wt.term)
            waff_track[i, w] = t
            waff_topo[i, w] = k
            waff_weight[i, w] = wt.weight
            waff_mask[i, w] = True
            w += 1
        for wt in pod.pod_anti_affinity_preferred:
            s, k, t = term_ids(pod, wt.term)
            waff_track[i, w] = t
            waff_topo[i, w] = k
            waff_weight[i, w] = -wt.weight
            waff_mask[i, w] = True
            w += 1

    # assigned pods' anti terms join E; remember who carries each term
    assigned_carrier_terms: list[tuple[Pod, int]] = []
    for pod in assigned:
        for term in pod.pod_anti_affinity_required:
            scope = _term_scope(pod, term, namespaces)
            s = sel_id(scope, term.label_selector)
            k = key_id(term.topology_key)
            e = anti_term_id(s, k)
            while len(pend_carriers) <= e:
                pend_carriers.append([])
            assigned_carrier_terms.append((pod, e))

    # --- symmetric score terms (E2 axis) --------------------------------
    sym_terms: dict = {}  # (sel, key, weight, hard) -> e2
    sym_rows: list = []

    def sym_id(sel: int, k: int, weight: int, hard: bool) -> int:
        key = (sel, k, weight, hard)
        if key not in sym_terms:
            sym_terms[key] = len(sym_rows)
            sym_rows.append(key)
        return sym_terms[key]

    def pod_sym_terms(pod: Pod):
        """(e2, count) pairs for one pod's score-symmetric terms."""
        out_counts: dict = {}
        for wt in pod.pod_affinity_preferred:
            s2 = sel_id(_term_scope(pod, wt.term, namespaces),
                        wt.term.label_selector)
            e2 = sym_id(s2, key_id(wt.term.topology_key), wt.weight, False)
            out_counts[e2] = out_counts.get(e2, 0) + 1
        for wt in pod.pod_anti_affinity_preferred:
            s2 = sel_id(_term_scope(pod, wt.term, namespaces),
                        wt.term.label_selector)
            e2 = sym_id(s2, key_id(wt.term.topology_key), -wt.weight, False)
            out_counts[e2] = out_counts.get(e2, 0) + 1
        for term in pod.pod_affinity_required:
            s2 = sel_id(_term_scope(pod, term, namespaces),
                        term.label_selector)
            e2 = sym_id(s2, key_id(term.topology_key), 1, True)
            out_counts[e2] = out_counts.get(e2, 0) + 1
        return out_counts

    assigned_sym: list[tuple[str, int, int]] = []  # (node name, e2, count)
    for pod in assigned:
        terms = pod_sym_terms(pod)
        if terms and pod.node_name is not None:
            assigned_sym.extend(
                (pod.node_name, e2, c) for e2, c in terms.items()
            )
    pending_sym: list[tuple[int, int, int]] = []  # (pod idx, e2, count)
    for i, pod in enumerate(pending):
        for e2, c in pod_sym_terms(pod).items():
            pending_sym.append((i, e2, c))

    S, K = len(sel_objs), max(len(key_names), 1)
    # topology domain codes per key (value interned per key)
    topo_code = np.full((K, N), -1, IDX)
    topo_has = np.zeros((K, N), bool)
    domain_values: list[dict] = [dict() for _ in range(K)]
    for k, name in enumerate(key_names):
        for n, node in enumerate(nodes):
            val = node.labels.get(name)
            if val is None:
                continue
            dv = domain_values[k]
            if val not in dv:
                dv[val] = len(dv)
            topo_code[k, n] = dv[val]
            topo_has[k, n] = True
    D = max((len(dv) for dv in domain_values), default=1) or 1
    domain_exists = np.zeros((K, D), bool)
    for k, dv in enumerate(domain_values):
        for code in dv.values():
            domain_exists[k, code] = True

    # --- static spread node-eligibility rows (upstream node-inclusion:
    # per-class all-keys presence, nodeAffinityPolicy, nodeTaintsPolicy).
    # Interned: replicas share rows; the common all-true row is index 0.
    elig_rows: dict = {}
    elig_list: list = []
    spread_elig_idx = np.zeros((P, CT), IDX)
    needs_node_counts = False

    def elig_intern(row: np.ndarray) -> int:
        key = row.tobytes()
        if key not in elig_rows:
            elig_rows[key] = len(elig_list)
            elig_list.append(row)
        return elig_rows[key]

    elig_intern(np.ones(N, bool))  # row 0: no exclusions
    any_taints = any(n.taints for n in nodes)
    for i, pod in enumerate(pending):
        if not pod.topology_spread:
            continue
        class_keys = {True: [], False: []}
        for tsc in pod.topology_spread:
            class_keys[tsc.when_unsatisfiable == "DoNotSchedule"].append(
                keys[tsc.topology_key]
            )
        for c, tsc in enumerate(pod.topology_spread):
            row = np.ones(N, bool)
            hard = tsc.when_unsatisfiable == "DoNotSchedule"
            for k in class_keys[hard]:
                row &= topo_has[k]
            if spread_policy_affinity[i, c] and (
                pod.node_selector or pod.node_affinity_required
            ):
                # reuse the interned node-affinity verdict row
                row &= pod_aff_rows[i]
            if spread_policy_taints[i, c] and any_taints:
                # reuse the interned untolerated-taint row
                row &= pod_tol_rows[i]
            spread_elig_idx[i, c] = elig_intern(row)
            k = keys[tsc.topology_key]
            if np.any(~row & (topo_code[k] >= 0)):
                needs_node_counts = True
    spread_elig = np.stack(elig_list)

    TR = max(len(tracks), 1)
    track_sel = np.zeros(TR, IDX)
    track_topo = np.zeros(TR, IDX)
    for (s, k), t in tracks.items():
        track_sel[t] = s
        track_topo[t] = k

    node_pos = {node.name: n for n, node in enumerate(nodes)}
    track_node_base = np.zeros((TR, N), I64)
    track_base = np.zeros((TR, D), I64)
    for pod in assigned:
        n = node_pos.get(pod.node_name)
        if n is None:
            continue
        for (s, k), t in tracks.items():
            ns, selector = sel_objs[s]
            if _sel_matches(selector, ns, pod):
                track_node_base[t, n] += 1
                code = topo_code[k, n]
                if code >= 0:
                    track_base[t, code] += 1
    pend_match = np.zeros((S, P), bool)
    for i, pod in enumerate(pending):
        for s, (ns, selector) in enumerate(sel_objs):
            pend_match[s, i] = _sel_matches(selector, ns, pod)

    out = dict(
        pend_match=pend_match,
        topo_code=topo_code,
        topo_has=topo_has,
        domain_exists=domain_exists,
        track_sel=track_sel,
        track_topo=track_topo,
        track_node_base=track_node_base if needs_node_counts else None,
        track_base=track_base,
        spread_track=spread_track,
        spread_topo=spread_topo,
        spread_max_skew=spread_max_skew,
        spread_hard=spread_hard,
        spread_self=spread_self,
        spread_mask=spread_mask,
        spread_min_domains=spread_min_domains,
        spread_policy_affinity=spread_policy_affinity,
        spread_policy_taints=spread_policy_taints,
        spread_elig=spread_elig,
        spread_elig_idx=spread_elig_idx,
        spread_needs_node_counts=needs_node_counts,
        aff_track=aff_track,
        aff_topo=aff_topo,
        aff_self=aff_self,
        aff_mask=aff_mask,
        anti_track=anti_track,
        anti_topo=anti_topo,
        anti_mask=anti_mask,
        waff_track=waff_track,
        waff_topo=waff_topo,
        waff_weight=waff_weight,
        waff_mask=waff_mask,
    )

    if anti_terms:
        E = len(anti_terms)
        exist_anti_sel = np.zeros(E, IDX)
        exist_anti_topo = np.zeros(E, IDX)
        for (s, k), e in anti_terms.items():
            exist_anti_sel[e] = s
            exist_anti_topo[e] = k
        exist_anti_base = np.zeros((E, D), bool)
        for pod, e in assigned_carrier_terms:
            n = node_pos.get(pod.node_name)
            if n is None:
                continue
            code = topo_code[exist_anti_topo[e], n]
            if code >= 0:
                exist_anti_base[e, code] = True
        exist_anti_carrier = np.zeros((E, P), bool)
        for e, carriers in enumerate(pend_carriers):
            for i in carriers:
                exist_anti_carrier[e, i] = True
        exist_anti_match = np.zeros((E, P), bool)
        for e in range(E):
            exist_anti_match[e] = pend_match[exist_anti_sel[e]]
        out.update(
            exist_anti_sel=exist_anti_sel,
            exist_anti_topo=exist_anti_topo,
            exist_anti_base=exist_anti_base,
            exist_anti_carrier=exist_anti_carrier,
            exist_anti_match=exist_anti_match,
        )
    if sym_rows:
        E2 = len(sym_rows)
        sym_sel = np.zeros(E2, IDX)
        sym_topo = np.zeros(E2, IDX)
        sym_weight = np.zeros(E2, I64)
        sym_hard = np.zeros(E2, bool)
        for e2, (s2, k, w, hard) in enumerate(sym_rows):
            sym_sel[e2], sym_topo[e2] = s2, k
            sym_weight[e2], sym_hard[e2] = w, hard
        sym_base = np.zeros((E2, D), I64)
        for node_name, e2, cnt in assigned_sym:
            n = node_pos.get(node_name)
            if n is None:
                continue
            code = topo_code[sym_topo[e2], n]
            if code >= 0:
                sym_base[e2, code] += cnt
        sym_carrier = np.zeros((E2, P), I64)
        for i, e2, cnt in pending_sym:
            sym_carrier[e2, i] = cnt
        out.update(
            sym_sel=sym_sel,
            sym_topo=sym_topo,
            sym_weight=sym_weight,
            sym_hard=sym_hard,
            sym_base=sym_base,
            sym_carrier=sym_carrier,
        )
    return out


def _sel_matches(selector, ns_scope, pod: Pod) -> bool:
    """Namespace-scoped label-selector match (metav1: a nil selector matches
    nothing; an empty selector matches everything). `ns_scope` is a str or
    a tuple of namespaces (PodAffinityTerm.namespaces)."""
    if isinstance(ns_scope, str):
        ns_scope = (ns_scope,)
    if "*" not in ns_scope and pod.namespace not in ns_scope:
        return False
    if selector is None:
        return False
    return selector.matches(pod.labels)
