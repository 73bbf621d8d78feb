"""Preemption engine, the PostFilter tier (port of
`scheduler_plugins_tpu.framework.preemption`).

Mirrors the upstream preemption evaluator driving plugin-specific victim
rules (SURVEY.md §3.3):

- `DEFAULT` mode: victims are lower-priority pods (upstream
  DefaultPreemption).
- `CAPACITY` mode: ElasticQuota borrow rules (capacity_scheduling.go:
  486-677): a preemptor whose quota would stay over Min preys on
  same-namespace lower-priority pods; a preemptor within its guaranteed Min
  preys on other namespaces' pods whose quota is over Min; a preemptor
  outside any quota preys on lower-priority pods outside any quota. The
  post-removal quota gates (own Max, aggregate Min) apply, and the reprieve
  loop re-checks them.

The dry run is host numpy, exact: every node's free capacity plus the
eligible victims' demand at once, then the reprieve per sampled candidate
node, ranked by the upstream pickOneNode criteria (fewest
PodDisruptionBudget violations, lowest highest victim priority, lowest
priority sum, fewest victims, lowest index). The reprieve tries the
PDB-violating victims first (`partition_pdb_violations`, over the store's
`pdbs`). It reads the snapshot through `host_view`: each column it needs
copied to the host once per preemption pass, never per preemptor.

`CROSS_NODE` mode and preemption toleration come with the plugins that
select them (CrossNodePreemption, PreemptionToleration).
"""

from __future__ import annotations

import enum
import random
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np

from scheduler_plugins_tpu_torch.api.objects import Pod
from scheduler_plugins_tpu_torch.api.resources import PODS
from scheduler_plugins_tpu_torch.ops.quota import nominee_contribution


def encode_demand(index, pod: Pod):
    """Pod demand vector with the pods slot set to 1 (the host-side analog
    of `ops.fit.pod_fit_demand`)."""
    vec = index.encode(pod.effective_request())
    vec[index.position(PODS)] = 1
    return vec


class PreemptionMode(enum.Enum):
    DEFAULT = "Default"
    CAPACITY = "CapacityScheduling"
    CROSS_NODE = "CrossNodePreemption"


#: sentinel: the preemptor is currently INELIGIBLE (PodEligibleToPreemptOthers
#: said no: terminations in flight on its nominated node); distinct from
#: None ("eligible but no viable candidates") so callers keep the nomination
GATED = object()


@dataclass
class PreemptionResult:
    nominated_node: str
    victims: list[str]  # uids, most important first


def host_view(snap):
    """Host copies of the snapshot columns the dry run reads: nodes'
    alloc, requested and mask, and the quota's has_quota, used, min and
    max (None without quotas). One copy per column; the engine reads
    these, never the device tensors."""
    def host(x):
        return x.cpu().numpy()

    quota = None
    if snap.quota is not None:
        q = snap.quota
        quota = SimpleNamespace(
            has_quota=host(q.has_quota), used=host(q.used), min=host(q.min),
            max=host(q.max),
        )
    nodes = snap.nodes
    return SimpleNamespace(
        nodes=SimpleNamespace(alloc=host(nodes.alloc),
                              requested=host(nodes.requested),
                              mask=host(nodes.mask)),
        quota=quota,
    )


class PreemptionEngine:
    #: upstream DefaultPreemptionArgs defaults: candidates = clamp(
    #: numNodes*pct/100, >= absolute, <= numNodes)
    #: (preemption_toleration.go:306-331 calculateNumCandidates)
    DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE = 10
    DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE = 100

    def __init__(self, mode: PreemptionMode = PreemptionMode.DEFAULT,
                 toleration: bool = False,
                 min_candidate_nodes_percentage: Optional[int] = None,
                 min_candidate_nodes_absolute: Optional[int] = None):
        if mode == PreemptionMode.CROSS_NODE:
            raise NotImplementedError(
                "CrossNodePreemption mode comes with the CrossNodePreemption "
                "plugin's slice"
            )
        if toleration:
            raise NotImplementedError(
                "preemption toleration comes with the PreemptionToleration "
                "plugin's slice (PriorityClass objects in the store)"
            )
        self.mode = mode
        pct, absolute = self.validate_sampling_args(
            min_candidate_nodes_percentage, min_candidate_nodes_absolute
        )
        self.min_candidate_nodes_percentage = pct
        self.min_candidate_nodes_absolute = absolute
        # seed 0, one stream per engine, drawn across cycles: snapshot ->
        # decision stays reproducible, where upstream uses rand.Int31n
        self._candidate_rng = random.Random(0)

    # -- candidate sampling ----------------------------------------------------
    @classmethod
    def validate_sampling_args(cls, pct, absolute):
        """Upstream ValidateDefaultPreemptionArgs: pct in [0, 100],
        absolute >= 0, and the pair must yield a positive candidate count.
        Returns the defaulted (pct, absolute)."""
        if pct is None:
            pct = cls.DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE
        if absolute is None:
            absolute = cls.DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE
        if not 0 <= pct <= 100:
            raise ValueError(
                f"minCandidateNodesPercentage must be in [0, 100], got {pct}"
            )
        if absolute < 0:
            raise ValueError(
                f"minCandidateNodesAbsolute must be >= 0, got {absolute}"
            )
        if pct == 0 and absolute == 0:
            raise ValueError(
                "minCandidateNodesPercentage and minCandidateNodesAbsolute "
                "cannot both be zero"
            )
        return pct, absolute

    def calculate_num_candidates(self, num_nodes: int) -> int:
        """calculateNumCandidates (preemption_toleration.go:318-331) over
        the candidate pool size: max(n*pct/100, absolute) capped at n."""
        n = (num_nodes * self.min_candidate_nodes_percentage) // 100
        if n < self.min_candidate_nodes_absolute:
            n = self.min_candidate_nodes_absolute
        if n > num_nodes:
            n = num_nodes
        return n

    def sample_candidates(self, fits):
        """GetOffsetAndNumCandidates (preemption_toleration.go:306-309): a
        random offset into the feasible pool, then a circular scan over it.
        Returns (rotated_pool, num_candidates); the caller counts only
        victim-producing candidates toward the cap."""
        pool = np.nonzero(fits)[0]
        if pool.size == 0:
            return pool, 0
        want = self.calculate_num_candidates(int(pool.size))
        offset = self._candidate_rng.randrange(int(pool.size))
        return pool[(np.arange(pool.size) + offset) % pool.size], want

    # -- preemptor eligibility ---------------------------------------------
    @staticmethod
    def _quota_view(view, meta, preemptor, nom_aggs=None):
        """(ns_codes, has_q, used, more_than_min, over_min) for the
        eligibility checks. `more_than_min` folds the same-namespace
        nominee aggregate like usedOverMinWith (capacity_scheduling.go:
        560)."""
        quota = view.quota
        ns_codes = {ns: i for i, ns in enumerate(meta.namespaces)}
        has_q = quota.has_quota
        used = quota.used
        qmin = quota.min
        over_min = np.any(used > qmin, axis=1)
        more_than_min = False
        p_ns = ns_codes.get(preemptor.namespace, -1)
        if p_ns >= 0 and has_q[p_ns]:
            req = meta.index.encode(preemptor.effective_request())
            in_eq_agg = nom_aggs[0] if nom_aggs is not None else 0
            more_than_min = bool(
                np.any(used[p_ns] + req + in_eq_agg > qmin[p_ns])
            )
        return ns_codes, has_q, used, more_than_min, over_min

    def pod_eligible(self, cluster, preemptor: Pod, snap, meta,
                     nom_aggs=None, scheduler=None, view=None) -> bool:
        """PodEligibleToPreemptOthers: a pod that already preempted must
        not preempt again while pods it could benefit from are still
        terminating on its nominated node (capacity_scheduling.go:409-484;
        upstream DefaultPreemption for the DEFAULT mode)."""
        if preemptor.preemption_policy == "Never":
            return False
        view = view or host_view(snap)
        nom = preemptor.nominated_node_name
        if not nom or nom not in cluster.nodes or nom not in meta.node_names:
            return True
        nom_idx = meta.node_names.index(nom)
        # upstream escape (capacity_scheduling.go:427-430): only a
        # nominated node that became unresolvable (cordoned or gone) frees
        # the pod to preempt elsewhere
        if not bool(view.nodes.mask[nom_idx]):
            return True
        on_node = [p for p in cluster.pods.values() if p.node_name == nom]
        if self.mode == PreemptionMode.CAPACITY and view.quota is not None:
            ns_codes, has_q, _, more_than_min, over_min = self._quota_view(
                view, meta, preemptor, nom_aggs
            )

            def ns_has_q(ns):
                i = ns_codes.get(ns, -1)
                return i >= 0 and bool(has_q[i])

            p_ns = ns_codes.get(preemptor.namespace, -1)
            if p_ns >= 0 and has_q[p_ns]:
                for p in on_node:
                    if not p.terminating or not ns_has_q(p.namespace):
                        continue
                    if (p.namespace == preemptor.namespace
                            and p.priority < preemptor.priority):
                        return False
                    if (p.namespace != preemptor.namespace
                            and not more_than_min
                            and bool(over_min[ns_codes[p.namespace]])):
                        return False
            else:
                # a preemptor outside any quota: only terminating pods
                # outside any quota count
                for p in on_node:
                    if ns_has_q(p.namespace):
                        continue
                    if p.terminating and p.priority < preemptor.priority:
                        return False
        else:
            for p in on_node:
                if p.terminating and p.priority < preemptor.priority:
                    return False
        return True

    # -- victim eligibility ----------------------------------------------------
    def _eligible(self, victims, preemptor, view, meta, nom_aggs=None):
        """(V,) bool victim eligibility per mode."""
        pri = np.array([v.priority for v in victims])
        same_ns = np.array(
            [v.namespace == preemptor.namespace for v in victims]
        )
        lower = pri < preemptor.priority
        if self.mode == PreemptionMode.CAPACITY and view.quota is not None:
            ns_codes, has_q, _, more_than_min, over_min = self._quota_view(
                view, meta, preemptor, nom_aggs
            )
            v_ns = np.array([ns_codes.get(v.namespace, -1) for v in victims])
            v_has_q = (v_ns >= 0) & has_q[np.maximum(v_ns, 0)]
            p_ns = ns_codes.get(preemptor.namespace, -1)
            if p_ns >= 0 and bool(has_q[p_ns]):
                if more_than_min:
                    return v_has_q & same_ns & lower
                v_over = (v_ns >= 0) & over_min[np.maximum(v_ns, 0)]
                return v_has_q & ~same_ns & v_over
            return ~v_has_q & lower
        return lower

    @staticmethod
    def _nominated_aggregates(cluster, preemptor, view, meta):
        """(in_eq, total) request vectors of OTHER nominated pods from the
        live store, so nominations made earlier in this pass count once;
        classified by `ops.quota.nominee_contribution` as the snapshot
        builder does. Resource names outside this snapshot's axis are
        dropped."""
        R = len(meta.index)
        in_eq = np.zeros(R, np.int64)
        total = np.zeros(R, np.int64)
        if view.quota is None:
            return in_eq, total
        ns_codes = {ns: i for i, ns in enumerate(meta.namespaces)}
        has_q = view.quota.has_quota
        over_min = np.any(view.quota.used > view.quota.min, axis=1)
        for m in cluster.pods.values():
            if (m.uid == preemptor.uid or m.nominated_node_name is None
                    or m.node_name is not None):
                continue
            m_ns = ns_codes.get(m.namespace, -1)
            if m_ns < 0 or not has_q[m_ns]:
                continue
            req_m = meta.index.encode({
                name: qty for name, qty in m.effective_request().items()
                if name in meta.index
            })
            counts_in_eq, counts_total = nominee_contribution(
                m.namespace == preemptor.namespace, m.priority,
                preemptor.priority, bool(over_min[m_ns]),
            )
            if counts_in_eq:
                in_eq += req_m
            if counts_total:
                total += req_m
        return in_eq, total

    # -- main ------------------------------------------------------------------
    def preempt(self, cluster, scheduler, preemptor: Pod, snap, meta,
                now_ms: int, extra_reserved=None, view=None):
        """Returns a PreemptionResult, None (no viable candidates), or the
        GATED sentinel (terminations in flight on the nominated node:
        callers keep the nomination). `view` is `host_view(snap)`, made
        once per pass by the caller (made here when not given)."""
        del now_ms  # read by preemption toleration only
        if preemptor.preemption_policy == "Never":
            return None
        view = view or host_view(snap)
        nom_aggs = (
            self._nominated_aggregates(cluster, preemptor, view, meta)
            if self.mode == PreemptionMode.CAPACITY and view.quota is not None
            else None
        )
        if not self.pod_eligible(cluster, preemptor, snap, meta, nom_aggs,
                                 scheduler, view=view):
            return GATED

        victims_all = [
            p for p in cluster.pods.values()
            if p.node_name is not None and not p.terminating
        ]
        if not victims_all:
            return None
        node_pos = {name: i for i, name in enumerate(meta.node_names)}
        v_node = np.array([node_pos.get(v.node_name, -1) for v in victims_all])
        keep = v_node >= 0
        victims_all = [v for v, k in zip(victims_all, keep) if k]
        if not victims_all:
            return None
        v_node = v_node[keep]

        index = meta.index
        R = len(index)
        N = len(meta.node_names)
        v_req = np.zeros((len(victims_all), R), np.int64)
        for i, v in enumerate(victims_all):
            v_req[i] = index.encode(v.effective_request())
            v_req[i, index.position(PODS)] = 1
        v_pri = np.array([v.priority for v in victims_all])

        eligible = self._eligible(victims_all, preemptor, view, meta,
                                  nom_aggs)
        if not eligible.any():
            return None

        # dry run over every node at once: free + eligible victims' demand
        free = (view.nodes.alloc - view.nodes.requested)[:N]
        if extra_reserved is not None:
            # earlier preemptors' nominations this pass hold capacity
            free = free - extra_reserved[:N]
        removed = np.zeros((N, R), np.int64)
        np.add.at(removed, v_node[eligible], v_req[eligible])
        demand = encode_demand(index, preemptor)
        node_mask = view.nodes.mask[:N]
        fits = np.all(free + removed >= demand[None, :], axis=1) & node_mask
        has_victims = np.zeros(N, bool)
        has_victims[v_node[eligible]] = True
        fits &= has_victims  # nodes without victims are unresolvable
        if self.mode == PreemptionMode.CAPACITY and view.quota is not None:
            fits &= self._quota_gate(victims_all, v_node, eligible,
                                     preemptor, view, meta, N)
        if not fits.any():
            return None

        # the exact reprieve per sampled candidate, ranked by the final
        # victim sets (pickOneNode)
        rotation, want = self.sample_candidates(fits)
        pdbs = list(cluster.pdbs.values())
        # plugin Filter chain for the preemptor (upstream
        # RunFilterPluginsWithNominatedPods) against the POST-EVICTION
        # state: upstream removes the victims from the NodeInfo before the
        # chain and re-runs it as reprievePod re-adds each one, so a
        # filter reading pod-derived side tables (the network placement
        # counts) must not see pods about to be evicted. The NRT cache
        # view stays as it is (`Cluster.post_eviction_tables`)
        has_filters = (scheduler is not None
                       and preemptor.uid in meta.pod_names)
        p_idx = meta.pod_names.index(preemptor.uid) if has_filters else -1
        uids_by_node: dict[int, list] = {}
        for i in np.nonzero(eligible)[0]:
            uids_by_node.setdefault(int(v_node[i]), []).append(
                victims_all[i].uid)
        # the verdict row of each evicted set, memoized for this dry run:
        # the reprieve re-adds victims one at a time, so sets repeat
        # across candidate nodes
        verdict_cache: dict[frozenset, np.ndarray] = {}
        best = None
        produced = 0
        for n in rotation:
            if produced >= want:
                break
            filter_ok = None
            if has_filters:
                def filter_ok(evicted, _n=int(n)):
                    return self._filters_pass(
                        cluster, scheduler, snap, meta, p_idx, evicted, _n,
                        verdict_cache)

                if not filter_ok(frozenset(uids_by_node.get(int(n), []))):
                    continue
            final, violations = self._reprieve(
                victims_all, v_node, v_req, v_pri, eligible, int(n),
                free[int(n)], demand, preemptor, view, meta, pdbs, nom_aggs,
                filter_ok=filter_ok,
            )
            if not final:
                continue
            produced += 1
            stats = (
                violations,
                max(v.priority for v in final),
                sum(v.priority for v in final),
                len(final),
                int(n),
            )
            if best is None or stats < best[0]:
                best = (stats, int(n), final)
        if best is None:
            return None
        _, chosen, final_victims = best
        return PreemptionResult(
            nominated_node=meta.node_names[chosen],
            victims=[v.uid for v in final_victims],
        )

    def _filters_pass(self, cluster, scheduler, snap, meta, p_idx,
                      evicted_uids, n, verdict_cache) -> bool:
        """The plugin Filter verdict for the preemptor (pending row
        `p_idx`) on candidate node `n` with `evicted_uids` evicted (the
        pod-derived tables only, `Cluster.post_eviction_tables`). The (N,)
        row depends only on (snapshot, row, evicted set), so it is
        memoized in `verdict_cache` by the frozen set. Without a network
        or in-tree scheduling table eviction cannot change a verdict, so
        every set shares the empty key and the row is computed once per
        preemptor."""
        key = (frozenset(evicted_uids)
               if snap.network is not None or snap.scheduling is not None
               else frozenset())
        if key not in verdict_cache:
            hyp = snap
            if key:
                hyp = cluster.post_eviction_tables(snap, meta, key)
            verdict_cache[key] = scheduler.filter_verdicts(
                hyp, p_idx).cpu().numpy()
        return bool(verdict_cache[key][n])

    def _quota_gate(self, victims, v_node, eligible, preemptor, view, meta,
                    N):
        """(N,) post-removal gates: own used+req <= Max and aggregate
        used+req <= aggregate Min (capacity_scheduling.go:612-618)."""
        quota = view.quota
        used, qmin, qmax, has_q = quota.used, quota.min, quota.max, \
            quota.has_quota
        ns_codes = {ns: i for i, ns in enumerate(meta.namespaces)}
        p_ns = ns_codes.get(preemptor.namespace, -1)
        if p_ns < 0 or not has_q[p_ns]:
            return np.ones(N, bool)
        req = meta.index.encode(preemptor.effective_request())
        R = used.shape[1]
        # two per-node sums: removed usage of the preemptor's namespace
        # (own Max) and of every quota namespace (aggregate Min)
        removed_own = np.zeros((N, R), np.int64)
        removed_total = np.zeros((N, R), np.int64)
        for i in np.nonzero(eligible)[0]:
            victim = victims[i]
            ns = ns_codes.get(victim.namespace, -1)
            if ns < 0 or not has_q[ns]:
                continue
            vec = meta.index.encode(victim.effective_request())
            removed_total[v_node[i]] += vec
            if ns == p_ns:
                removed_own[v_node[i]] += vec
        own_ok = np.all(
            used[p_ns][None, :] - removed_own + req[None, :]
            <= qmax[p_ns][None, :],
            axis=1,
        )
        agg_used = np.sum(used * has_q[:, None], axis=0)
        agg_min = np.sum(qmin * has_q[:, None], axis=0)
        agg_ok = np.all(
            agg_used[None, :] - removed_total + req[None, :]
            <= agg_min[None, :],
            axis=1,
        )
        return own_ok & agg_ok

    @staticmethod
    def partition_pdb_violations(candidates, pdbs):
        """filterPodsWithPDBViolation (capacity_scheduling.go:889-934):
        each candidate (index, pod) in turn takes one from the budget of
        every PDB that matches it (a pod named in the PDB's
        `disrupted_pods` takes none); a candidate that drives a budget
        below zero is violating. The budgets are fresh per call: one
        candidate node's victims share them. Returns (violating,
        non_violating) index lists in the candidates' order."""
        allowed = [pdb.disruptions_allowed for pdb in pdbs]
        violating, non_violating = [], []
        for i, pod in candidates:
            violated = False
            for j, pdb in enumerate(pdbs):
                if not pdb.matches(pod) or pod.name in pdb.disrupted_pods:
                    continue
                allowed[j] -= 1
                if allowed[j] < 0:
                    violated = True
            (violating if violated else non_violating).append(i)
        return violating, non_violating

    def _reprieve(self, victims, v_node, v_req, v_pri, eligible, node,
                  free_n, demand, preemptor, view, meta, pdbs=(),
                  nom_aggs=None, filter_ok=None):
        """Add victims back while the preemptor still fits and the quota
        gates hold (capacity_scheduling.go:632-670): the PDB-violating ones
        first, then the rest, each group most-important-first, so a
        violating victim has the best chance to stay. `filter_ok(evicted
        uids) -> bool`, when given, re-runs the plugin Filter chain for
        each tentative reprieve (upstream reprievePod): a victim whose
        return would block the preemptor again stays evicted. Returns (the
        final victims, most important first; how many of them violate a
        PDB)."""
        idxs = [i for i in np.nonzero(eligible)[0] if v_node[i] == node]
        # MoreImportantPod: higher priority, then earlier start
        idxs.sort(key=lambda i: (-v_pri[i], victims[i].creation_ms))
        violating, non_violating = self.partition_pdb_violations(
            [(i, victims[i]) for i in idxs], list(pdbs)
        )
        violating_set = set(violating)
        idxs = violating + non_violating
        free_after = free_n + v_req[idxs].sum(axis=0) if idxs else free_n

        quota = view.quota
        use_quota = self.mode == PreemptionMode.CAPACITY and quota is not None
        if use_quota:
            ns_codes = {ns: i for i, ns in enumerate(meta.namespaces)}
            has_q = quota.has_quota
            used = quota.used.copy()
            qmin = quota.min
            qmax = quota.max
            p_ns = ns_codes.get(preemptor.namespace, -1)
            req = meta.index.encode(preemptor.effective_request())
            # reprievePod folds the nominated aggregates into both gates
            # (capacity_scheduling.go:646)
            nom_in_eq, nom_total = (
                nom_aggs if nom_aggs is not None
                else (np.zeros_like(req), np.zeros_like(req))
            )
            req_in_eq = req + nom_in_eq
            req_total = req + nom_total
            for i in idxs:
                ns = ns_codes.get(victims[i].namespace, -1)
                if ns >= 0 and has_q[ns]:
                    used[ns] -= meta.index.encode(
                        victims[i].effective_request()
                    )

        final = []
        num_violating = 0
        evicted = {victims[i].uid for i in idxs}
        for i in idxs:
            candidate_free = free_after - v_req[i]
            fits = bool(np.all(candidate_free >= demand))
            if fits and filter_ok is not None:
                # re-adding this victim must not block the preemptor again
                fits = filter_ok(frozenset(evicted - {victims[i].uid}))
            quota_ok = True
            if use_quota and fits and p_ns >= 0 and has_q[p_ns]:
                vec = meta.index.encode(victims[i].effective_request())
                ns = ns_codes.get(victims[i].namespace, -1)
                used_try = used.copy()
                if ns >= 0 and has_q[ns]:
                    used_try[ns] += vec
                own_ok = np.all(used_try[p_ns] + req_in_eq <= qmax[p_ns])
                agg = np.sum(used_try * has_q[:, None], axis=0)
                agg_ok = np.all(
                    agg + req_total <= np.sum(qmin * has_q[:, None], axis=0)
                )
                quota_ok = bool(own_ok and agg_ok)
            if fits and quota_ok:
                # reprieved: stays on the node
                free_after = candidate_free
                evicted.discard(victims[i].uid)
                if use_quota:
                    ns = ns_codes.get(victims[i].namespace, -1)
                    if ns >= 0 and has_q[ns]:
                        used[ns] += meta.index.encode(
                            victims[i].effective_request()
                        )
            else:
                final.append(victims[i])
                if i in violating_set:
                    num_violating += 1
        # the two groups mixed: most important first again
        final.sort(key=lambda v: (-v.priority, v.creation_ms))
        return final, num_violating
