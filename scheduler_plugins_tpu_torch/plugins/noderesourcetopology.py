"""NodeResourceTopologyMatch (port of
`scheduler_plugins_tpu.plugins.noderesourcetopology`): NUMA-aware Filter
and Score over the zone tables the snapshot lowers from the
NodeResourceTopology CRs (upstream pkg/noderesourcetopology, plugin.go:
79-83).

- Filter: only on nodes whose topology-manager policy is single-numa-node
  (filter.go:176-225), with the container-scope handler (sequential
  subtraction) or the pod-scope handler, per node by its scope.
- Score: non-guaranteed pods score 100 (score.go:72-75); nodes without
  NRT data score 0; LeastAllocated / MostAllocated / BalancedAllocation /
  LeastNUMANodes with per-node scope handling.
- Reserve: the placed pod's request is deducted from EVERY reported zone
  of its node in the carried `SolverState.numa_avail` (the pessimistic
  deduction of cache/store.go:129-160).

The JAX plugin vmaps `ops.numa`'s one-node functions over nodes; here they
run over the node axis directly, and over (pod, node) rows in the batched
hooks. A plugin given any cache argument installs the NRT cache tier
(`state.nrt_cache`: OverReserve / Passthrough / DiscardReserved, selected
as initNodeTopologyInformer does) on the store in `configure_cluster`;
the snapshot then reads the cache's view.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.api.objects import (
    QOSClass,
    TopologyManagerPolicy,
    TopologyManagerScope,
)
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops import MAX_NODE_SCORE
from scheduler_plugins_tpu_torch.ops import numa as numa_ops
from scheduler_plugins_tpu_torch.ops.numa import (
    BALANCED_ALLOCATION,
    LEAST_ALLOCATED,
    LEAST_NUMA_NODES,
    MOST_ALLOCATED,
)
from scheduler_plugins_tpu_torch.state import nrt_cache

STRATEGIES = (
    LEAST_ALLOCATED,
    MOST_ALLOCATED,
    BALANCED_ALLOCATION,
    LEAST_NUMA_NODES,
)

GUARANTEED = int(QOSClass.GUARANTEED)
BEST_EFFORT = int(QOSClass.BEST_EFFORT)
SINGLE_NUMA_NODE = int(TopologyManagerPolicy.SINGLE_NUMA_NODE)
POD_SCOPE = int(TopologyManagerScope.POD)
CONTAINER_SCOPE = int(TopologyManagerScope.CONTAINER)


class NodeResourceTopologyMatch(Plugin):
    name = "NodeResourceTopologyMatch"
    #: the Filter reads the carried zone availability (in-cycle
    #: pessimistic deductions): the batched solve re-filters per wave
    state_dependent_filter = True

    #: Cache.ForeignPodsDetect / ResyncMethod / InformerMode values
    #: (apis/config/types.go:124-180)
    FOREIGN_PODS_DETECT = ("All", "None", "OnlyExclusiveResources")
    RESYNC_METHODS = ("Autodetect", "All", "OnlyExclusiveResources")
    INFORMER_MODES = ("Shared", "Dedicated")

    def __init__(
        self,
        scoring_strategy: str = LEAST_ALLOCATED,
        resources: Sequence[tuple[str, int]] = (),
        cache_resync_period_seconds: Optional[int] = None,
        discard_reserved_nodes: Optional[bool] = None,
        cache: Optional[dict] = None,
    ):
        if scoring_strategy not in STRATEGIES:
            raise ValueError(f"illegal scoring strategy {scoring_strategy!r}")
        if (cache_resync_period_seconds is not None
                and cache_resync_period_seconds < 0):
            # ValidateNodeResourceTopologyMatchArgs
            raise ValueError("cacheResyncPeriodSeconds must be >= 0")
        self.strategy = scoring_strategy
        self.resources = tuple(resources)
        #: the cache selection (pluginhelpers.go:47-78): DiscardReserved
        #: when discardReservedNodes, Passthrough when the resync period
        #: is <= 0, else OverReserve resynced on that period.
        #: `configure_cluster` installs a cache only when one of these
        #: arguments was PASSED: a default plugin leaves the store alone
        self._cache_args_given = any(
            v is not None for v in (cache_resync_period_seconds,
                                    discard_reserved_nodes, cache))
        self.cache_resync_period_seconds = int(
            cache_resync_period_seconds or 0)
        self.discard_reserved_nodes = bool(discard_reserved_nodes)
        cache = dict(cache or {})
        self.cache_foreign_pods_detect = cache.get("foreignPodsDetect", "All")
        self.cache_resync_method = cache.get("resyncMethod", "Autodetect")
        self.cache_informer_mode = cache.get("informerMode", "Dedicated")
        if self.cache_foreign_pods_detect not in self.FOREIGN_PODS_DETECT:
            raise ValueError(f"invalid foreignPodsDetect "
                             f"{self.cache_foreign_pods_detect!r}")
        if self.cache_resync_method not in self.RESYNC_METHODS:
            raise ValueError(
                f"invalid resyncMethod {self.cache_resync_method!r}")
        if self.cache_informer_mode not in self.INFORMER_MODES:
            raise ValueError(
                f"invalid informerMode {self.cache_informer_mode!r}")
        self._uniform_scope: Optional[int] = None
        #: whether the float32 path keeps the weighted zone-score sums
        #: exact: sum(100 * w) over the full weight vector below 2^24
        self._w_f32_ok = False
        self._affine = self._host_level = None
        self._host_extended = self._weights = None

    def events_to_register(self):
        # plugin.go:141-151: pod delete, node allocatable changes, NRT CRs
        return (ev.POD_DELETE, ev.NODE_ADD, ev.NODE_UPDATE,
                ev.NRT_ADD, ev.NRT_UPDATE)

    # -- the NRT cache tier ------------------------------------------------
    def _cache_signature(self):
        return (
            self.discard_reserved_nodes,
            self.cache_resync_period_seconds,
            self.cache_foreign_pods_detect,
            self.cache_informer_mode,
            self.cache_resync_method,
        )

    def make_cache(self, scheduler_names=None):
        """The cache tier initNodeTopologyInformer selects
        (pluginhelpers.go:55-66). `scheduler_names` seeds the foreign-pod
        registry with the profile names counted as ours."""
        if self.discard_reserved_nodes:
            return nrt_cache.DiscardReservedCache()
        if self.cache_resync_period_seconds <= 0:
            return nrt_cache.PassthroughCache()
        cache = nrt_cache.OverReserveCache(
            foreign_pods_detect=self.cache_foreign_pods_detect,
            informer_mode=self.cache_informer_mode,
            resync_method=self.cache_resync_method,
        )
        if scheduler_names:
            cache.our_schedulers = set(scheduler_names)
        cache.resync_period_ms = self.cache_resync_period_seconds * 1000
        return cache

    def configure_cluster(self, cluster):
        """Install the selected cache on the store, seeded with its NRTs
        and pods, when cache arguments were given and the store's cache
        has another configuration."""
        if cluster is None or not self._cache_args_given:
            return
        signature = self._cache_signature()
        if getattr(cluster, "_nrt_cache_config", None) == signature:
            return
        cache = self.make_cache(
            scheduler_names=getattr(cluster, "scheduler_names", None))
        for nrt in cluster.nrts.values():
            cache.update_nrt(nrt)
        if hasattr(cache, "track_pod"):
            for pod in cluster.pods.values():
                cache.track_pod(pod)
        cluster.nrt_cache = cache
        cluster._nrt_cache_config = signature

    def prepare_cluster(self, meta, cluster):
        """When every NRT shares one topology-manager scope (the common
        fleet), run only that scope's handler instead of both."""
        self._uniform_scope = None
        if cluster is not None and cluster.nrts:
            scopes = {int(t.scope) for t in cluster.nrts.values()}
            if len(scopes) == 1:
                self._uniform_scope = scopes.pop()

    def static_key(self):
        # the uniform-scope branch and the float32-weight guard are
        # Python-level selections outside the tensors
        return ("nrt_scope", self._uniform_scope,
                "w_f32_ok", bool(self._w_f32_ok))

    def host_state(self):
        # the scope comes from the live Cluster's NRT CRs, which a replayed
        # bundle lacks
        return {"uniform_scope": self._uniform_scope}

    def restore_host_state(self, state) -> None:
        scope = state.get("uniform_scope")
        self._uniform_scope = None if scope is None else int(scope)

    def prepare(self, meta):
        device = meta.device
        self._affine = torch.as_tensor(
            numa_ops.numa_affine_mask(meta.index), device=device)
        self._host_level = torch.as_tensor(
            numa_ops.host_level_mask(meta.index), device=device)
        self._host_extended = torch.as_tensor(
            np.array(["/" in name for name in meta.index.names], bool),
            device=device)
        w = np.ones(len(meta.index), np.int64)  # default 1 (score.go:49-60)
        for name, weight in self.resources:
            if name in meta.index and weight >= 1:
                w[meta.index.position(name)] = weight
        self._weights = torch.as_tensor(w, device=device)
        self._w_f32_ok = int(w.sum()) * MAX_NODE_SCORE < (1 << 24)

    def aux(self):
        return (self._affine, self._host_level, self._host_extended,
                self._weights)

    def bind_aux(self, aux):
        (self._affine, self._host_level, self._host_extended,
         self._weights) = aux

    def prepare_solve(self, snap):
        """The batch's requests in the live-availability quantity domain,
        once per solve; for LeastNUMANodes also the zone subsets and their
        pod-invariant distance tables."""
        if snap.numa is None:
            return None
        pre = {
            "req": numa_ops.scale_qty(snap.numa, snap.pods.req),
            "creq": numa_ops.scale_qty(snap.numa, snap.pods.container_req),
        }
        if self.strategy == LEAST_NUMA_NODES:
            pre["subsets"] = self._subsets(snap)
        return pre

    def _subsets(self, snap):
        """(masks (S, Z), sizes (S,), distance tables (N, S) x 2)."""
        numa = snap.numa
        masks, sizes = numa_ops.subset_tensors(numa.available.shape[1],
                                               snap.device)
        tables = numa_ops.subset_distance_tables(
            numa.distances, numa.zone_mask, masks, sizes)
        return masks, sizes, tables

    def _numa_avail(self, state, snap):
        """The live zone availability (N, Z, R), float: the carry when the
        state has one, else the snapshot's."""
        if state is not None and state.numa_avail is not None:
            return state.numa_avail
        return numa_ops.live_avail_init(snap.numa)

    def _qty(self, snap, key: str):
        """The whole batch's requests (`req` (P, R) or `creq` (P, C, R))
        in the live-availability domain."""
        if self._presolve is not None:
            return self._presolve[key]
        table = snap.pods.req if key == "req" else snap.pods.container_req
        return numa_ops.scale_qty(snap.numa, table)

    def _applies(self, numa, nodes=None):
        """Only the single-numa-node policy filters (filter.go:230-241)."""
        has, policy = numa.has_nrt, numa.policy
        if nodes is not None:
            has, policy = has[nodes], policy[nodes]
        return has & (policy == SINGLE_NUMA_NODE)

    def _skip(self, snap, rows):
        """Best-effort pods without extended-resource requests skip the
        Filter (filter.go:180-183, IncludeNonNative)."""
        non_native = ((snap.pods.req[rows] > 0)
                      & self._host_extended).any(dim=-1)
        return (snap.pods.qos[rows] == BEST_EFFORT) & ~non_native

    # -- Filter ----------------------------------------------------------
    def _scoped_fit(self, avail, node_args, guaranteed, req, creq, is_init,
                    cmask, scope):
        """The scope-selected single-numa verdict over the leading
        dimensions of `avail`: the pod-scope handler checks `req`, the
        container-scope one `creq` (..., C, R) one container at a time."""
        def one_request(r):
            return numa_ops.feasible_zones(
                avail, *node_args, guaranteed, r, self._affine,
                self._host_level)[1]

        def container_fit():
            if creq.shape[-2] == 1:
                # one container: no sequential subtraction to thread
                return one_request(creq[..., 0, :])
            return numa_ops.single_numa_fit(
                avail, *node_args, guaranteed, creq, is_init, cmask,
                self._affine, self._host_level)

        if self._uniform_scope == POD_SCOPE:
            return one_request(req)
        if self._uniform_scope == CONTAINER_SCOPE:
            return container_fit()
        return torch.where(scope == POD_SCOPE, one_request(req),
                           container_fit())

    def filter(self, state, snap, p):
        if snap.numa is None:
            return None
        numa = snap.numa
        pods = snap.pods
        scoped = self._scoped_fit(
            self._numa_avail(state, snap),
            (numa.reported, numa.zone_mask, snap.nodes.alloc),
            pods.qos[p] == GUARANTEED, self._qty(snap, "req")[p],
            self._qty(snap, "creq")[p], pods.container_is_init[p],
            pods.container_mask[p], numa.scope,
        )
        # a stale cache view is Unschedulable whatever the policy
        # (filter.go:194-197)
        verdict = torch.where(self._applies(numa), scoped, True) & numa.fresh
        return torch.where(self._skip(snap, p), True, verdict)

    # -- the batched rows ---------------------------------------------------
    def _single_request_rows(self, snap):
        """(P, R) single-request rows in the live-quantity domain when the
        whole-batch fit applies (uniform pod scope, or uniform container
        scope with one container slot), else None."""
        if self._uniform_scope == POD_SCOPE:
            return self._qty(snap, "req")
        if (self._uniform_scope == CONTAINER_SCOPE
                and snap.pods.container_req.shape[1] == 1):
            return self._qty(snap, "creq")[:, 0, :]
        return None

    def _batch_single_fit(self, state, snap, sel=None):
        """(S, N) Filter verdicts of the whole batch (or of the `sel`
        rows) through `ops.numa.batch_request_fit`, or None when the
        per-pod `filter` must serve."""
        numa = snap.numa
        rows = self._single_request_rows(snap)
        if rows is None:
            return None
        sel = slice(None) if sel is None else sel
        ok = numa_ops.batch_request_fit(
            self._numa_avail(state, snap), numa.reported, numa.zone_mask,
            snap.nodes.alloc, snap.pods.qos[sel] == GUARANTEED, rows[sel],
            self._affine, self._host_level,
        )
        verdict = (torch.where(self._applies(numa)[None, :], ok, True)
                   & numa.fresh[None, :])
        return torch.where(self._skip(snap, sel)[:, None], True, verdict)

    def filter_batch(self, state, snap):
        if snap.numa is None:
            return None
        return self._batch_single_fit(state, snap)

    def filter_rows(self, state, snap, idx):
        if snap.numa is None:
            return None
        return self._batch_single_fit(state, snap, sel=idx)

    def score_batch(self, state, snap):
        """(P, N) int32 raw scores with the zone scales computed once per
        solve, equal to the per-pod `score` in value; None for
        LeastNUMANodes and mixed-scope clusters (the per-pod path)."""
        if snap.numa is None or self.strategy == LEAST_NUMA_NODES:
            return None
        numa = snap.numa
        scope = self._uniform_scope
        if scope not in (POD_SCOPE, CONTAINER_SCOPE):
            return None
        available = self._strategy_avail(state, snap)
        if scope == POD_SCOPE:
            raw = numa_ops.batch_strategy_node_scores(
                self.strategy, self._qty(snap, "req"), available,
                numa.zone_mask, self._weights)
        else:
            creq = self._qty(snap, "creq")
            cmask = snap.pods.container_mask
            count = torch.clamp(cmask.sum(dim=1), min=1)
            scales = (numa_ops.precompute_zone_scales(available)
                      if self.strategy in (LEAST_ALLOCATED, MOST_ALLOCATED)
                      else None)
            # mean over containers, float, truncated (score.go:152-165)
            total = torch.zeros((snap.num_pods, snap.num_nodes),
                                dtype=torch.float64, device=snap.device)
            for c in range(creq.shape[1]):
                s_c = numa_ops.batch_strategy_node_scores(
                    self.strategy, creq[:, c], available, numa.zone_mask,
                    self._weights, scales=scales)
                total = total + torch.where(cmask[:, c][:, None],
                                            s_c.to(torch.float64), 0.0)
            raw = torch.trunc(total / count[:, None]).to(torch.int32)
        guaranteed = snap.pods.qos == GUARANTEED
        raw = torch.where((numa.has_nrt & numa.fresh)[None, :], raw, 0)
        return torch.where(guaranteed[:, None], raw, MAX_NODE_SCORE)

    # -- Reserve ----------------------------------------------------------
    def commit(self, state, snap, p, choice):
        """Reserve: deduct the placed pod's request from EVERY reported
        zone of the chosen node (ReserveNodeResources with the
        GetCachedNRTCopy deduction, cache/store.go:129-160). `choice` is
        (1,), -1 for unplaced."""
        if snap.numa is None or state.numa_avail is None:
            return state
        avail = state.numa_avail
        N = avail.shape[0]
        onehot = (torch.arange(N, device=avail.device) == choice)
        reqq = self._qty(snap, "req")[p].to(avail.dtype)
        deduct = torch.where(
            ((choice >= 0) & onehot)[:, None, None] & snap.numa.reported,
            reqq, 0.0,
        )
        return state.replace(numa_avail=avail - deduct)

    def commit_batch(self, state, snap, placed, choice):
        """The batched Reserve: the pessimistic deduction is a sum over
        the placed pods, so one per-node sum equals any order of
        `commit`s."""
        if snap.numa is None or state.numa_avail is None:
            return state
        avail = state.numa_avail
        reqq = self._qty(snap, "req").to(avail.dtype)  # (P, R)
        node_demand = torch.zeros((avail.shape[0], reqq.shape[1]),
                                  dtype=avail.dtype, device=avail.device)
        node_demand.index_add_(0, torch.clamp(choice, min=0).long(),
                               torch.where(placed[:, None], reqq, 0))
        deduct = torch.where(snap.numa.reported, node_demand[:, None, :], 0)
        return state.replace(numa_avail=avail - deduct)

    # -- the batched solve's wave hooks -------------------------------------
    def wave_capacity(self, state, snap, active):
        """(N,) int32 pods-per-node estimate under the pessimistic zone
        model: a node takes at most floor(max_z avail[z, r] / mean
        request_r) pods of the active mix (min over requested resources).
        Steers the waterfill's bucketing only."""
        if snap.numa is None:
            return None
        numa = snap.numa
        reqq = self._qty(snap, "req")
        n_active = torch.clamp(active.sum(), min=1)
        mean_req = torch.where(active[:, None], reqq, 0).sum(dim=0) / n_active
        avail = self._numa_avail(state, snap)
        reported = numa.reported & numa.zone_mask[:, :, None]
        best_zone = torch.where(reported, avail, 0.0).amax(dim=1)  # (N, R)
        # a resource no zone reports does not constrain the zone fit (the
        # filter's host-level bypass), so it must not zero the estimate
        has_affinity = reported.any(dim=1)
        per_r = torch.where(
            (mean_req[None, :] > 0) & has_affinity,
            torch.floor(best_zone / torch.clamp(mean_req, min=1e-9)),
            torch.inf,
        )
        cap = per_r.amin(dim=1)
        # clip while still float: a ratio past 2^31 would make the int32
        # cast undefined
        P = float(snap.num_pods)
        cap = torch.where(torch.isfinite(cap), cap, P)
        cap = torch.clamp(cap, 0.0, P).to(torch.int32)
        return torch.where(self._applies(numa), cap, snap.num_pods)

    def wave_guard_demand(self, snap):
        """The pod request in the live-availability domain: what an
        earlier same-wave winner deducts from every zone of a shared
        node."""
        if snap.numa is None:
            return None
        return self._qty(snap, "req")

    def wave_guard_rows(self, state, snap, pods, nodes, prefix):
        """Exact within-wave single-numa admission of the (pod, node)
        pairs: each pod's Filter verdict on its node alone, with the
        earlier same-wave winners' demand `prefix` (S, R) deducted from
        every reported zone, the view a sequential carry would show."""
        if snap.numa is None:
            return torch.ones(pods.shape[0], dtype=torch.bool,
                              device=pods.device)
        numa = snap.numa
        reported = numa.reported[nodes]
        avail = self._numa_avail(state, snap)[nodes]  # (S, Z, R)
        avail = avail - torch.where(reported,
                                    prefix[:, None, :].to(avail.dtype), 0)
        pods_t = snap.pods
        scoped = self._scoped_fit(
            avail, (reported, numa.zone_mask[nodes], snap.nodes.alloc[nodes]),
            pods_t.qos[pods] == GUARANTEED, self._qty(snap, "req")[pods],
            self._qty(snap, "creq")[pods], pods_t.container_is_init[pods],
            pods_t.container_mask[pods], numa.scope[nodes],
        )
        verdict = (torch.where(self._applies(numa, nodes), scoped, True)
                   & numa.fresh[nodes])
        return torch.where(self._skip(snap, pods), True, verdict)

    # -- Score -----------------------------------------------------------
    def score(self, state, snap, p):
        if snap.numa is None:
            return None
        numa = snap.numa
        guaranteed = snap.pods.qos[p] == GUARANTEED
        if self.strategy == LEAST_NUMA_NODES:
            raw = self._least_numa_scores(state, snap, p, guaranteed)
        else:
            raw = self._strategy_scores(state, snap, p)
        # nodes without NRT data or with a stale view score 0
        # (score.go:78-91); non-guaranteed pods score the max
        # (score.go:72-75)
        raw = torch.where(numa.has_nrt & numa.fresh, raw, 0)
        return torch.where(guaranteed, raw, MAX_NODE_SCORE)

    def _strategy_avail(self, state, snap):
        """The float live availability the strategies divide by; weights
        too large for float32's exact range force float64."""
        available = self._numa_avail(state, snap)
        if available.dtype == torch.float32 and not self._w_f32_ok:
            available = available.to(torch.float64)
        return available

    def _strategy_scores(self, state, snap, p):
        numa = snap.numa
        req = self._qty(snap, "req")[p]
        creq = self._qty(snap, "creq")[p]
        cmask = snap.pods.container_mask[p]
        available = self._strategy_avail(state, snap)
        zmask = numa.zone_mask

        def pod_scope():
            zs = numa_ops.zone_strategy_scores(
                self.strategy, req, available, zmask, req > 0, self._weights)
            return numa_ops.min_over_zones(zs, zmask)

        def container_scope():
            # mean over containers, float, truncated (score.go:152-165)
            total = torch.zeros(snap.num_nodes, dtype=torch.float64,
                                device=snap.device)
            count = torch.clamp(cmask.sum(), min=1)
            for c in range(creq.shape[0]):
                zs = numa_ops.zone_strategy_scores(
                    self.strategy, creq[c], available, zmask, creq[c] > 0,
                    self._weights)
                s = numa_ops.min_over_zones(zs, zmask)
                total = total + torch.where(cmask[c], s.to(torch.float64),
                                            0.0)
            return torch.trunc(total / count).to(torch.int64)

        if self._uniform_scope == POD_SCOPE:
            return pod_scope()
        if self._uniform_scope == CONTAINER_SCOPE:
            return container_scope()
        return torch.where(numa.scope == POD_SCOPE, pod_scope(),
                           container_scope())

    def _least_numa_scores(self, state, snap, p, guaranteed):
        numa = snap.numa
        pre = self._presolve
        masks, sizes, tables = (pre["subsets"] if pre is not None
                                else self._subsets(snap))
        req = self._qty(snap, "req")[p]
        creq = self._qty(snap, "creq")[p]
        cmask = snap.pods.container_mask[p]
        reported, zmask = numa.reported, numa.zone_mask
        available = self._numa_avail(state, snap)

        def required(avail, r):
            return numa_ops.least_numa_required(
                avail, reported, zmask, numa.distances, guaranteed, r,
                self._affine, masks, sizes, tables=tables)

        def pod_scope():
            skip = numa_ops.only_non_numa(reported, zmask, req)
            count, is_min, ok, _ = required(available, req)
            score = numa_ops.least_numa_normalize(count, is_min,
                                                  numa.max_numa)
            return torch.where(skip, MAX_NODE_SCORE,
                               torch.where(ok, score, 0))

        def container_scope():
            avail = available
            N = snap.num_nodes
            worst = torch.zeros(N, dtype=torch.int32, device=snap.device)
            all_min = torch.ones(N, dtype=torch.bool, device=snap.device)
            failed = torch.zeros(N, dtype=torch.bool, device=snap.device)
            for c in range(creq.shape[0]):
                applies = cmask[c] & ~numa_ops.only_non_numa(
                    reported, zmask, creq[c])
                count, is_min, ok, chosen = required(avail, creq[c])
                failed = failed | (applies & ~ok)
                worst = torch.where(applies & ok,
                                    torch.maximum(worst, count), worst)
                all_min = all_min & (~applies | is_min)
                # the full request leaves every chosen zone, init
                # containers included (subtractFromNUMAs is unconditional
                # in the least-numa loop, least_numa.go:40-64)
                grant = torch.where(
                    ((applies & ok)[:, None] & chosen)[:, :, None]
                    & reported, creq[c], 0)
                avail = avail - grant
            score = numa_ops.least_numa_normalize(worst, all_min,
                                                  numa.max_numa)
            return torch.where(failed, 0, torch.where(
                worst == 0, MAX_NODE_SCORE, score))

        if self._uniform_scope == POD_SCOPE:
            return pod_scope()
        if self._uniform_scope == CONTAINER_SCOPE:
            return container_scope()
        return torch.where(numa.scope == POD_SCOPE, pod_scope(),
                           container_scope())
