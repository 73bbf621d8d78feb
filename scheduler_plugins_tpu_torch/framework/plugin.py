"""Plugin trait layer (port of `scheduler_plugins_tpu.framework.plugin`).

The reference's extension points see one (pod, nodeInfo) pair at a time.
Here each is a tensor transformation over the node axis for one pod of
the batch, evaluated by the sequential solve (`framework.runtime`):

- `admit`       PreFilter verdict for pod `p`: a (1,) bool tensor.
- `admit_rows`  the same verdict for a batch of pod rows at once: the
                streamed solve and failure attribution read it against the
                cycle-initial state (the JAX package vmaps `admit`).
- `filter`      (N,) node feasibility for pod `p`.
- `score`       (N,) raw int64 node scores for pod `p`.
- `normalize`   per-pod transform of the raw scores over feasible nodes.
- `commit`      Reserve: fold the chosen placement into the SolverState
                carried from pod to pod.
- `filter_batch`, `score_batch`, `batch_rows`
                whole-batch (P, N) rows the batched solve and explain
                (`parallel.solver.collapsed_batch_rows`) read in place of
                the per-pod calls; None (the default) when a plugin has no
                whole-batch form.
- `filter_rows` the Filter verdicts of a subset of pod rows (a straggler
                wave of the batched solve).
- `commit_batch`, `wave_guard_demand`, `wave_guard_rows`, `wave_capacity`
                the batched solve's Reserve of a whole wave, its exact
                within-wave admission and its per-node capacity estimate
                (`ops.assign.waterfill_assign_stateful`).
- `validate_at` the batched solve's queue-order re-check of one placed
                pod on its node against the live carry, for hard
                constraints that span nodes (topology spread, inter-pod
                affinity).
- `queue_key`   host-side QueueSort key for a Pod object (lower first).
- `configure_cluster`
                host-side wiring the cycle runs before the snapshot (the
                Trimaran pod CPU-prediction parameters).

The tensor methods issue device work only: no host read of a tensor, so
the solve's loop over the pods never waits for the card. `prepare(meta)`
runs once per snapshot layout and keeps the plugin's tensors (weight
vectors) on the snapshot's device; `prepare_solve(snap)` runs once per
solve, before the loop, and hoists pod-invariant work out of it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from scheduler_plugins_tpu_torch.api import events as ev


@dataclass
class SolverState:
    """State carried from pod to pod through the sequential solve, and
    from wave to wave through the batched one. The fields of the ported
    plugins; the JAX state's rank-gang carry comes with its slice.

    `free` mirrors NodeInfo leftover capacity, `eq_used` the
    ElasticQuotaInfos usage map, `gang_scheduled` the members placed in
    this cycle per gang."""

    free: torch.Tensor  # (N, R) int64
    eq_used: Optional[torch.Tensor] = None  # (Q, R) int64
    gang_scheduled: Optional[torch.Tensor] = None  # (G,) int32
    #: (G, R) demand placed by each gang earlier in this solve, added back
    #: in the MinResources cluster check (core.go:433-467)
    gang_inflight: Optional[torch.Tensor] = None
    #: (P,) which batch pods have placed so far: a nominee stops holding
    #: capacity, and leaves the quota aggregates, once it places
    placed_mask: Optional[torch.Tensor] = None
    #: (N, Z, R) live NUMA zone availability, float32 over the pack scales
    #: or float64 (`ops.numa.live_avail_init`), with this solve's
    #: placements pessimistically deducted from every reported zone of
    #: their node (cache/store.go:129-160)
    numa_avail: Optional[torch.Tensor] = None
    #: (W, N) int32 placed pods per AppGroup workload and node, this
    #: solve's placements counted in (NetworkOverhead's tallies read it)
    net_placed: Optional[torch.Tensor] = None
    #: (TR, N) int64 live matching-pod counts per (track, NODE) (a track is
    #: a unique (selector group, topology key) pair): the assigned pods'
    #: matches plus this solve's placements, folded in by the built-in
    #: commit (`ops.selectors.commit_tracks`). Node-level so
    #: PodTopologySpread's node-inclusion policies can mask ineligible
    #: nodes per (pod, constraint); None unless one does
    sel_counts: Optional[torch.Tensor] = None
    #: (TR, D) int64 the same counts per topology DOMAIN: InterPodAffinity
    #: and PodTopologySpread's fast path gather from it
    sel_dom_counts: Optional[torch.Tensor] = None
    #: (E, D) bool: a pod carrying required anti-affinity term e occupies a
    #: node of domain d
    anti_domains: Optional[torch.Tensor] = None
    #: (E2, D) int64 symmetric-score carrier counts (the existing pods'
    #: preferred and required affinity terms per domain)
    sym_counts: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "SolverState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "SolverState":
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        })


#: cluster events that can free capacity for the framework's built-in
#: resource-fit Filter (upstream NodeResourcesFit EventsToRegister)
BUILTIN_EVENTS = (ev.NODE_ADD, ev.NODE_UPDATE, ev.POD_DELETE)


class Plugin:
    """Base plugin: every method is optional; `None` means "not implemented
    at this extension point" and costs nothing in the solve."""

    name: str = "Plugin"
    #: score weight: the framework multiplies normalized scores by it
    #: (upstream plugin weights in the profile config)
    weight: int = 1
    #: True when `filter` reads the SolverState carry (its verdict depends
    #: on earlier in-cycle placements). The batched solve
    #: (`parallel.solver.profile_batch_solve`) re-evaluates such a filter
    #: every wave against the committed carry, so a plugin that sets it
    #: must implement `commit_batch` or `validate_at`, and
    #: `wave_guard_demand` with `wave_guard_rows` when same-wave
    #: placements can violate its constraint. The streamed solve's gate
    #: (`parallel.solver.fast_path_scoring`) refuses a profile with one.
    state_dependent_filter: bool = False
    #: overridden (not None) when the plugin's hard filter must be
    #: re-checked pod by pod after each batched wave: the wave guard sees
    #: same-NODE conflicts only, and domain-counting constraints (topology
    #: spread, inter-pod anti-affinity) span nodes. The batched solve then
    #: walks the wave's winners in queue order, calling
    #: `validate_at(state, snap, p, node)` with `p` and `node` (1,) int64
    #: device tensors; it returns a (1,) bool, True iff the pod still
    #: passes this plugin's hard filter on that node against the live
    #: carry, and the pod commits (`ops.selectors.commit_tracks`, then
    #: `commit`) only when every validator agrees.
    validate_at = None
    _presolve = None

    def prepare(self, meta) -> None:
        """Build per-snapshot-layout tensors (resource weights) on
        `meta.device`."""

    def aux(self):
        """The tensors `prepare` built, or None. The JAX package traces
        them into its jitted solve as arguments; eager PyTorch reads them
        from the plugin."""
        return None

    def bind_aux(self, aux) -> None:
        """Put back tensors an earlier `aux()` returned, so a retained
        cycle report explains with its own cycle's configuration after a
        later `prepare` rebuilt them. A plugin whose `aux` returns tensors
        overrides this to store them."""

    def prepare_solve(self, snap):
        """Called once per solve, BEFORE the per-pod loop: derive
        loop-invariant tensors from the snapshot so they are computed once.
        Return them (read back via `self._presolve`) or None."""
        return None

    def bind_presolve(self, ctx) -> None:
        """Called by the solve with this plugin's `prepare_solve` result."""
        self._presolve = ctx

    def events_to_register(self) -> tuple:
        """EnqueueExtensions: cluster-event kinds that may make a pod THIS
        plugin failed schedulable again. Score-only plugins register
        nothing (upstream EventsToRegister)."""
        return ()

    def configure_cluster(self, cluster) -> None:
        """Called by the cycle BEFORE the snapshot is taken: a plugin whose
        args configure host-side machinery (pod request-prediction
        defaults) installs it on the store here, the analog of the wiring
        the reference does in each plugin's New()."""

    def queue_key(self, pod, cluster):
        """QueueSort key component for `pod`; tuples compare
        lexicographically."""
        return None

    # --- tensor extension points ------------------------------------------
    def admit(self, state: SolverState, snap, p: int):
        """PreFilter: (1,) bool verdict for pod index `p`."""
        return None

    def admit_rows(self, state: SolverState, snap, rows):
        """Batched PreFilter: (K,) bool verdicts for the pod rows `rows`
        ((K,) int64, or a slice), each equal to `admit(state, snap, p)` for its row,
        or None when the plugin has no PreFilter. A plugin that overrides
        `admit` must override this too."""
        if type(self).admit is not Plugin.admit:
            raise NotImplementedError(
                f"{type(self).__name__} overrides admit but not admit_rows"
            )
        return None

    def filter(self, state: SolverState, snap, p: int):
        """Filter: (N,) bool feasibility for pod `p` against `state`."""
        return None

    def score(self, state: SolverState, snap, p: int):
        """Score: (N,) int64 raw scores for pod `p`."""
        return None

    def static_node_scores(self, snap):
        """(N,) raw scores when this plugin's `score` is POD-INVARIANT
        against the cycle-initial state, else None. Only implement it when
        `normalize` is monotone non-decreasing in the raw score and the
        weight is positive, so the raw ordering is the normalized-weighted
        ordering (the batched solvers rank by it)."""
        return None

    def normalize(self, scores, feasible):
        """NormalizeScore: transform (N,) raw scores over the feasible
        mask."""
        return scores

    def commit(self, state: SolverState, snap, p: int, choice):
        """Reserve: fold `choice` ((1,) node index, -1 = unplaced) into the
        carried state; returns the new state."""
        return state

    # --- batched whole-batch rows (parallel.solver) ------------------------
    def filter_batch(self, state: SolverState, snap):
        """(P, N) Filter verdicts for the whole batch against `state`, or
        None to use the per-pod `filter`. Must equal `filter` row by
        row."""
        return None

    def score_batch(self, state: SolverState, snap):
        """(P, N) raw scores for the whole batch, or None to use the
        per-pod `score`. Must equal `score` row by row."""
        return None

    def batch_rows(self, state: SolverState, snap):
        """(filter (P, N) or None, scores (P, N) or None) from one pass,
        or None to use `filter_batch` / `score_batch`."""
        return None

    def filter_rows(self, state: SolverState, snap, idx):
        """(S, N) Filter verdicts for the pod rows `idx` ((S,) int64) only,
        or None to use `filter_batch` (gathered) or the per-pod `filter`.
        Must equal `filter` on those rows."""
        return None

    # --- the batched solve's wave hooks (ops.assign) -----------------------
    def commit_batch(self, state: SolverState, snap, placed, choice):
        """Batched Reserve: fold a whole wave's placements (`placed` (P,)
        bool, `choice` (P,) int32) into the carry at once. Must equal any
        order of per-pod `commit`s (the carries are sums). Required when
        `state_dependent_filter` is set."""
        return state

    def wave_guard_demand(self, snap):
        """(P, R') non-negative per-pod demand in this plugin's admission
        domain, or None when the plugin needs no within-wave guard."""
        return None

    def wave_guard_rows(self, state: SolverState, snap, pods, nodes,
                        prefix):
        """Exact within-wave admission of S (pod, node) pairs: (S,) bool,
        True where pod `pods[s]` still passes this plugin's filter on
        `nodes[s]` after `prefix[s]` (R',) of earlier same-wave winners'
        demand landed there, against the wave-start carry. The JAX
        package's `wave_guard` vmapped over the pairs."""
        return torch.ones(pods.shape[0], dtype=torch.bool,
                          device=pods.device)

    def wave_capacity(self, state: SolverState, snap, active):
        """(N,) per-node capacity estimate in pods under this plugin's
        constraints for the wave's active pods, or None. Steers only how
        many queue-ranked pods a wave sends to each node; admission stays
        exact through the guards."""
        return None
