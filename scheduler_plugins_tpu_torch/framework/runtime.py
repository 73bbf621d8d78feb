"""The sequential parity solve (port of `scheduler_plugins_tpu.framework.runtime`).

Reference dataflow per pending pod (SURVEY.md §1): QueueSort -> PreFilter
-> Filter(x nodes) -> Score(x nodes) -> Normalize -> Reserve -> Permit.
`Scheduler.solve` runs the pending batch as a Python loop over the pods
whose body evaluates every enabled plugin for one pod against the carried
`SolverState` (free capacity, quota usage, gang counts) and commits the
chosen node before the next pod: the reference's one-pod-at-a-time
semantics, each step vectorized over the nodes. The JAX package runs the
same body as a `lax.scan`; the two agree bit for bit.

Each step issues device work only. Every per-pod value (verdicts, the
chosen node, attribution codes) stays a tensor combined with
`torch.where`, and a pod's codes are read through one-element slices, so
the loop never reads a tensor on the host and never waits for the card.

Permit is evaluated after the loop as a reduction over gangs (quorum =
assigned before + scheduled this cycle >= MinMember, upstream
core.go:308-345).
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import (
    finish_fetch,
    resolve_device,
    start_fetch,
)
from scheduler_plugins_tpu_torch.framework.plugin import Plugin, SolverState
from scheduler_plugins_tpu_torch.ops.numa import live_avail_init
from scheduler_plugins_tpu_torch.ops.selectors import commit_tracks
from scheduler_plugins_tpu_torch.ops.fit import (
    fits,
    fits_one,
    free_capacity,
    pod_fit_demand,
)

#: attribution name for failures owned by the framework, not a profile
#: plugin: scheduling gates and resource-fit exhaustion (the upstream
#: built-in fit plugin name)
BUILTIN_FIT = "NodeResourcesFit"

#: the score every infeasible node gets before the argmax
MASKED_SCORE = -(2 ** 62)


@dataclass
class SolveResult:
    assignment: torch.Tensor  # (P,) int32 node index, -1 unschedulable
    admitted: torch.Tensor  # (P,) bool PreFilter verdict
    wait: torch.Tensor  # (P,) bool Permit said Wait (gang quorum unmet)
    state: SolverState  # final carried state
    #: (P,) int32 unschedulability attribution, the upstream
    #: `UnschedulablePlugins` signal per pod: -1 = placed; 0 = built-in
    #: (gated, or resource fit exhausted against the carried free
    #: capacity); 1+i = profile plugin i (its PreFilter rejected the pod,
    #: or its Filter first emptied the remaining feasible node set in
    #: profile order). Decoded by `Scheduler.fail_plugin_names`.
    failed_plugin: Optional[torch.Tensor] = None


def solve_output_anomaly(assignment, admitted, wait, n_nodes: int):
    """Reason string when solve outputs violate the framework contract,
    else None: integer (P,) assignment in [-1, n_nodes), admitted and wait
    of the same shape, no NaNs. Reads the outputs on the host."""

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    a = host(assignment)
    if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
        return f"assignment dtype/rank {a.dtype}/{a.ndim}"
    if a.size and (int(a.min()) < -1 or int(a.max()) >= n_nodes):
        return (
            f"assignment out of range [{int(a.min())}, {int(a.max())}] "
            f"vs {n_nodes} nodes"
        )
    for name, arr in (("admitted", admitted), ("wait", wait)):
        x = host(arr)
        if x.shape != a.shape:
            return f"{name} shape {x.shape} != assignment {a.shape}"
        if np.issubdtype(x.dtype, np.floating) and np.isnan(x).any():
            return f"NaN in {name}"
    return None


def _admit_with_attribution(plugins, verdict_of, ok0):
    """PreFilter sweep with attribution: (ok, admit_code), each shaped as
    `ok0`, where `admit_code` is the FIRST plugin (profile order) whose
    verdict (`verdict_of(plugin)`: its `admit` for one pod or `admit_rows`
    for a batch) flipped the pod inadmissible, -1 when none did."""
    ok = ok0
    admit_code = torch.full_like(ok0, -1, dtype=torch.int32)
    for i, plugin in enumerate(plugins):
        verdict = verdict_of(plugin)
        if verdict is not None:
            admit_code = torch.where(
                (admit_code < 0) & ok & ~verdict, i, admit_code
            )
            ok = ok & verdict
    return ok, admit_code


def _filter_with_attribution(plugins, state, snap, p, fit0, rows=None):
    """Filter chain with attribution: (feasible (N,), filter_code (1,)),
    where `filter_code` is the first plugin whose Filter emptied the
    still-feasible node set, -1 when none did. `rows` (plugin position ->
    (P, N) whole-batch verdicts, `parallel.solver.collapsed_batch_rows`)
    stands in for that plugin's per-pod `filter`: how the batched explain
    runs through this same chain."""
    feasible = fit0
    alive = fit0.any(dim=0, keepdim=True)
    filter_code = torch.full_like(alive, -1, dtype=torch.int32)
    for i, plugin in enumerate(plugins):
        if rows is not None and i in rows:
            mask = rows[i][p]
        else:
            mask = plugin.filter(state, snap, p)
        if mask is not None:
            feasible = feasible & mask
            now_alive = feasible.any(dim=0, keepdim=True)
            filter_code = torch.where(
                (filter_code < 0) & alive & ~now_alive, i, filter_code
            )
            alive = now_alive
    return feasible, filter_code


def _free_with_nominee_holds(state, snap, p):
    """Effective free capacity pod `p`'s built-in fit sees: nominated
    pods' demand holds capacity against lower-or-equal-priority pods
    (upstream AddNominatedPods; the pod's own batch row excluded, and a
    batch nominee stops holding once placed). Int64 `index_add`, exact in
    any order."""
    nm = snap.nominees
    if nm is None:
        return state.free
    live = (
        nm.mask
        & (nm.priority >= snap.pods.priority[p])
        & (nm.batch_idx != p)
    )
    if state.placed_mask is not None:
        placed_in_batch = (nm.batch_idx >= 0) & state.placed_mask[
            torch.clamp(nm.batch_idx, min=0).long()
        ]
        live = live & ~placed_in_batch
    hold = torch.zeros_like(state.free).index_add_(
        0, torch.clamp(nm.node, min=0).long(),
        torch.where(live[:, None], nm.demand, 0),
    )
    return state.free - hold


#: elements of the (K, N, R) comparison `_fits_rows` makes at once
_FIT_BLOCK = 1 << 26


def _fits_rows(req, free, node_mask):
    """(K, N) built-in fit of the (K, R) requests (`ops.fit.fits`), over
    blocks of rows so the (K, N, R) comparison stays bounded."""
    N, R = free.shape
    step = max(1, _FIT_BLOCK // max(N * R, 1))
    return torch.cat([
        fits(req[lo:lo + step], free, node_mask=node_mask)
        for lo in range(0, req.shape[0], step)
    ])


def _encode_fail(ok0, admit_code, fit0_any, filter_code, fallback: int):
    """Merge the stage attributions into one int32 code (see
    `SolveResult.failed_plugin`): PreFilter rejections name their plugin
    first (upstream runs PreFilter before the node sweep), then built-in
    fit, then the first Filter plugin that emptied the feasible set, then
    `fallback` (0 = built-in for the sequential solve, where reaching it
    means in-cycle capacity exhaustion)."""
    code = torch.where(filter_code >= 0, filter_code + 1, fallback)
    code = torch.where(fit0_any, code, 0)
    code = torch.where(admit_code >= 0, admit_code + 1, code)
    return torch.where(ok0, code, 0).to(torch.int32)


def _score_columns(plugins, state, snap, p, feasible, rows=None):
    """((L, N) int64 per-plugin weighted normalized score columns, (N,)
    int64 total) for pod `p`: each column is the `weight *
    normalize(raw, feasible)` term the solve step folds into its total, so
    the columns sum to the solver's node score; a plugin without Score
    gives a zero column. `rows` stands in for `score` as in
    `_filter_with_attribution`."""
    N = state.free.shape[0]
    cols = []
    total = torch.zeros(N, dtype=torch.int64, device=state.free.device)
    for i, plugin in enumerate(plugins):
        if rows is not None and i in rows:
            raw = rows[i][p]
        else:
            raw = plugin.score(state, snap, p)
        if raw is None:
            cols.append(torch.zeros_like(total))
            continue
        col = (plugin.weight * plugin.normalize(raw, feasible)).to(
            torch.int64
        )
        cols.append(col)
        total = total + col
    return torch.stack(cols), total


def _explain_rows(plugins, state0, snap, idx, rows, filter_rows=None,
                  score_rows=None):
    """The explain body for the pod rows `idx` (host ints; `rows` the same
    as a device tensor) against the cycle-initial state: PreFilter with
    attribution (`admit_rows`), the built-in fit and its margin (nominee
    holds included), the Filter chain and the per-plugin score columns.
    Returns (admitted (S,), fail_code (S,), feasible (S, N), fit_margin
    (S, N), columns (S, L, N), total (S, N)), device tensors. Shared by
    the sequential and batched explain entries (`*_rows` overrides)."""
    ok0 = snap.pods.mask[rows] & ~snap.pods.gated[rows]
    ok, admit_code = _admit_with_attribution(
        plugins, lambda plugin: plugin.admit_rows(state0, snap, rows), ok0
    )
    out = []
    for k, p in enumerate(idx):
        req = snap.pods.req[p]
        # the binding resource's headroom against the capacity the solve
        # step fits against; masked nodes get the sentinel
        free_eff = _free_with_nominee_holds(state0, snap, p)
        margin = (free_eff - pod_fit_demand(req)[None, :]).amin(dim=1)
        margin = torch.where(snap.nodes.mask, margin, MASKED_SCORE)
        fit0 = fits_one(req, free_eff, snap.nodes.mask)
        feasible, filter_code = _filter_with_attribution(
            plugins, state0, snap, p, fit0, rows=filter_rows
        )
        feasible = feasible & ok[k:k + 1]
        columns, total = _score_columns(plugins, state0, snap, p, feasible,
                                        rows=score_rows)
        fail_code = _encode_fail(ok0[k:k + 1], admit_code[k:k + 1],
                                 fit0.any(dim=0, keepdim=True), filter_code,
                                 -1)
        out.append((fail_code, feasible, margin, columns, total))
    fail_code, feasible, margin, columns, total = zip(*out)
    return (ok, torch.cat(fail_code), torch.stack(feasible),
            torch.stack(margin), torch.stack(columns), torch.stack(total))


@contextlib.contextmanager
def bound_auxes(plugins, auxes):
    """Bind `auxes` (tensors an earlier `aux()` of each plugin returned)
    on the shared plugins for the block, then put back what they held, so
    the next cycle solves with its own configuration. None binds
    nothing."""
    if auxes is None:
        yield
        return
    live = [plugin.aux() for plugin in plugins]
    for plugin, aux in zip(plugins, auxes):
        plugin.bind_aux(aux)
    try:
        yield
    finally:
        for plugin, aux in zip(plugins, live):
            plugin.bind_aux(aux)


def run_explain_rows(scheduler, snap, indices, auxes, explain_fn, device):
    """Shared plumbing of the two explain entries (`Scheduler.explain_rows`,
    `parallel.solver.batch_explain_rows`): the device, the empty-batch
    schema, binding `auxes` (a recorded cycle's `aux()` tensors) on the
    profile's plugins for the call and restoring theirs after, and one
    host copy of `explain_fn(plugins, state0, snap, idx, rows)`'s outputs
    as numpy, each with len(indices) rows."""
    device = resolve_device(device)
    if snap.device != device:
        snap = snap.to(device)
    plugins = tuple(scheduler.profile.plugins)
    idx = [int(i) for i in np.asarray(indices, np.int64)]
    if not idx:
        N = snap.num_nodes
        L = max(len(plugins), 1)
        return {
            "admitted": np.zeros(0, bool),
            "fail_code": np.zeros(0, np.int32),
            "feasible": np.zeros((0, N), bool),
            "fit_margin": np.zeros((0, N), np.int64),
            "columns": np.zeros((0, L, N), np.int64),
            "total": np.zeros((0, N), np.int64),
        }
    rows = torch.tensor(idx, dtype=torch.int64)
    if device.type == "cuda":
        # pinned and non-blocking: the call never waits on the card
        # before its one fetch
        rows = rows.pin_memory().to(device, non_blocking=True)
    with bound_auxes(plugins, auxes):
        for plugin in plugins:
            plugin.bind_presolve(plugin.prepare_solve(snap))
        out = explain_fn(plugins, scheduler.initial_state(snap), snap, idx,
                         rows)
        out = finish_fetch(start_fetch(out, device))
    names = ("admitted", "fail_code", "feasible", "fit_margin", "columns",
             "total")
    return dict(zip(names, out))


@dataclass
class _Hoisted:
    """Pod-invariant tensors of one solve, computed before the loop."""

    ok0: torch.Tensor  # (P,) bool: a real, ungated pod
    node_index: torch.Tensor  # (N,) int64 arange


def _solve_step(plugins, state, p: int, snap, hoisted: _Hoisted):
    """One pod of the sequential solve: PreFilter -> built-in fit (nominee
    holds) -> Filter chain -> Score/Normalize weighted sum -> argmax with
    the lowest-index tie-break -> Reserve commits. Returns (state, (choice,
    ok, fail_code)), each output (1,)."""
    # PreFilter, with per-plugin attribution
    ok0 = hoisted.ok0[p:p + 1]
    ok, admit_code = _admit_with_attribution(
        plugins, lambda plugin: plugin.admit(state, snap, p), ok0
    )
    # Filter: built-in resource fit (nominee capacity holds included) +
    # the plugin filters, exact against the CARRIED state
    req = snap.pods.req[p]
    free_eff = _free_with_nominee_holds(state, snap, p)
    fit0 = fits_one(req, free_eff, snap.nodes.mask)
    feasible, filter_code = _filter_with_attribution(
        plugins, state, snap, p, fit0
    )
    feasible = feasible & ok
    # Score + Normalize, weighted sum
    total = None
    for plugin in plugins:
        raw = plugin.score(state, snap, p)
        if raw is not None:
            # int64 whatever the plugin's score dtype (LeastNUMANodes
            # scores int32); a no-op for the int64 scorers
            col = (plugin.weight * plugin.normalize(raw, feasible)).to(
                torch.int64)
            total = col if total is None else total + col
    if total is None:
        total = torch.zeros_like(state.free[:, 0])
    # select: the highest score among feasible nodes, lowest index on a
    # tie (the JAX step's `argmax`), made explicit
    masked = torch.where(feasible, total, MASKED_SCORE)
    best = masked.amax(dim=0, keepdim=True)
    N = hoisted.node_index.shape[0]
    first = torch.where(masked == best, hoisted.node_index, N).amin(
        dim=0, keepdim=True
    )
    choice = torch.where(
        feasible.any(dim=0, keepdim=True), first, -1
    ).to(torch.int32)
    # built-in Reserve: commit capacity
    placed = choice >= 0
    demand = torch.where(placed[:, None], pod_fit_demand(req)[None, :], 0)
    state = state.replace(free=torch.index_add(
        state.free, 0, torch.clamp(choice, min=0).long(), -demand
    ))
    if state.placed_mask is not None:
        state = state.replace(placed_mask=torch.slice_scatter(
            state.placed_mask, placed, start=p, end=p + 1
        ))
    if snap.scheduling is not None:
        # built-in: the selector and domain carries are shared by the
        # spread and inter-pod affinity plugins, so they commit once
        state = commit_tracks(state, snap.scheduling, p, choice)
    for plugin in plugins:
        state = plugin.commit(state, snap, p, choice)
    # attribution; fallback 0: a failed pod that no stage rejected lost
    # to in-cycle capacity consumption -> built-in fit
    fail_code = torch.where(
        placed, -1,
        _encode_fail(ok0, admit_code, fit0.any(dim=0, keepdim=True),
                     filter_code, 0),
    ).to(torch.int32)
    return state, (choice, ok, fail_code)


def sequential_solve_body(plugins, snap, state0: SolverState) -> SolveResult:
    """The sequential parity solve over one snapshot: hoist presolves, run
    `_solve_step` pod by pod, reduce gang quorum. No host reads."""
    for plugin in plugins:
        plugin.bind_presolve(plugin.prepare_solve(snap))
    hoisted = _Hoisted(
        ok0=snap.pods.mask & ~snap.pods.gated,
        node_index=torch.arange(snap.num_nodes, device=snap.device),
    )
    state = state0
    choices, oks, fails = [], [], []
    for p in range(snap.num_pods):
        state, (choice, ok, fail) = _solve_step(plugins, state, p, snap,
                                                hoisted)
        choices.append(choice)
        oks.append(ok)
        fails.append(fail)
    assignment = torch.cat(choices)
    admitted = torch.cat(oks)
    failed_plugin = torch.cat(fails)
    wait = torch.zeros_like(admitted)
    if snap.gangs is not None and state.gang_scheduled is not None:
        # Permit quorum: previously assigned + this cycle's placements
        quorum = (snap.gangs.assigned + state.gang_scheduled
                  >= snap.gangs.min_member)
        gang = snap.pods.gang.long()
        pod_quorum = torch.where(
            gang >= 0, quorum[torch.clamp(gang, min=0)], True
        )
        wait = (assignment >= 0) & ~pod_quorum
    return SolveResult(
        assignment=assignment, admitted=admitted, wait=wait, state=state,
        failed_plugin=failed_plugin,
    )


#: the solve modes a profile may select; the packing optimizer
#: (`ops/packing.py`) comes with the packing slice
SOLVE_MODES = ("sequential",)


@dataclass
class Profile:
    """An enabled-plugin set: one KubeSchedulerConfiguration profile."""

    plugins: Sequence[Plugin] = field(default_factory=list)
    #: queue-sort plugin; None selects the first enabled plugin that
    #: overrides `queue_key` (a profile enables exactly one QueueSort
    #: upstream), falling back to upstream PrioritySort semantics
    queue_sort: Optional[Plugin] = None
    #: PostFilter preemption engine (`framework.preemption`); None
    #: auto-selects from the enabled plugins (CapacityScheduling ->
    #: quota-aware preemption)
    preemption: Optional[object] = None
    name: str = "tpu-scheduler"
    #: which solve serves this profile's cycles (`SOLVE_MODES`)
    solve_mode: str = "sequential"

    def __post_init__(self):
        if self.solve_mode not in SOLVE_MODES:
            raise ValueError(
                f"solve mode {self.solve_mode!r} is not ported yet: the "
                f"port has {SOLVE_MODES}; 'packing' comes with the packing "
                f"slice (ops/packing.py)"
            )
        if self.queue_sort is None:
            for plugin in self.plugins:
                if type(plugin).queue_key is not Plugin.queue_key or hasattr(
                    plugin, "queue_compare"
                ):
                    self.queue_sort = plugin
                    break
        if self.preemption is None:
            for plugin in self.plugins:
                if hasattr(plugin, "preemption_engine"):
                    self.preemption = plugin.preemption_engine()
                    break


class Scheduler:
    """Host shell around the solve. Owns nothing but the profile; cluster
    state comes in as a snapshot and decisions go back to the caller."""

    def __init__(self, profile: Profile):
        self.profile = profile
        #: (L,) int64 live per-plugin weight vector, or None (the static
        #: profile weights); set by `set_live_weights`
        self._live_weights = None

    def sort_pending(self, pods, cluster=None):
        """QueueSort: order the pending list with the profile's comparator
        (default: upstream PrioritySort — priority desc, then queue time).
        Plugins exposing a pairwise `queue_compare` are used via
        cmp_to_key, preserving exact Less() semantics."""
        qs = self.profile.queue_sort
        if qs is not None and hasattr(qs, "queue_compare"):
            return sorted(pods, key=functools.cmp_to_key(
                lambda a, b: qs.queue_compare(a, b, cluster)
            ))

        def key(pod):
            if qs is not None:
                k = qs.queue_key(pod, cluster)
                if k is not None:
                    return k
            return (-pod.priority, pod.creation_ms,
                    f"{pod.namespace}/{pod.name}")

        return sorted(pods, key=key)

    def prepare(self, meta, cluster=None):
        """Bake each plugin's per-layout tensors onto `meta.device`, then
        let a plugin with a `prepare_cluster(meta, cluster)` hook read the
        host store (the NUMA plugin's uniform-scope selection)."""
        for plugin in self.profile.plugins:
            plugin.prepare(meta)
            if hasattr(plugin, "prepare_cluster"):
                plugin.prepare_cluster(meta, cluster)

    # -- live weights (the online tuner's rollout seam) ------------------
    @property
    def live_weights(self):
        """The (L,) int64 live weight vector, or None when the static
        profile weights rule."""
        return self._live_weights

    def set_live_weights(self, weights) -> None:
        """Swap the profile's per-plugin score weights live: the vector's
        entries are written into the plugins' `weight` ints, which every
        later `solve` and explain folds, so `weights_key` and
        `profile_spec` see the same vector. `None` clears the live vector;
        the original ints are NOT restored (pass the old vector to roll
        back). The JAX package bakes weights into traced programs, so it
        carries the live vector into its `solve_live` program through
        `Plugin.bind_weight` and evicts its weight-keyed programs here;
        eager PyTorch reads the ints on every call and caches no program,
        so it needs neither."""
        if weights is None:
            self._live_weights = None
            return
        w = np.asarray(weights, np.int64)
        if w.shape != (len(self.profile.plugins),):
            raise ValueError(
                f"live weights shape {w.shape} != "
                f"({len(self.profile.plugins)},)"
            )
        if (w < 1).any():
            raise ValueError("live weights must be positive (the solve "
                             "contracts require positive weights)")
        self._live_weights = w
        for plugin, wi in zip(self.profile.plugins, w):
            plugin.weight = int(wi)

    def weights_key(self) -> tuple:
        """The marked host weight tuple, ("weights", w_0, ..., w_L-1): the
        JAX package folds it into the cache keys of its programs that bake
        the weights in."""
        return ("weights",) + tuple(
            int(p.weight) for p in self.profile.plugins
        )

    def initial_state(self, snap) -> SolverState:
        gang_sched = gang_inflight = None
        if snap.gangs is not None:
            G = snap.gangs.min_member.shape[0]
            gang_sched = torch.zeros(G, dtype=torch.int32, device=snap.device)
            gang_inflight = torch.zeros(
                (G, snap.num_resources), dtype=torch.int64, device=snap.device
            )
        placed_mask = None
        if snap.quota is not None or snap.nominees is not None:
            placed_mask = torch.zeros(
                snap.num_pods, dtype=torch.bool, device=snap.device
            )
        numa_avail = None
        if snap.numa is not None:
            numa_avail = live_avail_init(snap.numa)
        net_placed = (snap.network.placed_node if snap.network is not None
                      else None)
        tracks = {}
        sched = snap.scheduling
        if sched is not None:
            # the node-level carry only when a spread eligibility row
            # excludes a keyed node; every carry starts as the snapshot's
            # table, which no commit writes
            if (sched.track_node_base is not None
                    and sched.spread_needs_node_counts):
                tracks["sel_counts"] = sched.track_node_base
            tracks["sel_dom_counts"] = sched.track_base
            tracks["anti_domains"] = sched.exist_anti_base
            tracks["sym_counts"] = sched.sym_base
        return SolverState(
            free=free_capacity(snap.nodes.alloc, snap.nodes.requested),
            eq_used=snap.quota.used if snap.quota is not None else None,
            gang_scheduled=gang_sched,
            gang_inflight=gang_inflight,
            placed_mask=placed_mask,
            numa_avail=numa_avail,
            net_placed=net_placed,
            **tracks,
        )

    def solve(self, snap, state0: Optional[SolverState] = None, *,
              device=None) -> SolveResult:
        """Run the profile's plugins over the snapshot's pending batch on
        `device` (None = the CUDA card; the snapshot and `state0` move
        there if they live elsewhere). Returns device tensors; nothing is
        read on the host. Neither `snap` nor `state0` is modified."""
        device = resolve_device(device)
        if snap.device != device:
            snap = snap.to(device)
        if state0 is None:
            state0 = self.initial_state(snap)
        elif state0.free.device != device:
            state0 = state0.to(device)
        return sequential_solve_body(tuple(self.profile.plugins), snap,
                                     state0)

    def filter_verdicts(self, snap, pod_index: int) -> torch.Tensor:
        """(N,) AND of the enabled plugins' Filter verdicts for one pod
        against the cycle-initial state, on the snapshot's device
        (resource fit excluded: callers handle capacity). The preemption
        dry run reads it as upstream's RunFilterPluginsWithNominatedPods.
        The presolve is deliberately unbound: it amortizes a whole batch,
        and this evaluates one pod."""
        plugins = tuple(self.profile.plugins)
        for plugin in plugins:
            plugin.bind_presolve(None)
        state0 = self.initial_state(snap)
        feasible = torch.ones(snap.num_nodes, dtype=torch.bool,
                              device=snap.device)
        for plugin in plugins:
            mask = plugin.filter(state0, snap, pod_index)
            if mask is not None:
                feasible = feasible & mask
        return feasible

    def fail_plugin_names(self) -> list:
        """Decoder for `SolveResult.failed_plugin` and
        `attribution_codes`: code 0 (and any negative code on a failed
        pod) -> the built-in fit, code 1+i -> profile plugin i."""
        return [BUILTIN_FIT] + [p.name for p in self.profile.plugins]

    def attribution_codes(self, snap, indices) -> np.ndarray:
        """(len(indices),) int32 unschedulability attribution for the pod
        rows `indices` against the CYCLE-INITIAL state, on the snapshot's
        device: the failure decode of solves that carry no per-pod codes
        (the streamed solve). The failed rows go through as one batch:
        PreFilter in profile order (`admit_rows`, the first flipping
        plugin named), built-in fit against the initial free capacity
        (no nominee holds), then the Filter chain.

        Encoding as `SolveResult.failed_plugin`, except that -1 means
        "feasible cycle-initially": the pod lost to in-cycle capacity
        consumption, which the cycle decodes to the built-in fit."""
        plugins = tuple(self.profile.plugins)
        rows = torch.as_tensor(np.asarray(indices, np.int64),
                               device=snap.device)
        if rows.numel() == 0:
            return np.zeros(0, np.int32)
        for plugin in plugins:
            plugin.bind_presolve(plugin.prepare_solve(snap))
        state0 = self.initial_state(snap)
        ok0 = snap.pods.mask[rows] & ~snap.pods.gated[rows]
        _, admit_code = _admit_with_attribution(
            plugins, lambda plugin: plugin.admit_rows(state0, snap, rows), ok0
        )
        fit0 = _fits_rows(snap.pods.req[rows], state0.free, snap.nodes.mask)
        filter_code = torch.full_like(admit_code, -1)
        if any(type(p).filter is not Plugin.filter for p in plugins):
            filter_code = torch.cat([
                _filter_with_attribution(plugins, state0, snap, p,
                                         fit0[k])[1]
                for k, p in enumerate(rows.tolist())
            ])
        codes = _encode_fail(ok0, admit_code, fit0.any(dim=1), filter_code,
                             -1)
        return codes.cpu().numpy()

    def explain_rows(self, snap, indices, auxes=None, *,
                     device=None) -> dict:
        """Per-plugin score decomposition of the pod rows `indices`
        against the CYCLE-INITIAL state, on `device` (None = the CUDA
        card; the snapshot moves there if it lives elsewhere): the "why
        this node" surface behind `CycleReport.explain`. `auxes` binds a
        recorded cycle's `aux()` tensors for the call.

        Returns numpy arrays, each with len(indices) rows: `admitted`
        (S,), `fail_code` (S,) int32 (`_encode_fail`'s encoding, -1 =
        feasible cycle-initially), `feasible` (S, N), `fit_margin` (S, N)
        int64 (min over resources of effective free - demand, nominee
        holds included; -2^62 on masked nodes), `columns` (S, L, N) int64
        weighted normalized per-plugin scores in profile order, `total`
        (S, N) int64, their sum, which is the solve step's node score.
        One host copy a call."""
        return run_explain_rows(self, snap, indices, auxes, _explain_rows,
                                device)


def now_ms() -> int:
    return int(time.time() * 1000)
