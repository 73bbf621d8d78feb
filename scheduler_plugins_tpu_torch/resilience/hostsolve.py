"""Host-side (numpy) sequential parity solve: the failover target (port of
`scheduler_plugins_tpu.resilience.hostsolve`).

When the device backend is gone, retrying the device solve hangs again:
the cycle keeps serving only through a solve that never touches the
backend's compute. This is that path for the profiles it supports: a
numpy mirror of `framework.runtime._solve_step` (PreFilter gates,
built-in fit against the carried free capacity, weighted min-max
normalized scoring, argmax with the lowest-index tie-break, the capacity
commit) in the same int64 units with the same Go integer division, so
its placements equal `Scheduler.solve`'s bit for bit.

Scope: profiles whose every plugin is `NodeResourcesAllocatable` (the
serving profile) on snapshots without side tables (no gangs, quota, NUMA,
network, scheduling tables or nominees). `supports()` gates; the
watchdog raises `BackendUnavailable` for the rest rather than guess.

The snapshot's columns are read to the host with `.cpu()`, as the JAX
package reads them with `np.asarray`: on a backend that is truly dead
those reads block in both packages.
"""

from __future__ import annotations

import numpy as np

from scheduler_plugins_tpu_torch.ops import (
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    PODS_I,
)


def _go_div_np(a, b):
    """Numpy twin of `utils.intmath.go_div` (truncation toward zero,
    b > 0): the floor and remainder-correction form, never abs()."""
    a = np.asarray(a)
    q = a // b
    r = a - q * b
    return np.where((a < 0) & (r != 0), q + 1, q).astype(a.dtype)


def _host(t):
    return t.cpu().numpy()


def supports(scheduler, snap) -> bool:
    """True when the host mirror covers this (profile, snapshot): every
    plugin is `NodeResourcesAllocatable` and no side table (which would
    need carries the mirror does not model) is present."""
    from scheduler_plugins_tpu_torch.plugins.noderesources import (
        NodeResourcesAllocatable,
    )

    if not all(
        isinstance(p, NodeResourcesAllocatable)
        for p in scheduler.profile.plugins
    ):
        return False
    return (
        snap.gangs is None
        and snap.quota is None
        and snap.numa is None
        and snap.network is None
        and snap.scheduling is None
        and snap.nominees is None
    )


def host_sequential_solve(scheduler, snap):
    """(assignment, admitted, wait, failed_plugin) numpy arrays for the
    supported profile surface: exactly the outputs `Scheduler.solve`
    gives. Callers gate on `supports()` first."""
    alloc = _host(snap.nodes.alloc)
    requested = _host(snap.nodes.requested)
    node_mask = _host(snap.nodes.mask)
    req = _host(snap.pods.req)
    pod_mask = _host(snap.pods.mask)
    gated = _host(snap.pods.gated)
    P, N = req.shape[0], alloc.shape[0]

    free = alloc - requested  # the ops.fit.free_capacity rule
    # static per-node raw scores, one row per plugin (allocatable scores
    # rate the node, never the pod: resource_allocation.go:49-76)
    plugin_rows = []
    for plugin in scheduler.profile.plugins:
        weights = _host(plugin.aux()).astype(np.int64)
        weight_sum = max(int(weights.sum()), 1)
        raw = _go_div_np(
            (plugin.mode_sign * alloc * weights[None, :]).sum(axis=-1),
            weight_sum,
        )
        plugin_rows.append((int(plugin.weight), raw))

    assignment = np.full(P, -1, np.int32)
    admitted = np.zeros(P, bool)
    failed = np.zeros(P, np.int32)
    span = MAX_NODE_SCORE - MIN_NODE_SCORE
    for p in range(P):
        ok0 = bool(pod_mask[p]) and not bool(gated[p])
        admitted[p] = ok0
        demand = req[p].copy()
        demand[PODS_I] = 1
        feasible = np.all(demand[None, :] <= free, axis=-1) & node_mask
        feasible &= ok0
        if not feasible.any():
            # the sequential solve's encoding: every failure on this
            # profile surface decodes to the built-in fit (code 0);
            # placed pods carry -1
            failed[p] = 0
            continue
        total = np.zeros(N, np.int64)
        for weight, raw in plugin_rows:
            lo = raw[feasible].min()
            hi = raw[feasible].max()
            rng = hi - lo
            if rng == 0:
                col = np.full(N, MIN_NODE_SCORE, np.int64)
            else:
                # operands non-negative: `//` matches Go int division
                col = (raw - lo) * span // rng + MIN_NODE_SCORE
            total += weight * np.where(feasible, col, 0)
        masked = np.where(feasible, total, np.int64(-(2 ** 62)))
        choice = int(np.argmax(masked))  # first max == lowest index
        assignment[p] = choice
        failed[p] = -1
        free[choice] -= demand
    wait = np.zeros(P, bool)  # no gangs on the supported surface
    return assignment, admitted, wait, failed
