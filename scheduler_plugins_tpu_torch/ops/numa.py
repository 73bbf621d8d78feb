"""NUMA-aware fitting and scoring (port of `scheduler_plugins_tpu.ops.numa`).

The reference's per-node x per-container x per-resource x per-zone Go
loops (upstream pkg/noderesourcetopology) become boolean algebra over the
(Z, R) zone tensors. The JAX package writes each function for ONE node's
zone block and vmaps it over nodes (and over pods); here each takes any
leading dimensions in front of its zone block and broadcasts them, so one
function serves a node axis (N, Z, R), a (pod, node) grid (P, N, Z, R)
or a list of (pod, node) pairs (S, Z, R):

- `feasible_zones`      resourcesAvailableInAnyNUMANodes (filter.go:90-160):
  a per-resource zone mask, early reject on node-level absence, QoS gating
  (numaresources.go:137-142), the host-level resource bypass
  (numaresources.go:105-121).
- `single_numa_fit`     the container-scope handler (filter.go:39-78): init
  containers are checked without subtraction, app containers subtract
  their grant from the chosen (lowest-id) zone.
- strategy scores       Least / Most / Balanced per zone over the requested
  resources; node score = zero-skipping min over zones (score.go:110-124).
- `least_numa_*`        the minimal-k zone-combination search with the
  average inter-zone distance preference (least_numa.go:40-258).

Every sum of quantities is of exact integers (float32 below 2^24 when the
snapshot packs, float64 below 2^53 otherwise), so its value does not
depend on the order; the BalancedAllocation statistics, whose float sums
do round, add the resources one at a time in index order.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from scheduler_plugins_tpu_torch.api.resources import (
    CPU,
    EPHEMERAL_STORAGE,
    MEMORY,
    ResourceIndex,
)
from scheduler_plugins_tpu_torch.ops import MAX_NODE_SCORE
from scheduler_plugins_tpu_torch.utils.intmath import (
    floordiv_exact,
    floordiv_recip,
)

F32 = torch.float32
F64 = torch.float64

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
BALANCED_ALLOCATION = "BalancedAllocation"
LEAST_NUMA_NODES = "LeastNUMANodes"

#: a subset distance no real subset reaches (the JAX `big`)
_BIG = 1e18
#: elements of the (rows, N, Z, R) temporaries `batch_*` build at once
_BLOCK = 1 << 24


# ---------------------------------------------------------------------------
# static (host-side) resource classification (numaresources.go:105-135)
# ---------------------------------------------------------------------------

def numa_affine_mask(index: ResourceIndex) -> np.ndarray:
    """cpu, memory and hugepages must expose NUMA affinity."""
    out = np.zeros(len(index), bool)
    for i, name in enumerate(index.names):
        out[i] = name in (CPU, MEMORY) or name.startswith("hugepages-")
    return out


def host_level_mask(index: ResourceIndex) -> np.ndarray:
    """ephemeral-storage, storage and extended (namespaced) resources may
    lack NUMA affinity."""
    out = np.zeros(len(index), bool)
    for i, name in enumerate(index.names):
        out[i] = name in (EPHEMERAL_STORAGE, "storage") or "/" in name
    return out


def live_avail_init(numa) -> torch.Tensor:
    """The solve's initial live zone availability (N, Z, R): float32 over
    the static pack scales when the snapshot packs (each value times 100
    exact in float32), else float64 (exact below 2^53). Requests compared
    against it go through `scale_qty` with the same scales."""
    if numa.pack_scales is not None:
        return _rescaled(numa.available, numa.pack_scales)
    return numa.available.to(F64)


def scale_qty(numa, vec: torch.Tensor) -> torch.Tensor:
    """A request tensor (..., R) in `live_avail_init`'s quantity domain."""
    if numa.pack_scales is None:
        return vec
    return _rescaled(vec, numa.pack_scales)


def _rescaled(x: torch.Tensor, scales: tuple) -> torch.Tensor:
    """float32 `x // scales` over the last axis, one resource column at a
    time with each scale a Python int: a scale tensor would be a copy
    from the host, which waits for the card."""
    return torch.stack([x[..., r] // s for r, s in enumerate(scales)],
                       dim=-1).to(F32)


@lru_cache(maxsize=16)
def subset_masks(Z: int):
    """All non-empty zone subsets ordered by (size, lexicographic), the
    enumeration order of combin.Combinations by ascending size
    (least_numa.go:160-174): (masks (S, Z) bool, sizes (S,) int32)."""
    masks, sizes = [], []
    for k in range(1, Z + 1):
        for combo in itertools.combinations(range(Z), k):
            row = np.zeros(Z, bool)
            row[list(combo)] = True
            masks.append(row)
            sizes.append(k)
    return np.array(masks), np.array(sizes, np.int32)


@lru_cache(maxsize=16)
def subset_tensors(Z: int, device: torch.device):
    """`subset_masks(Z)` on `device`, made once per (Z, device); to the
    card through pinned memory without waiting for it."""
    out = tuple(torch.as_tensor(a) for a in subset_masks(Z))
    if device.type == "cuda":
        out = tuple(t.pin_memory().to(device, non_blocking=True) for t in out)
    return out


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def feasible_zones_from_suitable(suitable_qty, reported, zone_mask,
                                 node_alloc, guaranteed, req, affine,
                                 host_level):
    """`feasible_zones` with the quantity check given: `suitable_qty` is
    (..., Z, R) `live_avail >= req`. Returns (feasible (..., Z), ok
    (...)). `guaranteed` broadcasts against the leading dimensions."""
    relevant = req > 0  # (..., R): zero-qty requests are ignored
    present = node_alloc > 0
    early_reject = (relevant & ~present).any(dim=-1)
    reported_z = reported & zone_mask[..., None]  # (..., Z, R)
    suitable = (~guaranteed[..., None, None] & affine) | suitable_qty
    per_resource = reported_z & suitable
    has_affinity = reported_z.any(dim=-2)  # (..., R)
    # a resource constrains the zone mask unless it is irrelevant, or
    # unreported by every zone and host-level
    constrain = relevant & ~(~has_affinity & host_level)
    feasible = torch.where(constrain[..., None, :], per_resource,
                           True).all(dim=-1) & zone_mask
    ok = ~early_reject & feasible.any(dim=-1)
    return feasible, ok


def feasible_zones(avail, reported, zone_mask, node_alloc, guaranteed, req,
                   affine, host_level):
    """(feasible zones (..., Z), ok (...)) of one request per leading
    index: zero-qty resources are ignored, node-level absence rejects
    early, a resource no zone reports passes only if host-level, and
    non-guaranteed pods skip the quantity check of NUMA-affine
    resources."""
    return feasible_zones_from_suitable(
        avail >= req[..., None, :], reported, zone_mask, node_alloc,
        guaranteed, req, affine, host_level,
    )


def batch_request_fit(avail, reported, zone_mask, node_alloc, guaranteed,
                      reqs, affine, host_level):
    """(P, N) single-request feasibility of the (P, R) requests `reqs`
    against the (N, Z, R) live availability, `feasible_zones(...)[1]` over
    the (pod, node) grid; pods go through in blocks that bound the
    (rows, N, Z, R) compare."""
    N, Z, R = avail.shape
    step = max(1, _BLOCK // max(N * Z * R, 1))
    return torch.cat([
        feasible_zones(avail, reported, zone_mask, node_alloc,
                       guaranteed[lo:lo + step, None],
                       reqs[lo:lo + step, None, :], affine, host_level)[1]
        for lo in range(0, reqs.shape[0], step)
    ])


def single_numa_fit(avail, reported, zone_mask, node_alloc, guaranteed,
                    creq, is_init, cmask, affine, host_level):
    """Container-scope single-numa-node Filter verdict (...,): `creq`
    (..., C, R) per-container requests, init containers first; each app
    container subtracts its grant from its chosen zone before the next
    container (filter.go:39-78)."""
    C = creq.shape[-2]
    Z = avail.shape[-2]
    zones = torch.arange(Z, device=avail.device)
    ok = None
    for c in range(C):
        r = creq[..., c, :]
        feasible, ok_c = feasible_zones(avail, reported, zone_mask,
                                        node_alloc, guaranteed, r, affine,
                                        host_level)
        applies = cmask[..., c]
        verdict = ~applies | ok_c
        ok = verdict if ok is None else ok & verdict
        # the chosen zone: the lowest feasible NUMA id (filter.go:152-157)
        zone = feasible.to(torch.int32).argmax(dim=-1)
        subtract = applies & ok_c & ~is_init[..., c]
        onehot = zones == zone[..., None]  # (..., Z)
        grant = torch.where(
            (subtract[..., None] & onehot)[..., None] & reported,
            r[..., None, :], 0,
        )
        avail = avail - grant
    return ok


# ---------------------------------------------------------------------------
# strategy scores (LeastAllocated / MostAllocated / BalancedAllocation)
# ---------------------------------------------------------------------------

def _float_dtype(x):
    return x.dtype if x.is_floating_point() else F64


def _weighted_zone_score(per_resource_f, relevant, weights,
                         out_dtype=torch.int64):
    """sum_r score_r * w_r // sum_r w_r over the requested resources, in
    the caller's float dtype (exact: per-resource scores are <= 100).
    `per_resource_f` (..., Z, R), `relevant` (..., R)."""
    w = torch.where(relevant, weights, 0).to(per_resource_f.dtype)
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)
    return floordiv_exact(
        (per_resource_f * w[..., None, :]).sum(dim=-1), wsum[..., None]
    ).to(out_dtype)


def precompute_zone_scales(avail):
    """The pod-invariant zone scales of Least / Most: (capf, safe_cap,
    recip) in `avail`'s float dtype."""
    capf = avail.to(_float_dtype(avail))
    safe_cap = torch.clamp(capf, min=1)
    return capf, safe_cap, 1.0 / safe_cap


def _sum_last(x):
    """Sum over the last axis, one term at a time in index order: the
    order XLA's CPU reduction adds a short row in."""
    total = torch.zeros_like(x[..., 0])
    for r in range(x.shape[-1]):
        total = total + x[..., r]
    return total


def zone_strategy_scores(strategy, req, avail, zone_mask, relevant, weights,
                         scales=None, out_dtype=torch.int64):
    """(..., Z) per-zone scores of one request per leading index.

    Least / Most run the integer divisions of least_allocated.go:45-55 /
    most_allocated.go as exact floor divisions in `avail`'s float dtype
    (the reciprocal of `precompute_zone_scales` hoisted); Balanced keeps
    its ratios in float64, as the reference computes them in Go float64.
    `scales` are `precompute_zone_scales(avail)`, computed here if None."""
    cap = avail
    dt = _float_dtype(cap)
    if strategy in (LEAST_ALLOCATED, MOST_ALLOCATED):
        if scales is None:
            scales = precompute_zone_scales(cap)
        capf, safe_cap, recip = scales
        reqf = req[..., None, :].to(dt)
        numer = (capf - reqf) if strategy == LEAST_ALLOCATED else reqf
        per = torch.where(
            (capf == 0) | (reqf > capf),
            0.0,
            floordiv_recip(numer * float(MAX_NODE_SCORE), safe_cap, recip),
        )
        scores = _weighted_zone_score(per, relevant, weights, out_dtype)
    elif strategy == BALANCED_ALLOCATION:
        cap = cap.to(F64)
        rel = relevant[..., None, :]
        # fractionOfCapacity (balanced_allocation.go:50-55), unclamped: a
        # negative live capacity gives a negative fraction
        fraction = torch.where(
            cap == 0, 1.0,
            req[..., None, :].to(F64) / torch.where(cap == 0, 1.0, cap),
        )
        over = (rel & (fraction > 1.0)).any(dim=-1)
        n = torch.clamp(relevant.sum(dim=-1), min=1)[..., None]
        mean = _sum_last(torch.where(rel, fraction, 0.0)) / n
        d = fraction - mean[..., None]
        sq = _sum_last(torch.where(rel, d * d, 0.0))
        # gonum stat.Variance: the unbiased sample variance
        variance = torch.where(n > 1, sq / torch.clamp(n - 1, min=1), 0.0)
        scores = torch.where(
            over, 0,
            torch.trunc((1.0 - variance) * MAX_NODE_SCORE).to(out_dtype),
        )
    else:  # pragma: no cover
        raise ValueError(f"illegal scoring strategy {strategy}")
    return torch.where(zone_mask, scores, 0)


def min_over_zones(scores, zone_mask):
    """Zero-skipping min over the zone axis (score.go:110-124): zones
    scoring 0 are ignored, so 0 only when every zone scored 0."""
    nonzero = zone_mask & (scores != 0)
    sentinel = torch.iinfo(scores.dtype).max // 2
    min_nonzero = torch.where(nonzero, scores, sentinel).amin(dim=-1)
    return torch.where(nonzero.any(dim=-1), min_nonzero, 0)


def batch_strategy_node_scores(strategy, reqs, avail, zone_mask, weights,
                               scales=None):
    """(P, N) int32 zero-skip-min node scores of the (P, R) requests
    against the (N, Z, R) availability: `zone_strategy_scores` +
    `min_over_zones` over the (pod, node) grid, the zone scales computed
    once, the zone scores int32 (exact: they are <= 100). Pods go through
    in blocks."""
    if strategy in (LEAST_ALLOCATED, MOST_ALLOCATED) and scales is None:
        scales = precompute_zone_scales(avail)
    N, Z, R = avail.shape
    step = max(1, _BLOCK // max(N * Z * R, 1))
    out = []
    for lo in range(0, reqs.shape[0], step):
        r = reqs[lo:lo + step, None, :]
        zs = zone_strategy_scores(strategy, r, avail, zone_mask, r > 0,
                                  weights, scales=scales,
                                  out_dtype=torch.int32)
        out.append(min_over_zones(zs, zone_mask))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# LeastNUMANodes
# ---------------------------------------------------------------------------

def _subset_distances(distances, masks, sizes):
    """(..., S) average pairwise distance per subset (nodesAvgDistance,
    least_numa.go:117-139): the summed costs over the subset's pairs over
    |subset|^2 (exact integer sums in float64)."""
    m = masks.to(F64)  # (S, Z)
    pair_sums = ((m @ distances.to(F64)) * m).sum(dim=-1)
    return pair_sums / torch.clamp(sizes.to(F64) ** 2, min=1.0)


def subset_distance_tables(distances, zone_mask, masks, sizes):
    """The pod-invariant half of `least_numa_required`: (dist (..., S),
    the least distance among the REAL subsets of each subset's size
    (..., S)). Phantom padded zones never win the minimum."""
    Z = masks.shape[1]
    dist = _subset_distances(distances, masks, sizes)
    real_subset = (~masks | zone_mask[..., None, :]).all(dim=-1)  # (..., S)
    per_size = torch.stack([
        torch.where(real_subset & (sizes == k), dist, _BIG).amin(dim=-1)
        for k in range(1, Z + 1)
    ], dim=-1)  # (..., Z)
    return dist, per_size[..., sizes.long() - 1]


def least_numa_required(avail, reported, zone_mask, distances, guaranteed,
                        req, affine, masks, sizes, tables=None):
    """(count int32, is_min_avg_distance, ok, chosen zones (..., Z)) of one
    request per leading index: numaNodesRequired (least_numa.go:158-258),
    the smallest k such that a k-zone combination fits; within that k, a
    combination of the least average distance over ALL real k-subsets
    wins the bonus, else the fitting one of least distance is chosen
    (generation order on ties). `tables` are `subset_distance_tables`,
    computed here if None."""
    S, Z = masks.shape
    relevant = req > 0
    # every zone of the subset must report every requested resource and
    # be a real zone
    zone_reports_all = torch.where(relevant[..., None, :], reported,
                                   True).all(dim=-1)  # (..., Z)
    valid = (~masks | (zone_reports_all & zone_mask)[..., None, :]).all(
        dim=-1)  # (..., S)
    # (..., S, R) summed availability: exact integer sums, in float64 so
    # no reduced-precision matmul path can touch them
    combined = masks.to(F64) @ torch.where(reported, avail, 0).to(F64)
    suitable = (~guaranteed[..., None, None] & affine) | (
        combined >= req[..., None, :].to(F64))
    fits = valid & torch.where(relevant[..., None, :], suitable,
                               True).all(dim=-1)
    dist, min_dist = (tables if tables is not None else
                      subset_distance_tables(distances, zone_mask, masks,
                                             sizes))
    kmin = torch.where(fits, sizes, Z + 1).amin(dim=-1)  # (...) int32
    ok = kmin <= Z
    in_k = fits & (sizes == kmin[..., None])
    is_min = in_k & (dist == min_dist)
    pick_pool = torch.where(is_min.any(dim=-1, keepdim=True), is_min, in_k)
    order_penalty = torch.arange(S, dtype=F64, device=masks.device) * 1e-9
    pick = torch.where(pick_pool, dist + order_penalty, _BIG).argmin(dim=-1)
    chosen = masks[pick] & ok[..., None]
    return (torch.where(ok, kmin, 0).to(torch.int32), is_min.any(dim=-1),
            ok, chosen)


def least_numa_normalize(count, is_min_distance, max_numa):
    """normalizeScore (least_numa.go:91-102)."""
    per_numa = MAX_NODE_SCORE // torch.clamp(torch.as_tensor(max_numa),
                                             min=1)
    score = MAX_NODE_SCORE - count * per_numa
    return torch.where(torch.as_tensor(is_min_distance),
                       score + per_numa // 2, score)


def only_non_numa(reported, zone_mask, req):
    """onlyNonNUMAResources: every requested resource is unreported by
    every zone (least_numa.go:262-273)."""
    relevant = req > 0
    reported_any = (reported & zone_mask[..., None]).any(dim=-2)
    return ~(relevant & reported_any).any(dim=-1)
