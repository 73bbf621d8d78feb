"""NetworkOverhead dependency tallies (port of
`scheduler_plugins_tpu.ops.network`).

Reference: networkoverhead.go:500-638. For each placed pod of each
dependency workload, the cost between the candidate node and the placed
pod's location depends only on (region, zone) codes:

    same node                         -> satisfied, cost += 0 (SameHostname)
    same zone (different node)        -> satisfied unconditionally, cost += 1
    same region, different zone       -> zone-cost lookup: found ->
                                         satisfied / violated by
                                         MaxNetworkCost, cost += value;
                                         missing -> no count, cost += MaxCost
    different region                  -> region-cost lookup, the same way
    placed node without region + zone -> violated, cost += MaxCost

The placed-pod counts are carried through the solve as a (W, N) matrix
(`SolverState.net_placed`), so pods placed earlier in the cycle count for
later ones.

The counts feed hard Filter verdicts, so every contraction must be exact.
The JAX package forces its float32 dots to full precision (`_EXACT`); here
they run in float64, which no TF32 or reduced-precision matmul setting
touches, and every value is an integer far below 2^53 (at most MAX_COST
times the placed pods). The node-only pair tables (`pair_tables`) depend
on no pod and no carry, so a solve builds them once (the plugin's
`prepare_solve`) and each step reuses them.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

MAX_COST = 100  # networkoverhead.go MaxCost
SAME_ZONE_COST = 1
SAME_HOST_COST = 0

F64 = torch.float64


def pair_tables(node_zone, node_region, zone_region, zone_cost,
                region_cost) -> SimpleNamespace:
    """The (N, ZC) / (N, RC) location-pair tables of both tally forms,
    from the node codes ((N,) int32, -1 unset), the region of each zone
    ((ZC,)) and the dense cost matrices ((ZC, ZC) / (RC, RC), -1 for a
    missing pair): the JAX functions' pod-invariant half, the same
    expressions in the same order."""
    device = node_zone.device
    ZC = zone_cost.shape[0]
    RC = region_cost.shape[0]
    node_zone = node_zone.long()
    node_region = node_region.long()
    zone_region = zone_region.long()
    zone_cost = zone_cost.long()
    region_cost = region_cost.long()
    zoned = node_zone >= 0
    rnoz = (node_zone < 0) & (node_region >= 0)
    unloc = (node_zone < 0) & (node_region < 0)
    nz = torch.clamp(node_zone, min=0)
    nr = torch.clamp(node_region, min=0)
    zc = torch.arange(ZC, device=device)
    rc = torch.arange(RC, device=device)
    zone_onehot = (zoned[:, None] & (node_zone[:, None] == zc[None, :])
                   ).to(F64)  # (N, ZC)
    rnoz_onehot = (rnoz[:, None] & (node_region[:, None] == rc[None, :])
                   ).to(F64)  # (N, RC)
    same_zone = node_zone[:, None] == zc[None, :]  # (N, ZC)
    same_region = node_region[:, None] == zone_region[None, :]  # (N, ZC)
    # a candidate without a zone / region label looks up with key "" in
    # the reference (networkoverhead.go:544-566): always a miss, never
    # row 0
    zcost_row = torch.where(zoned[:, None], zone_cost[nz], -1)
    rcost_zone = region_cost[nr][:, torch.clamp(zone_region, min=0)]
    rcost_zone = torch.where(
        (node_region >= 0)[:, None] & (zone_region[None, :] >= 0),
        rcost_zone, -1)
    pair_cost = torch.where(
        same_zone, SAME_ZONE_COST,
        torch.where(
            same_region,
            torch.where(zcost_row >= 0, zcost_row, MAX_COST),
            torch.where(rcost_zone >= 0, rcost_zone, MAX_COST),
        ))  # (N, ZC)
    pair_known = torch.where(same_region, zcost_row >= 0, rcost_zone >= 0)
    pair_lookup = torch.where(same_region, zcost_row, rcost_zone)

    # region-only placed pods. Same region: a zoned candidate's zone
    # lookup misses (cost MaxCost, no count) but a zoneless candidate
    # compares "" == "" as the same zone (satisfied, cost 1,
    # networkoverhead.go:541-545). Across regions: the region-cost lookup,
    # a miss for label-less candidates.
    same_r = node_region[:, None] == rc[None, :]  # (N, RC)
    rcost = torch.where((node_region >= 0)[:, None], region_cost[nr], -1)
    both_zoneless = (node_zone < 0)[:, None] & same_r
    rn_cost = torch.where(
        both_zoneless, SAME_ZONE_COST,
        torch.where(same_r, MAX_COST,
                    torch.where(rcost >= 0, rcost, MAX_COST)))
    rn_known = ~same_r & (rcost >= 0)
    rcost_eff = torch.where(rcost >= 0, rcost, MAX_COST)
    kz = pair_known & ~same_zone
    return SimpleNamespace(
        zoned=zoned, rnoz=rnoz, unloc=unloc, nz=nz, nr=nr,
        zone_onehot=zone_onehot, rnoz_onehot=rnoz_onehot,
        same_zone=same_zone, pair_cost=pair_cost, pair_known=pair_known,
        pair_lookup=pair_lookup, same_r=same_r, both_zoneless=both_zoneless,
        rn_cost=rn_cost, rn_known=rn_known, rcost_eff=rcost_eff,
        rnoz_same_r=rnoz[:, None] & same_r, kz=kz,
    )


def dependency_tallies(dep_workload, dep_max_cost, dep_mask, placed_node,
                       node_zone, node_region, zone_region, zone_cost,
                       region_cost, tables=None):
    """Per-node (satisfied, violated, cost) tallies of one pod.

    dep_workload / dep_max_cost / dep_mask: (D,) dependency rows;
    placed_node: (W, N) live placed-pod counts; node_zone / node_region:
    (N,) codes (-1 unset); zone_region: (ZC,) region of each zone;
    zone_cost / region_cost: dense matrices, -1 for a missing pair;
    `tables`: their `pair_tables`, built here when None. Returns three
    (N,) int64 tensors (the JAX `dependency_tallies`)."""
    if tables is None:
        tables = pair_tables(node_zone, node_region, zone_region, zone_cost,
                             region_cost)
    tb = tables
    mc = dep_max_cost.long()[:, None, None]
    w = torch.clamp(dep_workload, min=0).long()
    placed = torch.where(dep_mask[:, None], placed_node[w].long(), 0)  # (D, N)
    placed_f = placed.to(F64)
    placed_zone = (placed_f @ tb.zone_onehot).long()  # (D, ZC)
    placed_rnoz = (placed_f @ tb.rnoz_onehot).long()  # (D, RC)
    placed_unloc = torch.where(tb.unloc[None, :], placed, 0).sum(dim=1)

    # same-node pods count separately: remove them from their zone
    zone_cnt = torch.clamp(
        placed_zone[:, None, :]
        - torch.where(tb.same_zone[None, :, :], placed[:, :, None], 0),
        min=0)  # (D, N, ZC)
    # same-zone pods are satisfied unconditionally (networkoverhead.go:
    # 542-545)
    sat_pair = tb.same_zone[None, :, :] | (
        tb.pair_known[None, :, :] & (tb.pair_lookup[None, :, :] <= mc))
    vio_pair = ~tb.same_zone[None, :, :] & tb.pair_known[None, :, :] & ~sat_pair
    satisfied = torch.where(sat_pair, zone_cnt, 0).sum(dim=(0, 2))
    violated = torch.where(vio_pair, zone_cnt, 0).sum(dim=(0, 2))
    cost = (zone_cnt * tb.pair_cost[None, :, :]).sum(dim=(0, 2))

    # same-node pods: satisfied, SameHostname cost (networkoverhead.go:
    # 521-525)
    same_node = placed.sum(dim=0)
    satisfied = satisfied + same_node
    cost = cost + SAME_HOST_COST * same_node

    # region-only placed pods
    rn_sat = tb.both_zoneless[None, :, :] | (
        tb.rn_known[None, :, :] & (tb.rcost_eff[None, :, :] <= mc))
    rn_vio = tb.rn_known[None, :, :] & ~rn_sat
    rnoz_cnt = torch.clamp(
        placed_rnoz[:, None, :]
        - torch.where(tb.rnoz_same_r[None, :, :], placed[:, :, None], 0),
        min=0)
    satisfied = satisfied + torch.where(rn_sat, rnoz_cnt, 0).sum(dim=(0, 2))
    violated = violated + torch.where(rn_vio, rnoz_cnt, 0).sum(dim=(0, 2))
    cost = cost + (rnoz_cnt * tb.rn_cost[None, :, :]).sum(dim=(0, 2))

    # unlocated placed pods: violated, MaxCost each
    unloc_cnt = torch.clamp(
        placed_unloc[:, None] - torch.where(tb.unloc[None, :], placed, 0),
        min=0).sum(dim=0)  # (N,)
    violated = violated + unloc_cnt
    cost = cost + MAX_COST * unloc_cnt
    return satisfied, violated, cost


def _class_placed(cls_dep_workload, cls_dep_mask, placed_node, tb):
    """The placed counts that both halves of the class tallies contract:
    (W, D, N) per dependency slot, their (W, N) sum, and the zone /
    region-only / unlocated aggregates, in float64."""
    w = torch.clamp(cls_dep_workload, min=0).long()
    placed = torch.where(cls_dep_mask[:, :, None], placed_node[w].to(F64),
                         0.0)  # (W, D, N)
    placed_sum = placed.sum(dim=1)  # (W, N)
    placed_zone = torch.einsum("wdn,nz->wdz", placed, tb.zone_onehot)
    placed_rnoz = torch.einsum("wdn,nr->wdr", placed, tb.rnoz_onehot)
    PU = (placed @ tb.unloc.to(F64)).sum(dim=1)  # (W,)
    return SimpleNamespace(
        placed_sum=placed_sum, placed_zone=placed_zone,
        placed_rnoz=placed_rnoz,
        PZ=placed_zone.sum(dim=1),  # (W, ZC)
        PR=placed_rnoz.sum(dim=1),  # (W, RC)
        # unlocated placed pods: violated, MaxCost each
        vu=PU[:, None] - torch.where(tb.unloc[None, :], placed_sum, 0.0),
    )


def _class_counts(c, mc, tb):
    """(W, N) float64 satisfied / violated counts of the class tallies
    from `_class_placed`'s aggregates `c` and the (W, D) thresholds."""
    W, D = mc.shape
    N = tb.zoned.shape[0]
    placed_sum = c.placed_sum
    kz_f = tb.kz.to(F64)  # known, not same zone (N, ZC)
    # zoned placed pods: the same-zone term collapses to a gather at the
    # candidate's own zone minus its own node's pods
    t_sz = torch.where(tb.zoned[None, :], c.PZ[:, tb.nz] - placed_sum, 0.0)
    # the threshold term, one (W, N, ZC) pass per dependency slot
    term_b = torch.zeros((W, N), dtype=F64, device=placed_sum.device)
    for d in range(D):
        le = tb.pair_lookup[None, :, :] <= mc[:, d, None, None]
        term_b = term_b + (torch.where(le, kz_f[None, :, :], 0.0)
                           * c.placed_zone[:, d, None, :]).sum(dim=2)
    known_t = c.PZ @ kz_f.T  # (W, N)

    # region-only placed pods
    rn_known_f = tb.rn_known.to(F64)
    t_bz = torch.where(tb.rnoz[None, :], c.PR[:, tb.nr] - placed_sum, 0.0)
    term_br = torch.zeros((W, N), dtype=F64, device=placed_sum.device)
    for d in range(D):
        le = tb.rcost_eff[None, :, :] <= mc[:, d, None, None]
        term_br = term_br + (torch.where(le, rn_known_f[None, :, :], 0.0)
                             * c.placed_rnoz[:, d, None, :]).sum(dim=2)
    known_tr = c.PR @ rn_known_f.T

    satisfied = t_sz + term_b + placed_sum + t_bz + term_br
    violated = (known_t - term_b) + (known_tr - term_br) + c.vu
    return satisfied, violated


def _class_cost(c, tb):
    """(W, N) float64 cost of the class tallies from `_class_placed`'s
    aggregates `c`: the Score half, which no Filter verdict reads."""
    cost_z = c.PZ @ tb.pair_cost.to(F64).T - torch.where(
        tb.zoned[None, :], c.placed_sum * SAME_ZONE_COST, 0.0)
    cost_r = c.PR @ tb.rn_cost.to(F64).T - torch.where(
        tb.rnoz[None, :], c.placed_sum * SAME_ZONE_COST, 0.0)
    return cost_z + cost_r + MAX_COST * c.vu


def class_dependency_counts(cls_dep_workload, cls_dep_max_cost,
                            cls_dep_mask, placed_node, node_zone,
                            node_region, zone_region, zone_cost,
                            region_cost, tables=None):
    """(W, N) int32 satisfied / violated tallies of every workload class:
    the first two outputs of `class_dependency_tallies` without its cost
    contractions, for a Filter that reads no score."""
    if tables is None:
        tables = pair_tables(node_zone, node_region, zone_region, zone_cost,
                             region_cost)
    c = _class_placed(cls_dep_workload, cls_dep_mask, placed_node, tables)
    satisfied, violated = _class_counts(c, cls_dep_max_cost.long(), tables)
    return satisfied.to(torch.int32), violated.to(torch.int32)


def class_dependency_tallies(cls_dep_workload, cls_dep_max_cost,
                             cls_dep_mask, placed_node, node_zone,
                             node_region, zone_region, zone_cost,
                             region_cost, tables=None):
    """(W, N) int32 satisfied / violated / cost tallies of every workload
    class at once: the JAX `class_dependency_tallies`, the tallies'
    linearity in the placed counts turned into (W, ZC) x (ZC, N)
    contractions against the class-independent pair tables, plus one
    (W, N, ZC) threshold pass per dependency slot (the MaxNetworkCost
    compare is the only per-dependency weight). Equal to
    `dependency_tallies` of each class row."""
    if tables is None:
        tables = pair_tables(node_zone, node_region, zone_region, zone_cost,
                             region_cost)
    c = _class_placed(cls_dep_workload, cls_dep_mask, placed_node, tables)
    satisfied, violated = _class_counts(c, cls_dep_max_cost.long(), tables)
    cost = _class_cost(c, tables)
    # int32 rows (values <= MAX_COST * placed pods), as JAX returns them
    return (satisfied.to(torch.int32), violated.to(torch.int32),
            cost.to(torch.int32))


def placed_commit(net_placed, workload, choice):
    """Reserve: count each placement of `workload` on `choice` (tensors
    of one shape; a -1 in either adds nothing) into a new (W, N) tensor.
    Integer accumulation: exact in any order."""
    w = torch.clamp(workload, min=0).long()
    n = torch.clamp(choice, min=0).long()
    add = ((workload >= 0) & (choice >= 0)).to(net_placed.dtype)
    return net_placed.index_put((w, n), add, accumulate=True)
