"""Bench configs 10 and 12, the rank-aware gangs (`bench.py` `rank_gangs`,
`bench.py:1950-2240`, and `mega_gangs`, `bench.py:2900-3080`), shared by
`tests/test_torch_gangs.py` (the port against the JAX package) and
`chip_smoke.py` (the card against the CPU).

Every function takes either package's names in a namespace and imports
neither package: `pkg.rank_gang_scenario`, `pkg.Scheduler`,
`pkg.Profile`, `pkg.plugins`, `pkg.run(scheduler, cluster, now, phase)`
(one `run_cycle`), `pkg.elastic_bounds`, `pkg.block_cost_view`,
`pkg.gang_cost_stats`, `pkg.rank_gang_quality`,
`pkg.elastic_satisfaction_quality` and `pkg.RankGangState`.

- Config 10: `RANK_GANG_SHAPE` (the full shape), `GANG_SMOKE_SHAPE` (the
  bench's reduced gate), `run_gang_arm` (the scenario through `run_cycle`
  until the queue drains), `elastic_transition` (a desired-width change
  run to convergence), `gang_placement_costs`, `gang_violations` and
  `rank_gangs` (the rank-aware arm, the grow and shrink transitions and
  the quorum-only Coscheduling baseline arm).
- Config 12: `MEGA_GANG_SHAPE`, `mega_gang_problem` (numpy) and
  `mega_gang_violations` (the independent replay of the hard
  constraints).
"""

from __future__ import annotations

import time

import numpy as np

from torch_churn_cases import capacity_violations

#: config 10's shape (`bench.py` RANK_GANG_SHAPE): 384 nodes over 2
#: regions x 3 zones, 24 MPI gangs of 8 ranks, 8 elastic DL jobs 2 / 4 / 8
RANK_GANG_SHAPE = dict(
    n_nodes=384, n_regions=2, zones_per_region=3, n_mpi=24, mpi_ranks=8,
    n_dl=8, dl_min=2, dl_desired=4, dl_max=8,
)
#: the bench's reduced gate (`bench.py` GANG_SMOKE_SHAPE)
GANG_SMOKE_SHAPE = dict(
    n_nodes=48, n_regions=2, zones_per_region=2, n_mpi=4, mpi_ranks=6,
    n_dl=2, dl_min=2, dl_desired=3, dl_max=6,
)
#: bench cycles advance the clock by this much, so the per-pod requeue
#: backoffs never stall a parked gang across the measured window
GANG_CYCLE_MS = 10_000

#: config 12's shape (`bench.py` MEGA_GANG_SHAPE): 10,240 nodes x 1,024
#: gangs of up to 8 ranks over 256 blocks in 8 regions, waves of 64
MEGA_GANG_SHAPE = dict(
    n_nodes=10_240, n_gangs=1_024, max_ranks=8, blocks=256, regions=8,
    quota_ns=32, resident_frac=0.8, wave=64, seed=0,
)


def flagship_profile(pkg):
    """Config 10's per-pod profile: NodeResourcesAllocatable,
    Coscheduling and CapacityScheduling."""
    P = pkg.plugins
    return pkg.Profile(plugins=[
        P.NodeResourcesAllocatable(), P.Coscheduling(),
        P.CapacityScheduling(),
    ])


def gang_placement_costs(pkg, cluster):
    """A cluster's CURRENT rank-gang placements scored: per-gang max /
    sum inter-rank cost and `rank_gang_quality`'s objectives, from the
    bound members' nodes against the scenario's NetworkTopology weights
    (`bench.py` `_gang_placement_costs`): both arms get one yardstick."""
    node_pos, zones, block_cost = pkg.block_cost_view(cluster)
    groups = [
        pg for _, pg in sorted(cluster.pod_groups.items())
        if getattr(pg, "rank_aware", False)
    ]
    rows, per_gang = [], {}
    M = 1
    for pg in groups:
        bound = [
            node_pos[p.node_name] for p in cluster.gang_members(pg)
            if p.node_name in node_pos
        ]
        rows.append((pg.full_name, bound))
        M = max(M, len(bound))
    rank_nodes = np.full((max(len(rows), 1), M), -1, np.int32)
    rank_mask = np.zeros((max(len(rows), 1), M), bool)
    for g, (_, bound) in enumerate(rows):
        rank_nodes[g, : len(bound)] = bound
        rank_mask[g, : len(bound)] = True
    max_cost, sum_cost = pkg.gang_cost_stats(
        rank_nodes, rank_mask, zones, block_cost
    )
    for g, (name, bound) in enumerate(rows):
        per_gang[name] = {
            "ranks": len(bound),
            "max_cost": int(max_cost[g]),
            "sum_cost": int(sum_cost[g]),
        }
    quality = pkg.rank_gang_quality(rank_nodes, rank_mask, zones, block_cost)
    return per_gang, quality


def gang_violations(cluster) -> dict:
    """The hard constraints replayed over the bound population
    (`bench.py` `_gang_violations`): node capacity, ElasticQuota max per
    namespace, and the rank-gang quorum (a rank-aware gang's bound count
    is 0 or at least min_member)."""
    quota_violations = 0
    used: dict = {}
    for pod in cluster.pods.values():
        if pod.node_name is None:
            continue
        bucket = used.setdefault(pod.namespace, {})
        for r, q in pod.effective_request().items():
            bucket[r] = bucket.get(r, 0) + q
    for eq in cluster.quotas.values():
        bucket = used.get(eq.namespace, {})
        for r, cap in eq.max.items():
            if bucket.get(r, 0) > cap:
                quota_violations += 1
    quorum_violations = 0
    for pg in cluster.pod_groups.values():
        if not getattr(pg, "rank_aware", False):
            continue
        bound = sum(
            1 for p in cluster.gang_members(pg) if p.node_name is not None
        )
        if 0 < bound < pg.min_member:
            quorum_violations += 1
    return {
        "capacity": capacity_violations(cluster),
        "quota": quota_violations,
        "quorum": quorum_violations,
    }


def run_gang_arm(pkg, shape, phase, seed=0, max_cycles=8) -> dict:
    """One arm of config 10 (`bench.py` `_run_gang_arm`): the scenario
    through `run_cycle` (with the gang phase when `phase` is given) until
    the queue drains or `max_cycles`. Returns the cluster and scheduler,
    each cycle's report fields, per-gang admission latency in cycles and
    the wall time."""
    cluster = pkg.rank_gang_scenario(seed=seed, **shape)
    scheduler = pkg.Scheduler(flagship_profile(pkg))
    first_pending: dict = {}
    admitted_at: dict = {}
    reports = []
    decided = 0
    start = time.perf_counter()
    for cycle in range(max_cycles):
        now = GANG_CYCLE_MS * (cycle + 1)
        pending_gangs = {
            pg.full_name
            for p in cluster.pending_pods()
            if (pg := cluster.pod_group_of(p)) is not None
        }
        for name in pending_gangs:
            first_pending.setdefault(name, cycle)
        report = pkg.run(scheduler, cluster, now, phase)
        reports.append(report_fields(report))
        decided += len(report.bound) + len(report.failed)
        for pg in cluster.pod_groups.values():
            name = pg.full_name
            if name in admitted_at or name not in first_pending:
                continue
            bound = sum(
                1 for p in cluster.gang_members(pg)
                if p.node_name is not None
            )
            if bound >= pg.min_member:
                admitted_at[name] = cycle - first_pending[name]
        if not cluster.pending_pods():
            break
    elapsed = time.perf_counter() - start
    return {
        "cluster": cluster, "scheduler": scheduler, "reports": reports,
        "latencies": admitted_at, "first_pending": first_pending,
        "decided": decided, "elapsed": elapsed, "cycles": cycle + 1,
    }


def report_fields(report) -> tuple:
    """What a gang cycle decided: bound, failed, failed_by, rejected
    gangs and the phase's per-gang stats."""
    return (dict(report.bound), list(report.failed), dict(report.failed_by),
            list(report.rejected_gangs), dict(report.rank_gangs))


def elastic_transition(pkg, cluster, scheduler, phase, set_desired,
                       start_now, max_cycles=4, reports=None) -> int:
    """Apply `set_desired(pg) -> int` to every elastic rank-aware gang
    (through `add_pod_group`: PodGroup/Update events) and run cycles until
    every one's LIVE width equals its clamped desired. Returns the
    convergence cycle count (max_cycles + 1 = did not converge)
    (`bench.py` `_elastic_transition`)."""
    targets = {}
    for pg in list(cluster.pod_groups.values()):
        if getattr(pg, "rank_aware", False) and \
                pg.desired_replicas is not None:
            pg.desired_replicas = set_desired(pg)
            cluster.add_pod_group(pg)
            targets[pg.full_name] = pkg.elastic_bounds(pg)[1]

    def converged():
        for name, want in targets.items():
            pg = cluster.pod_groups[name]
            live = sum(
                1 for p in cluster.gang_members(pg)
                if p.node_name is not None
            )
            if live != want:
                return False
        return True

    for k in range(max_cycles):
        if converged():
            return k
        report = pkg.run(scheduler, cluster,
                         start_now + GANG_CYCLE_MS * (k + 1), phase)
        if reports is not None:
            reports.append(report_fields(report))
    return max_cycles if converged() else max_cycles + 1


def store_state(cluster) -> dict:
    """The store's placements and parked pods, for card == CPU and port
    == JAX comparisons."""
    return {
        "placements": {uid: p.node_name for uid, p in cluster.pods.items()
                       if p.node_name is not None},
        "pods": sorted(cluster.pods),
        "unschedulable": sorted(cluster.unschedulable_since),
    }


def rank_gangs(pkg, shape, phase, seed=0) -> dict:
    """Config 10 (`bench.py` `rank_gangs`): the rank-aware arm through
    `phase` until the queue drains, the elastic grow (+2, capped at max)
    and shrink (to min) transitions, then the quorum-only baseline arm
    on the same scenario. Returns the bench's line, each arm's reports
    and stores, and the wall times."""
    rank = run_gang_arm(pkg, shape, phase, seed=seed)
    admit_now = GANG_CYCLE_MS * (rank["cycles"] + 1)
    transitions = []
    t0 = time.perf_counter()
    grow_cycles = elastic_transition(
        pkg, rank["cluster"], rank["scheduler"], phase,
        lambda pg: min(pg.max_replicas or 10**6,
                       (pg.desired_replicas or pg.min_member) + 2),
        admit_now, reports=transitions,
    )
    shrink_cycles = elastic_transition(
        pkg, rank["cluster"], rank["scheduler"], phase,
        lambda pg: pg.min_member, admit_now + GANG_CYCLE_MS * 8,
        reports=transitions,
    )
    transition_s = time.perf_counter() - t0
    rank_costs, rank_quality = gang_placement_costs(pkg, rank["cluster"])
    base = run_gang_arm(pkg, shape, None, seed=seed,
                        max_cycles=rank["cycles"] + 2)
    _base_costs, base_quality = gang_placement_costs(pkg, base["cluster"])
    lat = list(rank["latencies"].values())
    elastic_sat = pkg.elastic_satisfaction_quality([
        {
            name: {
                "resident": sum(
                    1 for p in rank["cluster"].gang_members(pg)
                    if p.node_name is not None
                ),
                "placed_new": 0,
                "desired": pg.desired_replicas or pg.min_member,
            }
            for name, pg in rank["cluster"].pod_groups.items()
            if getattr(pg, "rank_aware", False)
        }
    ])
    line = {
        "gangs": len(rank_costs),
        "gangs_admitted": len(lat),
        "gang_admission_latency_cycles": (
            float(np.mean(lat)) if lat else None
        ),
        "max_inter_rank_cost": rank_quality["rank_cost_max"],
        "baseline_max_inter_rank_cost": base_quality["rank_cost_max"],
        "rank_cost_p99": rank_quality["rank_cost_p99"],
        "baseline_rank_cost_p99": base_quality["rank_cost_p99"],
        "gang_spread_cost": rank_quality["gang_spread_cost"],
        "baseline_gang_spread_cost": base_quality["gang_spread_cost"],
        "elastic_grow_convergence_cycles": grow_cycles,
        "elastic_shrink_convergence_cycles": shrink_cycles,
        "elastic_satisfaction": elastic_sat,
        "violations": gang_violations(rank["cluster"]),
        "baseline_violations": gang_violations(base["cluster"]),
        "twin_drift": getattr(phase, "max_drift", None),
    }
    return {
        "line": line, "rank": rank, "base": base,
        "transitions": transitions, "transition_s": transition_s,
        "rank_costs": rank_costs,
    }


# ---------------------------------------------------------------------------
# config 12
# ---------------------------------------------------------------------------


def mega_gang_problem(shape, RankGangState) -> dict:
    """Config 12's problem as numpy (`bench.py` `mega_gang_problem`):
    heterogeneous node SKUs over `blocks` zone blocks grouped into
    regions (same block 1, same region 10, across regions 40),
    heterogeneous rank demand (the launcher 2x), half the namespaces
    quota-capped, elastic residents anchored per `resident_frac`."""
    rng = np.random.default_rng(shape["seed"])
    N, G, M, B = (shape["n_nodes"], shape["n_gangs"], shape["max_ranks"],
                  shape["blocks"])
    Q, regions = shape["quota_ns"], shape["regions"]
    R = 3  # a cpu, memory, pods-style axis (the gang solve is axis-agnostic)
    node_block = (np.arange(N) * B // N).astype(np.int32)
    free0 = np.zeros((N, R), np.int64)
    sku = rng.integers(0, 4, N)
    # a synthetic 3-slot axis local to this problem
    free0[:, 0] = np.array([32_000, 48_000, 64_000, 96_000])[sku]  # graft-lint: ignore[GL005]
    free0[:, 1] = np.array([128, 192, 256, 384])[sku]  # graft-lint: ignore[GL005]
    free0[:, 2] = 48  # graft-lint: ignore[GL005]
    zone_region = (np.arange(B) * regions // B)
    block_cost = np.where(
        zone_region[:, None] == zone_region[None, :], 10, 40
    ).astype(np.int32)
    np.fill_diagonal(block_cost, 1)
    rank_req = np.zeros((G, M, R), np.int64)
    rank_mask = np.zeros((G, M), bool)
    prev = np.full((G, M), -1, np.int32)
    min_ranks = np.zeros(G, np.int32)
    nodes_of_block = [np.where(node_block == b)[0] for b in range(B)]
    for g in range(G):
        k = int(rng.integers(max(4, M // 2), M + 1))
        rank_mask[g, :k] = True
        cpu = int(rng.integers(1_000, 4_000))
        rank_req[g, :k, 0] = cpu
        rank_req[g, 0, 0] = 2 * cpu  # the MPI launcher wants double
        rank_req[g, :k, 1] = int(rng.integers(4, 16))
        rank_req[g, :k, 2] = 1
        if rng.random() < shape["resident_frac"]:
            # a resident elastic gang: anchored ranks on one block, 1-2
            # pending grow or repair ranks
            b = int(rng.integers(0, B))
            pend = int(rng.integers(1, 3))
            block_nodes = nodes_of_block[b]
            prev[g, : k - pend] = block_nodes[
                rng.integers(0, len(block_nodes), k - pend)
            ]
            min_ranks[g] = max(2, k - pend)
        else:
            min_ranks[g] = k if rng.random() < 0.7 else max(2, k - 2)
    quota_max = np.full((Q, R), np.iinfo(np.int64).max, np.int64)
    quota_has = np.zeros(Q, bool)
    quota_has[: Q // 2] = True
    quota_max[: Q // 2, 0] = rng.integers(400_000, 4_000_000, Q // 2)
    quota_max[: Q // 2, 1] = rng.integers(4_000, 40_000, Q // 2)
    quota_max[: Q // 2, 2] = rng.integers(400, 4_000, Q // 2)
    gangs = RankGangState(
        rank_req=rank_req, rank_mask=rank_mask, prev_assigned=prev,
        min_ranks=min_ranks,
        gang_ns=rng.integers(-1, Q, G).astype(np.int32),
        gang_mask=np.ones(G, bool),
        node_block=node_block, block_cost=block_cost,
        quota_max=quota_max, quota_has=quota_has,
    )
    return {
        "gangs": gangs, "free0": free0,
        "eq_used0": np.zeros((Q, R), np.int64),
        "node_mask": np.ones(N, bool),
    }


def cut_mega_shape(n_nodes, n_gangs, blocks=None) -> dict:
    """Config 12's shape with fewer nodes and gangs (and blocks in the
    same nodes-per-block ratio unless given)."""
    full = MEGA_GANG_SHAPE
    if blocks is None:
        blocks = max(1, full["blocks"] * n_nodes // full["n_nodes"])
    return dict(full, n_nodes=n_nodes, n_gangs=n_gangs, blocks=blocks,
                quota_ns=max(2, full["quota_ns"] * n_gangs // full["n_gangs"]))


def mega_gang_violations(problem, rank_nodes, admitted, placed_new) -> dict:
    """An independent replay of the gang hard constraints over emitted
    placements (`bench.py` `_mega_gang_violations`): fit (new demand per
    node within free0, schedulable nodes only), quota caps, quorum and
    zero partial ranks."""
    gangs = problem["gangs"]
    free0 = problem["free0"]
    node_mask = problem["node_mask"]
    new = (rank_nodes >= 0) & (gangs.prev_assigned < 0) & gangs.rank_mask
    fit = quota = quorum = 0
    used = np.zeros_like(free0)
    g_idx, m_idx = np.nonzero(new)
    nodes = rank_nodes[g_idx, m_idx]
    if not node_mask[nodes].all():
        fit += int((~node_mask[nodes]).sum())
    np.add.at(used, nodes, gangs.rank_req[g_idx, m_idx])
    fit += int((used > free0).any(axis=1).sum())
    for q in range(gangs.quota_max.shape[0]):
        if not gangs.quota_has[q]:
            continue
        sel = gangs.gang_ns[g_idx] == q
        dem = gangs.rank_req[g_idx[sel], m_idx[sel]].sum(axis=0)
        if ((problem["eq_used0"][q] + dem) > gangs.quota_max[q]).any():
            quota += 1
    resident = ((gangs.prev_assigned >= 0) & gangs.rank_mask).sum(axis=1)
    n_new = new.sum(axis=1)
    quorum += int((
        admitted & (resident + n_new < gangs.min_ranks)
    ).sum())
    quorum += int((~admitted & (n_new > 0)).sum())
    quorum += int((admitted & (n_new != placed_new)).sum())
    return {"fit": int(fit), "quota": quota, "quorum": quorum}
