#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. print the card's `nvidia-smi --query-gpu=name,power.limit` line;
2. build the kernels from `scheduler_plugins_tpu_torch/csrc` (one `nvcc`
   per source, in parallel);
3. hold each kernel against its plain PyTorch version on the card at S = 8
   blocks and W in {256, 1024, 8192} (fused_election over blocks of
   BS = 1280 rows, the north star's), in every dtype it takes: exact
   equality (tolerance 0 — the kernels move, add and compare integers,
   float64 ones below 2^53), with kernel, plain and library times;
4. the north-star problem — `allocatable_scenario(10_240, 102_400)`, queue
   sorted by creation time, 8192-pod chunks, rescue window 256 — through
   `sharded_wave_solve` with 8 rank blocks, bit-identical to the unblocked
   `batch_solve` on the same snapshot, every kernel launched, hard
   constraints checked on the host;
5. the streamed chunk pipeline (`parallel/pipeline.py`): the same
   north-star cluster through `run_chunk_pipeline` as `bench.north_star`
   drives it (host numpy chunks staged a chunk ahead), equal to
   `batch_solve` on the same snapshot, with its timeline summary; bench
   config 6 (`allocatable_scenario(10_240, 102_400)`, flagship profile)
   through one `run_cycle(stream_chunk=4096)` on the card and, from a fresh
   cluster, on the CPU, with identical reports and store, no store
   violation, and the streamed solve proved to have served the cycle, then
   `CycleReport.explain(uid, top_k=5)` of the first, the 51,200th and the
   last pod in queue order on both reports (the card's under sync-debug
   "error"): identical tables, each candidate's scores summing to its
   total, each explain's wall time printed; and `cycle_script` with
   `stream_chunk=4`, card against CPU on every cycle. No election kernel
   lies on these paths: their launch counts print 0;
6. `gang_quota_scenario(32, 64, 1024)` the same way (gang and quota
   admission, quota prefix and quorum tail), plus a tight problem (40
   nodes, 3000 pods: rescue waves and hopeless pods) solved on the card and
   on the CPU with identical results;
7. the sequential parity solve (`Scheduler.solve`, the three-plugin
   flagship profile) on bench config 4's shape (`gang_quota_scenario(32,
   64, 1024)`), on the `entry()` problem (`allocatable_scenario(16, 32)`)
   and on a cluster with nominated pods: each solved on the card under
   `torch.cuda.set_sync_debug_mode("error")` (a host sync inside the loop
   raises) and on the CPU, with every output and final carry identical,
   hard constraints checked on the host, and the device work a step
   enqueues counted with `torch.profiler`; then config 4 with spread node
   sizes (`spread_config4`: on config 4's identical nodes every score
   column is 0) after `set_live_weights([3, 1, 1])`: on the card under
   sync-debug "error", equal to the CPU under the same vector, to a
   profile loaded with `"weights": [3, 1, 1]` and to the CPU after
   `set_live_weights(None)`; the explain rows of its first 256 queued
   pods card against CPU, each score column 3, 1, 1 times the card's
   unit-weight column and the allocatable column not all 0; on config 4
   and on the spread cluster, the same host calls enqueueing device work
   a step (kernel launches, copies, fills, by name) as the unit-weight
   run, with the device records a step printed beside them (CUPTI may
   drop device records, so those are not held);
8. the scheduling cycle (`run_cycle`): the README quick start on the
   card; bench config 4's shape through one cycle on the card and, from a
   fresh cluster, on the CPU, with identical reports and store state, no
   fit, quota or quorum violation in the store, and each stage's wall time
   printed, then pod 0's explain on both reports (identical, and its
   winner the node the cycle bound it to); the spread config 4 through
   one cycle under the live vector, card against CPU, and the explain of
   its first, middle and last queued pods on both reports: identical,
   some score not 0, every score the weight times the same report's
   unit-weight score, pod 0's winner its bind; `cycle_script`
   (`tests/torch_cycle_scripts.py`, 1024 nodes, small batches: Permit
   Wait then fan-out bind, a permit timeout, a whole-gang rejection with
   backoff, a parked pod skipped until a Node/Add, a quota preemption
   whose nominee binds once its victims are gone) card against CPU on
   every cycle; and `pdb_script`, the same with one more cycle whose
   preemption a PodDisruptionBudget steers, run with and without the PDB,
   card against CPU on every cycle, the two nominated nodes printed and
   required to differ;
9. the Trimaran plugins: bench config 2 (`trimaran_scenario(5000,
   2048)`, TargetLoadPacking + LoadVariationRiskBalancing, the shape of
   `bench.py:4495-4499`, uncut) through `Scheduler.solve` on the card
   (under sync-debug "error") and on the CPU, every output and final carry
   identical, 0 fit violations, ms a pod on both, 0 election-kernel
   launches, and the host calls that enqueue device work a step by name;
   two `run_cycle`s of config 2 (cycle 1 binds the batch, then 256 more
   pods and 30 s later cycle 2, whose snapshot must carry cycle 1's binds
   as `missing_cpu_millis` on their nodes), card against CPU on both
   reports and the store; its solve under live weights [3, 1] and [1, 3],
   card == CPU, with how many pods the two place differently; three of
   cycle 1's pods explained, identical, both plugins' columns nonzero,
   pod 0's winner its bind; and the seeded cases of
   `tests/torch_trimaran_cases.py` (LROC, Peaks, a loaded TLP beside
   LVRB), card == CPU, with how many raw scores differ and by how much;
10. NUMA: bench config 3 (`numa_scenario(1024, 512, zones=8)`,
   NodeResourceTopologyMatch, the shape of `bench.py:4500-4504`, uncut)
   through `Scheduler.solve` on the card (under sync-debug "error") and on
   the CPU, every output and final carry (the zone carry `numa_avail`
   included) identical, 0 fit and 0 zone violations (the placements
   replayed in queue order with the pessimistic deduction, each placed
   guaranteed pod needing one zone that holds its request), ms a pod, and
   the host calls that enqueue device work a step; then one `run_cycle`
   of it, card against CPU on the report and the store (`[numa]` lines);
11. the network-aware plugins: bench config 5 (`network_scenario(1024,
   1024)`, NetworkOverhead + TopologicalSort, the shape of
   `bench.py:4510-4514`, uncut) through `Scheduler.solve` on the card
   (under sync-debug "error") and on the CPU, every output and final carry
   (the placement carry `net_placed` included) identical, 0 fit and 0
   dependency-threshold violations (the placements replayed in queue
   order on the host: each placed pod with dependencies had no more
   violated than satisfied ones on its node at its turn), ms a pod and
   the host calls that enqueue device work a step; then one `run_cycle`
   of it, card against CPU on the report and the store (`[network]`
   lines);
12. the NRT cache tier: `tests/torch_numa_cases.nrt_cache_script`, four
   cycles of a NUMA profile with cacheResyncPeriodSeconds set (the
   over-reserve cache: an overcommit the assumed deduction blocks, a
   foreign pod that makes its node stale, failures that mark nodes
   maybe-overreserved, a resync whose matching fingerprints flush and
   bump the generation), card against CPU on every cycle: reports, store
   and the cache's state (`[nrt_cache]` lines);
13. the batched profile solve (`parallel.solver.profile_batch_solve`,
   `collect_stats=True`) on bench configs 3, 2 (`trimaran_scenario(5000,
   2048)`, TLP + LVRB), 4 (`gang_quota_scenario(32, 64, 1024)`, the
   flagship's targeted fast path) and 5, each uncut, on the card and on
   the CPU: assignment, admitted, wait and the wave stats identical, 0
   fit, zone, quota, quorum and dependency-threshold violations (config
   5's waves replayed in order), pods/s, waves, occupancy and the host
   syncs a wave counted under sync-debug "warn" (`[batch]` lines).
   Phases 9 to 13 launch no election kernel: their counts print
   0 / 0 / 0;
14. the kernel table as one JSON line (times at the shapes, dtypes and
   strides the north-star path launched), then the card's line, then the
   result line `{"ok": true, "device": {...}}` last.

Times: `ms` is the mean of 50 back-to-back calls of the Python wrapper
between CUDA events, so at these small shapes it is mostly the host's cost
to dispatch a call; `device_ms` is the same 50 calls captured in one CUDA
graph and replayed, which removes the host. `library_ms` and
`library_device_ms` time one PyTorch call for the same function the same
two ways. Each is the median of 5 rounds that take all the times of an
input in turn.

Imports nothing of JAX. Importing this module runs nothing.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

S_BLOCKS = 8
GRID_W = (256, 1024, 8192)
#: interleaved timing rounds per kernel input; each time is their median
ROUNDS = 5
#: HBM rate of an H100 SXM, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
SOURCE = "scheduler_plugins_tpu_torch/csrc/election.cu"
REPLACES = {
    "block_offsets": "scheduler_plugins_tpu/parallel/kernels.py:370",
    "elect_min": "scheduler_plugins_tpu/parallel/kernels.py:387",
    "fused_election": "scheduler_plugins_tpu/parallel/kernels.py:411",
}
NORTH_STAR = dict(n_nodes=10_240, n_pods=102_400, chunk=8192, rescue_window=256)
#: bench config 6 (`bench.py:762`) through one cycle: the flagship profile
#: streamed in chunks of 4096 pods (the snapshot pads 102,400 pods to a
#: multiple of 1024, so 4096 divides the rows and 8192 would not)
CONFIG6 = dict(n_nodes=10_240, n_pods=102_400, stream_chunk=4096)
#: bench config 4 (`bench.py:4505`): the three-plugin sequential solve
CONFIG4 = dict(n_gangs=32, gang_size=64, n_nodes=1024)
#: bench config 2 (`bench.py:4495-4499`): `trimaran_scenario(5000, 2048)`,
#: TargetLoadPacking + LoadVariationRiskBalancing, the sequential solve
CONFIG2 = dict(n_nodes=5000, n_pods=2048)
#: pods added between config 2's two cycles, and the time between them
#: (inside the metrics reporting interval, so cycle 1's binds count as
#: missing CPU in cycle 2's snapshot)
CYCLE2_NEW_PODS = 256
CYCLE2_GAP_MS = 30_000
#: the two live weight vectors of the config 2 profile
CONFIG2_WEIGHTS = ([3, 1], [1, 3])
#: bench config 3 (`bench.py:4500-4504`): `numa_scenario(1024, 512,
#: zones=8)`, NodeResourceTopologyMatch, uncut
CONFIG3 = dict(n_nodes=1024, n_pods=512, zones=8)
#: bench config 5 (`bench.py:4510-4514`): `network_scenario(1024, 1024)`,
#: NetworkOverhead + TopologicalSort, uncut
CONFIG5 = dict(n_nodes=1024, n_pods=1024)
#: the in-tree phase's problems at full width: the JAX package's
#: full-roster mixed profile (NodeResourcesAllocatable,
#: NodeResourceTopologyMatch, NetworkOverhead, PodTopologySpread) on
#: `mixed_scenario(1024, 1024)`, and the in-tree roster (NodeAffinity,
#: TaintToleration, PodTopologySpread, InterPodAffinity beside
#: NodeResourcesAllocatable) on `tests/torch_intree_cases.intree_cluster`
MIXED_FULL = dict(n_nodes=1024, n_pods=1024)
INTREE_1K = dict(n_nodes=1024, n_pods=1024, n_bound=256)
#: pods added between the in-tree phase's two cycles, with a Namespace
INTREE_CYCLE2_PODS = 256
#: pods of config 4 whose steps the profiler counts (and twice as many)
PROFILE_PODS = 64
#: the flagship profile's plugins, and the live weight vector its parity
#: solve is held to
FLAGSHIP = ("NodeResourcesAllocatable", "Coscheduling", "CapacityScheduling")
LIVE_WEIGHTS = [3, 1, 1]
#: queued pods of the spread config 4 whose explain rows the live-weight
#: phase holds card against CPU and against the unit-weight rows
LIVE_EXPLAIN_ROWS = 256
#: explain at the north-star width: queue positions in config 6's batch
EXPLAIN_POSITIONS = (0, 51_199, -1)
#: rank rows per block in the fused_election grid: the north star's
GRID_BS = NORTH_STAR["n_nodes"] // S_BLOCKS


def _tests_on_path() -> None:
    """Put the repo's `tests/` on `sys.path`: the smoke shares its cases
    (`torch_cycle_scripts`, `torch_parity_cases`) with the port's tests."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def sync_errors(device):
    """On the card, make any host sync inside the block raise
    (`torch.cuda.set_sync_debug_mode("error")`); on the CPU, nothing."""
    import torch

    if device.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def time_ms(fn, iters: int = 50) -> float:
    """Mean milliseconds per call on the card, host dispatch included:
    CUDA events around `iters` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, replays: int = 4) -> float:
    """Mean milliseconds per call on the device alone: `iters` calls
    captured in one CUDA graph (after a warm-up on a side stream), replayed
    `replays` times between CUDA events after one warm replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def kernel_inputs(name: str, key: tuple, device, seed: int):
    """Random inputs in each kernel's domain at `key` = (shape, dtype,
    strides of the first input), as `LAUNCH_SHAPES` records them —
    block_offsets (S, L) int64 or float64, exact integers below 2^40, with
    the given row stride; elect_min (S, H, L) int32 or int64 with some of
    the dtype's maximum as padding; fused_election at shape (S, BS, R, W):
    `prop` (S, W) int64 with each block proposing a rank of its own block
    or the sentinel N = S*BS, `node_ids` (S, BS) int32 a permutation of the
    real nodes with -1 on the last BS // 2 (padding) rows, and `rank_free`
    (S, BS, R) int64 below 2^40, zero on the padding rows."""
    import torch

    shape, dtype, strides = key
    g = torch.Generator(device="cpu").manual_seed(seed)
    # a flat buffer viewed with the path's strides: a row stride wider than
    # the row leaves the path's gaps between rows
    span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    if name == "block_offsets":
        flat = torch.randint(0, 1 << 40, (span,), generator=g).to(dtype)
        return (torch.as_strided(flat.to(device), shape, strides),)
    if name == "elect_min":
        flat = torch.randint(0, 1 << 30, (span,), generator=g).to(dtype)
        flat[torch.rand(span, generator=g) < 0.1] = torch.iinfo(dtype).max
        return (torch.as_strided(flat.to(device), shape, strides),)
    S, BS, R, W = shape
    N = S * BS
    n_real = N - BS // 2
    node_ids = torch.full((N,), -1, dtype=torch.int32)
    node_ids[:n_real] = torch.randperm(n_real, generator=g).to(torch.int32)
    rank_free = torch.randint(0, 1 << 40, (N, R), generator=g)
    rank_free[n_real:] = 0
    propose = torch.rand((S, W), generator=g) < 0.4
    prop = torch.arange(S)[:, None] * BS + torch.randint(0, BS, (S, W), generator=g)
    prop = torch.where(propose, prop, N)
    return (prop.to(device), node_ids.view(S, BS).to(device),
            rank_free.view(S, BS, R).to(device))


def check_kernel(name: str, key: tuple, device, seed: int = 0) -> dict:
    """Kernel vs plain version on one input (`key` as in `kernel_inputs`):
    exact equality, and times of the kernel, the plain version and the
    library yardstick, each with the host (`ms`) and without it
    (`device_ms`)."""
    import torch

    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    shape, dtype, _ = key
    args = kernel_inputs(name, key, device, seed)
    kernel = getattr(pk, name)
    plain = getattr(pk, f"{name}_plain")
    got, want = kernel(*args), plain(*args)
    _sync(device)
    pairs = [(got, want)] if isinstance(got, torch.Tensor) else list(zip(got, want))
    err = max(
        float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
        for a, b in pairs
    )
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name} {key}: kernel != plain (max err {err})")
    winners = None
    if name == "fused_election":
        # every proposal lies in its own block: a column whose rank is
        # real is a column whose winner's id and row are read
        S, BS = shape[:2]
        winners = int((want[0] < S * BS).sum())
    library = {
        "block_offsets": lambda: torch.cumsum(args[0], dim=0),
        "elect_min": lambda: torch.amin(args[0], dim=0),
    }.get(name)
    timers = {
        "ms": (time_ms, lambda: kernel(*args)),
        "device_ms": (graph_ms, lambda: kernel(*args)),
        "plain_ms": (time_ms, lambda: plain(*args)),
    }
    if library:
        timers["library_ms"] = (time_ms, library)
        timers["library_device_ms"] = (graph_ms, library)
    # the host's speed drifts: take every time in each round, in turn
    samples = {k: [] for k in timers}
    for _ in range(ROUNDS):
        for k, (timer, fn) in timers.items():
            samples[k].append(timer(fn))
    times = {k: statistics.median(v) for k, v in samples.items()}
    return {
        "max_abs_err": err,
        "ms": times["ms"],
        "device_ms": times["device_ms"],
        "plain_ms": times["plain_ms"],
        "library_ms": times.get("library_ms"),
        "library_device_ms": times.get("library_device_ms"),
        "bound_ms": (bytes_moved(name, shape, dtype, winners)
                     / HBM_BYTES_PER_S * 1e3),
    }


def bytes_moved(name: str, shape: tuple, dtype, winners=None) -> int:
    """Bytes the function must move: each input it needs read once, each
    output written once, at the input's element size (8 bytes for int64
    and float64, 4 for int32). fused_election at (S, BS, R, W) needs all S
    int64 keys of a column, and the int32 node id and R int64 free values
    of the winner only for the `winners` columns that have one (all W if
    not given); it writes rank, node id + 1 and the row, 8*(2 + R) bytes a
    column."""
    item = dtype.itemsize
    if name == "block_offsets":
        S, L = shape
        return item * (S * L + S * L + L)
    if name == "elect_min":
        S, H, L = shape
        return item * (S * H * L + H * L)
    S, _, R, W = shape
    winners = W if winners is None else winners
    return 8 * S * W + winners * (4 + 8 * R) + 8 * W * (2 + R)


def grid_shapes(R: int):
    """The phase-3 grid at S blocks: each kernel in every dtype it takes,
    at the shapes the solve gives it at window W, as (name, key)."""
    import torch

    i32, i64, f64 = torch.int32, torch.int64, torch.float64
    for W in GRID_W:
        for dtype in (i64, f64):
            yield "block_offsets", ((S_BLOCKS, W), dtype, (W, 1))
        for dtype in (i32, i64):
            yield "elect_min", ((S_BLOCKS, R, W), dtype, (R * W, W, 1))
        yield "fused_election", ((S_BLOCKS, GRID_BS, R, W), i64, (W, 1))


def fit_violations(snap, assignment) -> int:
    """Host-side hard-constraint check, independent of the solver: every
    placed pod on a real schedulable node, and no node's summed fit demand
    (pods slot 1 per pod) above its free capacity."""
    import numpy as np

    from scheduler_plugins_tpu_torch.ops import PODS_I

    a = assignment.cpu().numpy().astype(np.int64)
    alloc = snap.nodes.alloc.cpu().numpy()
    free = alloc - snap.nodes.requested.cpu().numpy()
    mask = snap.nodes.mask.cpu().numpy()
    demand = snap.pods.req.cpu().numpy().copy()
    demand[:, PODS_I] = 1
    placed = a >= 0
    bad = int((placed & (a >= alloc.shape[0])).sum())
    nodes = a[placed & (a < alloc.shape[0])]
    bad += int((~mask[nodes]).sum())
    used = np.zeros_like(free)
    np.add.at(used, nodes, demand[placed & (a < alloc.shape[0])])
    return bad + int((used > free).any(axis=1).sum())


def drive(label: str, cluster, device, n_blocks: int, chunk=None,
          rescue_window: int = 512, pad_to=None):
    """Snapshot `cluster` on `device`, solve it unblocked and in rank
    blocks, and require identical results. The launch counts are reset just
    before the blocked solve and read just after it."""
    import torch

    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel.solver import (
        batch_solve,
        sharded_wave_solve,
    )

    t0 = time.perf_counter()
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    pad_pods = None
    if pad_to:
        pad_pods = -(-len(pending) // pad_to) * pad_to
    snap, meta = cluster.snapshot(pending, now_ms=0, device=device,
                                  pad_pods=pad_pods)
    weights = meta.index.encode({"cpu": 1 << 20, "memory": 1})
    _sync(device)
    setup_s = time.perf_counter() - t0
    kw = dict(chunk=chunk, rescue_window=rescue_window)

    t0 = time.perf_counter()
    a_ref, ad_ref, w_ref = batch_solve(snap, weights, **kw)
    _sync(device)
    ref_s = time.perf_counter() - t0

    pk.reset_launches()
    t0 = time.perf_counter()
    a, ad, wt, stats = sharded_wave_solve(
        snap, weights, n_blocks, collect_stats=True, **kw
    )
    _sync(device)
    solve_s = time.perf_counter() - t0
    launches = pk.launches()
    shapes = {k: dict(v) for k, v in pk.LAUNCH_SHAPES.items()}

    same = (torch.equal(a, a_ref) and torch.equal(ad, ad_ref)
            and torch.equal(wt, w_ref))
    placed = int((a >= 0).sum())
    viol = fit_violations(snap, a)
    print(
        f"[{label}] nodes={len(meta.node_names)} pods={len(pending)} "
        f"blocks={n_blocks} setup_s={setup_s:.3f} unblocked_s={ref_s:.3f} "
        f"blocked_s={solve_s:.3f} placed={placed} admitted={int(ad.sum())} "
        f"wait={int(wt.sum())} pods_per_s={placed / solve_s:.1f} "
        f"waves={stats['waves']} identical={same} fit_violations={viol} "
        f"launches={launches}",
        flush=True,
    )
    if not same:
        raise AssertionError(f"{label}: blocked solve diverged from unblocked")
    if viol:
        raise AssertionError(f"{label}: {viol} hard-constraint violations")
    if placed == 0:
        raise AssertionError(f"{label}: nothing placed")
    if device.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"{label}: a kernel was never launched: {launches}")
    return {"launches": launches, "shapes": shapes, "assignment": a,
            "wait": wt, "admitted": ad}


def flagship_scheduler(**cosched):
    """A `Scheduler` of the flagship profile (`__graft_entry__.py:52`),
    Coscheduling built with `cosched`."""
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.plugins import (
        CapacityScheduling,
        Coscheduling,
        NodeResourcesAllocatable,
    )

    return Scheduler(Profile(plugins=[
        NodeResourcesAllocatable(), Coscheduling(**cosched),
        CapacityScheduling(),
    ]))


def spread_config4():
    """Bench config 4's shape with node cpu spread over 64,000 to 95,000
    millicores, in an order whose smallest node is node 13, so the winner
    is not the lowest index. Config 4's nodes are all one size, so the
    allocatable score's min-max normalization puts 0 on every node; the
    checks that read score values (a live weight reaching the fold,
    explain columns, an explain winner) need nodes of spread sizes."""
    from scheduler_plugins_tpu_torch.models import gang_quota_scenario

    cluster = gang_quota_scenario(**CONFIG4)
    for i, node in enumerate(cluster.nodes.values()):
        node.allocatable["cpu"] = 64_000 + 1000 * ((5 + 7 * i) % 32)
    return cluster


def parity_violations(snap, result) -> dict:
    """Host-side checks of a parity solve's result, independent of the
    solver: fit (`fit_violations`), no quota namespace over its Max, and
    no gang member bound without Wait while its gang is below quorum."""
    import numpy as np

    a = result.assignment.cpu().numpy()
    wait = result.wait.cpu().numpy()
    placed = a >= 0
    out = {"fit": fit_violations(snap, result.assignment), "quota": 0,
           "gang": 0}
    if snap.quota is not None:
        q = snap.quota
        ns = snap.pods.ns.cpu().numpy()
        used = q.used.cpu().numpy().copy()
        np.add.at(used, ns[placed], snap.pods.req.cpu().numpy()[placed])
        over = (used > q.max.cpu().numpy()).any(axis=1)
        out["quota"] = int((over & q.has_quota.cpu().numpy()).sum())
    if snap.gangs is not None:
        g = snap.pods.gang.cpu().numpy()
        member = placed & (g >= 0)
        count = snap.gangs.assigned.cpu().numpy().astype(np.int64)
        np.add.at(count, g[member], 1)
        short = count < snap.gangs.min_member.cpu().numpy()
        out["gang"] = int((member & ~wait & short[np.maximum(g, 0)]).sum())
    return out


def parity_drive(label: str, cluster, device,
                 make_scheduler=flagship_scheduler) -> None:
    """QueueSort, snapshot and `Scheduler.solve` of `cluster` on the card
    with the profile `make_scheduler()` builds: twice under sync-debug
    "error" (`cold_s` pays the kernels' first loads, `debug_s` is warm),
    then once without it (`solve_s`, the time reported per pod); then the
    same on the CPU (`cpu_s`, `cpu_ms_per_pod`). Every output and final
    carry must be identical (tolerance 0) and pass `parity_violations`.
    Returns the CPU's result, snapshot and meta."""
    import torch

    _tests_on_path()
    from torch_parity_cases import parity_outputs

    t0 = time.perf_counter()
    sched = make_scheduler()
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0, device=device)
    sched.prepare(meta, cluster)
    _sync(device)
    setup_s = time.perf_counter() - t0
    runs = []
    for mode in ("error", "error", "default"):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            result = sched.solve(snap, device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync(device)
        runs.append(time.perf_counter() - t0)
    cold_s, debug_s, solve_s = runs

    cpu = torch.device("cpu")
    sched_cpu = make_scheduler()
    snap_cpu, meta_cpu = cluster.snapshot(pending, now_ms=0, device=cpu)
    sched_cpu.prepare(meta_cpu, cluster)
    t0 = time.perf_counter()
    on_cpu = sched_cpu.solve(snap_cpu, device=cpu)
    cpu_s = time.perf_counter() - t0

    got, want = parity_outputs(result), parity_outputs(on_cpu)
    differ = [k for k in got if (got[k] is None) != (want[k] is None) or (
        got[k] is not None and not torch.equal(got[k].cpu(), want[k]))]
    viol = parity_violations(snap_cpu, on_cpu)
    P = snap.num_pods
    placed = int((on_cpu.assignment >= 0).sum())
    print(
        f"[parity] {label} nodes={len(meta.node_names)} pods={len(pending)} "
        f"rows={P} setup_s={setup_s:.3f} cold_s={cold_s:.3f} "
        f"debug_s={debug_s:.3f} "
        f"solve_s={solve_s:.3f} ms_per_pod={solve_s * 1e3 / P:.4f} "
        f"pods_per_s={P / solve_s:.1f} cpu_s={cpu_s:.3f} "
        f"cpu_ms_per_pod={cpu_s * 1e3 / P:.4f} placed={placed} "
        f"admitted={int(on_cpu.admitted.sum())} "
        f"wait={int(on_cpu.wait.sum())} identical={not differ} "
        f"violations={viol}",
        flush=True,
    )
    if differ:
        raise AssertionError(f"{label}: card != CPU in {differ}")
    if any(viol.values()):
        raise AssertionError(f"{label}: hard-constraint violations {viol}")
    if placed == 0:
        raise AssertionError(f"{label}: nothing placed")
    return on_cpu, snap_cpu, meta_cpu


#: the CUDA runtime and driver calls that put work on a stream: each one
#: is one kernel, copy or fill on the card
WORK_CALLS = ("LaunchKernel", "Memcpy", "Memset")


def launches_per_step(cluster, device, live_weights=None,
                      make_scheduler=flagship_scheduler,
                      label: str = "") -> dict:
    """What a parity step puts on the card, from `torch.profiler`: the
    solves of the cluster's first PROFILE_PODS and 2 * PROFILE_PODS queued
    pods differ by PROFILE_PODS steps (the set-up and the Permit tail are
    the same work), so their counts differ by PROFILE_PODS steps' work.
    `live_weights` sets the scheduler's live weight vector; the profile is
    `make_scheduler()`'s, and `label` prefixes the printed lines. Returns,
    each a
    step: `work`, the host calls that enqueue device work (names matching
    WORK_CALLS) by name, and `events`, the device records. The host calls
    are exact; the device records are read back through CUPTI's device
    buffers, which may drop some (a step then reads below its calls)."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched = make_scheduler()
    sched.set_live_weights(live_weights)
    if live_weights is not None:
        label += f"live_weights={live_weights} "
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    counts = {}
    for n in (PROFILE_PODS, 2 * PROFILE_PODS):
        snap, meta = cluster.snapshot(pending[:n], now_ms=0, device=device,
                                      pad_pods=n)
        sched.prepare(meta, cluster)
        sched.solve(snap, device=device)  # warm
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sched.solve(snap, device=device)
            _sync(device)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        counts[n] = (
            len(kernels),
            Counter(e.name for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("cu")
                    and any(w in e.name for w in WORK_CALLS)),
            sum(e.time_range.elapsed_us() for e in kernels),
        )
    (k1, w1, us1), (k2, w2, us2) = counts[PROFILE_PODS], counts[2 * PROFILE_PODS]
    work = {name: (w2[name] - w1[name]) / PROFILE_PODS
            for name in sorted(w1 | w2)}
    out = {"events": (k2 - k1) / PROFILE_PODS, "work": work}
    print(
        f"[parity] {label}launches_per_step "
        f"device_events={out['events']} "
        f"work_calls={sum(work.values())} {work} "
        f"device_us_per_step={(us2 - us1) / PROFILE_PODS} (device events "
        f"{k1} / {k2}, work calls {sum(w1.values())} / {sum(w2.values())}, "
        f"device us {us1} / {us2} for {PROFILE_PODS} / {2 * PROFILE_PODS} "
        f"pods)",
        flush=True,
    )
    # where the host's time goes: self CPU time by op in the longer run,
    # per pod (the profiler's own cost included)
    ops = prof.key_averages()
    n = 2 * PROFILE_PODS
    top = sorted(ops, key=lambda a: -a.self_cpu_time_total)[:12]
    print(
        f"[parity] {label}host_us_per_step="
        f"{sum(a.self_cpu_time_total for a in ops) / n} top ops (calls, "
        f"self CPU us per step): " + ", ".join(
            f"{a.key} {a.count / n:.2f} {a.self_cpu_time_total / n:.2f}"
            for a in top),
        flush=True,
    )
    return out


def live_weights_phase(device, config4, unit_steps: dict) -> None:
    """The spread config 4's parity solve after
    `set_live_weights(LIVE_WEIGHTS)`: on the card under sync-debug
    "error", equal to the CPU under the same vector, to a profile loaded
    with those `weights` and to the CPU after `set_live_weights(None)`
    (every output and final carry, tolerance 0); the explain rows of the
    first LIVE_EXPLAIN_ROWS queued pods, card against CPU under the vector
    and against the card's unit-weight rows, each column the unit column
    times its weight and the allocatable column not all 0; on `config4`
    and on the spread cluster, the same host calls enqueueing device work
    a step, name by name, as the unit-weight run (`unit_steps` on config
    4; see `launches_per_step`). The device records a step are printed
    beside them, not held: CUPTI may drop some."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler

    _tests_on_path()
    from torch_parity_cases import parity_outputs

    cluster = spread_config4()
    cpu = torch.device("cpu")
    rows = list(range(LIVE_EXPLAIN_ROWS))
    outs, explained = {}, {}
    for label, dev, sched in (
            ("card", device, flagship_scheduler()),
            ("unit", device, flagship_scheduler()),
            ("cpu", cpu, flagship_scheduler()),
            ("loaded", cpu, Scheduler(load_profile({
                "plugins": list(FLAGSHIP), "weights": LIVE_WEIGHTS})))):
        if label in ("card", "cpu"):
            sched.set_live_weights(LIVE_WEIGHTS)
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, device=dev)
        sched.prepare(meta, cluster)
        if label != "loaded":
            # the explain rows against the cycle-initial state, before
            # the solve (which never changes the snapshot)
            t0 = time.perf_counter()
            with sync_errors(dev):
                explained[label] = sched.explain_rows(snap, rows, device=dev)
            print(f"[parity] live_weights={LIVE_WEIGHTS} {label} "
                  f"explain_rows={len(rows)} device={dev.type} "
                  f"ms={(time.perf_counter() - t0) * 1e3}", flush=True)
        if label == "unit":
            continue
        t0 = time.perf_counter()
        with sync_errors(dev):
            result = sched.solve(snap, device=dev)
        _sync(dev)
        solve_s = time.perf_counter() - t0
        outs[label] = {k: None if v is None else v.cpu()
                       for k, v in parity_outputs(result).items()}
        print(f"[parity] live_weights={LIVE_WEIGHTS} {label} "
              f"device={dev.type} solve_s={solve_s} "
              f"weights_key={sched.weights_key()} "
              f"placed={int((result.assignment >= 0).sum())}", flush=True)
        if label == "cpu":
            sched.set_live_weights(None)
            if sched.live_weights is not None or sched.weights_key() != (
                    "weights", *LIVE_WEIGHTS):
                raise AssertionError("live weights: None did not revert")
            reverted = sched.solve(snap, device=cpu)
            outs["reverted"] = {k: None if v is None else v.cpu()
                                for k, v in parity_outputs(reverted).items()}

    def differ(a, b):
        return [k for k in a if (a[k] is None) != (b[k] is None) or (
            a[k] is not None and not torch.equal(a[k], b[k]))]

    bad = {other: differ(outs["card"], outs[other])
           for other in ("cpu", "loaded", "reverted")}
    # the explain fold: card == CPU under the vector; against the unit
    # rows only the columns (and so the total) move, each by its weight
    live, unit = explained["card"], explained["unit"]
    want = dict(unit, columns=np.asarray(LIVE_WEIGHTS, np.int64)[
        None, :, None] * unit["columns"])
    want["total"] = want["columns"].sum(axis=1)
    bad["explain_cpu"] = [k for k in live
                          if not np.array_equal(live[k], explained["cpu"][k])]
    bad["explain_unit"] = [k for k in live
                           if not np.array_equal(live[k], want[k])]
    nonzero = int((unit["columns"][:, 0] != 0).sum())
    # the device work a step, live against unit weights, on config 4 and
    # on the spread cluster
    steps = {
        "config4": (unit_steps, launches_per_step(
            config4, device, live_weights=LIVE_WEIGHTS)),
        "spread": (launches_per_step(cluster, device), launches_per_step(
            cluster, device, live_weights=LIVE_WEIGHTS)),
    }
    print(f"[parity] live_weights identical={bad} "
          f"unit_alloc_column_nonzero={nonzero} "
          f"alloc_column_max={int(live['columns'][:, 0].max())} " + " ".join(
              f"{name}_work_calls={sum(lv['work'].values())} "
              f"{name}_unit_work_calls={sum(un['work'].values())} "
              f"{name}_device_events={lv['events']} "
              f"{name}_unit_device_events={un['events']}"
              for name, (un, lv) in steps.items()),
          flush=True)
    if any(bad.values()):
        raise AssertionError(f"live weights: card differs in {bad}")
    if nonzero == 0:
        raise AssertionError("live weights: the allocatable column is 0 on "
                             "every node; the check cannot see the weight")
    for name, (un, lv) in steps.items():
        if not un["work"] or lv["work"] != un["work"]:
            raise AssertionError(
                f"live weights: on {name} a step enqueues {lv['work']} "
                f"({un['work']} at unit weights)")


def ordered(value):
    """Dicts as ordered item lists, sequences as lists: == then compares
    insertion order too."""
    if isinstance(value, dict):
        return [(k, ordered(v)) for k, v in value.items()]
    if isinstance(value, (list, tuple)):
        return [ordered(v) for v in value]
    return value


def cycle_state(report, cluster):
    """A cycle's report and the store's bookkeeping, comparable with ==
    (dicts as ordered item lists)."""
    from dataclasses import fields

    store = ("reserved", "pod_deadline_ms", "pod_attempts",
             "pod_backoff_until_ms", "unschedulable_since", "event_seq",
             "event_last", "gang_backoff_until_ms", "gang_last_failure_ms",
             "recent_bindings")
    return ordered({
        "report": {f.name: getattr(report, f.name) for f in fields(report)},
        "store": {k: getattr(cluster, k) for k in store},
        "pods": {uid: (p.node_name, p.nominated_node_name, p.deletion_ms)
                 for uid, p in cluster.pods.items()},
    })


def store_violations(cluster) -> dict:
    """Hard constraints on the store after a cycle, independent of the
    solver: no node's bound and reserved pods over its allocatable (pods
    slot 1 each), no quota namespace's bound and reserved pods over its
    Max, no gang with members bound below MinMember."""
    held = {}
    for uid, p in cluster.pods.items():
        node = p.node_name or cluster.reserved.get(uid)
        if node is not None:
            held[uid] = node
    used, ns_used, gang_bound = {}, {}, {}
    for uid, node in held.items():
        p = cluster.pods[uid]
        req = {**p.effective_request(), "pods": 1}
        for table, key in ((used, node), (ns_used, p.namespace)):
            row = table.setdefault(key, {})
            for r, v in req.items():
                row[r] = row.get(r, 0) + v
        pg = cluster.pod_group_of(p)
        if pg is not None and p.node_name is not None:
            gang_bound[pg.full_name] = gang_bound.get(pg.full_name, 0) + 1
    fit = sum(
        1 for node, row in used.items()
        if node in cluster.nodes and any(
            v > cluster.nodes[node].allocatable.get(r, 0)
            for r, v in row.items() if v)
    )
    quota = sum(
        1 for ns, eq in cluster.quotas.items()
        if any(ns_used.get(ns, {}).get(r, 0) > cap
               for r, cap in eq.max.items())
    )
    gang = sum(1 for g, n in gang_bound.items()
               if n < cluster.pod_groups[g].min_member)
    return {"fit": fit, "quota": quota, "gang": gang}


def explain_check(label: str, reports: dict, uids) -> None:
    """`CycleReport.explain(uid, top_k=5)` for each of `uids` on each
    device's report of one cycle (`reports`: device type -> report), the
    card's under `sync_errors`: the tables must be identical across the
    devices, and each candidate's per-plugin scores must sum to its
    total. Prints each explain's wall time in ms, and returns the first
    report's tables by uid."""
    import torch

    tables = {}
    for kind, report in reports.items():
        for uid in uids:
            t0 = time.perf_counter()
            with sync_errors(torch.device(kind)):
                table = report.explain(uid, top_k=5)
            ms = (time.perf_counter() - t0) * 1e3
            bad = [c["node"] for c in table["candidates"]
                   if sum(c["scores"].values()) != c["total"]]
            print(f"[explain] {label} device={kind} uid={uid} ms={ms} "
                  f"winner={table['winner']} assigned={table['assigned']} "
                  f"placed={table['placed']} "
                  f"failed_plugin={table['failed_plugin']} "
                  f"candidates={len(table['candidates'])} "
                  f"scores_sum_to_total={not bad}", flush=True)
            if bad:
                raise AssertionError(f"explain {label} {uid}: scores do not "
                                     f"sum to the total on {bad}")
            tables.setdefault(uid, []).append(table)
    differ = [uid for uid, ts in tables.items() if any(t != ts[0]
                                                       for t in ts)]
    print(f"[explain] {label} identical={not differ}", flush=True)
    if differ:
        raise AssertionError(f"explain {label}: card != CPU for {differ}")
    return {uid: ts[0] for uid, ts in tables.items()}


def cycle_phase(device) -> None:
    """Phase 7: the scheduling cycle on the card, held against the CPU."""
    import torch

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
    from scheduler_plugins_tpu_torch.models import gang_quota_scenario
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.state import Cluster

    cpu = torch.device("cpu")

    # the README quick start, on the card by default
    cluster = Cluster()
    cluster.add_node(objects.Node(name="n0", allocatable={
        "cpu": 8000, "memory": 32 << 30, "pods": 110}))
    cluster.add_pod(objects.Pod(name="web", containers=[
        objects.Container(requests={"cpu": 500})]))
    profile = load_profile({"plugins": ["NodeResourcesAllocatable",
                                        "Coscheduling", "CapacityScheduling"]})
    report = run_cycle(Scheduler(profile), cluster)
    print(f"[cycle] quickstart bound={report.bound}", flush=True)
    if report.bound != {"default/web": "n0"}:
        raise AssertionError(f"quick start: {report.bound}")

    # config 4's shape through one cycle, card and CPU
    states, times, reports = [], [], {}
    for dev in (device, cpu):
        cluster = gang_quota_scenario(**CONFIG4)
        sched = flagship_scheduler()
        first = sched.sort_pending(cluster.pending_pods(), cluster)[0].uid
        timings = {}
        pk.reset_launches()
        t0 = time.perf_counter()
        report = run_cycle(sched, cluster, now=1000, device=dev,
                           timings=timings)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        reports[dev.type] = report
        launches = pk.launches()
        viol = store_violations(cluster)
        states.append(cycle_state(report, cluster))
        print(
            f"[cycle] config4 device={dev.type} nodes={len(cluster.nodes)} "
            f"pods={len(cluster.pods)} bound={len(report.bound)} "
            f"reserved={len(report.reserved)} failed={len(report.failed)} "
            f"cycle_s={times[-1]} stage_s={timings} quality={report.quality} "
            f"kernel_launches={launches} violations={viol}",
            flush=True,
        )
        if any(viol.values()):
            raise AssertionError(f"config 4 cycle on {dev}: {viol}")
        if len(report.bound) != len(cluster.pods):
            raise AssertionError(f"config 4 cycle on {dev}: not all bound")
    if states[0] != states[1]:
        raise AssertionError("config 4 cycle: card != CPU")
    print(f"[cycle] config4 identical=True card_s={times[0]} "
          f"cpu_s={times[1]}", flush=True)
    # pod 0 solved against the cycle-initial state: its explain winner is
    # the node the cycle bound it to
    explain_check("config4", reports, [first])
    winner = reports[device.type].explain(first)["winner"]
    bound = reports[device.type].bound.get(first)
    print(f"[explain] config4 pod0={first} winner={winner} bound={bound}",
          flush=True)
    if winner is None or winner != bound:
        raise AssertionError(f"config 4: pod 0's explain winner {winner} "
                             f"is not its bind {bound}")

    spread_explain_check(device)
    script_phase(device)
    # the same script and one more cycle, in which a PodDisruptionBudget
    # guards the victim the priority keys alone would take
    nominated = {guard: script_phase(device, guard=guard)
                 for guard in (True, False)}
    print(f"[cycle] pdb_script nominated_with_pdb={nominated[True]} "
          f"nominated_without_pdb={nominated[False]}", flush=True)
    if None in nominated.values() or nominated[True] == nominated[False]:
        raise AssertionError(f"pdb script: the PDB did not move the "
                             f"nomination {nominated}")


def spread_explain_check(device) -> None:
    """The spread config 4 (`spread_config4`) through one cycle under
    `set_live_weights(LIVE_WEIGHTS)`, on the card and, from a fresh
    cluster, on the CPU, with identical reports and store; then
    `CycleReport.explain` of the first, the middle and the last queued pod
    on both reports (`explain_check`), with some candidate's score not 0,
    every candidate's scores the vector's weights times those of the same
    card report explained after `set_live_weights([1, 1, 1])`, and pod 0's
    winner the node the cycle bound it to."""
    import torch

    from scheduler_plugins_tpu_torch.framework import run_cycle

    states, reports, scheds = [], {}, {}
    for dev in (device, torch.device("cpu")):
        cluster = spread_config4()
        sched = flagship_scheduler()
        sched.set_live_weights(LIVE_WEIGHTS)
        queue = [p.uid for p in sched.sort_pending(cluster.pending_pods(),
                                                   cluster)]
        reports[dev.type] = run_cycle(sched, cluster, now=1000, device=dev)
        scheds[dev.type] = sched
        states.append(cycle_state(reports[dev.type], cluster))
    if states[0] != states[1]:
        raise AssertionError("spread config 4 cycle: card != CPU")
    uids = [queue[0], queue[len(queue) // 2], queue[-1]]
    live = explain_check("config4_spread", reports, uids)
    card = reports[device.type]
    scheds[device.type].set_live_weights([1] * len(LIVE_WEIGHTS))
    weight = dict(zip((p.name for p in scheds[device.type].profile.plugins),
                      LIVE_WEIGHTS))
    bad, nonzero = [], 0
    for uid in uids:
        with sync_errors(device):
            unit = card.explain(uid, top_k=5)
        for got, want in zip(live[uid]["candidates"], unit["candidates"]):
            nonzero += sum(v != 0 for v in got["scores"].values())
            if got["node"] != want["node"] or got["scores"] != {
                    k: weight[k] * v for k, v in want["scores"].items()}:
                bad.append((uid, got["node"]))
    winner, bound = live[queue[0]]["winner"], card.bound.get(queue[0])
    print(f"[explain] config4_spread live_weights={LIVE_WEIGHTS} "
          f"scaled={not bad} nonzero_scores={nonzero} pod0={queue[0]} "
          f"winner={winner} bound={bound}", flush=True)
    if bad or nonzero == 0:
        raise AssertionError(f"spread config 4 explain: scores not the unit "
                             f"scores times the weights on {bad}, or all 0 "
                             f"({nonzero} not 0)")
    if winner is None or winner != bound:
        raise AssertionError(f"spread config 4: pod 0's explain winner "
                             f"{winner} is not its bind {bound}")


def script_phase(device, stream_chunk=None, guard=None):
    """`cycle_script` (`tests/torch_cycle_scripts.py`, the multi-cycle
    script the port's tests also hold against JAX) through `run_cycle`
    with `stream_chunk`, on the card and on the CPU: every report and the
    store identical after every cycle, no store violation, every outcome
    the script is built for reached. With `guard` set, `pdb_script` runs
    instead (its PodDisruptionBudget added when `guard`), and the phase
    returns the (node, victims) its last cycle nominated."""
    import torch

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_cycle_scripts import (
        SCRIPT_COSCHED,
        cycle_script,
        pdb_nomination,
        pdb_script,
        script_outcomes,
    )

    label = "script" if stream_chunk is None else "streamed_script"
    if guard is not None:
        label = "pdb_script" if guard else "pdb_script_unguarded"
    cpu = torch.device("cpu")
    arms = []
    for dev in (device, cpu):
        if guard is None:
            cluster, steps = cycle_script(objects, Cluster)
        else:
            cluster, steps = pdb_script(objects, Cluster, guard=guard)
        arms.append((dev, cluster, steps, flagship_scheduler(**SCRIPT_COSCHED),
                     []))
    t_card = 0.0
    pk.reset_launches()
    for k in range(len(steps)):
        states = []
        for dev, cluster, steps, sched, reports in arms:
            now, mutate = steps[k]
            if mutate is not None:
                mutate(objects, cluster)
            t0 = time.perf_counter()
            reports.append(run_cycle(sched, cluster, now, stream_chunk,
                                     device=dev))
            if dev is device:
                t_card += time.perf_counter() - t0
            states.append(cycle_state(reports[-1], cluster))
        r = arms[1][4][k]
        viol = store_violations(arms[1][1])
        print(
            f"[cycle] {label} cycle={k} now={steps[k][0]} "
            f"identical={states[0] == states[1]} bound={len(r.bound)} "
            f"reserved={len(r.reserved)} failed={len(r.failed)} "
            f"skipped={len(r.skipped)} rejected={r.rejected_gangs} "
            f"expired={r.expired_gangs} preempted={r.preempted} "
            f"violations={viol}",
            flush=True,
        )
        if states[0] != states[1]:
            raise AssertionError(f"{label}, cycle {k}: card != CPU")
        if any(viol.values()):
            raise AssertionError(f"{label}, cycle {k}: {viol}")
    launches = pk.launches()
    missed = script_outcomes(arms[1][4])
    print(f"[cycle] {label} cycles={len(steps)} card_s={t_card} "
          f"kernel_launches={launches} outcomes_missed={missed}", flush=True)
    if missed:
        raise AssertionError(f"{label} did not reach {missed}")
    return None if guard is None else pdb_nomination(arms[1][4])


def north_star_pipeline(cluster, device) -> None:
    """The north-star problem through `run_chunk_pipeline`, as
    `bench.north_star` drives it (`bench.py:602-660`): the snapshot padded
    to a multiple of 8192 pod rows, `raw` the demoted least-allocatable
    scores under {cpu: 1<<20, memory: 1}, host numpy chunk inputs, and the
    chunk solver of `bench.north_star_solve_chunk` (masked free, targeted
    waterfill, 8 waves, rescue window 256). The assignment must equal
    `batch_solve(chunk=8192, rescue_window=256)` on the same snapshot.
    CUDA events around each chunk's solve give its window on the device
    clock (from its first op to its last, the device's waits on the
    host's per-wave reads inside it included); their sum is the solve time
    `timeline.summary` charges the bubble against. A calibration chunk is
    also timed synchronously, as the JAX bench does, and only printed. The
    launch counts are reset just before the pipeline run and read just
    after it."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.ops.allocatable import (
        MODE_LEAST,
        allocatable_scores,
        demote_scores_int32,
    )
    from scheduler_plugins_tpu_torch.ops.assign import (
        waterfill_assign_targeted,
    )
    from scheduler_plugins_tpu_torch.ops.fit import free_capacity
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel.pipeline import (
        run_chunk_pipeline,
    )
    from scheduler_plugins_tpu_torch.parallel.solver import (
        batch_solve,
        finalize_assignment,
    )

    chunk, rescue = NORTH_STAR["chunk"], NORTH_STAR["rescue_window"]
    t0 = time.perf_counter()
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    padded = -(-len(pending) // chunk) * chunk
    snap, meta = cluster.snapshot(pending, now_ms=0, device=device,
                                  pad_pods=padded)
    weights = meta.index.encode({"cpu": 1 << 20, "memory": 1})
    raw = demote_scores_int32(allocatable_scores(
        snap.nodes.alloc, torch.as_tensor(weights, device=device), MODE_LEAST
    )).to(torch.int64)
    node_mask = snap.nodes.mask
    windows = []  # (start, end) CUDA events of each chunk's solve

    def solve_chunk(raw, node_mask, req_chunk, mask_chunk, free0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        a, free, stats = waterfill_assign_targeted(
            raw, req_chunk, mask_chunk,
            torch.where(node_mask[:, None], free0, 0), max_waves=8,
            rescue_window=rescue,
        )
        end.record()
        windows.append((start, end))
        return (a, stats["waves"]), free

    req_np = snap.pods.req.cpu().numpy()
    mask_np = snap.pods.mask.cpu().numpy()
    chunk_inputs = [(req_np[lo:lo + chunk], mask_np[lo:lo + chunk])
                    for lo in range(0, padded, chunk)]
    _sync(device)
    setup_s = time.perf_counter() - t0

    def free0():
        return free_capacity(snap.nodes.alloc, snap.nodes.requested)

    def calibrate():
        free = free0()
        _sync(device)
        t0 = time.perf_counter()
        (a, waves), _ = solve_chunk(
            raw, node_mask,
            *(torch.from_numpy(x).to(device) for x in chunk_inputs[0]), free,
        )
        a.cpu()
        return time.perf_counter() - t0, waves

    calibrate()  # warm: the first solve pays the card's one-time loads
    cal_s, cal_waves = calibrate()

    free = free0()
    _sync(device)
    windows.clear()
    pk.reset_launches()
    t0 = time.perf_counter()
    results, free, done_s, timeline = run_chunk_pipeline(
        solve_chunk, (raw, node_mask), chunk_inputs, free, device=device
    )
    elapsed = time.perf_counter() - t0
    launches = pk.launches()
    _sync(device)
    waves = sum(w for _, w in results)
    solve_window_ms = sum(a.elapsed_time(b) for a, b in windows)
    summary = timeline.summary(solve_ms=solve_window_ms)

    assignment = torch.from_numpy(np.concatenate([a for a, _ in results]))
    a_pipe, wait_pipe = finalize_assignment(assignment.to(device), snap)
    t0 = time.perf_counter()
    a_ref, _, wait_ref = batch_solve(snap, weights, chunk=chunk,
                                     rescue_window=rescue)
    _sync(device)
    ref_s = time.perf_counter() - t0
    same = torch.equal(a_pipe, a_ref) and torch.equal(wait_pipe, wait_ref)
    placed = int((a_pipe >= 0).sum())
    viol = fit_violations(snap, a_pipe)
    n_pods = len(pending)
    print(
        f"[pipeline] north_star nodes={len(meta.node_names)} pods={n_pods} "
        f"rows={padded} chunks={len(chunk_inputs)} setup_s={setup_s:.3f} "
        f"elapsed_s={elapsed} pods_per_s={n_pods / elapsed} waves={waves} "
        f"calibration_chunk_s={cal_s} calibration_waves={cal_waves} "
        f"solve_window_ms={solve_window_ms} "
        f"batch_solve_s={ref_s} placed={placed} identical={same} "
        f"fit_violations={viol} done_s_last={done_s[-1]} "
        f"kernel_launches={launches}",
        flush=True,
    )
    print(f"[pipeline] north_star timeline={json.dumps(summary)}", flush=True)
    if not same:
        raise AssertionError("north-star pipeline != batch_solve")
    if viol or placed == 0:
        raise AssertionError(f"north-star pipeline: {viol} violations, "
                             f"{placed} placed")


def config6_cycle(device) -> None:
    """Bench config 6 (`allocatable_scenario(10_240, 102_400)`, the
    flagship profile) through one `run_cycle(now=1000, stream_chunk=4096)`
    on the card, then from a fresh cluster on the CPU: identical reports
    and store, no store violation. The cycle's snapshot and its streamed
    solve are captured as the cycle takes them, to prove the streamed
    solve served the cycle and that its placements are the cycle's binds
    and reservations."""
    import torch

    from scheduler_plugins_tpu_torch.framework import cycle as cycle_mod
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.models import allocatable_scenario
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    states, times, reports = [], [], {}
    real_solve = cycle_mod.streamed_profile_solve
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        cluster = allocatable_scenario(CONFIG6["n_nodes"], CONFIG6["n_pods"])
        scenario_s = time.perf_counter() - t0
        taken = {"snapshots": [], "solves": []}
        real_snapshot = cluster.snapshot

        def snapshot(*args, **kw):
            out = real_snapshot(*args, **kw)
            taken["snapshots"].append(out)
            return out

        def streamed(*args, **kw):
            out = real_solve(*args, **kw)
            taken["solves"].append(out)
            return out

        cluster.snapshot = snapshot
        cycle_mod.streamed_profile_solve = streamed
        timings = {}
        pk.reset_launches()
        try:
            t0 = time.perf_counter()
            report = run_cycle(flagship_scheduler(), cluster, now=1000,
                               stream_chunk=CONFIG6["stream_chunk"],
                               device=dev, timings=timings)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        finally:
            cycle_mod.streamed_profile_solve = real_solve
            del cluster.snapshot
        launches = pk.launches()
        if not taken["solves"] or taken["solves"][0] is None:
            raise AssertionError(f"config 6 cycle on {dev}: the streamed "
                                 f"solve did not serve the cycle")
        (snap, meta), (a, admitted, wait) = (taken["snapshots"][0],
                                             taken["solves"][0])
        a, admitted, wait = (x.cpu().numpy() for x in (a, admitted, wait))
        want = ({}, {})  # (bound, reserved) by the streamed solve
        for i, uid in enumerate(meta.pod_names):
            if a[i] >= 0 and admitted[i]:
                want[int(wait[i])][uid] = meta.node_names[a[i]]
        if (report.bound, report.reserved) != want:
            raise AssertionError(f"config 6 cycle on {dev}: binds differ "
                                 f"from the streamed solve's placements")
        viol = store_violations(cluster)
        states.append(cycle_state(report, cluster))
        reports[dev.type] = report
        uids = [meta.pod_names[i] for i in EXPLAIN_POSITIONS]
        print(
            f"[cycle] config6 device={dev.type} nodes={len(cluster.nodes)} "
            f"pods={len(cluster.pods)} rows={snap.num_pods} "
            f"stream_chunk={CONFIG6['stream_chunk']} streamed=True "
            f"scenario_s={scenario_s} cycle_s={times[-1]} stage_s={timings} "
            f"bound={len(report.bound)} reserved={len(report.reserved)} "
            f"failed={len(report.failed)} "
            f"preempted={len(report.preempted)} quality={report.quality} "
            f"kernel_launches={launches} violations={viol}",
            flush=True,
        )
        if any(viol.values()):
            raise AssertionError(f"config 6 cycle on {dev}: {viol}")
        if not report.bound:
            raise AssertionError(f"config 6 cycle on {dev}: nothing bound")
        del cluster, snap, meta, taken
    if states[0] != states[1]:
        raise AssertionError("config 6 cycle: card != CPU")
    print(f"[cycle] config6 identical=True card_s={times[0]} "
          f"cpu_s={times[1]}", flush=True)
    # explain at the north-star width: the first, the 51,200th and the
    # last pod in queue order
    explain_check("config6", reports, uids)


def config2_scheduler():
    """A `Scheduler` of bench config 2's profile: TargetLoadPacking and
    LoadVariationRiskBalancing at their defaults (`bench.py:4495-4499`)."""
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.plugins import (
        LoadVariationRiskBalancing,
        TargetLoadPacking,
    )

    return Scheduler(Profile(plugins=[TargetLoadPacking(),
                                      LoadVariationRiskBalancing()]))


def config2_cluster():
    from scheduler_plugins_tpu_torch.models import trimaran_scenario

    return trimaran_scenario(**CONFIG2)


def add_cycle2_pods(cluster) -> None:
    """CYCLE2_NEW_PODS more pods of config 2's request ranges, from their
    own seed, queued after the first batch."""
    import numpy as np

    from scheduler_plugins_tpu_torch.api import objects

    rng = np.random.default_rng(2)
    cpus = rng.integers(100, 4000, CYCLE2_NEW_PODS)
    mems = rng.integers(256 << 20, 8 << 30, CYCLE2_NEW_PODS)
    for i in range(CYCLE2_NEW_PODS):
        cluster.add_pod(objects.Pod(
            name=f"late-{i:04d}", creation_ms=CONFIG2["n_pods"] + i,
            containers=[objects.Container(requests={
                "cpu": int(cpus[i]), "memory": int(mems[i])})]))


def config2_cycles(device) -> dict:
    """Bench config 2 through two `run_cycle`s, on the card and, from a
    fresh cluster, on the CPU: cycle 1 binds the batch; CYCLE2_NEW_PODS
    more pods arrive and `now` moves CYCLE2_GAP_MS, inside the metrics
    reporting interval, so cycle 2's snapshot must carry, on every node
    cycle 1 bound pods to, the TargetLoadPacking prediction of those pods
    as `missing_cpu_millis` (and 0 elsewhere). Both cycles' reports and
    the store (`recent_bindings` included) must be identical card
    against CPU, with no store violation and no election kernel launched.
    Returns each device's cycle 1 report and the queue's uids."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    states, reports, queue = [], {}, None
    for dev in (device, torch.device("cpu")):
        cluster = config2_cluster()
        sched = config2_scheduler()
        queue = [p.uid for p in sched.sort_pending(cluster.pending_pods(),
                                                   cluster)]
        arm = []
        for k, now in enumerate((1000, 1000 + CYCLE2_GAP_MS)):
            if k == 1:
                add_cycle2_pods(cluster)
            taken = []
            real_snapshot = cluster.snapshot

            def snapshot(*args, **kw):
                out = real_snapshot(*args, **kw)
                taken.append(out)
                return out

            cluster.snapshot = snapshot
            timings = {}
            pk.reset_launches()
            try:
                t0 = time.perf_counter()
                report = run_cycle(sched, cluster, now=now, device=dev,
                                   timings=timings)
                _sync(dev)
                cycle_s = time.perf_counter() - t0
            finally:
                del cluster.snapshot
            launches = pk.launches()
            snap, meta = taken[0]
            missing = snap.metrics.missing_cpu_millis.cpu().numpy()
            viol = store_violations(cluster)
            print(
                f"[trimaran] cycle_config2 cycle={k + 1} device={dev.type} "
                f"nodes={len(cluster.nodes)} pods={len(cluster.pods)} "
                f"batch={len(meta.pod_names)} cycle_s={cycle_s} "
                f"stage_s={timings} bound={len(report.bound)} "
                f"failed={len(report.failed)} "
                f"missing_cpu_nodes={int((missing > 0).sum())} "
                f"missing_cpu_millis={int(missing.sum())} "
                f"kernel_launches={launches} violations={viol}",
                flush=True,
            )
            if any(viol.values()) or any(launches.values()):
                raise AssertionError(f"config 2 cycle {k + 1} on {dev}: "
                                     f"{viol} {launches}")
            if not report.bound:
                raise AssertionError(f"config 2 cycle {k + 1} on {dev}: "
                                     "nothing bound")
            if k == 1:
                # the compensation: cycle 1's binds, by node
                want = np.zeros_like(missing)
                pos = {name: i for i, name in enumerate(meta.node_names)}
                for uid, node in first.bound.items():
                    want[pos[node]] += cluster.pods[
                        uid].tlp_predicted_cpu_millis(*cluster.tlp_prediction)
                if not missing.any() or not np.array_equal(missing, want):
                    raise AssertionError(
                        f"config 2 cycle 2 on {dev}: missing_cpu_millis "
                        f"{int(missing.sum())} != cycle 1's binds "
                        f"{int(want.sum())}")
            else:
                first = report
                reports[dev.type] = report
                if missing.any():
                    raise AssertionError(f"config 2 cycle 1 on {dev}: "
                                         "missing CPU before any bind")
            arm.append(cycle_state(report, cluster))
        states.append(arm)
    if states[0] != states[1]:
        raise AssertionError("config 2 cycles: card != CPU")
    print("[trimaran] cycle_config2 identical=True", flush=True)
    return reports, queue


def config2_explain(device, reports: dict, queue: list) -> None:
    """`CycleReport.explain` of the first, the middle and the last pod of
    config 2's cycle 1 on the card's and the CPU's report
    (`explain_check`: identical, each candidate's scores summing to its
    total), with the TargetLoadPacking and LoadVariationRiskBalancing
    columns each not 0 on some candidate and pod 0's winner its bind."""
    uids = [queue[0], queue[len(queue) // 2], queue[-1]]
    tables = explain_check("config2", reports, uids)
    nonzero = {name: sum(c["scores"][name] != 0 for t in tables.values()
                         for c in t["candidates"])
               for name in ("TargetLoadPacking", "LoadVariationRiskBalancing")}
    winner = tables[queue[0]]["winner"]
    bound = reports[device.type].bound.get(queue[0])
    print(f"[explain] config2 nonzero_columns={nonzero} pod0={queue[0]} "
          f"winner={winner} bound={bound}", flush=True)
    if not all(nonzero.values()):
        raise AssertionError(f"config 2 explain: a column is 0 on every "
                             f"candidate {nonzero}")
    if winner is None or winner != bound:
        raise AssertionError(f"config 2: pod 0's explain winner {winner} "
                             f"is not its bind {bound}")


def config2_live_weights(device) -> None:
    """Config 2's parity solve under `set_live_weights(w)` for each of
    CONFIG2_WEIGHTS, on the card under sync-debug "error" and on the CPU:
    every output and final carry identical. Prints how many pods the two
    weightings place differently (a count, not a check)."""
    import torch

    _tests_on_path()
    from torch_parity_cases import parity_outputs

    cluster = config2_cluster()
    placed = {}
    for w in CONFIG2_WEIGHTS:
        outs = {}
        for dev in (device, torch.device("cpu")):
            sched = config2_scheduler()
            sched.set_live_weights(w)
            pending = sched.sort_pending(cluster.pending_pods(), cluster)
            snap, meta = cluster.snapshot(pending, now_ms=0, device=dev)
            sched.prepare(meta, cluster)
            t0 = time.perf_counter()
            with sync_errors(dev):
                result = sched.solve(snap, device=dev)
            _sync(dev)
            outs[dev.type] = {k: None if v is None else v.cpu()
                              for k, v in parity_outputs(result).items()}
            print(f"[trimaran] live_weights_config2 weights={w} "
                  f"device={dev.type} solve_s={time.perf_counter() - t0} "
                  f"placed={int((result.assignment >= 0).sum())}",
                  flush=True)
        card, cpu = outs[device.type], outs["cpu"]
        differ = [k for k in card if (card[k] is None) != (cpu[k] is None)
                  or (card[k] is not None and not torch.equal(card[k],
                                                              cpu[k]))]
        if differ:
            raise AssertionError(f"config 2 under {w}: card != CPU in "
                                 f"{differ}")
        placed[tuple(w)] = card["assignment"]
    a, b = placed.values()
    print(f"[trimaran] live_weights_config2 identical=True "
          f"placed_differently={int((a != b).sum())} of {a.numel()}",
          flush=True)


def raw_score_rows(sched, snap) -> list:
    """(P, N) raw scores of each scoring plugin of `sched` against the
    cycle-initial state, one pod at a time as the solve step calls them,
    on the snapshot's device (no host read)."""
    import torch

    plugins = tuple(sched.profile.plugins)
    for plugin in plugins:
        plugin.bind_presolve(plugin.prepare_solve(snap))
    state0 = sched.initial_state(snap)
    return [torch.stack([plugin.score(state0, snap, p)
                         for p in range(snap.num_pods)])
            for plugin in plugins]


def trimaran_small(device) -> None:
    """The seeded problems of `tests/torch_trimaran_cases.py` (LROC on
    pods whose limits exceed their requests, Peaks with a power model for
    part of the nodes, TLP loaded with targetUtilization 60 beside LVRB),
    each loaded with `load_profile` and solved on the card under sync-debug
    "error" and on the CPU: every output and final carry identical. Prints,
    per profile, how many raw score entries differ card against CPU and
    the largest relative difference (Peaks' `exp` and LROC's `lgamma`,
    `log` and `exp` come from other math libraries on the card), and
    requires the normalized scores, through the placements, to agree."""
    import torch

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_parity_cases import parity_outputs
    from torch_trimaran_cases import CASES, solve_inputs, trimaran_case

    for name in CASES:
        outs, raws = {}, {}
        for dev in (device, torch.device("cpu")):
            cluster, config = trimaran_case(name, objects, Cluster)
            sched = Scheduler(load_profile(config))
            _, snap, _ = solve_inputs(sched, cluster, device=dev)
            pk.reset_launches()
            t0 = time.perf_counter()
            with sync_errors(dev):
                result = sched.solve(snap, device=dev)
            _sync(dev)
            solve_s = time.perf_counter() - t0
            outs[dev.type] = {k: None if v is None else v.cpu()
                              for k, v in parity_outputs(result).items()}
            with sync_errors(dev):
                rows = raw_score_rows(sched, snap)
            raws[dev.type] = [r.cpu() for r in rows]
            print(f"[trimaran] small {name} device={dev.type} "
                  f"nodes={len(cluster.nodes)} rows={snap.num_pods} "
                  f"solve_s={solve_s} "
                  f"placed={int((result.assignment >= 0).sum())} "
                  f"kernel_launches={pk.launches()}", flush=True)
        card, cpu = outs[device.type], outs["cpu"]
        differ = [k for k in card if (card[k] is None) != (cpu[k] is None)
                  or (card[k] is not None and not torch.equal(card[k],
                                                              cpu[k]))]
        entries, rel = 0, 0.0
        for got, want in zip(raws[device.type], raws["cpu"]):
            entries += int((got != want).sum())
            diff = (got.double() - want.double()).abs()
            rel = max(rel, float((diff / want.double().abs().clamp(
                min=1.0)).max()))
        print(f"[trimaran] small {name} identical={not differ} "
              f"raw_entries_differing={entries} of "
              f"{sum(r.numel() for r in raws['cpu'])} "
              f"raw_max_rel_diff={rel}", flush=True)
        if differ:
            raise AssertionError(f"trimaran {name}: card != CPU in {differ}")


def trimaran_phase(device) -> None:
    """Phase 9: the Trimaran plugins on the card, held against the CPU."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    cluster = config2_cluster()
    pk.reset_launches()
    parity_drive("parity_config2", cluster, device,
                 make_scheduler=config2_scheduler)
    launches = pk.launches()
    print(f"[trimaran] parity_config2 kernel_launches={launches}",
          flush=True)
    if any(launches.values()):
        raise AssertionError(f"config 2 launched election kernels "
                             f"{launches}")
    launches_per_step(cluster, device, make_scheduler=config2_scheduler,
                      label="config2 ")
    del cluster
    reports, queue = config2_cycles(device)
    config2_explain(device, reports, queue)
    config2_live_weights(device)
    trimaran_small(device)


def config3_scheduler():
    """A `Scheduler` of bench config 3's profile: NodeResourceTopologyMatch
    at its defaults (LeastAllocated)."""
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.plugins import NodeResourceTopologyMatch

    return Scheduler(Profile(plugins=[NodeResourceTopologyMatch()]))


def config3_cluster():
    from scheduler_plugins_tpu_torch.models import numa_scenario

    return numa_scenario(**CONFIG3)


def numa_zone_violations(snap, meta, assignment, order=None) -> int:
    """`tests/torch_numa_cases.zone_violations` of a solve: the placed
    pods, replayed in `order` (default queue order) with the pessimistic
    zone deduction, that found no single zone for their request."""
    _tests_on_path()
    from torch_numa_cases import zone_violations

    from scheduler_plugins_tpu_torch.ops import numa as numa_ops

    return zone_violations(
        snap.to("cpu").numpy(), numa_ops.numa_affine_mask(meta.index),
        numa_ops.host_level_mask(meta.index), assignment.cpu().numpy(),
        order)


def no_election_launches(tag: str, label: str, launches: dict) -> None:
    """This slice's paths launch no election kernel: print the counts of
    the run just made and require 0 / 0 / 0."""
    print(f"[{tag}] {label} kernel_launches={launches}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"{label} launched election kernels {launches}")


def cycle_drive(tag: str, label: str, make_cluster, make_scheduler,
                device) -> None:
    """One `run_cycle` of `make_cluster()` under `make_scheduler()`'s
    profile on the card and, from a fresh cluster, on the CPU: identical
    reports and store bookkeeping, no store violation, no election kernel
    launched, each stage's wall time printed (`[tag] label` lines)."""
    import torch

    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    states = []
    for dev in (device, torch.device("cpu")):
        cluster = make_cluster()
        sched = make_scheduler()
        timings = {}
        pk.reset_launches()
        t0 = time.perf_counter()
        report = run_cycle(sched, cluster, now=1000, device=dev,
                           timings=timings)
        _sync(dev)
        cycle_s = time.perf_counter() - t0
        launches = pk.launches()
        viol = store_violations(cluster)
        print(f"[{tag}] {label} device={dev.type} "
              f"nodes={len(cluster.nodes)} pods={len(cluster.pods)} "
              f"cycle_s={cycle_s} stage_s={timings} "
              f"bound={len(report.bound)} failed={len(report.failed)} "
              f"failed_by={sorted(set(report.failed_by.values()))} "
              f"nodes_used={len(set(report.bound.values()))} "
              f"violations={viol}", flush=True)
        no_election_launches(tag, f"{label} device={dev.type}", launches)
        if any(viol.values()) or not report.bound:
            raise AssertionError(f"{label} on {dev}: {viol}, "
                                 f"{len(report.bound)} bound")
        states.append(cycle_state(report, cluster))
    if states[0] != states[1]:
        raise AssertionError(f"{label}: card != CPU")
    print(f"[{tag}] {label} identical=True", flush=True)


def numa_phase(device) -> None:
    """Phase 10: bench config 3 through `Scheduler.solve` (card == CPU,
    the final zone carry included, no fit or zone violation, ms a pod and
    the work a step enqueues) and one `run_cycle`."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    cluster = config3_cluster()
    pk.reset_launches()
    on_cpu, snap, meta = parity_drive("parity_config3", cluster, device,
                                      make_scheduler=config3_scheduler)
    no_election_launches("numa", "parity_config3", pk.launches())
    zone = numa_zone_violations(snap, meta, on_cpu.assignment)
    print(f"[numa] parity_config3 zone_violations={zone} "
          f"numa_avail_dtype={on_cpu.state.numa_avail.dtype} "
          f"pack_scales={snap.numa.pack_scales}", flush=True)
    if zone:
        raise AssertionError(f"config 3: {zone} zone violations")
    launches_per_step(cluster, device, make_scheduler=config3_scheduler,
                      label="config3 ")
    del cluster
    cycle_drive("numa", "cycle_config3", config3_cluster, config3_scheduler,
                device)


def config5_scheduler():
    """A `Scheduler` of bench config 5's profile: NetworkOverhead and
    TopologicalSort at their defaults."""
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.plugins import (
        NetworkOverhead,
        TopologicalSort,
    )

    return Scheduler(Profile(plugins=[NetworkOverhead(), TopologicalSort()]))


def config5_cluster():
    from scheduler_plugins_tpu_torch.models import network_scenario

    return network_scenario(**CONFIG5)


def network_dependency_violations(cluster, meta, assignment,
                                  wave_of=None) -> int:
    """`tests/torch_network_cases.dependency_violations` of a solve of
    the default-topology profile: the placements of the batch `meta`
    names, replayed on the host in queue order (or wave by wave)."""
    _tests_on_path()
    from torch_network_cases import dependency_violations

    pending = [cluster.pods[uid] for uid in meta.pod_names]
    return dependency_violations(cluster, pending, assignment.cpu().numpy(),
                                 meta.node_names, wave_of=wave_of)


def network_phase(device) -> None:
    """Phase 11: bench config 5 through `Scheduler.solve` (card == CPU,
    the final placement carry included, no fit or dependency-threshold
    violation, ms a pod and the work a step enqueues) and one
    `run_cycle`."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    cluster = config5_cluster()
    pk.reset_launches()
    on_cpu, snap, meta = parity_drive("parity_config5", cluster, device,
                                      make_scheduler=config5_scheduler)
    no_election_launches("network", "parity_config5", pk.launches())
    deps = network_dependency_violations(cluster, meta, on_cpu.assignment)
    gained = int((on_cpu.state.net_placed.sum()
                  - snap.network.placed_node.sum()).item())
    print(f"[network] parity_config5 dependency_violations={deps} "
          f"workloads={len(meta.workloads)} zones={len(meta.zones)} "
          f"regions={len(meta.regions)} net_placed_gained={gained} "
          f"nodes_used={len(set(on_cpu.assignment.tolist()) - {-1})}",
          flush=True)
    if deps:
        raise AssertionError(f"config 5: {deps} dependency violations")
    launches_per_step(cluster, device, make_scheduler=config5_scheduler,
                      label="config5 ")
    del cluster
    cycle_drive("network", "cycle_config5", config5_cluster,
                config5_scheduler, device)


def nrt_cache_phase(device) -> None:
    """Phase 12: `nrt_cache_script` through `run_cycle` on the card and
    on the CPU, compared after every cycle: the report, the store's
    bookkeeping and the over-reserve cache's state (generation, flag
    sets, assumed map, NRT copies, view)."""
    from types import SimpleNamespace

    import torch

    from scheduler_plugins_tpu_torch import plugins
    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import (
        Profile,
        Scheduler,
        run_cycle,
    )
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.state import Cluster, nrt_cache

    _tests_on_path()
    from torch_numa_cases import cache_state, nrt_cache_script

    pkg = SimpleNamespace(o=objects, Cluster=Cluster, Profile=Profile,
                          Scheduler=Scheduler, plugins=plugins,
                          nrt_cache=nrt_cache)
    runs = {}
    for dev in (device, torch.device("cpu")):
        cluster, sched, steps = nrt_cache_script(pkg)
        pk.reset_launches()
        out = []
        for now, mutate in steps:
            if mutate is not None:
                mutate(pkg, cluster)
            report = run_cycle(sched, cluster, now=now, device=dev)
            state = cache_state(cluster.nrt_cache)
            out.append((cycle_state(report, cluster), state))
            print(f"[nrt_cache] device={dev.type} now={now} "
                  f"bound={len(report.bound)} failed={len(report.failed)} "
                  f"generation={state['generation']} "
                  f"desynced={sorted(cluster.nrt_cache.desynced_nodes())} "
                  f"stale={state['stale']} "
                  f"assumed={ {n: len(e) for n, e in state['assumed']} }",
                  flush=True)
        no_election_launches("nrt_cache", f"script device={dev.type}",
                             pk.launches())
        runs[dev.type] = out
    card, cpu = runs[device.type], runs["cpu"]
    differ = [k for k, (a, b) in enumerate(zip(card, cpu)) if a != b]
    print(f"[nrt_cache] cycles={len(cpu)} identical={not differ} "
          f"generations={[s['generation'] for _, s in cpu]}", flush=True)
    if differ:
        raise AssertionError(f"nrt cache script: card != CPU in cycles "
                             f"{differ}")
    if cpu[-1][1]["generation"] < 1:
        raise AssertionError("nrt cache script: no resync flushed")


def batch_drive(label: str, cluster, make_scheduler, device) -> None:
    """`profile_batch_solve(collect_stats=True)` of `cluster` on the card
    and on the CPU: the card's first run under sync-debug "warn" counting
    the host syncs, then a timed run; assignment, admitted, wait and the
    wave stats identical; no fit, zone (replayed in the waves' commit
    order), quota or quorum violation; no election kernel launched."""
    import warnings
    from types import SimpleNamespace

    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel.solver import (
        profile_batch_solve,
    )

    outs = {}
    for dev in (device, torch.device("cpu")):
        sched = make_scheduler()
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, device=dev)
        sched.prepare(meta, cluster)
        _sync(dev)
        syncs = None
        if dev.type == "cuda":
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    profile_batch_solve(sched, snap, collect_stats=True,
                                        device=dev)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchroniz" in str(w.message) for w in seen)
        pk.reset_launches()
        t0 = time.perf_counter()
        res = profile_batch_solve(sched, snap, collect_stats=True, device=dev)
        _sync(dev)
        solve_s = time.perf_counter() - t0
        launches = pk.launches()
        outs[dev.type] = (res, solve_s, syncs, launches, snap, meta)
    (res, solve_s, syncs, launches, snap, meta) = outs[device.type]
    cpu_res, cpu_s = outs["cpu"][0], outs["cpu"][1]
    differ = [k for k, (a, b) in enumerate(zip(res[:3], cpu_res[:3]))
              if not torch.equal(a.cpu(), b)]
    stats, cpu_stats = res[3], cpu_res[3]
    if (stats["waves"] != cpu_stats["waves"]
            or not torch.equal(stats["occupancy"], cpu_stats["occupancy"])):
        differ.append("stats")
    a = cpu_res[0]
    viol = parity_violations(outs["cpu"][4], SimpleNamespace(
        assignment=a, wait=cpu_res[2]))
    if outs["cpu"][4].numa is not None:
        order = None
        if "wave_of" in cpu_stats:
            wave_of = cpu_stats["wave_of"].numpy()
            placed = np.nonzero(wave_of >= 0)[0]
            order = placed[np.lexsort((placed, wave_of[placed]))]
        viol["zone"] = numa_zone_violations(outs["cpu"][4], outs["cpu"][5],
                                            a, order)
    if outs["cpu"][4].network is not None:
        # the waves re-filter against the earlier waves' placements
        viol["dependency"] = network_dependency_violations(
            cluster, outs["cpu"][5], a, cpu_stats["wave_of"].numpy())
    validators = None
    if outs["cpu"][4].scheduling is not None:
        # each wave's winners re-checked in queue order after the
        # earlier waves: the oracle replays them so
        viol.update({f"intree_{k}": v for k, v in intree_oracle(
            cluster, outs["cpu"][5], a,
            cpu_stats["wave_of"].numpy()).items()})
        per_row = validator_walk(make_scheduler, cluster, device)
        validators = {
            "rows_per_wave": [rows for rows, _ in stats["walk"]],
            "host_s_per_wave": [walk_s for _, walk_s in stats["walk"]],
            "launches_per_row": per_row,
            "launches_per_wave": [rows * per_row
                                  for rows, _ in stats["walk"]],
        }
    placed = int((a >= 0).sum())
    waves = stats["waves"]
    print(f"[batch] {label} nodes={len(meta.node_names)} "
          f"pods={len(meta.pod_names)} rows={snap.num_pods} "
          f"solve_s={solve_s} pods_per_s={len(meta.pod_names) / solve_s} "
          f"cpu_s={cpu_s} placed={placed} admitted={int(cpu_res[1].sum())} "
          f"wait={int(cpu_res[2].sum())} waves={waves} "
          f"occupancy={stats['occupancy'].tolist()} host_syncs={syncs} "
          f"host_syncs_per_wave="
          f"{None if syncs is None else syncs / max(waves, 1)} "
          f"validators={validators} "
          f"identical={not differ} violations={viol}", flush=True)
    no_election_launches("batch", label, launches)
    if validators is not None and syncs is not None and syncs != waves:
        raise AssertionError(f"{label}: {syncs} host syncs in {waves} "
                             f"waves, not one a wave")
    if differ:
        raise AssertionError(f"{label}: card != CPU in {differ}")
    if any(viol.values()):
        raise AssertionError(f"{label}: hard-constraint violations {viol}")
    if placed == 0:
        raise AssertionError(f"{label}: nothing placed")


#: queued pods of a problem whose batched solve the profiler counts the
#: validator walk's kernel launches on
WALK_PROFILE_PODS = 128


def validator_walk(make_scheduler, cluster, device) -> float:
    """Kernel launches a row of the batched solve's validator walk, from a
    `torch.profiler` run of `profile_batch_solve` over the cluster's first
    WALK_PROFILE_PODS queued pods on `device` (two waves at most): each
    wave's walk is the
    `validate_wave` range (`ops.assign`), so the launches that start
    inside those ranges, over the rows the walks visited, are the
    validators' and the selector commits' a row. (Profiling the whole
    solve would cost more host time than it measures.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scheduler_plugins_tpu_torch.parallel.solver import (
        profile_batch_solve,
    )

    sched = make_scheduler()
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    n = WALK_PROFILE_PODS
    snap, meta = cluster.snapshot(pending[:n], now_ms=0, device=device,
                                  pad_pods=n)
    sched.prepare(meta, cluster)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = profile_batch_solve(sched, snap, max_waves=2,
                                    collect_stats=True, device=device)[3]
        _sync(device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    walks = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "validate_wave"]
    launches = sum(
        1 for e in events
        if e.name.startswith("cu") and "LaunchKernel" in e.name
        and any(lo <= e.time_range.start <= hi for lo, hi in walks))
    return launches / max(sum(rows for rows, _ in stats["walk"]), 1)


def batch_phase(device) -> None:
    """Phase 13: the batched profile solve on bench configs 3 (NUMA, the
    stateful waterfill), 2 (TLP + LVRB, the general branch), 4 (the
    flagship, the targeted fast path) and 5 (NetworkOverhead, the class
    tallies re-evaluated every wave), each uncut, card against CPU."""
    from scheduler_plugins_tpu_torch.models import gang_quota_scenario

    batch_drive("batch_config3", config3_cluster(), config3_scheduler,
                device)
    batch_drive("batch_config2", config2_cluster(), config2_scheduler,
                device)
    batch_drive("batch_config4", gang_quota_scenario(**CONFIG4),
                flagship_scheduler, device)
    batch_drive("batch_config5", config5_cluster(), config5_scheduler,
                device)


def intree_problem(name: str):
    """(make_cluster, make_scheduler) of the in-tree phase's problem
    `mixed_full` or `intree_1k`."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler
    from scheduler_plugins_tpu_torch.models import mixed_scenario
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_intree_cases import INTREE, MIXED, intree_cluster

    if name == "mixed_full":
        return (lambda: mixed_scenario(**MIXED_FULL),
                lambda: Scheduler(load_profile(MIXED)))
    pkg = SimpleNamespace(objects=objects, Cluster=Cluster)
    return (lambda: intree_cluster(pkg, **INTREE_1K),
            lambda: Scheduler(load_profile(INTREE)))


def intree_oracle(cluster, meta, assignment, wave_of=None) -> dict:
    """`tests/torch_intree_cases.intree_violations` of a solve of the
    batch `meta` names: fit, node affinity, NoSchedule taints, spread
    skew per DoNotSchedule constraint, required affinity, anti-affinity
    and its symmetry, replayed on the host in queue order (or wave by
    wave, each wave in queue order)."""
    _tests_on_path()
    from torch_intree_cases import intree_violations

    pending = [cluster.pods[uid] for uid in meta.pod_names]
    return intree_violations(cluster, pending, assignment.cpu().numpy(),
                             meta.node_names, wave_of=wave_of)


def intree_parity(label: str, make_cluster, make_scheduler, device):
    """`Scheduler.solve` of the problem on the card, first under sync-debug
    "error" (`cold_s`), then timed (`solve_s`), and on the CPU: every
    output and final carry (the four selector carries included)
    identical, no violation of `parity_violations` or `intree_oracle`,
    no election kernel launched. Returns the cluster."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    _tests_on_path()
    from torch_parity_cases import parity_outputs

    cluster = make_cluster()
    outs = []
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        sched = make_scheduler()
        for plugin in sched.profile.plugins:
            plugin.configure_cluster(cluster)
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, device=dev)
        sched.prepare(meta, cluster)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        runs = []
        pk.reset_launches()
        for debug in ((True, False) if dev is device else (False,)):
            t0 = time.perf_counter()
            with (sync_errors(dev) if debug else contextlib.nullcontext()):
                result = sched.solve(snap, device=dev)
            _sync(dev)
            runs.append(time.perf_counter() - t0)
        outs.append((result, snap, meta, setup_s, runs, pk.launches()))
    (result, snap, meta, setup_s, runs, launches), (
        on_cpu, snap_cpu, meta_cpu, _, (cpu_s,), _) = outs
    got, want = parity_outputs(result), parity_outputs(on_cpu)
    differ = [k for k in got if (got[k] is None) != (want[k] is None) or (
        got[k] is not None and not torch.equal(got[k].cpu(), want[k]))]
    viol = parity_violations(snap_cpu, on_cpu)
    viol.update(intree_oracle(cluster, meta_cpu, on_cpu.assignment))
    P = snap.num_pods
    cold_s, solve_s = runs
    sc = snap_cpu.scheduling
    codes = on_cpu.failed_plugin.numpy()
    failed_by = dict(zip(*[v.tolist() for v in np.unique(
        codes[codes >= 0], return_counts=True)]))
    print(
        f"[intree] parity_{label} nodes={len(meta.node_names)} "
        f"pods={len(meta.pod_names)} rows={P} setup_s={setup_s:.3f} "
        f"scheduling_tables_s={meta.scheduling_s:.4f} cold_s={cold_s:.3f} "
        f"solve_s={solve_s:.3f} ms_per_pod={solve_s * 1e3 / P:.4f} "
        f"pods_per_s={P / solve_s:.1f} cpu_s={cpu_s:.3f} "
        f"cpu_ms_per_pod={cpu_s * 1e3 / P:.4f} "
        f"placed={int((on_cpu.assignment >= 0).sum())} "
        f"failed_by={failed_by} "
        f"tracks={tuple(sc.track_base.shape)} "
        f"node_counts={sc.spread_needs_node_counts} "
        f"anti={None if sc.exist_anti_base is None else tuple(sc.exist_anti_base.shape)} "
        f"sym={None if sc.sym_base is None else tuple(sc.sym_base.shape)} "
        f"identical={not differ} violations={viol}", flush=True)
    no_election_launches("intree", f"parity_{label}", launches)
    if differ:
        raise AssertionError(f"{label}: card != CPU in {differ}")
    if any(viol.values()):
        raise AssertionError(f"{label}: hard-constraint violations {viol}")
    return cluster


def add_late_pods(cluster, make_cluster_of) -> None:
    """Between the in-tree phase's two cycles: a Namespace labelled
    tier=prod (an InterPodAffinity event) and INTREE_CYCLE2_PODS new
    pending pods of the problem's kinds, drawn with another seed."""
    from scheduler_plugins_tpu_torch.api import objects

    cluster.add_namespace(objects.Namespace(name="prod-c",
                                            labels={"tier": "prod"}))
    donor = make_cluster_of(INTREE_CYCLE2_PODS)
    for pod in donor.pods.values():
        if pod.node_name is not None:
            continue
        pod.name = f"late-{pod.name}"
        pod.uid = f"{pod.namespace}/{pod.name}"
        pod.creation_ms += 1_000_000
        cluster.add_pod(pod)


def intree_cycles(label: str, make_cluster, make_scheduler, make_late,
                  device) -> None:
    """Two `run_cycle`s of the problem on the card and, from a fresh
    cluster, on the CPU, with `add_late_pods` between them: identical
    reports and store bookkeeping after each, no store violation, no
    election kernel launched; each cycle's stage times (the scheduling
    tables' host seconds among them) printed."""
    import torch

    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    states = []
    for dev in (device, torch.device("cpu")):
        cluster = make_cluster()
        sched = make_scheduler()
        pk.reset_launches()
        out = []
        for k, now in enumerate((1000, 2000)):
            if k:
                add_late_pods(cluster, make_late)
            timings = {}
            t0 = time.perf_counter()
            report = run_cycle(sched, cluster, now=now, device=dev,
                               timings=timings)
            _sync(dev)
            cycle_s = time.perf_counter() - t0
            viol = store_violations(cluster)
            print(f"[intree] cycle_{label} cycle={k + 1} device={dev.type} "
                  f"pods={len(cluster.pods)} cycle_s={cycle_s} "
                  f"stage_s={timings} bound={len(report.bound)} "
                  f"failed={len(report.failed)} "
                  f"failed_by={sorted(set(report.failed_by.values()))} "
                  f"skipped={len(report.skipped)} violations={viol}",
                  flush=True)
            if any(viol.values()) or not report.bound:
                raise AssertionError(f"{label} cycle {k + 1} on {dev}: "
                                     f"{viol}, {len(report.bound)} bound")
            out.append(cycle_state(report, cluster))
        no_election_launches("intree", f"cycle_{label} device={dev.type}",
                             pk.launches())
        states.append(out)
    if states[0] != states[1]:
        raise AssertionError(f"{label} cycles: card != CPU")
    print(f"[intree] cycle_{label} identical=True", flush=True)


def intree_preemption(device) -> None:
    """`tests/torch_intree_cases.intree_preemption_script` (three cycles
    with DEFAULT preemption: an anti-affinity victim whose eviction frees
    the domain, then a symmetric block lifted by evicting its carrier) on
    the card and on the CPU, compared cycle by cycle; the nominations are
    the ones the post-eviction re-filter makes."""
    from types import SimpleNamespace

    import torch

    from scheduler_plugins_tpu_torch import plugins
    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import (
        Profile,
        Scheduler,
        run_cycle,
    )
    from scheduler_plugins_tpu_torch.framework import preemption
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_intree_cases import intree_preemption_script

    pkg = SimpleNamespace(o=objects, Cluster=Cluster, Profile=Profile,
                          Scheduler=Scheduler, plugins=plugins,
                          pre=preemption)
    runs = {}
    for dev in (device, torch.device("cpu")):
        cluster, sched, steps = intree_preemption_script(pkg)
        pk.reset_launches()
        out, reports = [], []
        for now, mutate in steps:
            if mutate is not None:
                mutate(pkg, cluster)
            report = run_cycle(sched, cluster, now=now, device=dev)
            reports.append(report)
            out.append(cycle_state(report, cluster))
            print(f"[intree] preemption device={dev.type} now={now} "
                  f"bound={report.bound} failed_by={report.failed_by} "
                  f"preempted={report.preempted}", flush=True)
        no_election_launches("intree", f"preemption device={dev.type}",
                             pk.launches())
        runs[dev.type] = (out, reports)
    (card, reports), (cpu, _) = runs[device.type], runs["cpu"]
    want = [{"default/claimant": ("n0", ["default/db-0"])}, {},
            {"default/db-1": ("n0", ["default/claimant"])}]
    got = [r.preempted for r in reports]
    print(f"[intree] preemption identical={card == cpu} "
          f"nominations={got}", flush=True)
    if card != cpu:
        raise AssertionError("in-tree preemption script: card != CPU")
    if got != want:
        raise AssertionError(f"in-tree preemption script: {got}")


def intree_phase(device) -> None:
    """Phase 14: the in-tree plugins and the batched solve's validators on
    `mixed_full` and `intree_1k` at 1,024 nodes x 1,024 pods: the parity
    solve with the work a step enqueues, two cycles, the batched solve
    through the validator branch (card == CPU everywhere, 0 oracle
    violations, no election kernel), then the preemption script."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.models import mixed_scenario
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_intree_cases import intree_cluster

    pkg = SimpleNamespace(objects=objects, Cluster=Cluster)
    late = {
        "mixed_full": lambda n: mixed_scenario(1, n, seed=1),
        "intree_1k": lambda n: intree_cluster(pkg, 1, n, 0, seed=1),
    }
    t_phase = time.perf_counter()
    for label in ("mixed_full", "intree_1k"):
        t0 = time.perf_counter()
        make_cluster, make_scheduler = intree_problem(label)
        cluster = intree_parity(label, make_cluster, make_scheduler, device)
        launches_per_step(cluster, device, make_scheduler=make_scheduler,
                          label=f"{label} ")
        batch_drive(f"batch_{label}", cluster, make_scheduler, device)
        del cluster
        intree_cycles(label, make_cluster, make_scheduler, late[label],
                      device)
        print(f"[intree] {label} phase_s={time.perf_counter() - t0}",
              flush=True)
    intree_preemption(device)
    print(f"[intree] phase_s={time.perf_counter() - t_phase}", flush=True)


def kernel_table(north: dict, device) -> list:
    """One row per kernel: launches on the north-star path, and times
    averaged per launch over the shapes, dtypes and strides that path gave
    the kernel."""
    rows = []
    for name, replaces in REPLACES.items():
        shapes = north["shapes"][name]
        n = sum(shapes.values())
        acc = dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms",
                             "library_ms", "library_device_ms"), 0.0)
        err = 0.0
        for i, (key, count) in enumerate(sorted(shapes.items(), key=str)):
            r = check_kernel(name, key, device, seed=100 + i)
            err = max(err, r["max_abs_err"])
            print(f"[kernel@path] {name} shape={key[0]} dtype={key[1]} "
                  f"strides={key[2]} launches={count} "
                  + " ".join(f"{k}={v}" for k, v in r.items()), flush=True)
            for k in acc:
                if r[k] is not None:
                    acc[k] += r[k] * count / n
        library = name != "fused_election"
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": north["launches"][name],
            "max_abs_err": err, "ms": acc["ms"],
            "device_ms": acc["device_ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"], "bound_by": "bytes",
            "library_ms": acc["library_ms"] if library else None,
            "library_device_ms": acc["library_device_ms"] if library else None,
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {smi} torch={torch.__version__} cuda={torch.version.cuda}",
          flush=True)

    # 2. build
    from scheduler_plugins_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    print(f"[build] {sorted(str(p) for p in libs.values())} "
          f"seconds={time.perf_counter() - t0:.2f}", flush=True)

    # 3. each kernel against its plain version on the grid
    from scheduler_plugins_tpu_torch.models import (
        allocatable_scenario,
        gang_quota_scenario,
    )

    for i, (name, key) in enumerate(grid_shapes(4)):
        r = check_kernel(name, key, device, seed=i)
        print(f"[kernel] {name} shape={key[0]} dtype={key[1]} "
              f"strides={key[2]} "
              + " ".join(f"{k}={v}" for k, v in r.items()), flush=True)

    # 4. north star through the blocked path
    t0 = time.perf_counter()
    cluster = allocatable_scenario(NORTH_STAR["n_nodes"], NORTH_STAR["n_pods"])
    print(f"[north_star] scenario_s={time.perf_counter() - t0:.3f}", flush=True)
    north = drive(
        "north_star", cluster, device, S_BLOCKS, chunk=NORTH_STAR["chunk"],
        rescue_window=NORTH_STAR["rescue_window"], pad_to=NORTH_STAR["chunk"],
    )

    # 5. the streamed chunk pipeline: the north star as bench drives it,
    # bench config 6 through one streamed cycle, the streamed script
    north_star_pipeline(cluster, device)
    del cluster
    config6_cycle(device)
    script_phase(device, stream_chunk=4)

    # 6. gang + quota, and a tight problem (rescue waves, hopeless pods)
    # solved on the card and, through the plain versions, on the CPU
    drive("gang_quota", gang_quota_scenario(32, 64, 1024), device, S_BLOCKS)
    tight = allocatable_scenario(40, 3000)
    kw = dict(chunk=1024, rescue_window=NORTH_STAR["rescue_window"],
              pad_to=1024)
    on_card = drive("tight_cuda", tight, device, 3, **kw)
    on_cpu = drive("tight_cpu", tight, torch.device("cpu"), 3, **kw)
    for key in ("assignment", "admitted", "wait"):
        if not torch.equal(on_card[key].cpu(), on_cpu[key]):
            raise AssertionError(f"tight problem: card != CPU ({key})")

    # 7. the sequential parity solve, card against CPU
    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_parity_cases import nominee_cluster

    config4 = gang_quota_scenario(**CONFIG4)
    parity_drive("parity_config4", config4, device)
    parity_drive("parity_entry", allocatable_scenario(16, 32), device)
    parity_drive("parity_nominees", nominee_cluster(objects, Cluster), device)
    live_weights_phase(device, config4, launches_per_step(config4, device))

    # 8. the scheduling cycle, card against CPU
    cycle_phase(device)

    # 9. the Trimaran plugins (bench config 2 and the small cases)
    trimaran_phase(device)

    # 10. NUMA: bench config 3 through the parity solve and a cycle
    numa_phase(device)

    # 11. the network-aware plugins: bench config 5 through the parity
    # solve and a cycle
    network_phase(device)

    # 12. the NRT cache tier through a four-cycle script
    nrt_cache_phase(device)

    # 13. the batched profile solve on configs 3, 2, 4 and 5
    batch_phase(device)

    # 14. the in-tree plugins and the batched solve's validators
    intree_phase(device)

    # 15. the kernel table, the card, the result
    print(json.dumps({"kernels": kernel_table(north, device)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
