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
14. the in-tree plugins and the batched solve's validators on
   `mixed_full` (the JAX full-roster mixed profile on `mixed_scenario(1024,
   512)`) and `intree_1k` (`tests/torch_intree_cases.intree_cluster`, 512
   pending pods; both cut from 1,024 pods since phase 21 came in):
   the parity solve, the work a step enqueues, the batched solve through
   the validator walk, two `run_cycle`s and the in-tree preemption
   script, card against CPU, 0 violations of the host oracle
   (`[intree]` lines);
15. the rest of the roster on `roster_1k` (`tests/torch_roster_cases
   .roster_cluster`: QOSSort, NodeResourcesAllocatable, SySched, PodState
   and PreemptionToleration over 1,024 nodes, 3,072 bound and 1,024
   pending pods and a 360-name syscall universe) and `metric_1k` (the
   JAX metric roster on `metric_affinity_scenario(1024, 1024)`): the
   parity solve (card == CPU, 0 fit and InterPodAffinity violations, 64
   pods' SySched rows on the card equal to the reference's set loop), the
   work a step enqueues, the batched solve; the roster's two cycles, the
   second's 36 preemptors held to the toleration policies (evicted,
   spared and overridden counted, none evicted that its policy spares);
   and the cross-node preemption script (4,096 subsets a preemptor),
   card against CPU (`[roster]` lines);
16. the packing solve mode at bench config 13's full size
   (`packing_scenario(768, 0.92, 0.05)`: 768 nodes, 19,213 pending pods,
   uncut): `packing_solve` at budgets 0, 8, 32 and 128 (knobs 4.0, 0.0,
   0.5) on the card and on the CPU, identical outputs and statistics, the
   JAX package's rounds / moves / emptied, budget 0 equal to
   `batch_solve`, 0 `tuning.gates` violations, the placed set kept and
   packed utilization up at 128, each arm's median solve seconds and
   pods/s; the host calls that enqueue device work a refinement round
   (`torch.profiler`); `packing_refine`'s 128 rounds under sync-debug
   "error"; the packing-mode profile through `Scheduler.solve` and one
   `run_cycle` (card == CPU, the cycle binding the direct solve's
   placements, the quality stamped); the test-only modes on a 24 x 160
   problem (`[packing]` lines);
17. the serving path (`serving.engine.ServeEngine` through
   `run_cycle(serve=)`): bench config 7 at its full shape (2,000 nodes,
   12,288 bound pods, 4 + 48 cycles of Poisson churn with node adds and
   deletes, `tests/torch_churn_cases.py`) served on the card, with a full
   re-snapshot every cycle on the card, and served on the CPU: every
   cycle's decisions identical across the three, 0 capacity violations,
   the engines' rebases and generation equal; a steady-state refresh under
   sync-debug "error"; the host calls that enqueue device work in one
   refresh and in its apply (`torch.profiler`); the anti-entropy verify
   exact; the bench's line (cycles/s of each arm, `vs_full_resnapshot`,
   decision latency p50 / p99); the flagship profile's thirty served
   churn cycles card == CPU (`[serving]` lines). Phases 9 to 17 launch no
   election kernel: their counts print 0 / 0 / 0;
18. the resilience layer (`[resilience]` lines): bench config 9 at its
   full shape (`tests/torch_chaos_cases.py` `CHAOS_SHAPE`: 500 nodes,
   4,096 bound pods, 4 + 32 cycles of churn under the standard fault
   plan through the serving engine and the solve watchdog), the control
   arm on the card and the chaos arm on the card and on the CPU: every
   timed cycle's bound map equal across the three, 0 capacity
   violations, one crash restored from the checkpoint, the failovers,
   degraded cycles, rebases, divergences and recovery windows equal on
   card and CPU, the control never on the host path, each arm's p50 / p99
   cycle time and abandoned workers; `host_sequential_solve` bit-identical
   to `Scheduler.solve` on the card (config 7's served snapshot,
   `allocatable_scenario(1024, 4096)`); the checkpoint (an exact one
   resumes with no rebase, a stale one rebases within one window); the
   north star through `run_chunk_pipeline(fetch_deadline_s=30)` equal to
   the call without, and `cycle_script` through `run_cycle(stream_chunk=4,
   resilience=)` equal to `run_cycle(stream_chunk=4)`;
19. the rank-aware gangs (`[gangs]` lines): bench config 10 at its full
   shape (`tests/torch_gang_cases.py` `RANK_GANG_SHAPE`: 384 nodes, 24
   MPI gangs of 8 ranks, 8 elastic jobs) through
   `run_cycle(gangs=GangPhase(check_twin=True))`, the elastic grow and
   shrink and the quorum-only baseline, card == CPU, drift 0.0, 0
   violations, the wave phase placing identically; bench config 12 at its
   full shape (`MEGA_GANG_SHAPE`: 10,240 nodes, 1,024 gangs) through
   `gang_solve` (under sync-debug "error") and `wave_gang_solve` on the
   card and on the CPU and `gang_solve_np`, all bit-identical, 0
   violations, each solver's seconds and ranks/s, the work a gang step
   enqueues and the wave solve's host syncs a wave. Phases 18 and 19
   launch no election kernel;
20. the pipelined cycle engine (`[life]` lines): bench config 11 at its
   full shape (`tests/torch_life_cases.py` `CLUSTER_LIFE_SHAPE`: 2,000
   nodes, 12,288 bound pods, 4 warm-up cycles, then 48 churn, 12 gang,
   16 chaos and 16 node-wave cycles) through three arms stepped
   interleaved, each with its own pod-lifecycle ledger:
   `PipelinedCycle` + `StreamingServeEngine` on the card, `run_cycle` +
   `ServeEngine` on the card, and the pipelined arm on the CPU. Every
   cycle's bound / reserved / failed / attribution, the final store and
   the ledger sequences equal across the three, 0 capacity violations, 0
   decomposition errors, row compactions in the waves phase and fewer
   rebases than the serial arm; each arm and phase's cycles/s, decision
   p50 / p99, rebases, compactions and late binds, the pipelined arms'
   mean overlap efficiency and pipeline bubble, the ledger's stage
   shares; then `cycle_script` through `PipelinedCycle(stream_chunk=4)`
   equal to `run_cycle(stream_chunk=4)` on the card, every cycle. Phase
   20 launches no election kernel;
21. the laned cycle engine (`[lanes]` lines): bench config 15 at
   `LANE_SHAPE`'s full width (`tests/torch_lane_cases.py`: 64 deep nodes
   and `node-hot`, 64 tenants over 8 zones, R = 12, 12,288 bound pods,
   12,288 arrivals and departures a cycle, 16 hot bidders for 8 slots),
   its depth cut to one warm-up, one timed and one contended cycle: the
   serial `Scheduler.solve` and `LaneSolver` K = 4 and K = 8 fused on the
   card every cycle, K = 4 sequential on the card and the serial solve and
   K = 4 fused on the CPU on the timed cycle, every digest equal to the
   card's serial solve, 0 capacity violations, 0 serial fallbacks,
   conflicts and re-resolves on the contended cycle, the bench's line and
   each arm's solve seconds, fence and partition ms; the same stream
   through `LanedCycle` (K = 4, fused, `StreamingServeEngine`, async
   bind) and `run_cycle` (`ServeEngine`) on the card, every cycle's
   decisions and the final store equal; the lane program's work calls a
   step at K = 1 and K = 4 (`torch.profiler`, required equal) and a K = 4
   program under sync-debug "error". Phase 21 launches no election
   kernel;
22. the flight recorder and the debug modes (`[record]`, `[golden]`,
   `[sanitize]`, `[race]`, `[record_off]` lines): (a) the recorder on
   (capacity 16) through the flagship `run_cycle` sequential
   (`allocatable_scenario(256, 128)`) and streamed (1,024 x 1,024, chunks
   of 256), config 7's first four served cycles at `SERVING_SHAPE`, a
   packing-profile cycle (config 13's profile on `packing_scenario(16,
   0.92, 0.05)`), a config-10 gang cycle (`RANK_GANG_SHAPE`), three ticks
   of `PipelinedCycle` and of `LanedCycle` (K = 4) on a 256-node churn
   cut; the bundle saved, loaded and every record replayed on the card and
   on the CPU (digest intact, profile faithful, aux equal, a sequential
   record's placements equal, card == CPU), the gang capture through the
   numpy twin, the same cycles recorded on the CPU with the same digests;
   the record and save times and nine interleaved recorder-off / on pairs
   of a config-7 served cycle (no gate); (b) the JAX package's committed
   bundle (`tests/fixtures/flightrec`) replayed on the card with its
   failure attribution and a valid explain table; (c) under
   `SPT_SANITIZE=1` the flagship streamed cycle, config 4's
   `profile_batch_solve`, a served refresh and the north star cut to
   2,048 nodes x 8,192 pods in S = 8 blocks through `sharded_wave_solve`
   (the three kernels launched), each equal to the unchecked call with
   checked calls and no error, then an out-of-range `add_rows` index
   reported `out-of-bounds` with the card still working; (d) under
   `SPT_RACE=1` the race composite (`tests/torch_race_cases.py`: a
   256-node churn cut through `PipelinedCycle` with the watchdog, a
   planted hang and the pod-lifecycle ledger) with three seeds and once
   without the checker: no violation, each checked run with wrapped
   locks and Events and at least one lock-order edge, identical
   decisions; (e) a served `run_cycle` with the
   recorder off, its hook stages under sync-debug "error";
23. the tuning observatory (`[tune]` lines): bench config 14, the
   drifting mix, at `TUNE_LIVE_SHAPE` uncut (`tests/torch_tune_cases.py`:
   96 nodes, 24 arrivals and 10 departures a cycle, 8 + 8 + 14 + 12 + 4
   cycles, K = 16 candidates, a corpus of 3, a sweep every 2 cycles):
   first a sweep step's work calls and device µs at K = 1 and K = 16
   (`torch.profiler`, required equal) and a K = 16 sweep under sync-debug
   "error"; (a) the static arm on the card, the tuned arm (the recorder
   and a synchronous `ShadowTuner` through `run_cycle(tuner=)`) on the
   card and on the CPU, each cycle's placements, failed pods and weights,
   the promotions, the injected cycle and the rollback equal card == CPU,
   the quality stamps within 1e-12 relative; (b) `tune_live_smoke`'s
   checks on the card (promoted, the post-promotion quality win > 0 and
   the overall one >= -0.002, no violation, no sweep failure, the
   observe-only lane's placements equal, the rollback within 2 cycles of
   the first detectable regression and no flapping, the per-tick overhead
   of 9 interleaved pairs within max(5 %, their jitter floor)); (c) the
   tuner chaos check (garbage sweep output, a sweep hang, a crash on
   every promotion) with every cycle's placements equal to the no-tuner
   control's; (d) the offline tuner's smoke (`tools/tune.py smoke`: a
   96-node x 128-pod trimaran corpus of 3 cycles, 64 candidates, an
   emitted profile with 0 violations, equal sweep ops at K = 1 and 64).
   No election kernel lies on this path;
24. the kernel table as one JSON line (times at the shapes, dtypes and
   strides the north-star path launched), then the card's line, then the
   result line `{"ok": true, "device": {...}}` last.

After phase 3 (the card, the build and the kernel grid together) and
each later one, a `[smoke] phase=n seconds=... total_s=...` line gives
the phase's wall seconds and the run's so far.

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
#: `mixed_scenario(1024, 512)`, and the in-tree roster (NodeAffinity,
#: TaintToleration, PodTopologySpread, InterPodAffinity beside
#: NodeResourcesAllocatable) on `tests/torch_intree_cases.intree_cluster`;
#: their depth cut from 1,024 to 512 pending pods (every check kept) to
#: keep the whole smoke inside its limit once the laned phase 21 came in
MIXED_FULL = dict(n_nodes=1024, n_pods=512)
INTREE_1K = dict(n_nodes=1024, n_pods=512, n_bound=256)
#: pods added between the in-tree phase's two cycles, with a Namespace
INTREE_CYCLE2_PODS = 256
#: the roster phase's problems at full width: the whole new roster
#: (QOSSort, NodeResourcesAllocatable, SySched, PodState,
#: PreemptionToleration) on `tests/torch_roster_cases.roster_cluster`
#: with the 360-name syscall universe, and the JAX metric roster on
#: `metric_affinity_scenario`; the roster's second cycle adds the
#: preemptors
ROSTER_1K = dict(n_nodes=1024, n_pods=1024)
METRIC_1K = dict(n_nodes=1024, n_pods=1024)
ROSTER_PREEMPTORS = dict(n_mid=32, n_high=4)
#: queued pods whose SySched rows the host oracle recomputes
SYSCHED_ORACLE_ROWS = 64
#: bench config 13 (`bench.py:3120-3352`, `PACKING_SHAPE`): the packing
#: problem uncut, 768 nodes and 19,213 pending pods; the budgets run
#: (0, the wave path, first) with the knobs (budget, 4.0, 0.0, 0.5)
PACKING = dict(n_nodes=768, demand_frac=0.92, empty_frac=0.05)
PACKING_BUDGETS = (0, 8, 32, 128)
PACKING_KNOBS = (4.0, 0.0, 0.5)
#: (rounds, moves, emptied) by budget, and the pods placed, of the JAX
#: package's `packing_solve` on this problem (run on a CPU): the port must
#: reproduce them exactly
PACKING_STATS = {0: (0, 0, 0), 8: (8, 49, 7), 32: (32, 136, 15),
                 128: (128, 312, 15)}
PACKING_PLACED = 19_213
#: the packing-mode profile of the phase's profile path, and its JAX
#: statistics on the same problem
PACKING_PROFILE = {"plugins": ["NodeResourcesAllocatable"],
                   "solveMode": "packing",
                   "packingConfig": {"iterations": 32}}
PACKING_PROFILE_STATS = (32, 136, 15)
#: timed runs of each packing arm (the median is kept)
PACKING_RUNS = 3
#: pods of config 4 whose steps the profiler counts (and twice as many)
PROFILE_PODS = 64
#: lane steps of config 15 the profiler counts at K = 1 and K = 4 (and
#: twice as many)
LANE_PROFILE_STEPS = 16
#: pods of config 15's timed cycle that K = 4 "threads" and "sequential"
#: solve to show what the threads overlap
LANE_THREADS_PODS = 512
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
    with the profile `make_scheduler()` builds: once under sync-debug
    "error" (`cold_s`, paying the kernels' first loads), then once without
    it (`solve_s`, the time reported per pod); then the
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
    for mode in ("error", "default"):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            result = sched.solve(snap, device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync(device)
        runs.append(time.perf_counter() - t0)
    cold_s, solve_s = runs

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


def profile_records(prof) -> list:
    """Every record `prof` (a finished `torch.profiler.profile`) took, as
    (name, on_device, start_ns, end_ns, thread), read from the
    profiler's raw results. `prof.events()` and `key_averages()` first
    build torch's Python event tree, most of the profiled phases' time on
    the card: for one 128-pod parity solve's 107,063 records 13.6 s
    against 0.87 s for these tuples and `host_self_us`
    (`tools/profiler_cost.py`)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def host_self_us(records) -> dict:
    """{name: [calls, self µs]} of the host records, as torch's
    `key_averages` gives them: a record's self time is its span less its
    direct children's on the same thread (a child lies inside its
    parent's span), and the only child of a record of the same name is
    counted with it, not as a call of its own."""
    from collections import defaultdict

    threads = defaultdict(list)
    for name, on_device, t0, t1, tid in records:
        if not on_device:
            threads[tid].append((t0, t1, name))
    out = defaultdict(lambda: [0, 0])
    for recs in threads.values():
        recs.sort(key=lambda r: (r[0], -r[1]))
        parent, children, stack = [], [0] * len(recs), []
        for i, (t0, t1, _) in enumerate(recs):
            while stack and (t0 >= recs[stack[-1]][1]
                             or t1 > recs[stack[-1]][1]):
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            if stack:
                children[stack[-1]] += 1
            stack.append(i)
        for i, (t0, t1, name) in enumerate(recs):
            row, up = out[name], parent[i]
            row[1] += t1 - t0
            if up >= 0:
                out[recs[up][2]][1] -= t1 - t0
            if not (up >= 0 and recs[up][2] == name and children[up] == 1):
                row[0] += 1
    return {name: [calls, ns / 1e3] for name, (calls, ns) in out.items()}


def profiled_work(run, device) -> tuple:
    """`run()` once to warm, then once under `torch.profiler`: (device
    records, the host calls that enqueue device work by name (names
    matching WORK_CALLS), device microseconds, every record
    (`profile_records`)). The host calls are exact; the device records
    come back through CUPTI's device buffers, which may drop some."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    run()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        _sync(device)
    records = profile_records(prof)
    kernels = [r for r in records if r[1]]
    work = Counter(r[0] for r in records
                   if not r[1] and r[0].startswith("cu")
                   and any(w in r[0] for w in WORK_CALLS))
    return (len(kernels), work,
            sum(t1 - t0 for _, _, t0, t1, _ in kernels) / 1e3, records)


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
        events, work, device_us, records = profiled_work(
            lambda: sched.solve(snap, device=device), device)
        counts[n] = (events, work, device_us)
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
    ops = host_self_us(records)
    n = 2 * PROFILE_PODS
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:12]
    print(
        f"[parity] {label}host_us_per_step="
        f"{sum(us for _, us in ops.values()) / n} top ops (calls, "
        f"self CPU us per step): " + ", ".join(
            f"{name} {calls / n:.2f} {us / n:.2f}"
            for name, (calls, us) in top),
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
    events = [r for r in profile_records(prof) if not r[1]]
    walks = [(t0, t1) for name, _, t0, t1, _ in events
             if name == "validate_wave"]
    launches = sum(
        1 for name, _, t0, _, _ in events
        if name.startswith("cu") and "LaunchKernel" in name
        and any(lo <= t0 <= hi for lo, hi in walks))
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
    `mixed_full` and `intree_1k` at 1,024 nodes x 512 pods: the parity
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


def roster_problem(name: str):
    """(make_cluster, make_scheduler) of the roster phase's problem
    `roster_1k` or `metric_1k`."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler
    from scheduler_plugins_tpu_torch.models import metric_affinity_scenario
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_roster_cases import (
        METRIC_PROFILE,
        ROSTER_PROFILE,
        roster_cluster,
    )

    if name == "metric_1k":
        return (lambda: metric_affinity_scenario(**METRIC_1K),
                lambda: Scheduler(load_profile(METRIC_PROFILE)))
    pkg = SimpleNamespace(objects=objects, Cluster=Cluster)
    return (lambda: roster_cluster(pkg, **ROSTER_1K),
            lambda: Scheduler(load_profile(ROSTER_PROFILE)))


def sysched_oracle(label: str, cluster, sched, snap, meta) -> int:
    """SySched's raw rows of SYSCHED_ORACLE_ROWS seeded queued pods,
    `score_batch` and the per-pod `score` on the snapshot's device,
    against `tests/torch_roster_cases.sysched_reference_rows` (the
    reference's set loop over the store's objects): returns the rows that
    differ, printing the count."""
    import numpy as np
    import torch

    _tests_on_path()
    from torch_roster_cases import sysched_reference_rows

    plugin = next(p for p in sched.profile.plugins if p.name == "SySched")
    n_pods, n_nodes = len(meta.pod_names), len(meta.node_names)
    rows = sorted(np.random.default_rng(0).choice(
        n_pods, size=min(SYSCHED_ORACLE_ROWS, n_pods),
        replace=False).tolist())
    t0 = time.perf_counter()
    batch = plugin.score_batch(None, snap)[rows][:, :n_nodes].cpu()
    per_pod = torch.stack([plugin.score(None, snap, r)
                           for r in rows])[:, :n_nodes].cpu()
    pending = [cluster.pods[uid] for uid in meta.pod_names]
    want = sysched_reference_rows(cluster, pending, rows, meta.node_names)
    bad = sum(1 for k in range(len(rows))
              if batch[k].tolist() != want[k]
              or per_pod[k].tolist() != want[k])
    print(f"[roster] {label} sysched_oracle rows={len(rows)} "
          f"differ={bad} syscalls={snap.syscalls.pod_sets.shape[1]} "
          f"seconds={time.perf_counter() - t0:.3f}", flush=True)
    return bad


def roster_parity(label: str, make_cluster, make_scheduler, device):
    """`Scheduler.solve` of the problem on the card, first under sync-debug
    "error" (`cold_s`), then timed (`solve_s`), and on the CPU: every
    output and final carry identical, no violation of `parity_violations`
    (nor of `intree_oracle` where InterPodAffinity's tables exist), the
    SySched oracle equal on the card, no election kernel launched. Returns
    the cluster."""
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
        outs.append((result, snap, meta, setup_s, runs, pk.launches(),
                     sched))
    (result, snap, meta, setup_s, runs, launches, sched), (
        on_cpu, snap_cpu, meta_cpu, _, (cpu_s,), _, _) = outs
    got, want = parity_outputs(result), parity_outputs(on_cpu)
    differ = [k for k in got if (got[k] is None) != (want[k] is None) or (
        got[k] is not None and not torch.equal(got[k].cpu(), want[k]))]
    viol = parity_violations(snap_cpu, on_cpu)
    if snap_cpu.scheduling is not None:
        viol.update(intree_oracle(cluster, meta_cpu, on_cpu.assignment))
    viol["sysched_oracle"] = sysched_oracle(f"parity_{label}", cluster,
                                            sched, snap, meta)
    P = snap.num_pods
    cold_s, solve_s = runs
    codes = on_cpu.failed_plugin.numpy()
    failed_by = dict(zip(*[v.tolist() for v in np.unique(
        codes[codes >= 0], return_counts=True)]))
    nodes = snap_cpu.nodes
    print(
        f"[roster] parity_{label} nodes={len(meta.node_names)} "
        f"pods={len(meta.pod_names)} rows={P} setup_s={setup_s:.3f} "
        f"cold_s={cold_s:.3f} solve_s={solve_s:.3f} "
        f"ms_per_pod={solve_s * 1e3 / P:.4f} pods_per_s={P / solve_s:.1f} "
        f"cpu_s={cpu_s:.3f} cpu_ms_per_pod={cpu_s * 1e3 / P:.4f} "
        f"placed={int((on_cpu.assignment >= 0).sum())} "
        f"failed_by={failed_by} "
        f"terminating={int(nodes.terminating.sum())} "
        f"nominated={int(nodes.nominated.sum())} "
        f"identical={not differ} violations={viol}", flush=True)
    no_election_launches("roster", f"parity_{label}", launches)
    if differ:
        raise AssertionError(f"{label}: card != CPU in {differ}")
    if any(viol.values()):
        raise AssertionError(f"{label}: violations {viol}")
    return cluster


def roster_cycles(device) -> None:
    """`roster_1k` through two `run_cycle`s on the card and, from a fresh
    cluster, on the CPU: the first binds the batch, the second (at the
    later ROSTER_NOW, after `add_preemptors`) preempts; identical reports
    and store bookkeeping after each, no store violation, no election
    kernel; each cycle's stage times, and the second's preemption counts
    against the toleration policies (`toleration_outcomes`: evicted,
    spared, overridden, and no victim its policy spares at that time)."""
    from types import SimpleNamespace

    import torch

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    _tests_on_path()
    from torch_roster_cases import (
        ROSTER_NOW,
        add_preemptors,
        toleration_outcomes,
    )

    pkg = SimpleNamespace(objects=objects)
    make_cluster, make_scheduler = roster_problem("roster_1k")
    states = []
    for dev in (device, torch.device("cpu")):
        cluster = make_cluster()
        sched = make_scheduler()
        pk.reset_launches()
        out = []
        for k, now in enumerate(ROSTER_NOW):
            if k:
                add_preemptors(pkg, cluster, **ROSTER_PREEMPTORS)
            timings = {}
            t0 = time.perf_counter()
            report = run_cycle(sched, cluster, now=now, device=dev,
                               timings=timings)
            _sync(dev)
            cycle_s = time.perf_counter() - t0
            viol = store_violations(cluster)
            tol = toleration_outcomes(cluster, report.preempted, now)
            print(f"[roster] cycle_roster_1k cycle={k + 1} "
                  f"device={dev.type} pods={len(cluster.pods)} "
                  f"cycle_s={cycle_s} stage_s={timings} "
                  f"bound={len(report.bound)} failed={len(report.failed)} "
                  f"nominated={len(report.preempted)} "
                  f"preemption={tol} violations={viol}", flush=True)
            if any(viol.values()) or tol["violations"]:
                raise AssertionError(f"roster cycle {k + 1} on {dev}: "
                                     f"{viol}, {tol}")
            if k == 0 and (len(report.bound) != ROSTER_1K["n_pods"]
                           or report.preempted):
                raise AssertionError(f"roster cycle 1 on {dev}: "
                                     f"{len(report.bound)} bound")
            if k == 1 and not (tol["evicted"] and tol["overridden"]
                               and tol["spared"]):
                raise AssertionError(f"roster cycle 2 on {dev}: {tol}")
            out.append(cycle_state(report, cluster))
        no_election_launches("roster", f"cycle_roster_1k device={dev.type}",
                             pk.launches())
        states.append(out)
    if states[0] != states[1]:
        raise AssertionError("roster cycles: card != CPU")
    print("[roster] cycle_roster_1k identical=True", flush=True)


def cross_node_phase(device) -> None:
    """`tests/torch_roster_cases.cross_node_script` (three cycles of
    CrossNodePreemption over a pool of 12, 4,096 subsets a preemptor) on
    the card and on the CPU, compared cycle by cycle, with the
    nominations and binds the script is built to reach."""
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
    from scheduler_plugins_tpu_torch.state import Cluster

    _tests_on_path()
    from torch_roster_cases import cross_node_script

    pkg = SimpleNamespace(o=objects, Cluster=Cluster, Profile=Profile,
                          Scheduler=Scheduler, plugins=plugins)
    runs = {}
    for dev in (device, torch.device("cpu")):
        cluster, sched, steps = cross_node_script(pkg)
        pk.reset_launches()
        out, reports = [], []
        for now, mutate in steps:
            if mutate is not None:
                mutate(pkg, cluster)
            t0 = time.perf_counter()
            report = run_cycle(sched, cluster, now=now, device=dev)
            cycle_s = time.perf_counter() - t0
            reports.append(report)
            out.append(cycle_state(report, cluster))
            print(f"[roster] cross_node_script device={dev.type} now={now} "
                  f"cycle_s={cycle_s} bound={report.bound} "
                  f"preempted={report.preempted}", flush=True)
        no_election_launches("roster", f"cross_node_script "
                             f"device={dev.type}", pk.launches())
        runs[dev.type] = (out, reports)
    (card, reports), (cpu, _) = runs[device.type], runs["cpu"]
    got = ([r.preempted for r in reports], reports[2].bound)
    want = ([{"default/small": ("a", ["default/v-a2"]),
              "default/big": ("c", ["default/v-c"])}, {}, {}],
            {"default/small": "a", "default/big": "c"})
    print(f"[roster] cross_node_script identical={card == cpu} "
          f"outcomes={got}", flush=True)
    if card != cpu:
        raise AssertionError("cross-node script: card != CPU")
    if got != want:
        raise AssertionError(f"cross-node script: {got}")


def roster_phase(device) -> None:
    """Phase 15: the rest of the plugin roster on `roster_1k` and
    `metric_1k` at 1,024 nodes x 1,024 pods: the parity solve with its
    SySched oracle and the work a step enqueues, the batched solve, the
    roster's two cycles with its preemptions, and the cross-node script
    (card == CPU everywhere, 0 oracle violations, no election kernel)."""
    t_phase = time.perf_counter()
    for label in ("roster_1k", "metric_1k"):
        t0 = time.perf_counter()
        make_cluster, make_scheduler = roster_problem(label)
        cluster = roster_parity(label, make_cluster, make_scheduler, device)
        launches_per_step(cluster, device, make_scheduler=make_scheduler,
                          label=f"{label} ")
        batch_drive(f"batch_{label}", cluster, make_scheduler, device)
        del cluster
        print(f"[roster] {label} phase_s={time.perf_counter() - t0}",
              flush=True)
    t0 = time.perf_counter()
    roster_cycles(device)
    print(f"[roster] cycle_roster_1k phase_s={time.perf_counter() - t0}",
          flush=True)
    t0 = time.perf_counter()
    cross_node_phase(device)
    print(f"[roster] cross_node_script phase_s={time.perf_counter() - t0}",
          flush=True)
    print(f"[roster] phase_s={time.perf_counter() - t_phase}", flush=True)


def packing_arm(snap, weights, budget: int, device) -> dict:
    """`packing_solve` at `budget` with `PACKING_KNOBS` on `device`,
    PACKING_RUNS times: the last run's host outputs and stats, and the
    median solve seconds (host clock around a synchronised call)."""
    from scheduler_plugins_tpu_torch.ops.packing import pack_aux_vector
    from scheduler_plugins_tpu_torch.parallel.solver import packing_solve

    aux = pack_aux_vector(budget, *PACKING_KNOBS)
    times = []
    for _ in range(PACKING_RUNS):
        _sync(device)
        t0 = time.perf_counter()
        assignment, admitted, wait, stats = packing_solve(
            snap, weights, aux, collect_stats=True)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return {
        "assignment": assignment.cpu(), "admitted": admitted.cpu(),
        "wait": wait.cpu(), "waves": stats["waves"],
        "stats": tuple(int(stats["packing"][k])
                       for k in ("rounds", "moves", "emptied")),
        "seconds": statistics.median(times), "out": (assignment, wait),
    }


def packing_work_per_round(snap, weights, device) -> dict:
    """What a refinement round puts on the card, from `torch.profiler`:
    `packing_solve` at budgets 8 and 16 differ by 8 rounds (the wave path,
    the head and the tail are the same work). Returns the host calls that
    enqueue device work a round (names matching WORK_CALLS), by name, and
    the device records and microseconds a round."""
    from scheduler_plugins_tpu_torch.ops.packing import pack_aux_vector
    from scheduler_plugins_tpu_torch.parallel.solver import packing_solve

    counts = {}
    for budget in (8, 16):
        aux = pack_aux_vector(budget, *PACKING_KNOBS)
        counts[budget] = profiled_work(
            lambda: packing_solve(snap, weights, aux), device)[:3]
    (k1, w1, us1), (k2, w2, us2) = counts[8], counts[16]
    work = {name: (w2[name] - w1[name]) / 8 for name in sorted(w1 | w2)}
    return {"work": work, "work_calls": sum(work.values()),
            "device_events": (k2 - k1) / 8, "device_us": (us2 - us1) / 8}


def packing_modes_small(device) -> None:
    """The test-only placement modes (`greedy_assign`, `wave_assign`,
    `waterfill_assign`) on `tests/test_parallel.py`'s 24-node x 160-pod
    problem (the pods slot in its canonical column), card == CPU."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.ops import CPU_I
    from scheduler_plugins_tpu_torch.ops import assign as A
    from scheduler_plugins_tpu_torch.ops.fit import fits, fits_one
    from scheduler_plugins_tpu_torch.ops.normalize import minmax_normalize

    rng = np.random.default_rng(5)
    N, P, gib = 24, 160, 1 << 30
    free0 = np.stack([rng.integers(4000, 16000, N),
                      rng.integers(8, 64, N) * gib,
                      np.zeros(N), np.full(N, 110)], axis=1).astype(np.int64)
    req = np.stack([rng.integers(100, 2500, P), rng.integers(1, 8, P) * gib,
                    np.zeros(P), np.zeros(P)], axis=1).astype(np.int64)
    raw = rng.integers(0, 1000, N).astype(np.int64)
    outs = {}
    for dev in (device, torch.device("cpu")):
        f0, r, s = (torch.as_tensor(x).to(dev) for x in (free0, req, raw))
        mask = torch.ones(P, dtype=torch.bool, device=dev)
        node_mask = torch.ones(N, dtype=torch.bool, device=dev)

        def batch_fn(free, active, r=r, s=s):
            feasible = fits(r, free, pod_mask=active)
            return feasible, minmax_normalize(
                torch.broadcast_to(s[None, :], feasible.shape), feasible)

        def step_fn(free, p, r=r, node_mask=node_mask):
            return fits_one(r[p], free, node_mask), free[:, CPU_I]

        outs[dev.type] = {
            "greedy": A.greedy_assign(step_fn, r, mask, f0),
            "wave": A.wave_assign(batch_fn, r, mask, f0),
            "waterfill": A.waterfill_assign(batch_fn, r, mask, f0),
        }
    for mode, (a, f) in outs[device.type].items():
        ca, cf = outs["cpu"][mode]
        same = torch.equal(a.cpu(), ca) and torch.equal(f.cpu(), cf)
        print(f"[packing] small_{mode} placed={int((a >= 0).sum())} "
              f"identical={same}", flush=True)
        if not same:
            raise AssertionError(f"{mode}: card != CPU")


def packing_phase(device, smi: str) -> None:
    """Phase 16: the packing solve mode at bench config 13's full size.
    `packing_solve` at budgets 0 / 8 / 32 / 128 on the card and on the CPU
    (identical outputs and statistics, the JAX statistics, budget 0 ==
    `batch_solve`, 0 `tuning.gates` violations, the placed set kept,
    packed utilization up at 128), the work a refinement round enqueues,
    `packing_refine` at budget 128 under sync-debug "error", the
    packing-mode profile through `Scheduler.solve` and one `run_cycle`
    (card == CPU, the cycle binding the direct solve's placements, the
    quality stamped), and the test-only modes (`[packing]` lines). No
    election kernel is launched."""
    import torch

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
    from scheduler_plugins_tpu_torch.models import packing_scenario
    from scheduler_plugins_tpu_torch.ops.packing import (
        pack_aux_vector,
        packing_refine,
    )
    from scheduler_plugins_tpu_torch.ops.assign import (
        waterfill_assign_targeted,
    )
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel.solver import (
        _solve_head,
        batch_solve,
    )
    from scheduler_plugins_tpu_torch.tuning.gates import hard_violations
    from scheduler_plugins_tpu_torch.tuning.quality import cycle_quality

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    pk.reset_launches()
    t0 = time.perf_counter()
    _, snap_c, _, weights_c = packing_scenario(**PACKING, device="cpu")
    print(f"[packing] scenario_s={time.perf_counter() - t0} "
          f"nodes={int(snap_c.nodes.mask.sum())}/{snap_c.num_nodes} "
          f"pending={int(snap_c.pods.mask.sum())}/{snap_c.num_pods} "
          f"R={snap_c.num_resources}", flush=True)
    snap_d, weights_d = snap_c.to(device), weights_c.to(device)

    # the budget sweep, card against CPU
    arms = {}
    for budget in PACKING_BUDGETS:
        card = packing_arm(snap_d, weights_d, budget, device)
        host = packing_arm(snap_c, weights_c, budget, cpu)
        same = all(torch.equal(card[k], host[k])
                   for k in ("assignment", "admitted", "wait")) and (
            card["stats"] == host["stats"] and card["waves"] == host["waves"])
        viol = hard_violations(snap_d, *card["out"])
        q = cycle_quality(snap_d, card["out"][0], None, card["out"][1])
        q_cpu = cycle_quality(snap_c, host["out"][0], None, host["out"][1])
        placed = int((card["assignment"] >= 0).sum())
        print(f"[packing] budget={budget} card={smi!r} "
              f"solve_s={card['seconds']} cpu_solve_s={host['seconds']} "
              f"pods_per_s={placed / card['seconds']} "
              f"cpu_pods_per_s={placed / host['seconds']} "
              f"placed={placed} waves={card['waves']} "
              f"rounds_moves_emptied={card['stats']} violations={viol} "
              f"quality={q} cpu_quality={q_cpu} identical={same}",
              flush=True)
        if not same:
            raise AssertionError(f"packing budget {budget}: card != CPU")
        if card["stats"] != PACKING_STATS[budget]:
            raise AssertionError(f"packing budget {budget}: stats "
                                 f"{card['stats']} != JAX's "
                                 f"{PACKING_STATS[budget]}")
        if viol["total"] or placed != PACKING_PLACED:
            raise AssertionError(f"packing budget {budget}: {viol}, "
                                 f"{placed} placed")
        arms[budget] = (card, q)
    wave = batch_solve(snap_d, weights_d)
    base = arms[0][0]
    if not all(torch.equal(a.cpu(), base[k]) for a, k in zip(
            wave, ("assignment", "admitted", "wait"))):
        raise AssertionError("packing budget 0 != batch_solve")
    for budget, (card, _) in arms.items():
        if not torch.equal(card["assignment"] >= 0, base["assignment"] >= 0):
            raise AssertionError(f"budget {budget} changed the placed set")
    gain = (arms[128][1]["packed_utilization"]
            - arms[0][1]["packed_utilization"])
    print(f"[packing] budget0_equals_batch_solve=True placed_set_kept=True "
          f"packed_utilization_gain={gain} fragmentation_gain="
          f"{arms[0][1]['fragmentation'] - arms[128][1]['fragmentation']}",
          flush=True)
    if not gain > 0:
        raise AssertionError(f"packed utilization did not rise: {gain}")

    # the work a round enqueues, and the rounds under sync-debug "error"
    work = packing_work_per_round(snap_d, weights_d, device)
    print(f"[packing] per_round work_calls={work['work_calls']} "
          f"{work['work']} device_events={work['device_events']} "
          f"device_us={work['device_us']} card={smi!r}", flush=True)
    free0, admitted, raw = _solve_head(snap_d, weights_d)
    a_w, f_w, _ = waterfill_assign_targeted(
        raw, snap_d.pods.req, admitted,
        torch.where(snap_d.nodes.mask[:, None], free0, 0))
    _sync(device)
    t0 = time.perf_counter()
    with sync_errors(device):
        a_r, _, _ = packing_refine(
            raw, snap_d.pods.req, admitted, snap_d.nodes.alloc,
            snap_d.nodes.mask, f_w, a_w, pack_aux_vector(128, *PACKING_KNOBS))
    _sync(device)
    refine_s = time.perf_counter() - t0
    same = torch.equal(a_r.cpu(), arms[128][0]["assignment"])
    print(f"[packing] refine_128_sync_debug_error ok=True refine_s={refine_s} "
          f"equals_solve={same} card={smi!r}", flush=True)
    if not same:
        raise AssertionError("refine under sync-debug != the budget-128 arm")

    # the packing-mode profile: Scheduler.solve, then one run_cycle
    views, states = {}, {}
    for dev in (device, cpu):
        cluster = packing_scenario(**PACKING, device="cpu")[0]
        sched = Scheduler(load_profile(PACKING_PROFILE))
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, device=dev)
        sched.prepare(meta, cluster)
        _sync(dev)
        t0 = time.perf_counter()
        view = sched.solve(snap, device=dev)
        _sync(dev)
        solve_s = time.perf_counter() - t0
        a = view.assignment.cpu().numpy()
        want = {pending[i].uid: meta.node_names[int(a[i])]
                for i in range(len(pending)) if a[i] >= 0}
        views[dev.type] = (a, view.stats)
        cluster = packing_scenario(**PACKING, device="cpu")[0]
        timings = {}
        t0 = time.perf_counter()
        report = run_cycle(Scheduler(load_profile(PACKING_PROFILE)),
                           cluster, now=1000, device=dev, timings=timings)
        cycle_s = time.perf_counter() - t0
        stats = tuple(view.stats[k] for k in ("rounds", "moves", "emptied"))
        print(f"[packing] profile device={dev.type} card={smi!r} "
              f"solve_s={solve_s} stats={view.stats} placed={len(want)} "
              f"cycle_s={cycle_s} stage_s={timings} "
              f"bound={len(report.bound)} failed={len(report.failed)} "
              f"binds_direct_solve={report.bound == want} "
              f"quality={report.quality}", flush=True)
        if (stats != PACKING_PROFILE_STATS or len(want) != PACKING_PLACED
                or report.bound != want
                or "packed_utilization" not in report.quality):
            raise AssertionError(f"packing profile on {dev}: {stats}, "
                                 f"{len(want)} placed")
        states[dev.type] = cycle_state(report, cluster)
    same = (states[device.type] == states["cpu"]
            and (views[device.type][0] == views["cpu"][0]).all()
            and views[device.type][1] == views["cpu"][1])
    print(f"[packing] profile identical={same}", flush=True)
    if not same:
        raise AssertionError("packing profile: card != CPU")

    packing_modes_small(device)
    no_election_launches("packing", "packing_phase", pk.launches())
    print(f"[packing] phase_s={time.perf_counter() - t_phase}", flush=True)


def _port_namespace():
    """The port's names for `tests/torch_churn_cases.py`'s helpers."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch import plugins
    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.state import Cluster

    return SimpleNamespace(objects=objects, Cluster=Cluster,
                           Profile=Profile, Scheduler=Scheduler,
                           plugins=plugins)


def serving_run(device, serve: bool) -> dict:
    """Bench config 7 at `SERVING_SHAPE` through `run_cycle` on `device`,
    served (`run_cycle(serve=ServeEngine().attach(cluster))`) or with a
    full re-snapshot every cycle: the churn record, each stage's seconds
    summed over the timed cycles and the snapshot stage's seconds a timed
    cycle, the capacity violations, the engine (or None) and the
    cluster."""
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
    from scheduler_plugins_tpu_torch.serving import ServeEngine

    import torch_churn_cases as churn

    pkg = _port_namespace()
    shape = churn.SERVING_SHAPE
    t0 = time.perf_counter()
    cluster = churn.churn_cluster(pkg, shape["n_nodes"], shape["prefill"])
    build_s = time.perf_counter() - t0
    engine = ServeEngine().attach(cluster) if serve else None
    stages, snapshot_s, seen = {}, [], [0]
    # per cycle: (served, rebased) -- whether the engine's refresh gave
    # the cycle's snapshot (else `run_cycle` fell back to
    # `Cluster.snapshot`) and whether that refresh rebased
    served = []
    if engine is not None:
        refresh = engine.refresh

        def counted_refresh(*args, **kwargs):
            rebases = engine.rebases
            out = refresh(*args, **kwargs)
            served.append((out is not None, engine.rebases != rebases))
            return out
        engine.refresh = counted_refresh

    def run(sched, c, now, e):
        timings = {}
        report = run_cycle(sched, c, now=now, serve=e, device=device,
                           timings=timings)
        _sync(device)
        seen[0] += 1
        if seen[0] > shape["warmup"]:
            for k, v in timings.items():
                stages[k] = stages.get(k, 0.0) + v
            snapshot_s.append(timings["snapshot"])
        return report

    out = churn.run_churn(pkg, cluster,
                          Scheduler(load_profile(churn.CHURN_PROFILE)),
                          shape, run, engine=engine)
    if engine is not None:
        engine.refresh = refresh
    out.update(build_s=build_s, stage_s=stages, snapshot_s=snapshot_s,
               engine=engine, served=served,
               cluster=cluster,
               violations=churn.capacity_violations(cluster))
    return out


def serving_served_checks(label: str, run: dict, engine) -> None:
    """Every cycle of a served arm took its snapshot from the engine, none
    from the `Cluster.snapshot` fallback; the engine rebased at its first
    refresh and at each node delete and nowhere else (no anti-entropy
    divergence), so the timed cycles are all served and all but the
    delete cycles steady-state."""
    import torch_churn_cases as churn

    shape = churn.SERVING_SHAPE
    n = shape["warmup"] + shape["cycles"]
    every = shape["node_remove_every"]
    deletes = [c for c in range(n) if every and c % every == every - 1]
    timed = run["served"][shape["warmup"]:]
    n_served = sum(s for s, _ in run["served"])
    timed_steady = sum(s and not r for s, r in timed)
    want_steady = shape["cycles"] - sum(c >= shape["warmup"]
                                        for c in deletes)
    print(f"[serving] {label} served_cycles={n_served}/{n} "
          f"timed_served={sum(s for s, _ in timed)}/{shape['cycles']} "
          f"timed_steady={timed_steady} want_steady={want_steady} "
          f"rebases={engine.rebases} want_rebases={1 + len(deletes)}",
          flush=True)
    if (len(run["served"]) != n or n_served != n
            or timed_steady != want_steady
            or engine.rebases != 1 + len(deletes)
            or engine.antientropy_divergences):
        raise AssertionError(f"{label}: the engine did not serve the "
                             f"cycles as config 7 should")


def serving_refresh_checks(run, device) -> None:
    """On the served card arm's live engine and store: one more cycle's
    churn, then a steady-state `refresh` under sync-debug "error" (no
    host read: the periodic verify, a host read on purpose, is held off
    for it); the host calls that enqueue device work in one refresh and
    in its apply alone (`torch.profiler`); then the anti-entropy verify
    against a fresh host snapshot must find the resident columns exact."""
    import numpy as np

    import torch_churn_cases as churn

    pkg = _port_namespace()
    engine, cluster = run["engine"], run["cluster"]
    rng = np.random.default_rng(99)
    shape = dict(churn.SERVING_SHAPE, node_add_every=0, node_remove_every=0)
    state = {"serial": 10 ** 6, "now": 10 ** 6}

    def churned():
        state["now"] += 1000
        state["serial"] = churn.churn_events(
            pkg, cluster, rng, shape, 1, state["now"], state["serial"])
        return cluster.pending_pods()

    every, engine.verify_every = engine.verify_every, 0
    rebases = engine.rebases
    try:
        pending = churned()
        with sync_errors(device):
            served = engine.refresh(cluster, pending, now_ms=state["now"],
                                    device=device)
        _sync(device)
        if served is None or engine.rebases != rebases:
            raise AssertionError("steady-state refresh did not serve")
        print(f"[serving] sync_debug_refresh ok pending={len(pending)} "
              f"generation={engine.generation}", flush=True)

        def refresh():
            engine.refresh(cluster, churned(), now_ms=state["now"],
                           device=device)

        def apply_only():
            churned()
            upserts, usage, side, rebase = engine._classify(
                engine._sink.drain())
            assert rebase is None
            engine._apply_batch(upserts, usage, side)

        for label, fn in (("refresh", refresh), ("apply", apply_only)):
            n_dev, work, dev_us, _ = profiled_work(fn, device)
            print(f"[serving] {label}_work work_calls={sum(work.values())} "
                  f"by_name={dict(sorted(work.items()))} "
                  f"device_records={n_dev} device_us={dev_us}", flush=True)
    finally:
        engine.verify_every = every
    reason = engine.verify(cluster)
    print(f"[serving] verify={reason} rebases={engine.rebases} "
          f"divergences={engine.antientropy_divergences}", flush=True)
    if reason is not None or engine.rebases != rebases:
        raise AssertionError(f"resident columns diverged: {reason}")


def serving_bench_line(serve: dict, base: dict, cpu: dict) -> dict:
    """`bench.py` `serving_churn`'s line for the card arms, with the CPU
    serve arm's cycles/s beside it."""
    import numpy as np

    n_cycles = len(serve["times"])
    serve_s, base_s, cpu_s = (sum(r["times"]) for r in (serve, base, cpu))
    lat = np.repeat(serve["times"], serve["decided"])
    base_lat = np.repeat(base["times"], base["decided"])
    engine = serve["engine"]
    return {
        "cycles": n_cycles,
        "cycles_per_sec": n_cycles / serve_s,
        "baseline_cycles_per_sec": n_cycles / base_s,
        "cpu_serve_cycles_per_sec": n_cycles / cpu_s,
        "vs_full_resnapshot": base_s / serve_s,
        "decision_latency_p50_ms": float(np.percentile(lat, 50)) * 1000,
        "decision_latency_p99_ms": float(np.percentile(lat, 99)) * 1000,
        "baseline_latency_p50_ms": float(np.percentile(base_lat, 50)) * 1000,
        "baseline_latency_p99_ms": float(np.percentile(base_lat, 99)) * 1000,
        "pods_per_sec": sum(serve["decided"]) / serve_s,
        "placements_match": serve["reports"] == base["reports"],
        "capacity_violations": serve["violations"],
        "rebases": engine.rebases,
        "resident_generation": engine.generation,
        "decisions": sum(serve["decided"]),
    }


def serving_phase(device) -> None:
    """Phase 17: the serving path. Bench config 7 at `SERVING_SHAPE`
    (2,000 nodes, 12,288 bound pods, 4 + 48 cycles of Poisson churn,
    uncut) served on the card, re-snapshotted on the card and served on
    the CPU: every cycle's decisions identical across the three, 0
    capacity violations, the engines' rebases and generation equal; the
    steady-state refresh checks (`serving_refresh_checks`); the bench's
    line; then the flagship profile's thirty served churn cycles, card
    == CPU (`[serving]` lines). No election kernel is launched."""
    import torch

    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.serving import ServeEngine

    _tests_on_path()
    import torch_churn_cases as churn

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    pk.reset_launches()
    runs = {}
    for label, dev, serve in (("serve_card", device, True),
                              ("full_card", device, False),
                              ("serve_cpu", cpu, True)):
        t0 = time.perf_counter()
        r = runs[label] = serving_run(dev, serve)
        e = r["engine"]
        print(f"[serving] {label} run_s={time.perf_counter() - t0} "
              f"build_s={r['build_s']} timed_s={sum(r['times'])} "
              f"decided={sum(r['decided'])} "
              f"placed={len(r['placements'])} "
              f"violations={r['violations']} stage_s={r['stage_s']} "
              f"snapshot_ms_median="
              f"{statistics.median(r['snapshot_s']) * 1000} "
              f"snapshot_ms_max={max(r['snapshot_s']) * 1000} "
              + (f"rebases={e.rebases} generation={e.generation} "
                 f"gang_fallbacks={e.gang_fallbacks} "
                 f"divergences={e.antientropy_divergences} npad={e.npad}"
                 if e is not None else ""), flush=True)
        if r["violations"]:
            raise AssertionError(f"{label}: {r['violations']} violations")
        if e is not None:
            serving_served_checks(label, r, e)
    serve, base, on_cpu = (runs[k] for k in ("serve_card", "full_card",
                                             "serve_cpu"))
    same = (serve["reports"] == base["reports"] == on_cpu["reports"])

    def state(e):
        return (e.rebases, e.generation, e.gang_fallbacks,
                e.antientropy_divergences)

    print(f"[serving] identical={same} engines_equal="
          f"{state(serve['engine']) == state(on_cpu['engine'])}",
          flush=True)
    if not same or state(serve["engine"]) != state(on_cpu["engine"]):
        raise AssertionError("config 7: serve card, full card and serve "
                             "CPU disagree")
    serving_refresh_checks(serve, device)
    print(f"[serving] bench {json.dumps(serving_bench_line(serve, base, on_cpu))}",
          flush=True)

    results = []
    for dev in (device, cpu):
        t0 = time.perf_counter()
        r = churn.flagship_churn(
            _port_namespace(),
            lambda s, c, now, e, dev=dev: run_cycle(s, c, now=now, serve=e,
                                                    device=dev),
            serve=lambda c: ServeEngine().attach(c))
        e = r["engine"]
        results.append((r["reports"], r["placements"], state(e)))
        print(f"[serving] flagship_churn device={dev.type} "
              f"run_s={time.perf_counter() - t0} "
              f"placed={len(r['placements'])} "
              f"violations={r['violations']} plain_left={r['plain_left']} "
              f"rebases={e.rebases} generation={e.generation} "
              f"gang_fallbacks={e.gang_fallbacks}", flush=True)
        if r["violations"] or r["plain_left"]:
            raise AssertionError(f"flagship churn on {dev}: "
                                 f"{r['violations']} {r['plain_left']}")
    print(f"[serving] flagship_churn identical={results[0] == results[1]}",
          flush=True)
    if results[0] != results[1]:
        raise AssertionError("flagship churn: card != CPU")
    no_election_launches("serving", "serving_phase", pk.launches())
    print(f"[serving] phase_s={time.perf_counter() - t_phase}", flush=True)


# ---------------------------------------------------------------------------
# phase 18: resilience
# ---------------------------------------------------------------------------


def _chaos_namespace(device):
    """The port's names for `tests/torch_chaos_cases.py`, its cycles and
    checkpoint restores on `device`."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch import resilience
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.serving import ServeEngine

    return SimpleNamespace(
        **vars(_port_namespace()), Engine=ServeEngine,
        faults=resilience.faults, Resilience=resilience.Resilience,
        SolveWatchdog=resilience.SolveWatchdog,
        run=lambda s, c, now, e, rz: run_cycle(s, c, now=now, serve=e,
                                               resilience=rz, device=device),
        restore=lambda e, ckpt: e.restore_checkpoint(ckpt, device=device),
    )


def chaos_arms(device) -> None:
    """Bench config 9 at `CHAOS_SHAPE`, uncut: the fault-free control arm
    on the card, the chaos arm (the standard plan, seed 0) on the card and
    on the CPU. Every timed cycle's bound map equal across the three, 0
    capacity violations, one crash restored from the checkpoint, the
    failovers, degraded cycles, rebases, divergences and recovery windows
    equal on card and CPU with every window closed within the bench's
    bound, the control never on the host path; each arm's p50 / p99 cycle
    time and abandoned workers (`[resilience]` lines)."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler

    import torch_chaos_cases as chaos
    import torch_churn_cases as churn

    shape = chaos.CHAOS_SHAPE
    cpu = torch.device("cpu")
    arms, plans = {}, {}
    schedulers = {}
    for label, dev, faulted in (("control_card", device, False),
                                ("chaos_card", device, True),
                                ("chaos_cpu", cpu, True)):
        pkg = _chaos_namespace(dev)
        sched = schedulers.setdefault(
            dev.type, Scheduler(load_profile(churn.CHURN_PROFILE)))
        plan = chaos.chaos_fault_plan(pkg, shape) if faulted else None
        t0 = time.perf_counter()
        r = arms[label] = chaos.run_chaos_arm(pkg, sched, shape, plan=plan)
        plans[label] = plan
        times = np.asarray(r["times"])
        print(f"[resilience] config9 {label} run_s={time.perf_counter() - t0} "
              f"cycles={len(times)} cycle_ms_p50="
              f"{float(np.percentile(times, 50)) * 1000} cycle_ms_p99="
              f"{float(np.percentile(times, 99)) * 1000} "
              f"decided={sum(r['decided'])} paths="
              f"{ {p: r['paths'].count(p) for p in sorted(set(r['paths']))} } "
              f"degraded_cycles={r['degraded_cycles']} "
              f"crashes={r['crashes']} rebases={r['rebases']} "
              f"divergences={r['divergences']} "
              f"recoveries={r['recoveries']} abandoned={r['abandoned']} "
              f"violations={churn.capacity_violations(r['cluster'])}",
              flush=True)
        if faulted:
            # each hang leaves workers asleep for hang_seconds: wait them
            # out before anything else runs (sync-debug is process-wide)
            time.sleep(shape["hang_seconds"])
    control = arms["control_card"]
    gates = {label: chaos.chaos_gates(arms[label], control, plans[label])
             for label in ("chaos_card", "chaos_cpu")}
    for label, g in gates.items():
        print(f"[resilience] config9 {label} gates {json.dumps(g)}",
              flush=True)

    def bookkeeping(r):
        return (r["paths"], r["degraded_cycles"], r["crashes"],
                r["rebases"], r["divergences"], r["recoveries"],
                r["abandoned"])

    card, on_cpu = arms["chaos_card"], arms["chaos_cpu"]
    same_bound = control["bound"] == card["bound"] == on_cpu["bound"]
    same_books = bookkeeping(card) == bookkeeping(on_cpu)
    print(f"[resilience] config9 bound_identical={same_bound} "
          f"card_cpu_bookkeeping_identical={same_books} "
          f"control_paths={sorted(set(control['paths']))}", flush=True)
    problems = []
    if not same_bound:
        problems.append("bound maps differ across the arms")
    if not same_books:
        problems.append("chaos card != chaos CPU bookkeeping")
    if set(control["paths"]) != {"device"}:
        problems.append("the control arm left the device path")
    for label in ("chaos_card", "chaos_cpu"):
        g, r = gates[label], arms[label]
        if (g["capacity_violations"] or g["faults_unfired"]
                or g["crashes"] != 1 or "host" not in r["paths"]
                or g["recovery_cycles_max"] > chaos.RECOVERY_BOUND
                or r["resilience"].degraded):
            problems.append(f"{label}: gates {g}")
    if churn.capacity_violations(control["cluster"]):
        problems.append("control: capacity violations")
    if problems:
        raise AssertionError(f"config 9: {problems}")


def host_solve_check(device) -> tuple:
    """`host_sequential_solve` against `Scheduler.solve` on the card: on
    config 7's served snapshot (`SERVING_SHAPE`'s cluster plus one cycle
    of arrivals, through the serving engine) and on
    `allocatable_scenario(1024, 4096)`: assignment, admitted, wait and the
    failure codes bit-identical. Returns config 7's cluster and engine."""
    import numpy as np

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler
    from scheduler_plugins_tpu_torch.models import allocatable_scenario
    from scheduler_plugins_tpu_torch.resilience import (
        host_sequential_solve,
        supports_host_solve,
    )
    from scheduler_plugins_tpu_torch.serving import ServeEngine

    import torch_churn_cases as churn

    pkg = _port_namespace()
    shape = churn.SERVING_SHAPE
    cluster = churn.churn_cluster(pkg, shape["n_nodes"], shape["prefill"])
    engine = ServeEngine().attach(cluster)
    churn.churn_events(pkg, cluster, np.random.default_rng(1), shape, 0,
                       1000, 0)
    sched = Scheduler(load_profile(churn.CHURN_PROFILE))
    problems = {"config7_served": (cluster, engine),
                "alloc_1024x4096": (allocatable_scenario(1024, 4096), None)}
    for label, (c, e) in problems.items():
        pending = sched.sort_pending(c.pending_pods(), c)
        if e is not None:
            snap, meta = e.refresh(c, pending, now_ms=1000, device=device)
        else:
            snap, meta = c.snapshot(pending, now_ms=0, device=device)
        sched.prepare(meta, c)
        assert supports_host_solve(sched, snap)
        _sync(device)
        t0 = time.perf_counter()
        res = sched.solve(snap, device=device)
        card = [x.cpu().numpy() for x in (res.assignment, res.admitted,
                                          res.wait, res.failed_plugin)]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = host_sequential_solve(sched, snap)
        host_s = time.perf_counter() - t0
        same = all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(card, host))
        print(f"[resilience] host_solve {label} nodes={len(meta.node_names)} "
              f"pods={len(pending)} placed={int((host[0] >= 0).sum())} "
              f"failed={len(pending) - int((host[0] >= 0).sum())} "
              f"card_s={card_s} "
              f"host_s={host_s} identical={same}", flush=True)
        if not same:
            raise AssertionError(f"host solve != card solve on {label}")
    return cluster, engine


def checkpoint_check(cluster, engine, device) -> None:
    """On config 7's served engine on the card: an exact checkpoint
    restored into a fresh engine serves the next refresh with no
    divergence and no rebase (generation continuity); a checkpoint made
    stale by a pod delete rebases at the first refresh and is clean at the
    second."""
    from scheduler_plugins_tpu_torch.serving import ServeEngine

    engine.refresh(cluster, [], now_ms=2000, device=device)  # settle
    ckpt = engine.checkpoint_bytes()
    gen = engine.generation
    engine.detach()
    exact = ServeEngine().attach(cluster)
    exact.verify_every = 1
    exact.restore_checkpoint(ckpt, device=device)
    served = exact.refresh(cluster, [], now_ms=3000, device=device)
    exact_ok = (served is not None and exact.rebases == 0
                and exact.antientropy_divergences == 0
                and exact.generation > gen)
    stale_ckpt = exact.checkpoint_bytes()
    exact.detach()
    victim = next(uid for uid, p in cluster.pods.items()
                  if p.node_name is not None)
    cluster.remove_pod(victim)
    stale = ServeEngine().attach(cluster)
    stale.verify_every = 1
    stale.restore_checkpoint(stale_ckpt, device=device)
    first = stale.refresh(cluster, [], now_ms=4000, device=device)
    books = (stale.antientropy_divergences, stale.rebases)
    second = stale.refresh(cluster, [], now_ms=5000, device=device)
    stale_ok = (first is not None and second is not None and books == (1, 1)
                and (stale.antientropy_divergences, stale.rebases) == (1, 1))
    print(f"[resilience] checkpoint bytes={len(ckpt)} exact_resumed="
          f"{exact_ok} stale_divergences_rebases={books} "
          f"stale_recovered={stale_ok}", flush=True)
    if not (exact_ok and stale_ok):
        raise AssertionError("checkpoint restore misbehaved")


def fetch_deadline_check(device) -> None:
    """The north-star snapshot through `run_chunk_pipeline` with
    `fetch_deadline_s=30` and without: equal results, both elapsed times;
    then `cycle_script` through `run_cycle(stream_chunk=4, resilience=)`
    on the card equal to `run_cycle(stream_chunk=4)`, every solved cycle
    on the device path."""
    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.models import allocatable_scenario
    from scheduler_plugins_tpu_torch.ops.allocatable import (
        MODE_LEAST,
        allocatable_scores,
        demote_scores_int32,
    )
    from scheduler_plugins_tpu_torch.ops.assign import (
        waterfill_assign_targeted,
    )
    from scheduler_plugins_tpu_torch.ops.fit import free_capacity
    from scheduler_plugins_tpu_torch.parallel.pipeline import (
        run_chunk_pipeline,
    )
    from scheduler_plugins_tpu_torch.resilience import Resilience, SolveWatchdog
    from scheduler_plugins_tpu_torch.state import Cluster

    from torch_cycle_scripts import SCRIPT_COSCHED, cycle_script

    chunk, rescue = NORTH_STAR["chunk"], NORTH_STAR["rescue_window"]
    cluster = allocatable_scenario(NORTH_STAR["n_nodes"], NORTH_STAR["n_pods"])
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    padded = -(-len(pending) // chunk) * chunk
    snap, meta = cluster.snapshot(pending, now_ms=0, device=device,
                                  pad_pods=padded)
    weights = meta.index.encode({"cpu": 1 << 20, "memory": 1})
    raw = demote_scores_int32(allocatable_scores(
        snap.nodes.alloc, torch.as_tensor(weights, device=device), MODE_LEAST
    )).to(torch.int64)

    def solve_chunk(raw, node_mask, req_chunk, mask_chunk, free0):
        a, free, _ = waterfill_assign_targeted(
            raw, req_chunk, mask_chunk,
            torch.where(node_mask[:, None], free0, 0), max_waves=8,
            rescue_window=rescue)
        return a, free

    req_np = snap.pods.req.cpu().numpy()
    mask_np = snap.pods.mask.cpu().numpy()
    inputs = [(req_np[lo:lo + chunk], mask_np[lo:lo + chunk])
              for lo in range(0, padded, chunk)]
    outs, elapsed = {}, {}
    for label, deadline in (("warm", None), ("plain", None),
                            ("deadline", 30.0)):
        free = free_capacity(snap.nodes.alloc, snap.nodes.requested)
        _sync(device)
        t0 = time.perf_counter()
        results, _, _, _ = run_chunk_pipeline(
            solve_chunk, (raw, snap.nodes.mask), inputs, free,
            fetch_deadline_s=deadline, device=device)
        elapsed[label] = time.perf_counter() - t0
        outs[label] = np.concatenate(results)
    same = np.array_equal(outs["plain"], outs["deadline"])
    print(f"[resilience] fetch_deadline north_star chunks={len(inputs)} "
          f"plain_s={elapsed['plain']} deadline_s={elapsed['deadline']} "
          f"identical={same} placed={int((outs['plain'] >= 0).sum())}",
          flush=True)
    if not same:
        raise AssertionError("run_chunk_pipeline with a deadline differs")
    del cluster, snap

    states, paths = [], []
    for rz in (None, Resilience(watchdog=SolveWatchdog(timeout_s=30.0))):
        c, steps = cycle_script(objects, Cluster)
        sched = flagship_scheduler(**SCRIPT_COSCHED)
        arm = []
        for now, mutate in steps:
            if mutate is not None:
                mutate(objects, c)
            report = run_cycle(sched, c, now, 4, resilience=rz,
                               device=device)
            if rz is not None and report.solve_path is not None:
                paths.append(report.solve_path)
            report.solve_path = None
            arm.append(cycle_state(report, c))
        states.append(arm)
    same = states[0] == states[1]
    print(f"[resilience] streamed_script_under_watchdog cycles="
          f"{len(states[0])} identical={same} paths="
          f"{ {p: paths.count(p) for p in set(paths)} }", flush=True)
    if not same or set(paths) != {"device"}:
        raise AssertionError("the streamed script under the watchdog "
                             "differs or left the device path")


def resilience_phase(device) -> None:
    """Phase 18: the resilience layer. Bench config 9 at its full shape
    (`chaos_arms`), the host solve against the card (`host_solve_check`),
    the fetch deadline (`fetch_deadline_check`) and the checkpoint
    (`checkpoint_check`), `[resilience]` lines. No election kernel."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    _tests_on_path()
    t_phase = time.perf_counter()
    pk.reset_launches()
    chaos_arms(device)
    cluster, engine = host_solve_check(device)
    checkpoint_check(cluster, engine, device)
    del cluster, engine
    fetch_deadline_check(device)
    no_election_launches("resilience", "resilience_phase", pk.launches())
    print(f"[resilience] phase_s={time.perf_counter() - t_phase}", flush=True)


# ---------------------------------------------------------------------------
# phase 19: rank-aware gangs
# ---------------------------------------------------------------------------


def _gang_namespace(device):
    """The port's names for `tests/torch_gang_cases.py`, its cycles on
    `device`."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch import gangs
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.gangs import phase, topology
    from scheduler_plugins_tpu_torch.models import rank_gang_scenario
    from scheduler_plugins_tpu_torch.tuning import quality

    return SimpleNamespace(
        **vars(_port_namespace()), rank_gang_scenario=rank_gang_scenario,
        run=lambda s, c, now, ph: run_cycle(s, c, now=now, gangs=ph,
                                            device=device),
        GangPhase=gangs.GangPhase, elastic_bounds=gangs.elastic_bounds,
        block_cost_view=phase.block_cost_view,
        gang_cost_stats=topology.gang_cost_stats,
        rank_gang_quality=quality.rank_gang_quality,
        elastic_satisfaction_quality=quality.elastic_satisfaction_quality,
        RankGangState=topology.RankGangState,
    )


def config10_gangs(device) -> None:
    """Bench config 10 at `RANK_GANG_SHAPE`, uncut, through
    `run_cycle(gangs=GangPhase(check_twin=True))` until the queue drains,
    then the elastic grow and shrink transitions and the quorum-only
    Coscheduling baseline arm, on the card and on the CPU: reports,
    stores and `rank_gangs` stats identical, `max_drift` 0.0, 0 fit /
    quota / quorum violations, the bench line; then `GangPhase(wave=True)`
    on the card placing identically (`[gangs]` lines)."""
    import torch

    import torch_gang_cases as gcases

    shape = gcases.RANK_GANG_SHAPE
    records = {}
    for label, dev, wave in (("card", device, False),
                             ("cpu", torch.device("cpu"), False),
                             ("card_wave", device, True)):
        pkg = _gang_namespace(dev)
        phase = pkg.GangPhase(check_twin=True, wave=wave)
        t0 = time.perf_counter()
        out = gcases.rank_gangs(pkg, shape, phase)
        run_s = time.perf_counter() - t0
        records[label] = {
            "rank_reports": out["rank"]["reports"],
            "transitions": out["transitions"],
            "base_reports": out["base"]["reports"],
            "rank_store": gcases.store_state(out["rank"]["cluster"]),
            "base_store": gcases.store_state(out["base"]["cluster"]),
            "line": out["line"],
        }
        line = out["line"]
        print(f"[gangs] config10 {label} run_s={run_s} "
              f"rank_arm_s={out['rank']['elapsed']} "
              f"rank_cycles={out['rank']['cycles']} "
              f"transition_s={out['transition_s']} "
              f"baseline_s={out['base']['elapsed']} line={json.dumps(line)}",
              flush=True)
        if (line["twin_drift"] != 0.0
                or any(line["violations"].values())
                or line["gangs_admitted"] != line["gangs"]
                or line["elastic_grow_convergence_cycles"] > 2
                or line["elastic_shrink_convergence_cycles"] > 2):
            raise AssertionError(f"config 10 on {label}: {line}")
    same = records["card"] == records["cpu"]
    wave_same = (records["card_wave"]["rank_store"]
                 == records["card"]["rank_store"]
                 and records["card_wave"]["transitions"]
                 == records["card"]["transitions"])
    print(f"[gangs] config10 card_cpu_identical={same} "
          f"wave_places_identically={wave_same}", flush=True)
    if not (same and wave_same):
        raise AssertionError("config 10: card != CPU or wave != sequential")


def _gang_rows(gangs, k):
    """The first `k` gangs of a `RankGangState` (the node-side tables
    whole)."""
    from dataclasses import replace

    return replace(gangs, **{name: getattr(gangs, name)[:k] for name in (
        "rank_req", "rank_mask", "prev_assigned", "min_ranks", "gang_ns",
        "gang_mask")})


def config12_gangs(device) -> None:
    """Bench config 12 at `MEGA_GANG_SHAPE`, uncut: `gang_solve` (the
    sequential solve, on the card under sync-debug "error") and
    `wave_gang_solve` (waves of 64) on the card and on the CPU, and
    `gang_solve_np`, all bit-identical; 0 violations of the independent
    replay; waves, accepted runs and host solves; each solver's seconds
    and newly placed ranks/s; the host calls that enqueue device work a
    gang step (`torch.profiler`); the wave solve's host syncs a wave
    under sync-debug "warn" (`[gangs]` lines)."""
    import warnings

    import numpy as np
    import torch

    from scheduler_plugins_tpu_torch.gangs import topology as T
    from scheduler_plugins_tpu_torch.gangs import waves as GW

    import torch_gang_cases as gcases

    shape = gcases.MEGA_GANG_SHAPE
    t0 = time.perf_counter()
    problem = gcases.mega_gang_problem(shape, T.RankGangState)
    build_s = time.perf_counter() - t0
    gangs = problem["gangs"]
    args = (problem["free0"], problem["eq_used0"], problem["node_mask"])
    cpu = torch.device("cpu")
    outs, secs, stats = {}, {}, {}

    def sequential(dev, gangs_np=gangs):
        g_dev = gangs_np.to(dev)
        state0 = T.initial_state(gangs_np, *args[:2], device=dev)
        mask = T._tensor(args[2], torch.bool, dev)
        _sync(dev)
        return lambda: T.gang_solve(g_dev, state0, mask, device=dev)

    # the sequential solve on the card: first under sync-debug "error" (a
    # host read inside a step raises), then timed
    run = sequential(device)
    with sync_errors(device):
        run()
    _sync(device)
    print("[gangs] config12 sequential_sync_debug_error ok", flush=True)
    for dev in (device, cpu):
        run = sequential(dev)
        t0 = time.perf_counter()
        rn, adm, new, state = run()
        out = tuple(x.cpu().numpy() for x in (rn, adm, new, state.free,
                                              state.eq_used))
        secs[f"sequential_{dev.type}"] = time.perf_counter() - t0
        outs[f"sequential_{dev.type}"] = out
    for dev in (device, cpu):
        GW.wave_gang_solve(gangs, *args, wave=shape["wave"], device=dev)
        st: dict = {}
        t0 = time.perf_counter()
        outs[f"wave_{dev.type}"] = GW.wave_gang_solve(
            gangs, *args, wave=shape["wave"], stats=st, device=dev)
        secs[f"wave_{dev.type}"] = time.perf_counter() - t0
        stats[dev.type] = st
    t0 = time.perf_counter()
    outs["twin"] = T.gang_solve_np(gangs, *args)
    secs["twin"] = time.perf_counter() - t0
    ref = outs["twin"]
    differ = [label for label, out in outs.items()
              if not all(np.array_equal(a, b) for a, b in zip(out, ref))]
    placed = int(ref[2].sum())
    viol = gcases.mega_gang_violations(problem, *ref[:3])
    st = stats[device.type]
    print(f"[gangs] config12 nodes={shape['n_nodes']} "
          f"gangs={shape['n_gangs']} build_s={build_s} "
          f"admitted={int(ref[1].sum())} placed_ranks={placed} "
          f"violations={viol} waves={st['waves']} "
          f"accepted={st['accepted']} host_solves={st['host_solves']} "
          f"stats_card_cpu_identical={stats[device.type] == stats['cpu']} "
          f"seconds={json.dumps(secs)} ranks_per_s="
          f"{json.dumps({k: placed / v for k, v in secs.items()})} "
          f"identical={not differ} differ={differ}", flush=True)
    if differ or any(viol.values()) or stats[device.type] != stats["cpu"]:
        raise AssertionError(f"config 12: {differ} {viol}")

    # the work a gang step enqueues: two solves of 64 and 128 gangs differ
    # by 64 gangs' steps
    counts = {}
    for k in (64, 128):
        run = sequential(device, _gang_rows(gangs, k))
        counts[k] = profiled_work(run, device)[:3]
    (e1, w1, us1), (e2, w2, us2) = counts[64], counts[128]
    work = {n: (w2[n] - w1[n]) / 64 for n in sorted(w1 | w2)}
    print(f"[gangs] config12 work_calls_per_gang={sum(work.values())} "
          f"by_name={work} device_records_per_gang={(e2 - e1) / 64} "
          f"device_us_per_gang={(us2 - us1) / 64}", flush=True)

    # the wave solve's host syncs, a wave
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st = {}
            GW.wave_gang_solve(gangs, *args, wave=shape["wave"], stats=st,
                               device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in seen)
    print(f"[gangs] config12 wave_host_syncs={syncs} waves={st['waves']} "
          f"syncs_per_wave={syncs / st['waves']}", flush=True)
    if syncs != st["waves"]:
        raise AssertionError(f"wave solve: {syncs} host syncs in "
                             f"{st['waves']} waves (one a wave expected)")


def gangs_phase(device) -> None:
    """Phase 19: the rank-aware gangs, bench configs 10 and 12 at their
    full shapes (`config10_gangs`, `config12_gangs`), `[gangs]` lines. No
    election kernel."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    _tests_on_path()
    t_phase = time.perf_counter()
    pk.reset_launches()
    config10_gangs(device)
    config12_gangs(device)
    no_election_launches("gangs", "gangs_phase", pk.launches())
    print(f"[gangs] phase_s={time.perf_counter() - t_phase}", flush=True)


# ---------------------------------------------------------------------------
# phase 20: the pipelined cycle engine
# ---------------------------------------------------------------------------


def _life_namespace(device):
    """The port's names for `tests/torch_life_cases.py`, its cycles on
    `device`."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch.framework import PipelinedCycle
    from scheduler_plugins_tpu_torch.obs import ledger
    from scheduler_plugins_tpu_torch.serving import StreamingServeEngine

    return SimpleNamespace(
        **vars(_chaos_namespace(device)),
        StreamingEngine=StreamingServeEngine, ledger=ledger,
        Pipelined=lambda s, c, e: PipelinedCycle(s, c, serve=e,
                                                 device=device),
    )


def life_arm_lines(label: str, arm: dict) -> None:
    """The `[life]` lines of one finished arm: each phase's cycles/s,
    decision p50 / p99, rebases, compactions and late binds, then the
    arm's totals."""
    import torch_life_cases as life

    for phase in life.CLUSTER_LIFE_PHASES:
        p50, p99 = life.decision_latency_ms(arm, phase)
        rebases, compactions = arm["phase_counters"][phase]
        print(f"[life] {label} phase={phase} "
              f"cycles={len(arm['times'][phase])} "
              f"cycles_per_s={life.cycles_per_sec(arm, phase)} "
              f"decided={sum(arm['decided'][phase])} "
              f"decision_p50_ms={p50} decision_p99_ms={p99} "
              f"rebases={rebases} compactions={compactions} "
              f"late_binds={arm.get('phase_late_binds', {}).get(phase)}",
              flush=True)
    p50, p99 = life.decision_latency_ms(arm)
    print(f"[life] {label} all cycles_per_s={life.cycles_per_sec(arm)} "
          f"decision_p50_ms={p50} decision_p99_ms={p99} "
          f"build_s={arm['build_s']} rebases={arm['rebases']} "
          f"compactions={arm['compactions']} "
          f"divergences={arm['antientropy_divergences']} "
          f"faults_fired={arm['faults_fired']} "
          f"gang_fallbacks={arm['gang_fallbacks']} "
          f"violations={arm['violations']} "
          f"ledger_events={len(arm['ledger_sequence'])} "
          f"decomposition_errors={arm['ledger_decomposition_errors']} "
          f"overlap_efficiency_mean={arm.get('overlap_efficiency_mean')} "
          f"pipeline_bubble_ms_mean={arm.get('pipeline_bubble_ms_mean')} "
          f"late_binds={arm.get('late_binds')}", flush=True)


def life_stream_script(device) -> None:
    """`cycle_script` (1024 nodes, the flagship profile) through
    `PipelinedCycle(stream_chunk=4)` and through `run_cycle(stream_chunk=
    4)`, both on the card: every report and the store equal after every
    cycle (the pipelined arm fenced and its last cycle flushed before the
    reports are read)."""
    from scheduler_plugins_tpu_torch.api import objects
    from scheduler_plugins_tpu_torch.framework import (
        PipelinedCycle,
        run_cycle,
    )
    from scheduler_plugins_tpu_torch.state import Cluster
    from torch_cycle_scripts import SCRIPT_COSCHED, cycle_script

    pc, steps = cycle_script(objects, Cluster)
    sc, ssteps = cycle_script(objects, Cluster)
    pipe = PipelinedCycle(flagship_scheduler(**SCRIPT_COSCHED), pc,
                          stream_chunk=4, device=device)
    sched = flagship_scheduler(**SCRIPT_COSCHED)
    got, want = [], []
    t_pipe = t_serial = 0.0
    for (now, mutate), (_, smutate) in zip(steps, ssteps):
        if mutate is not None:
            mutate(objects, pc)
            smutate(objects, sc)
        t0 = time.perf_counter()
        got.append(pipe.tick(now))
        pipe.fence()
        t1 = time.perf_counter()
        want.append(run_cycle(sched, sc, now, 4, device=device))
        t_serial += time.perf_counter() - t1
        t_pipe += t1 - t0
        if cycle_state(got[-1], pc)[1:] != cycle_state(want[-1], sc)[1:]:
            raise AssertionError(f"streamed script, cycle {len(got) - 1}: "
                                 "pipelined store != run_cycle's")
    pipe.close()
    same = [cycle_state(g, pc)[0] == cycle_state(w, sc)[0]
            for g, w in zip(got, want)]
    print(f"[life] stream_script cycles={len(steps)} identical={all(same)} "
          f"pipelined_s={t_pipe} serial_s={t_serial} "
          f"failed_by={sum(len(r.failed_by) for r in got)} "
          f"preempted={sum(len(r.preempted) for r in got)}", flush=True)
    if not all(same):
        raise AssertionError(f"streamed script: pipelined != run_cycle "
                             f"at cycles {[k for k, s in enumerate(same) if not s]}")


def life_phase(device) -> None:
    """Phase 20: bench config 11 at `CLUSTER_LIFE_SHAPE`, uncut, through
    the pipelined arm on the card, the serial arm on the card and the
    pipelined arm on the CPU, stepped interleaved; the hard checks
    (`torch_life_cases.life_gates` between the card's pipelined arm and
    each of the others, and the engines' counters card == CPU); the
    `[life]` lines; then the streamed script through the pipelined
    engine. No election kernel is launched."""
    import gc

    import torch

    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    _tests_on_path()
    import torch_life_cases as life

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    shape = life.CLUSTER_LIFE_SHAPE
    pk.reset_launches()
    arms = {
        "pipelined_card": life.LifeArm(_life_namespace(device), shape, True),
        "serial_card": life.LifeArm(_life_namespace(device), shape, False),
        "pipelined_cpu": life.LifeArm(_life_namespace(cpu), shape, True),
    }
    print(f"[life] arms built_s={time.perf_counter() - t_phase} "
          f"cycles={len(arms['serial_card'].schedule)}", flush=True)
    # the arms' prefill populations leave the collector's scan set, so a
    # full collection does not land on one arm's timed cycle
    gc.collect()
    gc.freeze()
    try:
        while not arms["serial_card"].done:
            for arm in arms.values():
                arm.step()
        out = {label: arm.finish() for label, arm in arms.items()}
    finally:
        gc.unfreeze()
    for label, arm in out.items():
        life_arm_lines(label, arm)
    pipe = out["pipelined_card"]
    shares = pipe["sli"].get("stage_ms", {})
    total = sum(shares.values())
    print(f"[life] sli pods_bound={pipe['sli']['pods_bound']} "
          f"e2e_ms={pipe['sli'].get('e2e_ms')} "
          f"stage_shares={ {k: v / total for k, v in shares.items()} if total else {} }",
          flush=True)
    print(f"[life] vs_serial cycles_per_s_ratio="
          f"{life.cycles_per_sec(pipe) / life.cycles_per_sec(out['serial_card'])} "
          f"churn_ratio={life.cycles_per_sec(pipe, 'churn') / life.cycles_per_sec(out['serial_card'], 'churn')} "
          f"cpu_vs_card={life.cycles_per_sec(out['pipelined_cpu']) / life.cycles_per_sec(pipe)}",
          flush=True)
    bad = life.life_gates(pipe, out["serial_card"])
    bad += [f"card vs CPU: {b}"
            for b in life.life_gates(pipe, out["pipelined_cpu"])]
    for key in ("rebases", "compactions", "phase_counters",
                "antientropy_divergences", "faults_fired", "gang_fallbacks"):
        if pipe[key] != out["pipelined_cpu"][key]:
            bad.append(f"card vs CPU: {key}")
    if pipe["faults_fired"] != len(life.life_fault_plan(
            _life_namespace(cpu), shape).specs):
        bad.append(f"faults fired {pipe['faults_fired']}")
    print(f"[life] gates failed={bad}", flush=True)
    if bad:
        raise AssertionError(f"config 11: {bad}")
    life_stream_script(device)
    no_election_launches("life", "life_phase", pk.launches())
    print(f"[life] phase_s={time.perf_counter() - t_phase}", flush=True)


def _lane_namespace(device):
    """The port's names for `tests/torch_lane_cases.py`: snapshots, solves
    and lane solvers on the device each arm names; `LanedCycle` on
    `device`, and `run_cycle`, the reference it is held to, on the CPU."""
    from types import SimpleNamespace

    import torch

    from scheduler_plugins_tpu_torch.framework import LanedCycle, run_cycle
    from scheduler_plugins_tpu_torch.parallel.lanes import LaneSolver
    from scheduler_plugins_tpu_torch.serving import (
        ServeEngine,
        StreamingServeEngine,
    )

    def serial(sched, snap, dev):
        r = sched.solve(snap, device=dev)
        return tuple(x.cpu().numpy() for x in (r.assignment, r.admitted,
                                               r.wait))

    return SimpleNamespace(
        **vars(_port_namespace()),
        snapshot=lambda c, pending, now, dev: c.snapshot(
            pending, now_ms=now, device=dev),
        serial=serial,
        LaneSolver=lambda s, k, part, disp, dev: LaneSolver(
            s, k=k, partition=part, dispatch=disp, device=dev),
        Engine=ServeEngine, StreamingEngine=StreamingServeEngine,
        Laned=lambda s, c, e: LanedCycle(s, c, k=4, dispatch="fused",
                                         serve=e, async_bind=True,
                                         device=device),
        run=lambda s, c, now, e: run_cycle(s, c, now=now, serve=e,
                                           device=torch.device("cpu")),
    )


def lane_work_per_step(device, sched, snap) -> dict:
    """What a fused lane step puts on the card at K = 1 and K = 4, from
    `torch.profiler`: the lane program on `snap` (config 15's timed cycle,
    its full width) at L = LANE_PROFILE_STEPS and twice that, the
    difference divided by the steps (as `launches_per_step` does for the
    parity step); the two must be equal. Then one K = 4 program under
    sync-debug "error": a lane step reads nothing on the host."""
    import numpy as np

    from scheduler_plugins_tpu_torch.device import to_device
    from scheduler_plugins_tpu_torch.parallel.lanes import lane_solve

    t0 = time.perf_counter()
    plugins = tuple(sched.profile.plugins)
    state0 = sched.initial_state(snap)
    auxes = tuple(p.aux() for p in plugins)

    def inputs(k, steps):
        idx = np.arange(k * steps).reshape(k, steps)
        return (to_device(idx, device),
                to_device(np.ones(idx.shape, bool), device))

    out = {}
    for k in (1, 4):
        counts = {}
        for steps in (LANE_PROFILE_STEPS, 2 * LANE_PROFILE_STEPS):
            idx, live = inputs(k, steps)
            counts[steps] = profiled_work(
                lambda: lane_solve(plugins, snap, state0, auxes, idx, live),
                device)[:3]
        (e1, w1, us1), (e2, w2, us2) = (
            counts[LANE_PROFILE_STEPS], counts[2 * LANE_PROFILE_STEPS])
        work = {name: (w2[name] - w1[name]) / LANE_PROFILE_STEPS
                for name in sorted(w1 | w2)}
        out[k] = {"work": sum(work.values()),
                  "events": (e2 - e1) / LANE_PROFILE_STEPS,
                  "device_us": (us2 - us1) / LANE_PROFILE_STEPS}
        print(f"[lanes] k={k} work_calls_per_step={out[k]['work']} {work} "
              f"device_events_per_step={out[k]['events']} "
              f"device_us_per_step={out[k]['device_us']} (work calls "
              f"{sum(w1.values())} / {sum(w2.values())} for "
              f"{LANE_PROFILE_STEPS} / {2 * LANE_PROFILE_STEPS} steps)",
              flush=True)
    idx, live = inputs(4, LANE_PROFILE_STEPS)
    _sync(device)
    t1 = time.perf_counter()
    with sync_errors(device):
        lane_solve(plugins, snap, state0, auxes, idx, live)
    _sync(device)
    print(f"[lanes] sync_debug_error k=4 steps={LANE_PROFILE_STEPS} "
          f"s={time.perf_counter() - t1} host_reads=0 "
          f"profile_s={time.perf_counter() - t0}", flush=True)
    if out[4]["work"] != out[1]["work"]:
        raise AssertionError(f"a K = 4 lane step enqueues {out[4]['work']} "
                             f"work calls, a K = 1 step {out[1]['work']}")
    return out


def lane_threads_overlap(device, ns, lc, sched, pending, cluster,
                         now) -> None:
    """What `dispatch="threads"` overlaps on the card, where its K worker
    threads share one stream: K = 4 "sequential" and "threads" on the
    first LANE_THREADS_PODS pods of config 15's timed cycle (full width,
    depth cut: at the whole cycle the threaded arm alone takes about 47
    s), each digest equal to the card's serial solve of the same pods.
    Prints each arm's lanes' summed wall over its wall (1.0 = one after
    another, K = all at once) and the sequential wall over the threaded
    one (the gain)."""
    sub = pending[:LANE_THREADS_PODS]
    snap, meta = ns.snapshot(cluster, sub, now, device)
    sched.prepare(meta, cluster)
    want = lc.digest(*ns.serial(sched, snap, device), len(sub))
    walls = {}
    for dispatch in ("sequential", "threads"):
        solver = ns.LaneSolver(sched, 4, "namespace", dispatch, device)
        t0 = time.perf_counter()
        a, ok, w, _, st = solver.solve(snap, sub, cluster, meta=meta)
        walls[dispatch] = wall_ms = (time.perf_counter() - t0) * 1000.0
        solver.close()
        got = lc.digest(a, ok, w, len(sub))
        print(f"[lanes] overlap dispatch={dispatch} pods={len(sub)} "
              f"path={st.path} sizes={st.sizes} lane_ms={st.lane_ms} "
              f"lane_ms_sum={sum(st.lane_ms)} wall_ms={wall_ms} "
              f"concurrency={sum(st.lane_ms) / wall_ms} "
              f"digest_equal={got == want}", flush=True)
        if got != want or st.path != "laned":
            raise AssertionError(f"K = 4 {dispatch} on {len(sub)} pods: "
                                 f"digest {got} != serial {want}, path "
                                 f"{st.path}")
    print(f"[lanes] overlap sequential_over_threads="
          f"{walls['sequential'] / walls['threads']}", flush=True)


def lanes_phase(device) -> None:
    """Phase 21: bench config 15 at `LANE_SHAPE`'s full width, its depth
    cut to one warm-up, one timed and one contended cycle
    (`torch_lane_cases.LANE_CARD_SHAPE`): every cycle the serial
    `Scheduler.solve` on the CPU (the reference) and `LaneSolver` K = 4
    and K = 8 fused on the card; on the timed and contended cycles the
    serial solve on the card; on the timed cycle K = 4 sequential on the
    card and K = 4 fused on the CPU, and K = 4 threads against
    sequential on a cut of it (`lane_threads_overlap`). Gates: every
    arm's digest equal to the CPU's serial solve on every cycle it runs,
    0 capacity violations, 0 serial fallbacks, conflicts and re-resolves
    on the contended cycle. Then the same stream through
    `LanedCycle(k=4, "fused", StreamingServeEngine, async_bind)` on the
    card and `run_cycle(ServeEngine)` on the CPU, every cycle's bound,
    reserved, failed and failed_by and the final store equal; the lane
    program's work calls a step at K = 1 and K = 4. No election kernel
    is launched."""
    import torch

    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    _tests_on_path()
    import torch_lane_cases as lc

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    shape = lc.LANE_CARD_SHAPE
    pk.reset_launches()
    ns = _lane_namespace(device)
    arms = [("serial_cpu", 0, None, cpu, None),
            ("serial", 0, None, device, ("timed", "contended")),
            ("fused4", 4, "fused", device, None),
            ("fused8", 8, "fused", device, None),
            ("seq4", 4, "sequential", device, ("timed",)),
            ("fused4_cpu", 4, "fused", cpu, ("timed",))]

    def probe(scheds, views, pending, cluster, now):
        lane_work_per_step(device, scheds[device], views[device][0])
        lane_threads_overlap(device, ns, lc, scheds[device], pending,
                             cluster, now)

    line = lc.lane_scaling(ns, shape, arms, probe=probe)
    keys = ("lane_ratio", "lane_ratio_full", "lane_ratio_wall",
            "digests_match", "conflicts", "re_resolved", "serial_fallbacks",
            "capacity_violations")
    print("[lanes] " + " ".join(f"{k}={line[k]}" for k in keys)
          + f" curve={json.dumps(line['lanes']['curve'])}", flush=True)
    for name, arm in line["arms"].items():
        for rec in arm["cycles"]:
            print(f"[lanes] arm={name} cycle={rec['cycle']} "
                  f"solve_s={rec['wall_s']} path={rec.get('path')} "
                  f"sizes={rec.get('sizes')} fence_ms={rec.get('fence_ms')} "
                  f"partition_ms={rec.get('partition_ms')} "
                  f"lane_ms={rec.get('lane_ms')} "
                  f"conflicts={rec.get('conflicts')} "
                  f"re_resolved={rec.get('re_resolved')}", flush=True)
    print(f"[lanes] scaling_s={time.perf_counter() - t_phase}", flush=True)
    bad = [k for k in ("digests_match",) if not line[k]]
    bad += [k for k in ("capacity_violations", "serial_fallbacks")
            if line[k]]
    bad += [k for k in ("conflicts", "re_resolved") if not line[k] > 0]

    t0 = time.perf_counter()
    got, got_final, got_walls = lc.lane_engine_run(ns, shape, True)
    want, want_final, want_walls = lc.lane_engine_run(ns, shape, False)
    same = [g[:4] == w[:4] for g, w in zip(got, want)]
    print(f"[lanes] engine cycles={len(got)} identical={same} "
          f"final_store_equal={got_final == want_final} "
          f"laned_cycle_s={got_walls} run_cycle_s={want_walls} "
          f"bound={[len(g[0]) for g in got]} "
          f"conflicts={[sum(g[4]['conflicts']) for g in got]} "
          f"engine_s={time.perf_counter() - t0}", flush=True)
    if not all(same):
        bad.append(f"engine cycles {[k for k, s in enumerate(same) if not s]}")
    if got_final != want_final:
        bad.append("engine final store")
    print(f"[lanes] gates failed={bad}", flush=True)
    if bad:
        raise AssertionError(f"config 15: {bad}")
    no_election_launches("lanes", "lanes_phase", pk.launches())
    print(f"[lanes] phase_s={time.perf_counter() - t_phase}", flush=True)


# ---------------------------------------------------------------------------
# phase 22: the flight recorder and the debug modes
# ---------------------------------------------------------------------------

#: the recorder's ring in phase 22: every recorded cycle of (a) fits
RECORD_CAPACITY = 16
#: phase 22 (a)'s cuts, each small enough that every record replays
#: through the sequential parity solve on the card and on the CPU: the
#: flagship cycle sequential and streamed, config 7 at SERVING_SHAPE's
#: width for four served cycles, the packing profile of config 13 on a
#: 16-node cut of its scenario, config 10 uncut, and three ticks of
#: `PipelinedCycle` and of `LanedCycle` (K = 4) on a 256-node churn cut
RECORD_SEQ = dict(n_nodes=256, n_pods=128)
RECORD_STREAM = dict(n_nodes=1024, n_pods=1024, stream_chunk=256)
RECORD_SERVED_CYCLES = 4
RECORD_PACKING = dict(n_nodes=16, demand_frac=0.92, empty_frac=0.05)
RECORD_ENGINE = dict(n_nodes=256, prefill=2048, ticks=3, lanes=4,
                     lam_arrive=32, lam_depart=16, node_add_every=0,
                     node_remove_every=0)
#: interleaved recorder-off / recorder-on pairs of a config-7 served cycle
RECORD_PAIRS = 9
#: phase 22 (c)'s cuts: the flagship streamed cycle, config 4's batched
#: solve, and the north star cut to 2,048 nodes and 8,192 pods in S = 8
#: rank blocks
SANITIZE_STREAM = dict(n_nodes=1024, n_pods=4096, stream_chunk=1024)
SANITIZE_WAVE = dict(n_nodes=2048, n_pods=8192, chunk=1024)


def _record_namespace(device):
    """The port's names for the churn helpers and both cycle engines on
    `device`."""
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch.framework import (
        LanedCycle,
        PipelinedCycle,
    )
    from scheduler_plugins_tpu_torch.serving import StreamingServeEngine

    return SimpleNamespace(**{
        **vars(_life_namespace(device)), **vars(_gang_namespace(device)),
        "StreamingEngine": StreamingServeEngine,
        "Pipelined": lambda s, c, e: PipelinedCycle(s, c, serve=e,
                                                    device=device),
        "Laned": lambda s, c: LanedCycle(s, c, k=RECORD_ENGINE["lanes"],
                                         async_bind=True, device=device),
        "PipelinedResilient": lambda s, c, e, rz: PipelinedCycle(
            s, c, serve=e, resilience=rz, device=device),
    })


def record_paths(device) -> dict:
    """Every recorded path of phase 22 (a) on `device` with the recorder
    on: the flagship cycle sequential and streamed, config 7's served
    cycles, a packing-profile cycle, a config-10 gang cycle, three ticks
    each of `PipelinedCycle` and `LanedCycle`. Returns the records (the
    recorder's ring, in order), each path's label per record, the config-7
    cluster and engine (for the on / off pairs) and the gang phase."""
    import numpy as np

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
    from scheduler_plugins_tpu_torch.models import (
        allocatable_scenario,
        packing_scenario,
    )
    from scheduler_plugins_tpu_torch.serving import ServeEngine
    from scheduler_plugins_tpu_torch.utils import flightrec

    import torch_churn_cases as churn
    import torch_gang_cases as gcases

    recorder = flightrec.recorder
    recorder.start(capacity=RECORD_CAPACITY)
    labels = []

    def mark(label):
        labels.extend([label] * (len(recorder.records()) - len(labels)))

    run_cycle(flagship_scheduler(), allocatable_scenario(
        RECORD_SEQ["n_nodes"], RECORD_SEQ["n_pods"]), now=1000,
        device=device)
    mark("sequential")
    run_cycle(flagship_scheduler(), allocatable_scenario(
        RECORD_STREAM["n_nodes"], RECORD_STREAM["n_pods"]), now=1000,
        stream_chunk=RECORD_STREAM["stream_chunk"], device=device)
    mark("streamed")

    pkg = _record_namespace(device)
    shape = churn.SERVING_SHAPE
    served = churn.churn_cluster(pkg, shape["n_nodes"], shape["prefill"])
    engine = ServeEngine().attach(served)
    served_sched = Scheduler(load_profile(churn.CHURN_PROFILE))
    rng = np.random.default_rng(1)
    serial = 0
    for cycle in range(RECORD_SERVED_CYCLES):
        now = 1000 * (cycle + 1)
        serial = churn.churn_events(pkg, served, rng, shape, cycle, now,
                                    serial)
        run_cycle(served_sched, served, now=now, serve=engine,
                  device=device)
    mark("served")

    cluster, _, _, _ = packing_scenario(**RECORD_PACKING, device=device)
    run_cycle(Scheduler(load_profile(PACKING_PROFILE)), cluster, now=1000,
              device=device)
    mark("packing")

    gang_cluster = pkg.rank_gang_scenario(seed=0, **gcases.RANK_GANG_SHAPE)
    phase = pkg.GangPhase()
    run_cycle(pkg.Scheduler(gcases.flagship_profile(pkg)), gang_cluster,
              now=gcases.GANG_CYCLE_MS, gangs=phase, device=device)
    mark("gangs")

    cfg = RECORD_ENGINE
    for label in ("pipelined", "laned"):
        cluster = churn.churn_cluster(pkg, cfg["n_nodes"], cfg["prefill"])
        sched = Scheduler(load_profile(churn.CHURN_PROFILE))
        eng = (pkg.Pipelined(sched, cluster,
                             pkg.StreamingEngine().attach(cluster))
               if label == "pipelined" else pkg.Laned(sched, cluster))
        rng = np.random.default_rng(2)
        serial = 0
        for tick in range(cfg["ticks"]):
            now = 1000 * (tick + 1)
            serial = churn.churn_events(pkg, cluster, rng, cfg, tick, now,
                                        serial)
            eng.tick(now)
        eng.close()
        mark(label)
    recs = recorder.records()
    recorder.stop()
    return {"records": recs, "labels": labels, "served": served,
            "engine": engine, "sched": served_sched, "rng": rng,
            "serial": serial, "gang_phase": phase}


def record_phase(device) -> None:
    """Phase 22 (a): record every path on the card; save, load and replay
    every saved record on the card and on the CPU (digest intact, profile
    faithful, aux equal, a sequential record's placements equal, card ==
    CPU); the gang record's capture replayed through the numpy twin; the
    same cycles recorded on the CPU give the same digests; the record and
    save times and the recorder's on / off cost on a served cycle
    (`[record]` lines)."""
    import numpy as np

    import tempfile

    import torch

    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.gangs.topology import (
        RankGangState,
        gang_solve_np,
    )
    from scheduler_plugins_tpu_torch.utils import flightrec

    import torch_churn_cases as churn

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card = record_paths(device)
    record_s = time.perf_counter() - t0
    recs = card["records"]
    bundle = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    summary = flightrec.recorder.save(bundle.name)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = record_paths(cpu)
    host_s = time.perf_counter() - t0
    digests = [r.to_manifest()["digest"] for r in recs]
    host_digests = [r.to_manifest()["digest"] for r in host["records"]]
    print(f"[record] paths={sorted(set(card['labels']))} "
          f"records={len(recs)} card_s={record_s} cpu_s={host_s} "
          f"card_cpu_digests_equal={digests == host_digests}", flush=True)
    for label, rec in zip(card["labels"], recs):
        print(f"[record] {label} cycle={rec.seq} complete={rec.complete} "
              f"blobs={len(rec.blobs)} capture_ms={rec.capture_s * 1e3} "
              f"mode={(rec.manifest.get('outputs') or {}).get('mode')}",
              flush=True)
    if len(recs) != len(card["labels"]) or len(recs) >= RECORD_CAPACITY:
        raise AssertionError(f"recorder ring: {len(recs)} records")
    if not all(r.complete for r in recs):
        raise AssertionError("an incomplete record")
    if digests != host_digests:
        raise AssertionError("card and CPU records differ")

    # the gang cycle's capture replays through the numpy twin
    gang = [r for r, l in zip(recs, card["labels"]) if l == "gangs"]
    cap = flightrec.unpack_pytree(gang[-1].manifest["rank_gangs"],
                                  gang[-1].blobs)
    twin = gang_solve_np(RankGangState(**cap["gangs"]), cap["free0"],
                         cap["eq_used0"], cap["node_mask"])
    gang_ok = ((twin[0] == cap["rank_nodes"]).all()
               and (twin[1] == cap["admitted"]).all())
    print(f"[record] gang capture ranks={int(cap['rank_nodes'].size)} "
          f"twin_equal={bool(gang_ok)}", flush=True)
    if not gang_ok:
        raise AssertionError("the gang record does not replay")

    with bundle as tmp:
        size = sum(p.stat().st_size for p in Path(tmp).rglob("*")
                   if p.is_file())
        print(f"[record] save_s={save_s} bytes={size} "
              f"summary={json.dumps(summary)}", flush=True)
        loaded = flightrec.load_bundle(tmp)
        saved = [r for r in recs if r.manifest.get("snapshot")]
        if [lc.manifest["digest"] for lc in loaded] != [
                r.to_manifest()["digest"] for r in saved]:
            raise AssertionError("the bundle's manifest differs")
        for lc in loaded:
            t0 = time.perf_counter()
            on_card = flightrec.replay_cycle(lc, device=device)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_cpu = flightrec.replay_cycle(lc, device=cpu)
            cpu_s = time.perf_counter() - t0
            mode = on_card["mode"]
            ok = (on_card["digest_ok"] and on_card["profile_faithful"]
                  and on_card["aux_match"]
                  and (on_card["placements_match"] or mode != "sequential")
                  and np.array_equal(on_card["_assignment"],
                                     on_cpu["_assignment"]))
            print(f"[record] replay cycle={lc.manifest['cycle']} "
                  f"mode={mode} pods={len(lc.manifest['meta']['pod_names'])}"
                  f" digest_ok={on_card['digest_ok']} "
                  f"faithful={on_card['profile_faithful']} "
                  f"aux_match={on_card['aux_match']} "
                  f"placements_match={on_card['placements_match']} "
                  f"card_s={card_s} cpu_s={cpu_s} ok={ok}", flush=True)
            if not ok:
                raise AssertionError(
                    f"record {lc.manifest['cycle']} does not replay: "
                    f"{on_card['mismatches'][:3]}")

    # the recorder's cost on a config-7 served cycle: interleaved pairs
    pkg = _record_namespace(device)
    served, engine, sched = card["served"], card["engine"], card["sched"]
    rng, serial = card["rng"], card["serial"]
    recorder = flightrec.recorder
    recorder.start(capacity=2)
    pairs = []
    for k in range(RECORD_PAIRS):
        times = []
        for on in (False, True):
            cycle = RECORD_SERVED_CYCLES + 2 * k + on
            now = 1000 * (cycle + 1)
            serial = churn.churn_events(pkg, served, rng, churn.SERVING_SHAPE,
                                        cycle, now, serial)
            if on:
                recorder.resume()
            else:
                recorder.stop()
            t0 = time.perf_counter()
            run_cycle(sched, served, now=now, serve=engine, device=device)
            _sync(device)
            times.append(time.perf_counter() - t0)
        pairs.append(times)
    recorder.stop()
    capture = [r.capture_s for r in recorder.records()]
    off = statistics.median(t for t, _ in pairs)
    on = statistics.median(t for _, t in pairs)
    delta = statistics.median(b - a for a, b in pairs)
    print(f"[record] served_pairs={RECORD_PAIRS} off_ms={off * 1e3} "
          f"on_ms={on * 1e3} paired_delta_ms={delta * 1e3} "
          f"record_share={delta / off} "
          f"last_capture_ms={[c * 1e3 for c in capture]}", flush=True)


def golden_phase(device) -> None:
    """Phase 22 (b): the JAX package's committed bundle replayed on the
    card: placements equal, the recorded failure attribution, an explain
    table that passes the schema."""
    from scheduler_plugins_tpu_torch.tools.replay import validate_explain
    from scheduler_plugins_tpu_torch.utils import flightrec

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / \
        "flightrec"
    lc = flightrec.load_bundle(str(fixture))[0]
    out = flightrec.replay_cycle(lc, device=device)
    table = flightrec.explain_record(lc, "default/huge", device=device)
    errors = validate_explain(table)
    failed_by = lc.manifest["report"]["failed_by"]
    print(f"[golden] digest_ok={out['digest_ok']} "
          f"placements_match={out['placements_match']} "
          f"faithful={out['profile_faithful']} aux_match={out['aux_match']} "
          f"failed_by={json.dumps(failed_by)} "
          f"explain_failed_plugin={table['failed_plugin']} "
          f"schema_errors={errors}", flush=True)
    if not (out["digest_ok"] and out["placements_match"]
            and out["profile_faithful"] and out["aux_match"]
            and failed_by == {"default/huge": "NodeResourcesFit"}
            and table["failed_plugin"] == "NodeResourcesFit"
            and not errors):
        raise AssertionError("the golden bundle does not replay on the card")


def sanitize_phase(device) -> None:
    """Phase 22 (c): under `SPT_SANITIZE=1`, the flagship streamed cycle,
    config 4's `profile_batch_solve`, a served refresh (config 7's second
    served cycle) and the north star's `sharded_wave_solve` cut to S = 8
    blocks of 256 nodes, each equal to the same call without the
    sanitizer, each cycle with checked calls and no error, the three
    kernels launched; then an out-of-range commit index planted in
    `add_rows`, reported `out-of-bounds` with the card still working
    (`[sanitize]` lines)."""
    import numpy as np

    import os

    import torch

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
    from scheduler_plugins_tpu_torch.models import (
        allocatable_scenario,
        gang_quota_scenario,
    )
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel.solver import (
        profile_batch_solve,
        sharded_wave_solve,
    )
    from scheduler_plugins_tpu_torch.serving import ServeEngine
    from scheduler_plugins_tpu_torch.utils import sanitize
    from scheduler_plugins_tpu_torch.utils.intmath import add_rows

    import torch_churn_cases as churn

    def twice(fn):
        """(fn() without the sanitizer, fn() with it, its reports)."""
        os.environ.pop("SPT_SANITIZE", None)
        off = fn()
        os.environ["SPT_SANITIZE"] = "1"
        sanitize.drain()
        try:
            on = fn()
        finally:
            os.environ.pop("SPT_SANITIZE", None)
        return off, on, sanitize.drain()

    def stream():
        r = run_cycle(flagship_scheduler(), allocatable_scenario(
            SANITIZE_STREAM["n_nodes"], SANITIZE_STREAM["n_pods"]),
            now=1000, stream_chunk=SANITIZE_STREAM["stream_chunk"],
            device=device)
        return r.bound, r.failed, r.sanitize_checked, r.sanitize_errors

    t0 = time.perf_counter()
    off, on, _ = twice(stream)
    print(f"[sanitize] streamed_cycle checked={on[2]} errors={on[3]} "
          f"equal={off[:2] == on[:2]} s={time.perf_counter() - t0}",
          flush=True)
    if off[:2] != on[:2] or not on[2] or on[3]:
        raise AssertionError("the sanitized streamed cycle")

    def batch():
        cluster = gang_quota_scenario(**CONFIG4)
        sched = flagship_scheduler()
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, device=device)
        sched.prepare(meta, cluster)
        return [t.cpu() for t in profile_batch_solve(sched, snap,
                                                     device=device)]

    t0 = time.perf_counter()
    off, on, reports = twice(batch)
    same = all(torch.equal(a, b) for a, b in zip(off, on))
    print(f"[sanitize] profile_batch reports={reports} equal={same} "
          f"s={time.perf_counter() - t0}", flush=True)
    if not same or reports != [{"sanitize": "profile_batch", "ok": True}]:
        raise AssertionError("the sanitized batched solve")

    def served():
        pkg = _port_namespace()
        shape = churn.SERVING_SHAPE
        cluster = churn.churn_cluster(pkg, shape["n_nodes"],
                                      shape["prefill"])
        engine = ServeEngine().attach(cluster)
        sched = Scheduler(load_profile(churn.CHURN_PROFILE))
        rng = np.random.default_rng(1)
        serial, out = 0, []
        for cycle in range(2):
            now = 1000 * (cycle + 1)
            serial = churn.churn_events(pkg, cluster, rng, shape, cycle,
                                        now, serial)
            r = run_cycle(sched, cluster, now=now, serve=engine,
                          device=device)
            out.append((r.bound, r.failed, r.sanitize_checked,
                         r.sanitize_errors))
        return out

    t0 = time.perf_counter()
    off, on, _ = twice(served)
    print(f"[sanitize] served checked={[o[2] for o in on]} "
          f"errors={[o[3] for o in on]} "
          f"equal={[o[:2] for o in off] == [o[:2] for o in on]} "
          f"s={time.perf_counter() - t0}", flush=True)
    if ([o[:2] for o in off] != [o[:2] for o in on] or not on[1][2]
            or any(o[3] for o in on)):
        raise AssertionError("the sanitized served refresh")

    cluster = allocatable_scenario(SANITIZE_WAVE["n_nodes"],
                                   SANITIZE_WAVE["n_pods"])
    snap, meta = cluster.snapshot(
        sorted(cluster.pending_pods(), key=lambda p: p.creation_ms),
        device=device)
    weights = meta.index.encode({"cpu": 1 << 20, "memory": 1})
    launches = {}

    def wave():
        pk.reset_launches()
        out = [t.cpu() for t in sharded_wave_solve(
            snap, weights, S_BLOCKS, chunk=SANITIZE_WAVE["chunk"],
            rescue_window=NORTH_STAR["rescue_window"])]
        launches[len(launches)] = pk.launches()
        return out

    t0 = time.perf_counter()
    off, on, reports = twice(wave)
    same = all(torch.equal(a, b) for a, b in zip(off, on))
    print(f"[sanitize] sharded_wave_solve S={S_BLOCKS} reports={reports} "
          f"equal={same} launches_off={launches[0]} "
          f"launches_on={launches[1]} s={time.perf_counter() - t0}",
          flush=True)
    # on the CPU the wrappers take their plain versions and count nothing
    launched = device.type != "cuda" or all(launches[1].values())
    if (not same or not launched
            or reports != [{"sanitize": "sharded_wave_solve", "ok": True}]):
        raise AssertionError("the sanitized sharded wave solve")

    os.environ["SPT_SANITIZE"] = "1"
    try:
        target = torch.zeros((8, 4), dtype=torch.int64, device=device)
        with sanitize.checked("planted_commit"):
            out = add_rows(target,
                           torch.tensor([1, 10 ** 6], device=device),
                           torch.ones((2, 4), dtype=torch.int64,
                                      device=device))
        reports = sanitize.drain()
    finally:
        os.environ.pop("SPT_SANITIZE", None)
    _sync(device)
    after = int((torch.arange(4, device=device) + 1).sum())
    rows = out.sum(dim=1).tolist()
    print(f"[sanitize] planted reports={reports} rows={rows} "
          f"card_after={after}", flush=True)
    if (len(reports) != 1 or reports[0]["ok"]
            or "out-of-bounds" not in reports[0]["error"]
            or rows != [0, 4, 0, 0, 0, 0, 0, 0] or after != 10):
        raise AssertionError("the planted out-of-range commit")


def race_phase(device) -> None:
    """Phase 22 (d): under `SPT_RACE=1`, the race composite
    (`tests/torch_race_cases.py`) on the card with three seeds and once
    without the checker: no violation, each checked run with wrapped
    locks and Events and at least one lock-order edge, the hang fired,
    every tick's decisions, the final store and the ledger's counts equal
    (`[race]` lines)."""
    import os

    from scheduler_plugins_tpu_torch.utils import racecheck

    import torch_race_cases as race

    pkg = _record_namespace(device)
    t0 = time.perf_counter()
    control = race.race_composite(pkg, racecheck, race.RACE_SHAPE,
                                  race=False)
    os.environ["SPT_RACE"] = "1"
    try:
        runs = [race.race_composite(pkg, racecheck, race.RACE_SHAPE,
                                    seed=s) for s in race.RACE_SEEDS]
    finally:
        os.environ.pop("SPT_RACE", None)
    errors = race.race_gates(runs, control)
    for seed, run in zip(race.RACE_SEEDS, runs):
        rep = run["racecheck"]
        print(f"[race] seed={seed} violations={len(rep['violations'])} "
              f"locks={rep['locks_created']} events={rep['events_created']} "
              f"edges={rep['order_edges']} yields={rep['yields']} "
              f"fired={run['fired']} failovers={run['failovers']}",
              flush=True)
    print(f"[race] runs={len(runs) + 1} ticks={race.RACE_SHAPE['ticks']} "
          f"bound={sum(len(b) for b, _, _ in control['ticks'])} "
          f"errors={errors} s={time.perf_counter() - t0}", flush=True)
    if errors:
        raise AssertionError(f"race composite: {errors}")


def recorder_off_phase(device) -> None:
    """Phase 22 (e): one served `run_cycle` with the recorder off, its
    stages run one by one: the record's opening, the solve's dispatch, the
    post-solve stage (the outputs hook) and the finalize (the commit hook)
    under `torch.cuda.set_sync_debug_mode("error")` (no new host sync);
    the snapshot stage (the inputs hook), the fence and the bind stages
    outside; its report equals a plain `run_cycle` of a twin cluster
    (`[record_off]` lines)."""
    import numpy as np

    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
    from scheduler_plugins_tpu_torch.framework import cycle as C
    from scheduler_plugins_tpu_torch.serving import ServeEngine
    from scheduler_plugins_tpu_torch.utils import flightrec

    import torch_churn_cases as churn

    flightrec.recorder.stop()
    pkg = _port_namespace()
    reports = []
    for staged in (False, True):
        cluster = churn.churn_cluster(pkg, 512, 4096)
        engine = ServeEngine().attach(cluster)
        sched = Scheduler(load_profile(churn.CHURN_PROFILE))
        rng = np.random.default_rng(1)
        serial = churn.churn_events(pkg, cluster, rng,
                                    churn.SERVING_SHAPE, 0, 1000, 0)
        run_cycle(sched, cluster, now=1000, serve=engine, device=device)
        serial = churn.churn_events(pkg, cluster, rng,
                                    churn.SERVING_SHAPE, 1, 2000, serial)
        if not staged:
            reports.append(run_cycle(sched, cluster, now=2000, serve=engine,
                                     device=device))
            continue
        ctx = C._cycle_open(sched, cluster, 2000, device, serve=engine)
        try:
            C._cycle_pending(ctx)
            with sync_errors(device):
                C._cycle_arm(ctx)
            # the snapshot stage's own copies (`prepare` stages the
            # plugins' tensors from the host) are no hook's: outside
            C._cycle_snapshot(ctx)
            with sync_errors(device):
                C._cycle_solve_dispatch(ctx)
            C._cycle_solve_fence(ctx)
            with sync_errors(device):
                C._cycle_post_solve(ctx)
            C._cycle_bind(ctx)
            C._cycle_postbind(ctx)
            with sync_errors(device):
                C._cycle_finalize(ctx)
        finally:
            C.podledger.LEDGER.pop_scope(ctx.led)
            C.podledger.LEDGER.cycle_close(ctx.led)
        reports.append(ctx.report)
    same = (reports[0].bound == reports[1].bound
            and reports[0].failed == reports[1].failed)
    print(f"[record_off] served={ctx.served} rec={ctx.rec} "
          f"bound={len(reports[1].bound)} equal={same}", flush=True)
    if not (same and ctx.served and ctx.rec is None and reports[1].bound):
        raise AssertionError("the recorder-off cycle")


def flightrec_phase(device) -> None:
    """Phase 22: the flight recorder and the debug modes, (a) to (e)."""
    _tests_on_path()
    for label, fn in (("record", record_phase), ("golden", golden_phase),
                      ("sanitize", sanitize_phase), ("race", race_phase),
                      ("record_off", recorder_off_phase)):
        t0 = time.perf_counter()
        fn(device)
        print(f"[flightrec] {label}_s={time.perf_counter() - t0}",
              flush=True)


def _tune_namespace(device):
    """The port's names for `tests/torch_tune_cases.py`, its cycles and
    sweeps on `device`."""
    import functools
    from types import SimpleNamespace

    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.resilience import faults
    from scheduler_plugins_tpu_torch.tuning import quality
    from scheduler_plugins_tpu_torch.tuning.shadow import ShadowTuner
    from scheduler_plugins_tpu_torch.utils import flightrec

    return SimpleNamespace(
        **vars(_port_namespace()),
        ShadowTuner=functools.partial(ShadowTuner, device=device),
        run=lambda s, c, now, tuner: run_cycle(s, c, now=now, tuner=tuner,
                                               device=device),
        flightrec=flightrec, faults=faults, SENSE=quality.SENSE,
    )


#: the sweep widths whose step work is held equal
TUNE_K = (1, 16)


def tune_sweep_work(device) -> None:
    """A sweep step's work at K = 1 and K = 16 on config 14's first
    cycle: the drift profile's vmapped solve of the first 12 and of all 24
    arrivals differ by 12 steps (`launches_per_step`'s method). The host
    calls that enqueue device work a step must be equal at both K (one
    program a step, not one a lane); a K = 16 sweep then runs under
    sync-debug "error"."""
    import torch

    import torch_tune_cases as tune
    from scheduler_plugins_tpu_torch.parallel.solver import sweep_solve_fn
    from scheduler_plugins_tpu_torch.tuning.sweep import candidate_weights

    pkg = _tune_namespace(device)
    shape = tune.TUNE_LIVE_SHAPE
    script, _ = tune._drift_script(shape)
    cluster = tune._drift_cluster(pkg, shape)
    phase, arrivals, departs = script[0]
    tune._drift_apply_events(pkg, cluster, arrivals, departs, 1000)
    tune._drift_metrics(pkg, cluster, shape, phase)
    sched = tune._drift_profile(pkg)
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    half = len(pending) // 2
    fn = sweep_solve_fn(sched)
    per_k = {}
    for k in TUNE_K:
        W = torch.as_tensor(candidate_weights([1, 20], k, seed=0),
                            device=device)
        counts = {}
        for n in (half, 2 * half):
            snap, meta = cluster.snapshot(pending[:n], now_ms=1000,
                                          device=device, pad_pods=n)
            sched.prepare(meta, cluster)
            state0 = sched.initial_state(snap)
            events, work, device_us, _ = profiled_work(
                lambda: fn(snap, state0, None, W), device)
            counts[n] = (sum(work.values()), device_us, events)
        (w1, us1, e1), (w2, us2, e2) = counts[half], counts[2 * half]
        per_k[k] = ((w2 - w1) / half, (us2 - us1) / half, (e2 - e1) / half)
        print(f"[tune] sweep_step K={k} work_calls_per_step={per_k[k][0]} "
              f"device_us_per_step={per_k[k][1]} "
              f"device_events_per_step={per_k[k][2]} (work calls {w1} / "
              f"{w2}, device us {us1} / {us2} for {half} / {2 * half} "
              f"pods)", flush=True)
    if per_k[TUNE_K[0]][0] != per_k[TUNE_K[1]][0]:
        raise AssertionError(f"sweep step work grows with K: {per_k}")
    W = torch.as_tensor(candidate_weights([1, 20], TUNE_K[1], seed=0),
                        device=device)
    state0 = sched.initial_state(snap)
    _sync(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(snap, state0, None, W)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync(device)


def tune_arms(device) -> dict:
    """(a) and (b): config 14's static arm on the card, its tuned arm on
    the card and on the CPU (equal but for wall times), the overhead
    pairs on the card, and `tune_live_smoke`'s checks."""
    import torch

    import torch_tune_cases as tune

    shape = tune.TUNE_LIVE_SHAPE
    card = _tune_namespace(device)
    arms = {}
    for label, pkg, tuned in (("static_card", card, False),
                              ("tuned_card", card, True),
                              ("tuned_cpu",
                               _tune_namespace(torch.device("cpu")), True)):
        t0 = time.perf_counter()
        arms[label] = arm = tune.run_drift_arm(pkg, shape, tuned=tuned)
        wall = time.perf_counter() - t0
        t_idx = range(shape["warmup"], arm["b_end"])
        serve_s = sum(arm["times"][i] for i in t_idx)
        print(f"[tune] arm={label} wall_s={wall} cycles={len(arm['times'])} "
              f"timed_cycles_per_s={len(t_idx) / serve_s} "
              f"sweep_wall_s={arm['sweep_wall_s']} "
              f"probe_wall_s={arm['probe_wall_s']} "
              f"promotions={arm['promotions']} rollback={arm['rollback']} "
              f"tuner={arm['tuner']}", flush=True)
    got, want = arms["tuned_card"], arms["tuned_cpu"]
    for key in ("bound", "failed", "weights_by_cycle", "promotions",
                "injected_at", "rollback", "regress_seen_at", "decided"):
        if got[key] != want[key]:
            raise AssertionError(f"config 14 tuned arm: card != CPU in {key}")
    for c, (g, w) in enumerate(zip(got["quality"], want["quality"])):
        if set(g) != set(w) or any(
                abs(g[k] - w[k]) > 1e-12 * max(abs(w[k]), 1e-300)
                for k in g if g[k] != w[k]):
            raise AssertionError(f"config 14 cycle {c}: quality card "
                                 f"{g} != CPU {w}")
    line = tune.drift_line(card, shape, arms["static_card"], got)
    t0 = time.perf_counter()
    pct, floor, match, overlap = tune.tune_overhead_pct(card, shape)
    print(f"[tune] overhead_pairs={tune.TUNE_OVERHEAD_PAIRS} "
          f"overhead_pct={pct} jitter_floor_pct={floor} "
          f"observe_only_placements_match={match} "
          f"background_sweep_overlap={json.dumps(overlap)} "
          f"seconds={time.perf_counter() - t0}", flush=True)
    line.update(overhead_pct=pct, overhead_jitter_floor_pct=floor,
                observe_only_placements_match=match)
    checks = tune.tune_live_checks(line)
    print(f"[tune] line={json.dumps(line)}", flush=True)
    print(f"[tune] checks={json.dumps(checks)}", flush=True)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"config 14: tune_live_smoke checks failed: "
                             f"{failed}")
    return line


def tune_chaos(device) -> None:
    """(c): the tuner chaos check on the card."""
    import torch_tune_cases as tune

    t0 = time.perf_counter()
    line = tune.tuner_chaos_check(_tune_namespace(device))
    print(f"[tune] chaos={json.dumps(line)} "
          f"seconds={time.perf_counter() - t0}", flush=True)
    if not line["ok"]:
        raise AssertionError(f"tuner chaos check failed: {line}")


def tune_offline_smoke(device) -> None:
    """(d): `tools/tune.py smoke` on the card; its one JSON line must say
    ok (an accepted, emitted profile with 0 violations and equal sweep
    ops at K = 1 and 64)."""
    import io
    import tempfile

    from scheduler_plugins_tpu_torch.tools import tune as offline

    t0 = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="tune_smoke_") as tmp:
        with contextlib.redirect_stdout(buf):
            rc = offline.main(["smoke", "--device", str(device),
                               "--out", str(Path(tmp) / "bundle")])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[tune] offline_smoke rc={rc} seconds="
          f"{time.perf_counter() - t0} {json.dumps(line)}", flush=True)
    if rc != 0 or not line["ok"] or line["emitted_profile_violations"] != 0:
        raise AssertionError(f"offline tune smoke failed: {line}")


def tune_phase(device) -> None:
    """Phase 23: the tuning observatory, bench config 14 uncut."""
    _tests_on_path()
    for label, fn in (("sweep_work", tune_sweep_work), ("arms", tune_arms),
                      ("chaos", tune_chaos),
                      ("offline_smoke", tune_offline_smoke)):
        t0 = time.perf_counter()
        fn(device)
        print(f"[tune] {label}_s={time.perf_counter() - t0}", flush=True)


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
    t_start = t_phase = time.perf_counter()

    def phase_done(n: int) -> None:
        """Print phase n's wall seconds and the run's so far."""
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[smoke] phase={n} seconds={now - t_phase} "
              f"total_s={now - t_start}", flush=True)
        t_phase = now

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

    phase_done(3)

    # 4. north star through the blocked path
    t0 = time.perf_counter()
    cluster = allocatable_scenario(NORTH_STAR["n_nodes"], NORTH_STAR["n_pods"])
    print(f"[north_star] scenario_s={time.perf_counter() - t0:.3f}", flush=True)
    north = drive(
        "north_star", cluster, device, S_BLOCKS, chunk=NORTH_STAR["chunk"],
        rescue_window=NORTH_STAR["rescue_window"], pad_to=NORTH_STAR["chunk"],
    )

    phase_done(4)

    # 5. the streamed chunk pipeline: the north star as bench drives it,
    # bench config 6 through one streamed cycle, the streamed script
    north_star_pipeline(cluster, device)
    del cluster
    config6_cycle(device)
    script_phase(device, stream_chunk=4)

    phase_done(5)

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

    phase_done(6)

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

    phase_done(7)

    # 8. the scheduling cycle, card against CPU
    cycle_phase(device)

    phase_done(8)

    # 9. the Trimaran plugins (bench config 2 and the small cases)
    trimaran_phase(device)

    phase_done(9)

    # 10. NUMA: bench config 3 through the parity solve and a cycle
    numa_phase(device)

    phase_done(10)

    # 11. the network-aware plugins: bench config 5 through the parity
    # solve and a cycle
    network_phase(device)

    phase_done(11)

    # 12. the NRT cache tier through a four-cycle script
    nrt_cache_phase(device)

    phase_done(12)

    # 13. the batched profile solve on configs 3, 2, 4 and 5
    batch_phase(device)

    phase_done(13)

    # 14. the in-tree plugins and the batched solve's validators
    intree_phase(device)

    phase_done(14)

    # 15. the rest of the roster: SySched, PodState, QOSSort and the two
    # preemption plugins
    roster_phase(device)

    phase_done(15)

    # 16. the packing solve mode at bench config 13's full size
    packing_phase(device, smi)

    phase_done(16)

    # 17. the serving path: bench config 7 served, re-snapshotted and on
    # the CPU; the flagship profile's served churn
    serving_phase(device)

    phase_done(17)

    # 18. resilience: bench config 9, the host solve, the checkpoint and
    # the fetch deadline
    resilience_phase(device)

    phase_done(18)

    # 19. rank-aware gangs: bench configs 10 and 12
    gangs_phase(device)

    phase_done(19)

    # 20. the pipelined cycle engine: bench config 11
    life_phase(device)

    phase_done(20)

    # 21. the laned cycle engine: bench config 15
    lanes_phase(device)

    phase_done(21)

    # 22. the flight recorder, the golden bundle, the sanitizer, the race
    # checker and the recorder off
    flightrec_phase(device)

    phase_done(22)

    # 23. the tuning observatory: bench config 14
    tune_phase(device)

    phase_done(23)

    # 24. the kernel table, the card, the result
    kernels = kernel_table(north, device)
    phase_done(24)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
