#!/usr/bin/env python3
"""Count the ATen operations that each wave of the port's blocked solve,
and each step of its sequential parity solve, dispatches, on the CPU.

    python tools/wave_op_census.py [--root DIR]

Solves the tight problem of `chip_smoke.py` (`allocatable_scenario(40,
3000)`, queue sorted by creation time, chunks of 1024, rescue window 256,
S = 3 rank blocks) with the port package found under `--root` (default:
this checkout, so a second checkout of another commit can be counted the
same way) on the CPU, and counts, per wave, with a `TorchDispatchMode`:

- `aten`: every ATen operation the wave dispatches outside the exchange
  kernels' wrappers;
- `views`: those of them that only make a view (no launch on a card);
- `launching`: the rest, each at least one kernel launch on a card;
- `kernels`: calls of the exchange kernels' wrappers (`block_offsets`,
  `elect_min`, `fused_election`), one launch each on a card. On the CPU a
  wrapper runs its plain version; those operations are not counted.

The wave's one device-to-host sync (`.tolist()` of its counts) is outside
the wave and is not counted. Waves are grouped by kind, lite and rescue;
every wave of a kind dispatches the same operations (the script checks
this).

The parity step: `Scheduler.solve` with the flagship profile over the
first 64 and the first 128 queued pods of bench config 4's cluster
(`gang_quota_scenario(32, 64, 1024)`); the two solves differ by 64 steps
(the set-up and the Permit tail are the same work), so the difference of
their counts over 64 is one step's `aten` / `views` / `launching` ops.
`by_op` lists the launching ops a step dispatches, by name.
`parity_step_config3` is the same for bench config 3
(`numa_scenario(1024, 512, zones=8)`, NodeResourceTopologyMatch), and
`parity_step_config5` for bench config 5 (`network_scenario(1024, 1024)`,
NetworkOverhead + TopologicalSort), and `parity_step_intree` for the
in-tree roster problem `intree_1k` (`tests/torch_intree_cases.py`
`intree_cluster()`: 1,024 nodes, 1,024 pending pods; NodeResourcesAllocatable,
NodeAffinity, TaintToleration, PodTopologySpread, InterPodAffinity), and
`parity_step_mixed` for `mixed_full` (`mixed_scenario(1024, 1024)` under
NodeResourcesAllocatable, NodeResourceTopologyMatch, NetworkOverhead and
PodTopologySpread), `parity_step_roster` for `roster_1k`
(`tests/torch_roster_cases.py` `roster_cluster()`: QOSSort,
NodeResourcesAllocatable, SySched, PodState, PreemptionToleration) and
`parity_step_metric` for `metric_1k` (`metric_affinity_scenario(1024,
1024)` under TargetLoadPacking, LoadVariationRiskBalancing,
InterPodAffinity and SySched), each with every plugin's
`configure_cluster` run first, as the cycle runs it.

`validator_intree`: the ATen ops of one row of the batched solve's
validator walk on `intree_1k` (both validators' `validate_at` and the
selector commit, `ops.selectors.commit_tracks`), averaged over its first
64 rows against the cycle-initial carry; a dense wave walks every pod
row, a straggler wave 128.

`batch`: `profile_batch_solve(collect_stats=True)` of bench configs 3 and
2 (`trimaran_scenario(5000, 2048)`, TLP + LVRB) at full width: its waves,
occupancy, placed pods and the ATen ops of the whole solve.

`packing_round`: the packing solve (`parallel.solver.packing_solve`) of
bench config 13 at full size (`packing_scenario(768, 0.92, 0.05)`: 768
nodes, 19,213 pending pods) at refinement budgets 8 and 16, knobs (b, 4.0,
0.0, 0.5); the two differ by 8 rounds, so their difference over 8 is one
round's `aten` / `views` / `launching` ops (`by_op` by name), and
`solve_128` the launching ops of the whole budget-128 solve.

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

KERNELS = ("block_offsets", "elect_min", "fused_election")


def census(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from torch.utils._python_dispatch import (
        TorchDispatchMode,
        _disable_current_modes,
    )

    from scheduler_plugins_tpu_torch.models import allocatable_scenario
    from scheduler_plugins_tpu_torch.ops import assign
    from scheduler_plugins_tpu_torch.parallel import kernels as pk
    from scheduler_plugins_tpu_torch.parallel.solver import (
        sharded_wave_solve,
    )

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = dict.fromkeys(
                ("aten", "views", "launching", "kernels"), 0
            )

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts["aten"] += 1
            self.counts["views" if func.is_view else "launching"] += 1
            return func(*args, **(kwargs or {}))

    active = []  # the Counter of the wave that is running

    def counted_kernel(kernel):
        def wrapper(*args):
            active[-1].counts["kernels"] += 1
            with _disable_current_modes():
                return kernel(*args)
        return wrapper

    for name in KERNELS:
        setattr(pk, name, counted_kernel(getattr(pk, name)))

    waves = []
    run_phases = assign._run_phases

    def counted_run_phases(wave, *rest):
        def counted_wave(W, choice_fn):
            counter = Counter()
            active.append(counter)
            with counter:
                out = wave(W, choice_fn)
            active.pop()
            waves.append((choice_fn.__name__.replace("_choice", ""),
                          counter.counts))
            return out
        return run_phases(counted_wave, *rest)

    assign._run_phases = counted_run_phases
    cluster = allocatable_scenario(40, 3000)
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    snap, meta = cluster.snapshot(pending, now_ms=0, device="cpu",
                                  pad_pods=3072)
    sharded_wave_solve(snap, meta.index.encode({"cpu": 1 << 20, "memory": 1}),
                       3, chunk=1024, rescue_window=256)
    by_kind = {}
    for kind, counts in waves:
        by_kind.setdefault(kind, []).append(counts)
    for kind, rows in by_kind.items():
        if any(r != rows[0] for r in rows):
            raise AssertionError(f"{kind} waves differ: {rows}")
    return {
        "root": str(root),
        "device": "cpu",
        "waves": {kind: dict(rows[0], n=len(rows))
                  for kind, rows in by_kind.items()},
    }


def _op_counter():
    """A `TorchDispatchMode` counting ATen ops: all, views, the launching
    rest, and the launching ones by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = {"aten": 0, "views": 0, "launching": 0}
            self.by_op = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts["aten"] += 1
            self.counts["views" if func.is_view else "launching"] += 1
            if not func.is_view:
                name = func.__name__.split(".")[0]
                self.by_op[name] = self.by_op.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    return Counter()


def _problem(which: str):
    """(cluster, scheduler) of bench config 4 (the flagship profile), 3
    (NUMA), 5 (NetworkOverhead + TopologicalSort), the full-roster mixed
    profile, the in-tree roster problem, the rest of the roster's
    problem, the metric roster's or 2 (TLP + LVRB) at full width."""
    from scheduler_plugins_tpu_torch import plugins as P
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.models import (
        gang_quota_scenario,
        network_scenario,
        numa_scenario,
        trimaran_scenario,
    )

    if which == "config4":
        return gang_quota_scenario(32, 64, 1024), Scheduler(Profile(plugins=[
            P.NodeResourcesAllocatable(), P.Coscheduling(),
            P.CapacityScheduling()]))
    if which == "config3":
        return numa_scenario(1024, 512, zones=8), Scheduler(Profile(
            plugins=[P.NodeResourceTopologyMatch()]))
    if which == "config5":
        return network_scenario(1024, 1024), Scheduler(Profile(
            plugins=[P.NetworkOverhead(), P.TopologicalSort()]))
    if which == "mixed":
        from scheduler_plugins_tpu_torch.models import mixed_scenario

        return mixed_scenario(1024, 1024), Scheduler(Profile(plugins=[
            P.NodeResourcesAllocatable(), P.NodeResourceTopologyMatch(),
            P.NetworkOverhead(), P.PodTopologySpread()]))
    if which in ("roster", "metric"):
        from types import SimpleNamespace

        from scheduler_plugins_tpu_torch.api import objects
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.models import (
            metric_affinity_scenario,
        )
        from scheduler_plugins_tpu_torch.state import Cluster

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                               / "tests"))
        from torch_roster_cases import (
            METRIC_PROFILE,
            ROSTER_PROFILE,
            roster_cluster,
        )

        if which == "metric":
            cluster = metric_affinity_scenario(1024, 1024)
            scheduler = Scheduler(load_profile(METRIC_PROFILE))
        else:
            cluster = roster_cluster(SimpleNamespace(objects=objects,
                                                     Cluster=Cluster))
            scheduler = Scheduler(load_profile(ROSTER_PROFILE))
        for plugin in scheduler.profile.plugins:
            plugin.configure_cluster(cluster)
        return cluster, scheduler
    if which == "intree":
        from types import SimpleNamespace

        from scheduler_plugins_tpu_torch.api import objects
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.state import Cluster

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                               / "tests"))
        from torch_intree_cases import INTREE, intree_cluster

        return intree_cluster(SimpleNamespace(
            objects=objects, Cluster=Cluster)), Scheduler(
            load_profile(INTREE))
    return trimaran_scenario(5000, 2048), Scheduler(Profile(plugins=[
        P.TargetLoadPacking(), P.LoadVariationRiskBalancing()]))


def parity_step_census(root: Path, pods: int = 64,
                       which: str = "config4") -> dict:
    """Per-step op counts of the parity solve (see the module docstring)."""
    sys.path.insert(0, str(root))
    cluster, scheduler = _problem(which)
    pending = scheduler.sort_pending(cluster.pending_pods(), cluster)
    counters = []
    for n in (pods, 2 * pods):
        snap, meta = cluster.snapshot(pending[:n], now_ms=0, device="cpu",
                                      pad_pods=n)
        scheduler.prepare(meta, cluster)
        counter = _op_counter()
        with counter:
            scheduler.solve(snap, device="cpu")
        counters.append(counter)
    short, long = counters
    by_op = {k: (v - short.by_op.get(k, 0)) / pods
             for k, v in long.by_op.items()}
    return {
        **{k: (long.counts[k] - short.counts[k]) / pods
           for k in short.counts},
        "by_op": {k: v for k, v in sorted(by_op.items(),
                                          key=lambda kv: -kv[1]) if v},
    }


def validator_census(root: Path, rows: int = 64) -> dict:
    """Per-row op counts of the validator walk on `intree_1k` (see the
    module docstring)."""
    sys.path.insert(0, str(root))
    import torch

    from scheduler_plugins_tpu_torch.ops.selectors import commit_tracks

    cluster, scheduler = _problem("intree")
    pending = scheduler.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0, device="cpu")
    scheduler.prepare(meta, cluster)
    validators = [p for p in scheduler.profile.plugins
                  if p.validate_at is not None]
    state = scheduler.initial_state(snap)
    args = [(torch.tensor([j]), torch.tensor([j % len(meta.node_names)]))
            for j in range(rows)]
    counter = _op_counter()
    with counter:
        for q, node in args:
            ok = None
            for plugin in validators:
                verdict = plugin.validate_at(state, snap, q, node)
                ok = verdict if ok is None else ok & verdict
            state = commit_tracks(state, snap.scheduling, q,
                                  torch.where(ok, node, -1))
    return {
        "validators": [p.name for p in validators],
        **{k: v / rows for k, v in counter.counts.items()},
        "by_op": {k: v / rows for k, v in sorted(
            counter.by_op.items(), key=lambda kv: -kv[1])},
    }


def batch_census(root: Path) -> dict:
    """Waves, occupancy and ATen ops of the batched profile solve of bench
    configs 3 and 2 (see the module docstring)."""
    sys.path.insert(0, str(root))
    from scheduler_plugins_tpu_torch.parallel.solver import (
        profile_batch_solve,
    )

    out = {}
    for which in ("config3", "config2"):
        cluster, scheduler = _problem(which)
        pending = scheduler.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, device="cpu")
        scheduler.prepare(meta, cluster)
        counter = _op_counter()
        with counter:
            assignment, _, _, stats = profile_batch_solve(
                scheduler, snap, collect_stats=True, device="cpu")
        out[which] = {
            "waves": stats["waves"],
            "occupancy": stats["occupancy"].tolist(),
            "placed": int((assignment >= 0).sum()),
            **counter.counts,
        }
    return out


def packing_census(root: Path) -> dict:
    """Per-round op counts of the packing refinement (see the module
    docstring)."""
    sys.path.insert(0, str(root))
    from scheduler_plugins_tpu_torch.models import packing_scenario
    from scheduler_plugins_tpu_torch.ops.packing import pack_aux_vector
    from scheduler_plugins_tpu_torch.parallel.solver import packing_solve

    _, snap, _, weights = packing_scenario(768, 0.92, 0.05, device="cpu")
    counters = {}
    for budget in (8, 16, 128):
        counter = _op_counter()
        with counter:
            packing_solve(snap, weights,
                          pack_aux_vector(budget, 4.0, 0.0, 0.5))
        counters[budget] = counter
    short, long = counters[8], counters[16]
    by_op = {k: (v - short.by_op.get(k, 0)) / 8
             for k, v in long.by_op.items()}
    return {
        **{k: (long.counts[k] - short.counts[k]) / 8 for k in short.counts},
        "by_op": {k: v for k, v in sorted(by_op.items(),
                                          key=lambda kv: -kv[1]) if v},
        "solve_128": counters[128].counts["launching"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="checkout that holds scheduler_plugins_tpu_torch/")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    print(json.dumps({
        **census(root),
        "parity_step": parity_step_census(root),
        "parity_step_config3": parity_step_census(root, which="config3"),
        "parity_step_config5": parity_step_census(root, which="config5"),
        "parity_step_intree": parity_step_census(root, which="intree"),
        "parity_step_mixed": parity_step_census(root, which="mixed"),
        "parity_step_roster": parity_step_census(root, which="roster"),
        "parity_step_metric": parity_step_census(root, which="metric"),
        "validator_intree": validator_census(root),
        "batch": batch_census(root),
        "packing_round": packing_census(root),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
