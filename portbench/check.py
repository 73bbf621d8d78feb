"""How `correct` is decided: the run's record against the plain reference
(`reference/`), once the window has closed and the program's state is
freed.

The reference replays the run from the generator's records: the nodes,
the pods bound at set-up, and each iteration's completions and arrivals.
For every cycle it takes the program's placements (read from the store
after the cycle) and counts

- `overcommitted_pods`: pods the program bound to an unknown node, or to
  a node whose usage then exceeds its allocatable;
- `stranded_pods`: pods the program left pending although, after its
  binds, some node still fits them (counted only for profiles whose
  filters do not depend on the cycle's own placements: there a pod that
  fails at its turn cannot fit later);

and for a sample of cycles drawn from the seed (the last always among
them, until their pods reach the mix's `exact_pods`) it schedules the
cycle itself and counts

- `placement_mismatch`: pods whose outcome (the node, or pending) differs
  from the reference's.

Once the run is over it counts

- `usage_gap_nodes`: nodes whose cpu, memory or pod count in the last
  cycle's snapshot (the served engine's resident columns in a served
  cycle) differ from the reference's usage when that cycle began;
- `store_gap_pods`: pods whose node in the store at the end differs from
  the reference's model.

Every number is exact, so every limit is 0. A configuration's
`compared` lists the numbers that decide `correct` for it: one that no
fault can move in its cells (see PERF.md) is left out."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

LIMITS = {
    "placement_mismatch": 0,
    "overcommitted_pods": 0,
    "stranded_pods": 0,
    "usage_gap_nodes": 0,
    "store_gap_pods": 0,
}


@dataclass
class Iteration:
    """One iteration as the run applied it: the uids it completed, the
    pods that arrived ((first generator serial, count): `Traffic.rebuild`
    makes them again), and the program's outcome for the pods pending
    before its cycle ({uid: node} of those bound). Only strings and ints:
    the run's record adds nothing for the garbage collector to walk."""

    kind: str  # "warmup", "window" or "trace"
    removed: list
    added: tuple
    bound: dict
    attempted: int


def reference_module(config: dict):
    return importlib.import_module(
        f"portbench.reference.{config['reference']}")


def exact_cycles(budget: int, sizes: list, seed: int) -> set:
    """The cycles the reference schedules itself: the last, then cycles
    drawn from the seed in a random order until their pending pods
    (`sizes`, one count a cycle) reach `budget`; all when they fit."""
    n = len(sizes)
    if sum(sizes) <= budget:
        return set(range(n))
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), 0x636865636b]))
    picked, spent = {n - 1}, sizes[-1]
    for k in rng.permutation(n - 1).tolist():
        if spent + sizes[k] > budget:
            break
        picked.add(k)
        spent += sizes[k]
    return picked


def has_state_dependent_filter(config: dict) -> bool:
    return "PodTopologySpread" in config["profile"]["plugins"]


def decide(cell, seed: int, iterations, snapshot_usage,
           store_placements) -> dict:
    """{number: value} of the comparison of a run of `cell`
    (`harness.Cell`); `correct` is every compared number at or under its
    limit. The cluster, the pods bound at set-up and the arrivals are made
    again from the seed."""
    config, mix = cell.config, cell.mix
    traffic, generator = cell.traffic(seed)
    ref_mod = reference_module(config)
    ref = ref_mod.Reference(traffic.nodes, config["profile"]["plugins"])
    for pod in generator.fill():
        ref.add(pod)
    n = len(iterations)
    exact = exact_cycles(int(mix["exact_pods"]),
                         [it.attempted for it in iterations], seed)
    fit_only = not has_state_dependent_filter(config)
    out = dict.fromkeys(LIMITS, 0)
    usage_before_last = None
    for k, it in enumerate(iterations):
        for uid in it.removed:
            ref.remove(uid)
        for pod in traffic.rebuild(*it.added):
            ref.add(pod)
        if k == n - 1:
            usage_before_last = ref.usage()
        pending = [p.uid for p in ref.pending()]
        over, stranded = ref.judge(it.bound, pending)
        out["overcommitted_pods"] += over
        if fit_only:
            out["stranded_pods"] += stranded
        if k in exact:
            mine, _ = ref.cycle()
            out["placement_mismatch"] += ref_mod.compare(mine, it.bound)
        else:
            ref.apply(it.bound)
    out["usage_gap_nodes"] = usage_gap(ref, snapshot_usage,
                                       usage_before_last)
    out["store_gap_pods"] = sum(
        1 for uid in set(store_placements) | set(ref.where)
        if store_placements.get(uid) != (
            ref.names[ref.where[uid]] if uid in ref.where else None))
    out["cycles_compared_exactly"] = len(exact)
    out["cycles"] = n
    return out


def usage_gap(ref, snapshot_usage, expected) -> int:
    """Nodes whose usage in the program's last snapshot differs from the
    reference's; every node when the run kept no snapshot."""
    if snapshot_usage is None or expected is None:
        return len(ref.names)
    names, usage = snapshot_usage
    if list(names) != ref.names:
        return len(ref.names)
    return int((usage != expected).any(axis=1).sum())


def compared(config: dict) -> dict:
    """{number: limit} of the numbers that decide `correct`."""
    return {k: LIMITS[k] for k in config["compared"]}


def correct(numbers: dict, config: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in compared(config).items())


def lines(numbers: dict, config: dict) -> list:
    """One line a compared number, its value beside its limit."""
    return [f"check {k} {numbers[k]} limit {lim}"
            for k, lim in compared(config).items()]
