"""How `correct` is decided: the run's record against the plain reference
(`reference/`), once the window has closed and the program's state is
freed.

The reference (the configuration's `reference`, `reference/<name>.py`)
replays the run from the generator's records, made again from the seed
and each iteration's key: the nodes, the records of set-up, and each
iteration's removals and records, in the order the program got them. For
every cycle it is handed the program's outcome (read from the store after
the cycle: the binds, the standing Permit reservations, the preemptions
with their nominated nodes and victims) and counts

- `overcommitted_pods`: pods the program bound to an unknown node, or to
  a node whose usage then exceeds its allocatable;
- `stranded_pods`: pods the program left pending although, after its
  binds, some node still fits them (where the reference can tell: it
  says so itself, by giving no count where it cannot);

and for a sample of cycles drawn from the seed (the last always among
them, until their pods reach the mix's `exact_pods`) it schedules the
cycle itself and counts

- `placement_mismatch`: pods whose outcome (bound at a node, reserved at
  a node, or pending) differs from the reference's;
- `victim_mismatch`: pods that one side's preemptions made victims and
  the other's did not.

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

from dataclasses import dataclass

import numpy as np

LIMITS = {
    "placement_mismatch": 0,
    "overcommitted_pods": 0,
    "stranded_pods": 0,
    "usage_gap_nodes": 0,
    "store_gap_pods": 0,
    "victim_mismatch": 0,
}


@dataclass
class Iteration:
    """One iteration as the run applied it: the uids it removed, the key
    of the records it added (the generator's `rebuild` makes them again),
    and the program's outcome: {uid: node} of the pods pending before its
    cycle that it bound, {uid: node} of the Permit reservations standing
    after it, {preemptor uid: (nominated node, [victim uids])} of its
    preemptions. Only strings and ints: the run's record adds nothing for
    the garbage collector to walk."""

    kind: str  # "warmup", "window" or "trace"
    removed: list
    added: tuple
    bound: dict
    reserved: dict
    preempted: dict
    attempted: int


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


def decide(cell, seed: int, iterations, snapshot_usage,
           store_placements) -> dict:
    """{number: value} of the comparison of a run of `cell`
    (`harness.Cell`); `correct` is every compared number at or under its
    limit. The cluster, the pods bound at set-up and the arrivals are made
    again from the seed."""
    config, mix = cell.config, cell.mix
    traffic, generator = cell.traffic(seed)
    ref = cell.reference.Reference(traffic.nodes,
                                   config["profile"]["plugins"])
    for rec in generator.fill():
        ref.add(rec)
    n = len(iterations)
    exact = exact_cycles(int(mix["exact_pods"]),
                         [it.attempted for it in iterations], seed)
    out = dict.fromkeys(LIMITS, 0)
    usage_before_last = None
    for k, it in enumerate(iterations):
        for uid in it.removed:
            ref.remove(uid)
        for rec in generator.rebuild(it.added):
            ref.add(rec)
        if k == n - 1:
            usage_before_last = ref.usage()
        pending = [p.uid for p in ref.pending()]
        over, stranded = ref.judge(it.bound, it.reserved, it.preempted,
                                   pending)
        out["overcommitted_pods"] += over
        if stranded is not None:
            out["stranded_pods"] += stranded
        if k in exact:
            bound, reserved, preempted = ref.cycle()
            out["placement_mismatch"] += placement_gap(
                bound, reserved, it.bound, it.reserved)
            out["victim_mismatch"] += len(victims(preempted)
                                          ^ victims(it.preempted))
        else:
            ref.apply(it.bound, it.reserved, it.preempted)
    out["usage_gap_nodes"] = usage_gap(ref, snapshot_usage,
                                       usage_before_last)
    out["store_gap_pods"] = sum(
        1 for uid in set(store_placements) | set(ref.where)
        if store_placements.get(uid) != (
            ref.names[ref.where[uid]] if uid in ref.where else None))
    out["cycles_compared_exactly"] = len(exact)
    out["cycles"] = n
    return out


def placement_gap(bound_a: dict, reserved_a: dict, bound_b: dict,
                  reserved_b: dict) -> int:
    """Pods whose outcome differs between two cycles: bound at another
    node, reserved at another node, or bound, reserved or pending on one
    side and not on the other."""
    uids = set(bound_a) | set(bound_b) | set(reserved_a) | set(reserved_b)
    return sum(1 for u in uids
               if (bound_a.get(u), reserved_a.get(u))
               != (bound_b.get(u), reserved_b.get(u)))


def victims(preempted: dict) -> set:
    """The victim uids of a cycle's preemptions."""
    return {uid for _, doomed in preempted.values() for uid in doomed}


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
