"""The records a run makes are pinned: for each cell's cut, on three
seeds, the nodes and the records of set-up, then the first iterations'
removals and records, driven by the control on the CPU, digest to the
constants below. They were taken before the harness learnt PodGroups,
ElasticQuotas, node events, Permit reservations and preemption victims,
so the cells still build the same records; churn's iterations were taken
again when its mix's warm-up grew to the window's full backlog (its
set-up digest is the old one).
The comparison makes each iteration's records again, through the mix's
generator, exactly as the run applied them."""

import hashlib
import time

import pytest

from portbench import check, control, harness
from portbench.traffic import NodeSpec, PodSpec

from pbhelpers import SMALL, small_cell

ITERATIONS = 6

#: (cell, seed) -> (digest of the nodes and set-up's records, digest of
#: the first ITERATIONS iterations' removals and records)
DIGESTS = {
    ("basic_5k.burst", 0): ("aa7653f923d4ec7edc7859c7135cb171",
                            "27baf947749495fef607bab176fabc22"),
    ("basic_5k.burst", 1): ("7a9e40e0c2a7d7f525ef51607d7173a0",
                            "27baf947749495fef607bab176fabc22"),
    ("basic_5k.burst", 2): ("8a248b048692ed2c999bd3f4fe563fbc",
                            "27baf947749495fef607bab176fabc22"),
    ("basic_5k.churn", 0): ("d8c1aa698baf9fcc127e1f0960e8f6b2",
                            "d724b043b23237c7cf969734ed4afb41"),
    ("basic_5k.churn", 1): ("d8c1aa698baf9fcc127e1f0960e8f6b2",
                            "cf2b295a034ad15283781e55a2abd24f"),
    ("basic_5k.churn", 2): ("d8c1aa698baf9fcc127e1f0960e8f6b2",
                            "91afb25e06660739412d543cadc78c42"),
    ("spread_5k.burst", 0): ("f61b5d245208818a38dcd91371c5664f",
                             "1e43f79aea7831ff7ac5f45578888bf6"),
    ("spread_5k.burst", 1): ("e90aa0c7c04b7e41a9633952dbdcb952",
                             "1e43f79aea7831ff7ac5f45578888bf6"),
    ("spread_5k.burst", 2): ("063d5cf037d3b48096f5f278334561db",
                             "1e43f79aea7831ff7ac5f45578888bf6"),
}


def canon(rec):
    """A record as plain values: every field the pinned records had. The
    fields added since (a pod's PodGroup) must be at their defaults."""
    if isinstance(rec, NodeSpec):
        return ("node", rec.name, rec.cpu_millis, rec.memory_bytes, rec.pods,
                tuple(sorted(rec.labels.items())))
    assert isinstance(rec, PodSpec), rec
    assert rec.group is None, rec
    return ("pod", rec.uid, rec.name, rec.namespace, rec.creation_ms,
            rec.priority, rec.cpu_millis, rec.memory_bytes,
            tuple(sorted(rec.labels.items())), rec.spread, rec.node)


def digest(items) -> str:
    h = hashlib.sha256()
    for item in items:
        h.update(repr(item).encode())
        h.update(b"\n")
    return h.hexdigest()[:32]


class Recording(control.ControlSystem):
    """The control, keeping every record it is handed, in order."""

    def __init__(self, cell, nodes, fill, device):
        super().__init__(cell, nodes, fill, device)
        self.seen = [("nodes", [canon(n) for n in nodes]),
                     ("fill", [canon(p) for p in fill])]

    def ingest(self, removals, records):
        self.seen.append(("removed", list(removals)))
        self.seen.append(("added", [canon(p) for p in records]))
        super().ingest(removals, records)


def run(cell, seed):
    """The loop after set-up's warm-up iterations and the window's first,
    ITERATIONS in all, as `harness.drive` runs them."""
    loop = harness.Loop(cell, seed, Recording, "cpu", time.perf_counter())
    warm = int(cell.mix["warmup_iterations"])
    for k in range(ITERATIONS):
        loop.warming = k < warm
        loop.iterate("warmup" if k < warm else "window")
    return loop


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_are_as_pinned(name, seed):
    seen = run(small_cell(name), seed).system.seen
    assert (digest(seen[:2]), digest(seen[2:])) == DIGESTS[(name, seed)]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_comparison_rebuilds_what_the_run_applied(name):
    cell = small_cell(name)
    loop = run(cell, 7)
    applied = [("add", rec) for rec in loop.system.seen[1][1]]
    for kind, items in loop.system.seen[2:]:
        applied += [("remove" if kind == "removed" else "add", x)
                    for x in items]
    handed = []

    class Spy(cell.reference.Reference):
        def add(self, record):
            handed.append(("add", canon(record)))
            super().add(record)

        def remove(self, uid):
            handed.append(("remove", uid))
            super().remove(uid)

    cell.reference = type("SpyModule", (), {"Reference": Spy})
    numbers = check.decide(cell, 7, loop.iterations, None, {})
    assert numbers["cycles"] == ITERATIONS
    assert handed == applied
