"""The control of the comparison: the plain reference put in the
program's place with one guarantee of the configuration broken, driven
through the same loop, traffic and comparison as a run. It has to come
out as not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>]

prints one JSON line a seed with the compared numbers. The benchmark's own
runs never run it; `tests/test_portbench_control.py` runs it at a cut
size, and on the card's machine it runs at the cell's own size."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class ControlSystem:
    """`program.System`'s interface over a reference with one guarantee
    broken (the configuration's `control`, the reference's `broken`
    switch): it keeps its own model, places each cycle itself, and
    reports its usage and placements as the program's would be read."""

    def __init__(self, cell, nodes, fill, device):
        config = cell.config
        self.ref = cell.reference.Reference(
            nodes, config["profile"]["plugins"],
            broken=config["control"])
        for rec in fill:
            self.ref.add(rec)
        self._usage = None

    def ingest(self, removals, records) -> None:
        for uid in removals:
            self.ref.remove(uid)
        for rec in records:
            self.ref.add(rec)

    def cycle(self, now_ms, candidates, timings=None):
        self._usage = self.ref.usage()
        return self.ref.cycle()

    def snapshot_usage(self):
        return list(self.ref.names), self._usage

    def placements(self) -> dict:
        return {uid: self.ref.names[i] for uid, i in self.ref.where.items()}

    def close(self) -> None:
        self.ref = None


def readings(cell, seed: int, seconds: float) -> dict:
    """The compared numbers of one control run of `cell`
    (`harness.load_cell`)."""
    from portbench import harness

    out = harness.drive(cell, seed, seconds, False, "cpu",
                        time.perf_counter(), system_factory=ControlSystem)
    numbers = dict(out["numbers"])
    numbers["correct"] = out["correct"]
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        numbers = readings(cell, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
