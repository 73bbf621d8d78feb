"""Cut runs of a cell on the CPU, for the benchmark's tests."""

import time

from portbench import harness
from portbench.traffic import load_json

#: cuts of each cell small enough for a CPU (scale keys only; every width
#: is the configuration's own)
SMALL = {
    "basic_5k.burst": {"nodes": 40, "init_pods": 8, "measure_pods": 300},
    "basic_5k.churn": {"nodes": 40, "pod_ceiling": 1200},
    "spread_5k.burst": {"nodes": 48, "init_pods": 48, "measure_pods": 120},
}

#: the churn cut's backlog: its 40 nodes hold 10 more pods each
SMALL_BACKLOG = 64


#: cells whose configuration and mix stay under portbench/ but that
#: BENCHMARK.json does not list (PERF.md says why): name -> (configuration
#: file, mix)
UNLISTED = {"basic_5k.burst": ("sched_perf_basic_5k", "burst"),
            "spread_5k.burst": ("sched_perf_spread_5k", "burst")}


def unlisted_cell(name, overrides):
    """An unlisted cell built from its files as `harness.load_cell` builds
    a listed one, with no metrics."""
    config_name, traffic = UNLISTED[name]
    pb = harness.ROOT / "portbench"
    config = load_json(pb / "configs" / f"{config_name}.json")
    config.update(overrides)
    mix = load_json(pb / "mixes" / f"{traffic}.json")
    generator = harness.load_module(
        harness.ROOT, "generators",
        mix.get("generator", harness.DEFAULT_GENERATOR))
    reference = harness.load_module(harness.ROOT, "reference",
                                    config["reference"])
    return harness.Cell(name, 1, config, mix, [], [], generator, reference)


def small_cell(name, bench_path=None):
    if name in UNLISTED and bench_path is None:
        cell = unlisted_cell(name, SMALL[name])
    else:
        cell = harness.load_cell(name, bench_path, SMALL[name])
    if cell.mix.get("backlog"):
        cell.mix["backlog"] = SMALL_BACKLOG
    return cell


def cpu_run(name, seed, seconds=0.5, system_factory=None):
    """A cut run of cell `name` on the CPU: the harness's drive with the
    look for a card skipped."""
    return harness.drive(small_cell(name), seed, seconds, False, "cpu",
                         time.perf_counter(), system_factory)
