"""One run of one cell: find its files by name, build the cluster from the
seed, warm up, measure for `seconds`, profile one more iteration when
tracing, and hand the record to the comparison.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<file>`, from the `configs` entry), whose `reference` key names
its plain reference (`reference/<name>.py`), and a traffic mix
(`mixes/<traffic>.json`), whose `generator` key names its generator
(`generators/<name>.py`, default `closed_loop`); each metric is
`metrics/<name>.py`, a reader with `read(record) -> float | None`. Adding
a cell, a configuration, a mix, a generator, a reference or a metric is
adding files and entries: nothing here names one. The records a
generator may make (pods with their namespace, priority and PodGroup,
PodGroups, ElasticQuotas, node adds and deletes) are `traffic`'s."""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from portbench import check
from portbench.traffic import SCALE_KEYS, BoundSet, Traffic, load_json

#: the generator of a mix that names none
DEFAULT_GENERATOR = "closed_loop"

ROOT = Path(__file__).resolve().parent.parent

#: `run_cycle`'s stages in the order it runs them (`timings` keys)
CYCLE_STAGES = ("open", "pending", "snapshot", "solve", "fence", "bind",
                "postbind", "finalize")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    generator: object  # the mix's generator module
    reference: object  # the configuration's reference module

    def traffic(self, seed: int):
        """(the `Traffic` of `seed`, the mix's generator over it)"""
        traffic = Traffic(self.config, seed)
        return traffic, self.generator.make(traffic, self.mix)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = None, overrides=None) -> Cell:
    """The cell `name` of `BENCHMARK.json`, its configuration and mix
    loaded; `overrides` replaces scale keys of the configuration (tests)."""
    bench_path = bench_path or ROOT / "BENCHMARK.json"
    bench = load_json(bench_path)
    root = bench_path.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    for key, value in (overrides or {}).items():
        if key not in SCALE_KEYS:
            raise ValueError(f"{key!r} is not a scale key")
        config[key] = value
    mix = load_json(root / "portbench" / "mixes" / f"{cell['traffic']}.json")
    generator = load_module(root, "generators",
                            mix.get("generator", DEFAULT_GENERATOR))
    return Cell(name, int(cell["chips"]), config, mix,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                generator, load_module(root, "reference",
                                       config["reference"]))


def load_module(root: Path, folder: str, name: str):
    """`portbench/<folder>/<name>.py` of the tree at `root`, loaded."""
    path = root / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(name: str, record, root: Path = ROOT):
    """`metrics/<name>.py`'s `read(record)`: a number, or None when the
    record holds nothing for it."""
    return load_module(root, "metrics", name).read(record)


@dataclass
class Record:
    """What the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    window_bound: int = 0
    window_attempted: int = 0
    window_cycles: list = field(default_factory=list)  # timings dicts
    ingest_s: float = 0.0  # the window's arrivals and completions
    ingest_pods: int = 0  # pods that arrived in the window
    profile: dict | None = None  # the traced iteration (`trace`)
    #: set-up's parts in seconds: to the harness's first step (imports),
    #: the cluster built, the warm-up iteration
    setup_parts: dict = field(default_factory=dict)
    #: the interpreter's cyclic garbage collector in the window: seconds,
    #: and the full (generation 2) collections among them
    gc_s: float = 0.0
    gc_gen2: int = 0
    #: the comparison's seconds, after the window (not in `setup_s`)
    check_s: float = 0.0
    #: each window iteration's seconds, ingest and cycle (the first ones
    #: show whether anything still warms up inside the window)
    iteration_s: list = field(default_factory=list)


class GcClock:
    """Times the cyclic garbage collector's passes while installed."""

    def __init__(self, record: Record):
        self.record = record
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        self.record.gc_s += time.perf_counter() - self._t0
        self.record.gc_gen2 += info["generation"] == 2

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


class Loop:
    """The loop of one run: each iteration deletes pods and adds records,
    both as the mix's generator chooses and through the store's mutators,
    then runs one cycle.
    It keeps uids, counts and the generator's keys only: the generator's
    records are made for an iteration and dropped, and the comparison
    makes them again from the keys.

    The mix's generator reads from it: `warming` (set-up's warm-up
    iterations), `pending` (uids of pods arrived and not bound: those the
    store holds reserved for Permit among them), `bound` (the bound pods'
    `BoundSet`), `prev_arrivals` (the uids of the pods the last iteration
    added), `last_bound` (pods the last cycle bound), `iterations` and
    `elapsed_s()` (seconds since the run started).

    The harness plays the kubelet: the victims a cycle's preemptions mark
    terminating leave `bound` and `pending` at once, so no completion
    draws them, and are deleted through `remove_pod` at the start of the
    next iteration's ingest, first among its removals.

    The store's clock is the run's own: the milliseconds since it
    started, as a daemon's tick passes the time it runs at."""

    def __init__(self, cell: Cell, seed: int, system_factory, device,
                 t_start: float):
        self.t_start = t_start
        self.traffic, self.generator = cell.traffic(seed)
        fill = self.generator.fill()
        self.system = system_factory(cell, self.traffic.nodes, fill, device)
        self.bound = BoundSet()
        for rec in fill:
            if rec.kind == "pod":
                self.bound.add(rec.uid)
        self.pending: dict = {}  # uid -> None: arrived and not bound
        self.iterations: list = []
        self.prev_arrivals: list = []  # uids
        self.last_bound = 0
        self.victims: list = []  # uids the last cycle marked terminating
        self.warming = False

    def elapsed_s(self) -> float:
        return time.perf_counter() - self.t_start

    def events(self) -> tuple:
        """The next iteration's (removals, arrivals, key): the
        generator's, the last cycle's victims first among the removals."""
        removals, arrivals, key = self.generator.events(self)
        if self.victims:
            doomed = set(self.victims)
            removals = self.victims + [u for u in removals
                                       if u not in doomed]
            self.victims = []
        return removals, arrivals, key

    def ingest(self, removals, arrivals) -> tuple:
        """(seconds in the store's mutators, uids of the pods among the
        arrivals)"""
        t0 = time.perf_counter()
        self.system.ingest(removals, arrivals)
        spent = time.perf_counter() - t0
        for uid in removals:
            self.pending.pop(uid, None)
            self.bound.discard(uid)
        pods = [rec.uid for rec in arrivals if rec.kind == "pod"]
        for uid in pods:
            self.pending[uid] = None
        return spent, pods

    def cycle(self, kind: str, removals, key, pods, timings=None) -> int:
        candidates = list(self.pending)
        now = int(self.elapsed_s() * 1e3)
        bound, reserved, preempted = self.system.cycle(now, candidates,
                                                       timings)
        for uid in bound:
            self.pending.pop(uid, None)
            self.bound.add(uid)
        for _, doomed in preempted.values():
            for uid in doomed:
                self.pending.pop(uid, None)
                self.bound.discard(uid)
                self.victims.append(uid)
        self.iterations.append(check.Iteration(
            kind, list(removals), key, bound, reserved, preempted,
            len(candidates)))
        self.prev_arrivals = pods
        self.last_bound = len(bound)
        return len(bound)

    def iterate(self, kind: str, record: Record | None = None) -> int:
        t0 = time.perf_counter()
        removals, arrivals, key = self.events()
        spent, pods = self.ingest(removals, arrivals)
        timings = {} if record is not None else None
        placed = self.cycle(kind, removals, key, pods, timings)
        if record is not None:
            record.iteration_s.append(time.perf_counter() - t0)
            record.ingest_s += spent
            record.ingest_pods += len(pods)
            record.window_cycles.append(timings)
            record.window_bound += placed
            record.window_attempted += self.iterations[-1].attempted
        return placed

    def traced(self, record: Record, device) -> None:
        """One more iteration under `torch.profiler`: the device's busy
        time, the host's launches and the breakdown by host stage."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import profiling

        on_card = torch.device(device).type == "cuda"
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        removals, arrivals, key = self.events()
        timings = {}
        with profile(activities=activities) as prof:
            with record_function("portbench.ingest"):
                _, pods = self.ingest(removals, arrivals)
            with record_function("portbench.cycle"):
                placed = self.cycle("trace", removals, key, pods, timings)
                if on_card:
                    torch.cuda.synchronize(device)
        records = profiling.profile_records(prof)
        # the ranges of `record_function` show on the device's timeline
        # too: they are not device work
        ranges = profiling.annotation_names(prof)
        records = [r for r in records if not (r[1] and r[0] in ranges)]
        marks = {name: (s, e) for name, on_dev, s, e, _ in records
                 if not on_dev and name.startswith("portbench.")}
        t0 = marks["portbench.ingest"][0]
        c0, t1 = marks["portbench.cycle"]
        stages = profiling.stage_spans(c0, CYCLE_STAGES, timings,
                                       marks["portbench.ingest"])
        intervals = profiling.device_intervals(records, t0, t1)
        busy = profiling.busy_ns(intervals)
        gaps = profiling.idle_gaps(intervals, t0, t1)
        record.profile = {
            "pods": placed,
            "work_calls": profiling.work_calls(records, t0, t1),
            "busy_s": busy / 1e9,
            "window_s": (t1 - t0) / 1e9,
            "device_records": len(intervals),
            "breakdown": profiling.breakdown(intervals, gaps, stages),
        }


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, system_factory=None) -> dict:
    """The run: set-up (the cluster from the seed, the mix's warm-up
    iterations), the window, the traced iteration, then the comparison
    once the program's state is freed. Returns the record, the device's
    peak memory, the compared numbers and the verdict."""
    import torch

    if system_factory is None:
        from portbench.program import System as system_factory
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    record = Record()
    t_built = time.perf_counter()
    loop = Loop(cell, seed, system_factory, device, t_start)
    t_warm = time.perf_counter()
    # the window's own shape, cut by the generator: the first iteration
    # only adds, the next completes and adds, so every path the window
    # takes has run
    loop.warming = True
    for _ in range(int(cell.mix["warmup_iterations"])):
        loop.iterate("warmup")
    loop.warming = False
    if on_card:
        torch.cuda.synchronize(device)
    # the set-up's garbage collected before the window, not inside it
    gc.collect()
    t0 = time.perf_counter()
    record.setup_s = t0 - t_start
    record.setup_parts = {"start": t_built - t_start,
                          "build": t_warm - t_built, "warmup": t0 - t_warm}
    with GcClock(record):
        while time.perf_counter() - t0 < seconds:
            loop.iterate("window", record)
    if on_card:
        torch.cuda.synchronize(device)
    record.window_s = time.perf_counter() - t0
    if trace:
        loop.traced(record, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the program's outputs, then its state freed before the reference
    usage = loop.system.snapshot_usage()
    store = loop.system.placements()
    loop.system.close()
    loop.system = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.decide(cell, seed, loop.iterations, usage, store)
    record.check_s = time.perf_counter() - t_check
    # pods neither bound nor held by a Permit reservation
    failed = sum(it.attempted - len(it.bound) - len(it.reserved)
                 for it in loop.iterations if it.kind == "window")
    return {"record": record, "peak": peak, "numbers": numbers,
            "correct": check.correct(numbers, cell.config),
            "attempted": record.window_attempted, "failed": failed}


def metrics_of(cell: Cell, record: Record, trace: bool, root: Path = ROOT):
    """{name: {"value", "unit"}} of the cell's end-to-end metrics (trace
    off) or per-layer metrics (trace on), each from its reader."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], record, root)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown, numbers: dict, config: dict) -> str:
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": numbers[k], "limit": lim}
                      for k, lim in check.compared(config).items()}
    return json.dumps(line)
