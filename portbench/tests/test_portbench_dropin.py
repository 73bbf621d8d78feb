"""A configuration, a mix, a generator and a metric dropped into a copy of
the tree are found by name, with no other file edited, and the control
of the new configuration comes out as not correct."""

import json
import shutil
import time

from portbench import control, harness

#: a generator of a kind the closed loop does not have: an empty cluster,
#: then a fixed number of arrivals an iteration, each iteration's
#: arrivals completing in the next
STEADY = """
class Steady:
    def __init__(self, traffic, mix):
        self.traffic, self.mix = traffic, mix

    def fill(self):
        return []

    def events(self, loop):
        n = 1 if loop.warming else int(self.mix["per_iteration"])
        return list(loop.prev_arrivals), self.traffic.arrivals(n)


def make(traffic, mix):
    return Steady(traffic, mix)
"""

from pbhelpers import SMALL

ROOT = harness.ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "sched_perf_basic_5k.json")
                        .read_text())
    config["name"] = "tiny_dropin"
    config.update(SMALL["basic_5k.burst"])
    (pb / "configs" / "tiny_dropin.json").write_text(json.dumps(config))
    mix = {"name": "dropin_mix", "generator": "steady", "per_iteration": 300,
           "stream_chunk": 128, "serve": False, "exact_pods": 10 ** 9,
           "warmup_iterations": 2}
    (pb / "mixes" / "dropin_mix.json").write_text(json.dumps(mix))
    (pb / "generators" / "steady.py").write_text(STEADY)
    (pb / "metrics" / "cycles_run.py").write_text(
        "def read(record):\n    return len(record.window_cycles)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny_dropin", "source": "https://example.org/tiny",
        "file": "portbench/configs/tiny_dropin.json", "reduced": ["nodes"],
        "why": "a drop-in"})
    bench["workloads"].append({
        "name": "tiny.dropin", "config": "tiny_dropin",
        "traffic": "dropin_mix", "chips": 1, "why": "a drop-in"})
    bench["per_layer"].append({
        "name": "cycles_run", "unit": "cycles", "better": "higher",
        "source": "host_clock", "layer": "cycle", "moves": "pods_per_s",
        "workloads": ["tiny.dropin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("tiny.dropin", tmp_path / "BENCHMARK.json")
    assert cell.config["nodes"] == 40 and cell.mix["name"] == "dropin_mix"
    out = harness.drive(cell, 9, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"], out["numbers"]
    assert out["record"].window_bound >= 300
    assert not control.readings(cell, 9, 0.3)["correct"]
    metrics = harness.metrics_of(cell, out["record"], True, tmp_path)
    assert metrics["cycles_run"]["value"] >= 1
    # per-layer readers with nothing to read (no profile) return nothing
    assert "device_idle_pct" not in metrics
    assert "pods_per_s" in harness.metrics_of(cell, out["record"], False,
                                              tmp_path)
    # no file that was there changed
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel
