"""A configuration, a mix, a generator, a reference and a metric dropped
into a copy of the tree are found by name, with no other file edited: the
control of a new configuration comes out as not correct, and a deployment
of gangs, quotas, priorities and node events runs through the harness
with its PodGroups and ElasticQuotas in the store, its reservations and
preemptions recorded, its victims deleted, and its records made again
for the reference exactly as the program got them."""

import json
import shutil
import time

from portbench import control, harness
from portbench.program import System

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
        arrivals = self.traffic.arrivals(n)
        return (list(loop.prev_arrivals), arrivals,
                (arrivals[0].creation_ms, n))

    def rebuild(self, key):
        return self.traffic.rebuild(*key)


def make(traffic, mix):
    return Steady(traffic, mix)
"""

#: gangs over a nearly full cluster (see its docstring)
GANGS = '''"""Gangs over a nearly full cluster: the namespaces' ElasticQuotas and
low-priority pods bound evenly at set-up; then each iteration one gang of 2 to 4
pods with its PodGroup (quorum: its size), every other one at a higher
priority than the fill. Besides, in the fourth iteration a gang of 10
whose last member no node fits (Coscheduling tolerates a quorum gap of
10 %, so its nine others stand reserved), from the fifth one
high-priority pod with no group (it preempts), in the sixth a node
added, and in the seventh a node drained (its pods deleted) and deleted.
No pod completes otherwise."""

from portbench.traffic import NodeDelete, NodeSpec, PodGroupSpec, QuotaSpec


class Gangs:
    def __init__(self, traffic, mix):
        self.traffic, self.mix = traffic, mix
        self.where = {}  # uid -> node of the pods bound, as the run went
        self.read = 0  # loop iterations folded into `where`
        self.serial = 0  # the last serial used

    def fill(self):
        t = self.traffic
        cfg = t.config
        names = [n.name for n in t.nodes]
        pods = [t.pod(cfg["init_pod_template"], names[i % len(names)])
                for i in range(int(cfg["init_pods"]))]
        self.where = {p.uid: p.node for p in pods}
        self.serial = len(pods)
        return [QuotaSpec(**q) for q in cfg["quotas"]] + pods

    def events(self, loop):
        for it in loop.iterations[self.read:]:
            for uid in it.removed:
                self.where.pop(uid, None)
            self.where.update(it.bound)
        self.read = len(loop.iterations)
        k = len(loop.iterations)
        size = int(self.traffic.rng["events"].integers(2, 5))
        removals, drain = [], ""
        if k == 6:
            held = set(loop.iterations[-1].reserved.values())
            drain = next(n.name for n in reversed(self.traffic.nodes)
                         if n.name not in held)
            removals = [u for u, n in self.where.items() if n == drain]
        key = (self.serial + 1, size, k % 2, int(k == 3), int(k >= 4),
               int(k == 5), drain)
        records = self.rebuild(key)
        self.serial += sum(1 for r in records if r.kind in ("pod", "node"))
        return removals, records, key

    def rebuild(self, key):
        serial, size, high, wide, solo, add, drain = key
        cfg = self.traffic.config
        tpl = dict(cfg["gang_pod_template"],
                   priority=cfg["high_priority"] if high else 0)
        out = []
        for n in ([size, 10] if wide else [size]):
            group = f"gang-{serial:08d}"
            out.append(PodGroupSpec(tpl["namespace"], group, n, serial))
            for j in range(n):
                member = tpl if j < 9 else dict(
                    tpl, cpu_millis=2 * cfg["node_template"]["cpu_millis"])
                out.append(self.traffic.pod_at(member, serial, group=group))
                serial += 1
        if solo:
            out.append(self.traffic.pod_at(
                dict(tpl, priority=cfg["high_priority"]), serial))
            serial += 1
        if add:
            node = cfg["node_template"]
            out.append(NodeSpec(f"added-{serial:08d}", node["cpu_millis"],
                                node["memory_bytes"], node["pods"], {}))
        if drain:
            out.append(NodeDelete(drain))
        return out


def make(traffic, mix):
    return Gangs(traffic, mix)
'''

#: a test-only reference: it keeps what it is handed, in order, and
#: judges nothing
RECORDER = """
class Reference:
    instances = []

    def __init__(self, nodes, plugins, broken=None):
        self.names = [n.name for n in nodes]
        self.where = {}
        self.handed = []
        Reference.instances.append(self)

    def add(self, record):
        self.handed.append(("add", record))

    def remove(self, uid):
        self.handed.append(("remove", uid))

    def pending(self):
        return []

    def judge(self, bound, reserved, preempted, pending):
        self.handed.append(("outcome", (bound, reserved, preempted)))
        return 0, None

    def cycle(self):
        return {}, {}, {}

    def apply(self, bound, reserved, preempted):
        pass

    def usage(self):
        import numpy as np

        return np.zeros((len(self.names), 3), dtype=np.int64)
"""

from pbhelpers import SMALL

ROOT = harness.ROOT


def copy_tree(tmp_path) -> dict:
    """BENCHMARK.json and portbench/ copied under `tmp_path`: {path: bytes}
    of every file copied."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return {p.relative_to(tmp_path): p.read_bytes()
            for p in tmp_path.rglob("*") if p.is_file()}


def assert_unchanged(tmp_path, before: dict) -> None:
    for rel, data in before.items():
        if rel.name != "BENCHMARK.json":
            assert (tmp_path / rel).read_bytes() == data, rel


def test_new_files_are_found_by_name(tmp_path):
    before = copy_tree(tmp_path)
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
    assert_unchanged(tmp_path, before)


class Kept(System):
    """The program, keeping what it applied and what its store held."""

    applied = []  # ("add", record) and ("remove", uid), in order
    held = {}

    def __init__(self, cell, nodes, fill, device):
        Kept.applied = []  # the fill comes through `ingest`
        super().__init__(cell, nodes, fill, device)

    def ingest(self, removals, records):
        Kept.applied += [("remove", uid) for uid in removals]
        Kept.applied += [("add", rec) for rec in records]
        super().ingest(removals, records)

    def close(self):
        Kept.held = {"pod_groups": set(self.cluster.pod_groups),
                     "quotas": set(self.cluster.quotas),
                     "nodes": list(self.cluster.nodes)}
        super().close()


def test_gang_quota_and_node_events_as_new_files(tmp_path):
    before = copy_tree(tmp_path)
    pb = tmp_path / "portbench"
    node = {"name_prefix": "gang-node-", "cpu_millis": 4000,
            "memory_bytes": 17179869184, "pods": 110}
    pod = {"name_prefix": "pod-", "cpu_millis": 1000,
           "memory_bytes": 1073741824}
    config = {
        "name": "gangs_dropin", "nodes": 40, "init_pods": 120,
        "node_template": node,
        "node_labels": {"kubernetes.io/hostname": "{name}"},
        "init_pod_template": dict(pod, name_prefix="init-pod-",
                                  namespace="team-b"),
        "gang_pod_template": dict(pod, name_prefix="gang-pod-",
                                  namespace="team-a"),
        "high_priority": 100,
        "quotas": [
            {"namespace": "team-a", "min_cpu_millis": 120000,
             "min_memory_bytes": 1 << 40, "max_cpu_millis": 160000,
             "max_memory_bytes": 1 << 41},
            {"namespace": "team-b", "min_cpu_millis": 40000,
             "min_memory_bytes": 1 << 40, "max_cpu_millis": 160000,
             "max_memory_bytes": 1 << 41}],
        "profile": {"plugins": ["NodeResourcesAllocatable", "Coscheduling",
                                "CapacityScheduling"]},
        "reference": "recorder",
        "compared": ["placement_mismatch", "victim_mismatch"],
    }
    (pb / "configs" / "gangs_dropin.json").write_text(json.dumps(config))
    mix = {"name": "gangs", "generator": "gangs", "stream_chunk": None,
           "serve": False, "exact_pods": 0, "warmup_iterations": 2}
    (pb / "mixes" / "gangs.json").write_text(json.dumps(mix))
    (pb / "generators" / "gangs.py").write_text(GANGS)
    (pb / "reference" / "recorder.py").write_text(RECORDER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "gangs_dropin", "source": "https://example.org/gangs",
        "file": "portbench/configs/gangs_dropin.json", "reduced": [],
        "why": "a drop-in"})
    bench["workloads"].append({
        "name": "gangs.dropin", "config": "gangs_dropin", "traffic": "gangs",
        "chips": 1, "why": "a drop-in"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("gangs.dropin", tmp_path / "BENCHMARK.json")
    out = harness.drive(cell, 13, 2.0, False, "cpu", time.perf_counter(),
                        system_factory=Kept)
    assert out["numbers"]["cycles"] >= 8, out["numbers"]
    (ref,) = cell.reference.Reference.instances
    handed = [h for h in ref.handed if h[0] != "outcome"]
    outcomes = [h[1] for h in ref.handed if h[0] == "outcome"]
    added = [r for kind, r in Kept.applied if kind == "add"]

    # the comparison made the generator's records again, in the order the
    # program got them
    assert handed == Kept.applied
    # the store held every PodGroup and quota the generator made, and the
    # node events
    assert Kept.held["pod_groups"] == {
        f"{r.namespace}/{r.name}" for r in added if r.kind == "pod_group"}
    assert Kept.held["quotas"] == {"team-a", "team-b"}
    added_nodes = [r.name for r in added if r.kind == "node"]
    deleted = [r.name for r in added if r.kind == "node_delete"]
    assert len(added_nodes) == 1 and len(deleted) == 1
    assert added_nodes[0] in Kept.held["nodes"]
    assert deleted[0] not in Kept.held["nodes"]
    # reservations stood, and were handed to the reference
    assert any(reserved for _, reserved, _ in outcomes)
    # the harness played the kubelet: each cycle's victims were the first
    # removals of the next iteration, and no removal drew them again
    removals = [[]]  # each iteration's, handed ahead of its outcome
    for kind, item in ref.handed:
        if kind == "outcome":
            removals.append([])
        elif kind == "remove":
            removals[-1].append(item)
    victims = [sorted(v for _, doomed in pre.values() for v in doomed)
               for _, _, pre in outcomes]
    assert any(victims)
    for k, doomed in enumerate(victims[:-1]):
        assert sorted(removals[k + 1][:len(doomed)]) == doomed
        later = [u for r in removals[k + 2:] for u in r]
        assert not set(doomed) & set(later)
    assert_unchanged(tmp_path, before)
