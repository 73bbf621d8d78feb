"""The port's flight recorder (`scheduler_plugins_tpu_torch.utils.flightrec`:
the ring, bundles, replay and explain, through every cycle engine) against
the JAX package's, on the CPU.

- The JAX classes of `tests/test_flightrec.py` (TestRecorderRing,
  TestBundleRoundTrip, TestHostStateRestore, TestGoldenFixture and the
  crash-safe save order) run again on the port, every JAX name they call
  swapped for the port's; the static-fields round trip, which walks JAX
  pytrees, is re-stated over the port's structs.
- The JAX recorder seams run on the port the same way:
  `tests/test_gangs.py` TestFlightRecorderSeam and `tests/test_serving.py`
  TestServeFlightRecorder; the packing label of `tests/test_packing.py`
  is re-stated on the port's packing scenario.
- One deterministic cluster goes through JAX's `run_cycle` and the
  port's with both recorders on: the manifests agree field by field but
  for `NAMED_DIFFERENCES`, and both recorded assignments equal the
  committed golden bundle's.
- Two served cycles: every saved blob loads with its digest intact (a
  record must hold copies, never views of the resident columns).
- `PipelinedCycle` and `LanedCycle` record the same cycles as `run_cycle`
  (equal digests), and their records replay bit-identically.
- The replay tool (`scheduler_plugins_tpu_torch.tools.replay`) on the
  golden bundle."""

import dataclasses
import inspect
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.models as port_models
import scheduler_plugins_tpu_torch.plugins as port_plugins
import scheduler_plugins_tpu_torch.utils.observability as port_obs
from scheduler_plugins_tpu_torch.api import resources as port_resources
from scheduler_plugins_tpu_torch.api.config import load_profile
from scheduler_plugins_tpu_torch.framework import (
    LanedCycle,
    PipelinedCycle,
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.serving import (
    ServeEngine as PServeEngine,
    StreamingServeEngine,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.tools import replay as port_tool
from scheduler_plugins_tpu_torch.utils import flightrec as pf

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.models as jax_models
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.utils as jax_utils
    import scheduler_plugins_tpu.utils.flightrec as jax_flightrec
    import tests.test_flightrec as jax_fr_tables
    import tests.test_gangs as jax_gang_tables
    import tests.test_serving as jax_serving_tables
    import tools.replay as jax_tool
    from scheduler_plugins_tpu.framework import run_cycle as j_run_cycle
except ImportError:
    jax_objects = None

CPU = "cpu"
GIB = 1 << 30

#: manifest fields a port record and a JAX record of the same cycle may
#: differ in, each with its reason; every other field must be equal
NAMED_DIFFERENCES: dict = {}


@pytest.fixture
def jax_package():
    if jax_objects is None:
        pytest.skip("the JAX package is not importable here")


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    pf.recorder.stop()


def _run(s, c, now=None, **kw):
    return port_cycle.run_cycle(s, c, now=now, device=CPU, **kw)


class _CPULoaded(pf.LoadedCycle):
    """A bundle cycle whose entry points default to the CPU."""

    def scheduler(self, device=CPU):
        return super().scheduler(device)

    def meta(self, device=CPU):
        return super().meta(device)


def _cpu_load_bundle(directory):
    return [_CPULoaded(lc.manifest, lc._blob_dir)
            for lc in pf.load_bundle(directory)]


#: the port's flight recorder, its entry points on the CPU
PORT_FLIGHTREC = SimpleNamespace(
    recorder=pf.recorder,
    load_bundle=_cpu_load_bundle,
    replay_cycle=lambda lc: pf.replay_cycle(lc, device=CPU),
    explain_record=lambda rec, uid, **kw: pf.explain_record(
        rec, uid, device=CPU, **kw),
    array_digest=pf.array_digest,
    pack_pytree=pf.pack_pytree,
    unpack_pytree=pf.unpack_pytree,
    record_digest=pf.record_digest,
)


class _CPUEngine(PServeEngine):
    def refresh(self, cluster, pending, now_ms=0, *, device=CPU):
        return super().refresh(cluster, pending, now_ms, device=device)


def _swap_flightrec(monkeypatch):
    """Body imports of the JAX recorder (`from scheduler_plugins_tpu.utils
    import flightrec`, `... .flightrec import unpack_pytree`) reach the
    port's."""
    monkeypatch.setattr(jax_utils, "flightrec", PORT_FLIGHTREC)
    monkeypatch.setattr(jax_flightrec, "unpack_pytree", pf.unpack_pytree)


def _call(obj, method, tmp_path, monkeypatch):
    """A JAX test method with its fixtures supplied by hand."""
    fn = getattr(obj, method)
    params = inspect.signature(fn).parameters
    kwargs = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
              "recorder_off": None}
    fn(**{k: v for k, v in kwargs.items() if k in params})


# --- the JAX recorder tables on the port -----------------------------------

#: cases of `tests/test_flightrec.py` that walk JAX pytrees (re-stated
#: below) or exercise JAX-only machinery
_NOT_ON_PORT = {"test_pack_unpack_preserves_static_fields"}


def _tables():
    if jax_objects is None:
        return []
    classes = [jax_fr_tables.TestRecorderRing,
               jax_fr_tables.TestBundleRoundTrip,
               jax_fr_tables.TestHostStateRestore,
               jax_fr_tables.TestGoldenFixture]
    cases = [(cls, name) for cls in classes for name in sorted(vars(cls))
             if name.startswith("test_") and name not in _NOT_ON_PORT]
    cases.append((jax_fr_tables.TestAtomicWrites,
                  "test_bundle_save_is_crash_safe_order"))
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls, name in cases]


@pytest.mark.parametrize("cls,method", _tables())
def test_recorder_table_against_port(cls, method, tmp_path, monkeypatch):
    """Each case, with every JAX name it calls, at module level and in its
    body's imports, swapped for the port's (entry points on the CPU)."""
    swaps = {
        "Cluster": PCluster,
        "Profile": PProfile,
        "Scheduler": PScheduler,
        "run_cycle": _run,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "Coscheduling": port_plugins.Coscheduling,
        "CapacityScheduling": port_plugins.CapacityScheduling,
        "flightrec": PORT_FLIGHTREC,
        "obs": port_obs,
        "CPU": port_resources.CPU,
        "MEMORY": port_resources.MEMORY,
        "PODS": port_resources.PODS,
    }
    for name in ("Container", "Node", "Pod", "PodGroup", "POD_GROUP_LABEL"):
        swaps[name] = getattr(port_objects, name)
    for name, value in swaps.items():
        monkeypatch.setattr(jax_fr_tables, name, value)
    monkeypatch.setattr(jax_models, "mixed_scenario",
                        port_models.mixed_scenario)
    for name in ("NetworkOverhead", "NodeResourceTopologyMatch"):
        monkeypatch.setattr(jax_plugins, name, getattr(port_plugins, name))
    monkeypatch.setattr(jax_tool, "validate_explain",
                        port_tool.validate_explain)
    _call(cls(), method, tmp_path, monkeypatch)


def _leaves(value, path=""):
    """(path, array) for every array of a snapshot struct tree."""
    if dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from _leaves(getattr(value, f.name), f"{path}.{f.name}")
    elif isinstance(value, torch.Tensor):
        yield path, value.numpy()
    elif isinstance(value, np.ndarray):
        yield path, value


def test_pack_unpack_preserves_static_fields():
    """`NumaState.pack_scales` (a host tuple) and the scheduling table's
    host bool survive the round trip, and every array comes back equal
    in dtype and value (`tests/test_flightrec.py`'s case, over the port's
    structs)."""
    cluster = port_models.mixed_scenario(n_nodes=8, n_pods=16)
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    snap, _ = cluster.snapshot(pending, now_ms=0, device=CPU)
    blobs = {}
    rebuilt = pf.unpack_pytree(pf.pack_pytree(snap, blobs), blobs)
    assert type(rebuilt) is type(snap)
    assert snap.numa is not None and snap.scheduling is not None
    assert rebuilt.numa.pack_scales == snap.numa.pack_scales
    assert (rebuilt.scheduling.spread_needs_node_counts
            == snap.scheduling.spread_needs_node_counts)
    got, want = dict(_leaves(rebuilt)), dict(_leaves(snap))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg=path)


# --- the JAX seams on the port ---------------------------------------------

def test_gang_seam_against_port(jax_package, monkeypatch):
    """`tests/test_gangs.py` TestFlightRecorderSeam: a recorded gang
    cycle's capture replays bit-identically through the numpy twin."""
    import test_torch_gangs

    _swap_flightrec(monkeypatch)
    test_torch_gangs.test_decision_table_against_port(
        jax_gang_tables.TestFlightRecorderSeam,
        "test_recorded_gang_cycle_replays_bit_identically", monkeypatch)


def test_serve_seam_against_port(jax_package, tmp_path, monkeypatch):
    """`tests/test_serving.py` TestServeFlightRecorder: served cycles
    record their provenance (rebase, then delta with the packed batch) and
    replay through the standard path."""
    _swap_flightrec(monkeypatch)
    swaps = {"Cluster": PCluster, "Profile": PProfile,
             "Scheduler": PScheduler, "run_cycle": _run,
             "ServeEngine": _CPUEngine,
             "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable}
    for name in ("Container", "Node", "Pod"):
        swaps[name] = getattr(port_objects, name)
    for name, value in swaps.items():
        monkeypatch.setattr(jax_serving_tables, name, value)
    jax_serving_tables.TestServeFlightRecorder(
    ).test_serve_cycles_record_replayably(tmp_path)


def test_packing_cycle_is_labelled_packing():
    """`tests/test_packing.py` TestPackingCycle: the recorder labels a
    packing cycle's outputs "packing" (replayed as evidence, never as a
    sequential anchor) and records the profile's solve mode."""
    cluster, _, _, _ = port_models.packing_scenario(
        24, 0.85, 0.15, seed=0, device=CPU)
    profile = load_profile({
        "profileName": "pack",
        "plugins": ["NodeResourcesAllocatable"],
        "solveMode": "packing",
        "packingConfig": {"iterations": 8},
    })
    pf.recorder.start(capacity=4)
    report = _run(PScheduler(profile), cluster, now=1000)
    rec = pf.recorder.records()[-1]
    assert report.bound and report.quality is not None
    assert rec.manifest["outputs"]["mode"] == "packing"
    assert rec.manifest["profile_config"]["solveMode"] == "packing"


# --- the same cycle through both packages ----------------------------------

def _manifest_diffs(a, b, path=""):
    """Paths where two manifests differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            sub = f"{path}/{k}"
            if k not in a or k not in b:
                out.append(sub)
            else:
                out += _manifest_diffs(a[k], b[k], sub)
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _manifest_diffs(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def test_manifest_equals_jax_record(jax_package, monkeypatch):
    """JAX's `run_cycle` and the port's record the golden cluster: the
    manifests agree field by field but for `NAMED_DIFFERENCES` (same
    array digests, dtypes, meta, plugins, outputs and report), and both
    recorded assignments are the golden bundle's."""
    jax_flightrec.recorder.start(capacity=1)
    try:
        j_run_cycle(jax_fr_tables.make_scheduler(),
                    jax_fr_tables.make_cluster(), now=1000)
        want = jax_flightrec.recorder.records()[0].to_manifest()
    finally:
        jax_flightrec.recorder.stop()

    for name in ("Container", "Node", "Pod", "PodGroup", "POD_GROUP_LABEL"):
        monkeypatch.setattr(jax_fr_tables, name, getattr(port_objects, name))
    for name, value in {
        "Cluster": PCluster, "Profile": PProfile, "Scheduler": PScheduler,
        "NodeResourcesAllocatable": port_plugins.NodeResourcesAllocatable,
        "Coscheduling": port_plugins.Coscheduling,
        "CapacityScheduling": port_plugins.CapacityScheduling,
    }.items():
        monkeypatch.setattr(jax_fr_tables, name, value)
    pf.recorder.start(capacity=1)
    _run(jax_fr_tables.make_scheduler(), jax_fr_tables.make_cluster(),
         now=1000)
    rec = pf.recorder.records()[0]
    got = rec.to_manifest()

    assert sorted(_manifest_diffs(got, want)) == sorted(NAMED_DIFFERENCES)
    assert rec.complete and pf.recorder.find("default/huge") is rec
    golden = pf.load_bundle(str(jax_fr_tables.FIXTURE_DIR))[0]
    gold_assignment = golden.output("assignment")
    for manifest in (got, want):
        spec = manifest["outputs"]["assignment"]
        assert spec == golden.manifest["outputs"]["assignment"]
    np.testing.assert_array_equal(
        pf.unpack_pytree(got["outputs"]["assignment"], rec.blobs),
        gold_assignment)


# --- copies, threads, the engines ------------------------------------------

def _serving_cluster(n_nodes=6):
    cluster = PCluster()
    for i in range(n_nodes):
        cluster.add_node(port_objects.Node(
            name=f"n{i:03d}",
            allocatable={port_resources.CPU: 8000,
                         port_resources.MEMORY: 32 * GIB,
                         port_resources.PODS: 32}))
    return cluster


def _pod(serial, now, cpu=500):
    return port_objects.Pod(
        name=f"p{serial:05d}", creation_ms=now + serial,
        containers=[port_objects.Container(requests={
            port_resources.CPU: cpu, port_resources.MEMORY: GIB})])


def test_served_cycles_save_copies(tmp_path):
    """Two served cycles: the engine adds the second refresh into the
    resident columns in place, so a record holding views would save the
    second cycle's rows under the first cycle's digests. Every saved blob
    loads with its digest intact, and both records replay."""
    cluster = _serving_cluster()
    engine = PServeEngine().attach(cluster)
    sched = PScheduler(PProfile(plugins=[
        port_plugins.NodeResourcesAllocatable()]))
    pf.recorder.start(capacity=4)
    for k, now in enumerate((1000, 2000)):
        for j in range(3):
            cluster.add_pod(_pod(10 * k + j, now, cpu=700 + 300 * j))
        _run(sched, cluster, now=now, serve=engine)
    recs = pf.recorder.records()
    assert [r.manifest["serve"]["mode"] for r in recs] == ["rebase", "delta"]
    for rec in recs:
        for digest, arr in rec.blobs.items():
            assert pf.array_digest(arr) == digest
    pf.recorder.save(str(tmp_path))
    cycles = pf.load_bundle(str(tmp_path))
    for lc in cycles:
        for blob in (tmp_path / "blobs").glob("*.npy"):
            lc.blob(blob.stem)  # raises on a digest mismatch
        out = pf.replay_cycle(lc, device=CPU)
        assert out["digest_ok"] and out["placements_match"], out
    # the two snapshots' requested columns differ: the second cycle's
    # record did not alias the first's
    first, second = (lc.snapshot().nodes.requested for lc in cycles)
    assert (first != second).any()


def test_find_skips_a_capture_in_flight():
    """A record whose inputs are still being captured (seen from another
    thread) is never returned; a complete one is preferred over one whose
    outputs are missing."""
    pf.recorder.start(capacity=4)
    done = pf.recorder.begin(now_ms=1, profile="p")
    done.manifest["meta"] = {"pod_names": ["ns/a"]}
    done.manifest["plugins"] = []
    done.complete = True
    partial = pf.recorder.begin(now_ms=2, profile="p")
    partial.manifest["meta"] = {"pod_names": ["ns/a", "ns/b"]}
    partial.manifest["plugins"] = []
    inflight = pf.recorder.begin(now_ms=3, profile="p")
    inflight.manifest["meta"] = {"pod_names": ["ns/a", "ns/b", "ns/c"]}
    seen = []
    t = threading.Thread(target=lambda: seen.extend(
        pf.recorder.find(uid) for uid in ("ns/a", "ns/b", "ns/c")),
        name="find-reader", daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [done, partial, None]


def _life_cluster():
    cluster = _serving_cluster(8)
    for j in range(12):
        cluster.add_pod(_pod(j, 0, cpu=900 + 150 * (j % 5)))
    cluster.add_pod(_pod(99, 0, cpu=10 ** 9))  # fits nowhere
    return cluster


def _record_stream(engine_of, ticks=3):
    """Digests and records of a three-cycle stream through one engine."""
    cluster = _life_cluster()
    sched = PScheduler(PProfile(plugins=[
        port_plugins.NodeResourcesAllocatable()]))
    pf.recorder.start(capacity=8)
    tick, close = engine_of(sched, cluster)
    for k in range(ticks):
        for j in range(4):
            cluster.add_pod(_pod(100 * (k + 1) + j, 1000 * k, cpu=1200))
        tick(1000 * (k + 1))
    close()
    recs = pf.recorder.records()
    pf.recorder.stop()
    return recs


def _serial(sched, cluster):
    return (lambda now: _run(sched, cluster, now=now)), (lambda: None)


def _pipelined(sched, cluster):
    pipe = PipelinedCycle(sched, cluster,
                          serve=StreamingServeEngine().attach(cluster),
                          device=CPU)
    return pipe.tick, pipe.close


def _laned(sched, cluster):
    laned = LanedCycle(sched, cluster, k=2, async_bind=True, device=CPU)
    return laned.tick, laned.close


@pytest.mark.parametrize("engine", [_pipelined, _laned],
                         ids=["pipelined", "laned"])
def test_engines_record_the_serial_cycles(engine, tmp_path):
    """`PipelinedCycle` (served, its commit in the deferred finalize) and
    `LanedCycle` (K = 2, its commit on the flusher thread) record the same
    cycles as `run_cycle`: equal digests, every record complete, and each
    replays bit-identically from a saved bundle."""
    serial = _record_stream(_serial)
    got = _record_stream(engine)
    assert all(r.complete for r in got)
    for g, s in zip(got, serial):
        g_line, s_line = g.to_manifest(), s.to_manifest()
        g_line.pop("serve", None)  # the served engine's provenance block
        g_line["digest"] = pf.record_digest(g_line)
        assert _manifest_diffs(g_line, s_line) == []
    assert len(got) == len(serial) == 3
    pf.recorder.start(capacity=8)
    for rec in got:
        pf.recorder._ring.append(rec)
    pf.recorder.save(str(tmp_path))
    for lc in pf.load_bundle(str(tmp_path)):
        out = pf.replay_cycle(lc, device=CPU)
        assert out["mode"] == "sequential"
        assert out["digest_ok"] and out["placements_match"], out


def test_recorder_off_records_nothing():
    """Off (the default), no engine opens a record."""
    pf.recorder.start(capacity=2)
    pf.recorder.stop()
    for engine in (_serial, _pipelined, _laned):
        cluster = _life_cluster()
        tick, close = engine(PScheduler(PProfile(plugins=[
            port_plugins.NodeResourcesAllocatable()])), cluster)
        tick(1000)
        close()
    assert pf.recorder.records() == []


def test_explain_record_on_a_ring_record():
    """The live path: a ring record explains as the report does."""
    pf.recorder.start(capacity=2)
    report = _run(PScheduler(PProfile(plugins=[
        port_plugins.NodeResourcesAllocatable()])), _life_cluster(),
        now=1000)
    rec = pf.recorder.find("default/p00099")
    table = pf.explain_record(rec, "default/p00099", device=CPU)
    assert port_tool.validate_explain(table) == []
    assert table["cycle"] == rec.seq
    assert table == dict(report.explain("default/p00099"), cycle=rec.seq)


# --- the tool --------------------------------------------------------------

def test_tool_on_the_golden_bundle(capsys, tmp_path):
    """info, replay (rc 0: the sequential record replays bit-identically)
    and explain on JAX's committed bundle; a record whose recorded
    placement was edited fails the replay with rc 1."""
    fixture = "tests/fixtures/flightrec"
    assert port_tool.main(["info", fixture]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["cycles"][0]["digest_ok"]
    assert port_tool.main(["replay", fixture, "--device", CPU]) == 0
    replay = json.loads(capsys.readouterr().out)
    assert replay["ok"] and replay["replays"][0]["placements_match"]
    assert port_tool.main(["explain", fixture, "--uid", "default/huge",
                           "--device", CPU]) == 0
    table = json.loads(capsys.readouterr().out)
    assert table["schema_errors"] == []
    assert table["failed_plugin"] == "NodeResourcesFit"

    # a second bundle whose recorded assignment moves one pod
    lc = pf.load_bundle(fixture)[0]
    manifest = json.loads(json.dumps(lc.manifest))
    assignment = lc.output("assignment").copy()
    assignment[0] = 7
    blobs = {}
    manifest["outputs"]["assignment"] = pf.pack_pytree(assignment, blobs)
    manifest["digest"] = pf.record_digest(manifest)
    (tmp_path / "blobs").mkdir()
    for spec in [manifest["snapshot"]] + [p["aux"]
                                          for p in manifest["plugins"]]:
        blobs.update(lc._blobs_for(spec))
    for digest, arr in blobs.items():
        np.save(tmp_path / "blobs" / f"{digest}.npy", arr)
    (tmp_path / "cycles.jsonl").write_text(json.dumps(manifest) + "\n")
    assert port_tool.main(["replay", str(tmp_path), "--device", CPU]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["replays"][0]["mismatches"] == [
        {"pod": "default/p00", "recorded": "n7", "replayed": "n0"}]


def test_validate_explain_equals_jax(jax_package):
    """The schema and its checker are the JAX tool's."""
    assert port_tool.EXPLAIN_SCHEMA == jax_tool.EXPLAIN_SCHEMA
    assert port_tool.CANDIDATE_SCHEMA == jax_tool.CANDIDATE_SCHEMA
    bad = {"uid": 1, "candidates": [{"scores": {"a": 1}, "total": 2}],
           "weights": {"a": True}}
    assert port_tool.validate_explain(bad) == jax_tool.validate_explain(bad)
