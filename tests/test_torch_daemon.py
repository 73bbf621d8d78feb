"""The port's daemon (`python -m scheduler_plugins_tpu_torch`,
`scheduler_plugins_tpu_torch.__main__`) against the JAX package's, with
tolerance 0 on every decision.

- The cases of `tests/test_daemon.py` run again on `python -m
  scheduler_plugins_tpu_torch --device cpu` (every command naming the JAX
  daemon is rewritten to the port's), the thread-topology cases on the
  port's `THREAD_PATTERNS`, `thread_topology` and `HealthServer`.
- In-process daemons fed the same events over TCP (`tests/torch_edge_
  cases.py`, bench config 7's churn at `CHURN_TEST_SHAPE`): JAX's served
  daemon and the port's served, native-store, pipelined and plain ones,
  equal tick by tick and equal to the port's direct-mutation served run.
- Checkpoints and flight bundles read across packages in both
  directions; a port daemon's SIGTERM checkpoint restored by JAX's engine.
- `PipelinedCycle(async_bind=False)`: no flusher thread, decisions equal
  to the flusher path's and `run_cycle`'s.
- Every thread name the port's code assigns matches `THREAD_PATTERNS`.
- No card and no `--device cpu`: the daemon exits non-zero; a JSON profile
  loads without PyYAML."""

import ast
import fnmatch
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.__main__ as port_main
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.bridge as port_bridge
import scheduler_plugins_tpu_torch.bridge.grpc_feed as port_grpc
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.utils.observability as port_obs
from scheduler_plugins_tpu_torch.api.config import load_profile
from scheduler_plugins_tpu_torch.bridge.feed import FeedClient
from scheduler_plugins_tpu_torch.framework import (
    PipelinedCycle,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.serving import ServeEngine
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.utils import flightrec as pf
import torch_churn_cases as churn
import torch_edge_cases as edge
from torch_table_runner import PortSubprocess, run_case, swap, table_params

try:
    import scheduler_plugins_tpu.__main__ as jax_main
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.bridge as jax_bridge
    import scheduler_plugins_tpu.bridge.grpc_feed as jax_grpc
    import scheduler_plugins_tpu.utils as jax_utils
    import scheduler_plugins_tpu.utils.flightrec as jf
    import tests.test_daemon as jax_tables
    from scheduler_plugins_tpu.bridge.feed import FeedClient as JFeedClient
    from scheduler_plugins_tpu.framework import (
        Scheduler as JScheduler,
        run_cycle as j_run_cycle,
    )
    from scheduler_plugins_tpu.api.config import load_profile as j_load
    from scheduler_plugins_tpu.serving import ServeEngine as JServeEngine
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
except ImportError:
    jax_objects = None

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
PORT_PKG = SimpleNamespace(objects=port_objects, main=port_main,
                           FeedClient=FeedClient)


@pytest.fixture
def jax_package():
    if jax_objects is None:
        pytest.skip("the JAX package is not importable here")


def _port_env():
    return dict(os.environ, PYTHONPATH=str(REPO))


# --- the JAX tables on the port's daemon -------------------------------------

def _tables():
    if jax_objects is None:
        return []
    return table_params([
        jax_tables.TestDaemonE2E, jax_tables.TestComposeDemoRecipe,
        jax_tables.TestDaemonErrors, jax_tables.TestDaemonGrpcFeed,
        jax_tables.TestApiserverOutageRecovery, jax_tables.TestDaemonLanes,
        jax_tables.TestThreadTopology])


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch, request):
    """Each case of `tests/test_daemon.py` on the port's daemon process
    (`--device cpu`) and the port's daemon module."""
    swap(monkeypatch, jax_tables, {"subprocess": PortSubprocess(
        subprocess, "scheduler_plugins_tpu", "scheduler_plugins_tpu_torch",
        ("--device", "cpu"))})
    swap(monkeypatch, jax_main, {
        "_known_thread_patterns": lambda: list(port_main.THREAD_PATTERNS),
        "thread_topology": port_main.thread_topology,
        "HealthServer": port_main.HealthServer})
    swap(monkeypatch, jax_utils, {"observability": port_obs})
    swap(monkeypatch, jax_bridge, {"NativeStore": port_bridge.NativeStore})
    swap(monkeypatch, jax_grpc, {"GrpcFeedClient": port_grpc.GrpcFeedClient})
    run_case(cls, method, request)


# --- in-process daemons, tick by tick ----------------------------------------

class _JaxDaemonAt:
    """JAX's in-process `Daemon` ticking at a chosen wall clock (its tick
    reads `time.time()`), with the port daemon's `shutdown`."""

    def __init__(self, daemon):
        self.daemon = daemon
        self.cluster = daemon.cluster
        self.feed = daemon.feed
        self.health = daemon.health

    def tick(self, now_ms):
        real = jax_main.time
        jax_main.time = SimpleNamespace(time=lambda: now_ms / 1000.0,
                                        monotonic=real.monotonic)
        try:
            return self.daemon.tick()
        finally:
            jax_main.time = real

    def shutdown(self):
        if self.health:
            self.health.stop()
        self.feed.stop()


def test_daemons_equal_tick_by_tick(jax_package, tmp_path):
    """Config 7's churn at `CHURN_TEST_SHAPE` as feed events into JAX's
    served daemon and the port's served, native-store, pipelined-served
    and plain daemons: every tick's decisions equal across the five and
    to the port's direct-mutation served run, the stores equal, no
    capacity violation."""
    shape = churn.CHURN_TEST_SHAPE
    profile = edge.write_profile(str(tmp_path))
    jpkg = SimpleNamespace(objects=jax_objects, main=jax_main,
                           FeedClient=JFeedClient)
    jdaemon = _JaxDaemonAt(jax_main.Daemon(jax_main.parse_args([
        "--profile", profile, "--no-ledger", "--health-port", "-1",
        "--serve"])))
    arms = [edge.EdgeArm("jax_serve", jpkg, jdaemon)]
    try:
        for label, flags in (("serve", ["--serve"]),
                             ("native", ["--native-store"]),
                             ("pipeline", ["--pipeline", "--serve"]),
                             ("plain", [])):
            arms.append(edge.EdgeArm(label, PORT_PKG, edge.make_daemon(
                PORT_PKG, profile, [*flags, "--device", CPU])))
        info = edge.run_edge_churn(jpkg, arms, shape)
        direct = churn.churn_cluster(churn_ns(), shape["n_nodes"],
                                     shape["prefill"])
        reference = churn.run_churn(
            churn_ns(), direct, PScheduler(load_profile(churn.CHURN_PROFILE)),
            shape, lambda s, c, now, e: port_cycle.run_cycle(
                s, c, now, serve=e, device=CPU),
            engine=ServeEngine().attach(direct))["reports"]
        assert edge.edge_gates(arms, reference) == []
        assert info["bootstrap_events"] == (shape["n_nodes"]
                                            + shape["prefill"])
        assert sum(len(b) for b, _ in arms[0].reports) > 50
        assert arms[3].daemon.pipeline._flusher is None
        assert arms[2].daemon.cluster._native_exports() is not None
    finally:
        for arm in arms:
            arm.close()


def churn_ns():
    return SimpleNamespace(objects=port_objects, Cluster=PCluster)


# --- checkpoints and bundles across packages --------------------------------

def _served(pkg_objects, Cluster, Engine, Scheduler, load, run, device_kw):
    """Three served churn cycles on a small config-7 cluster, then one
    refresh, so the resident columns hold the last cycle's binds too."""
    cluster = churn.churn_cluster(SimpleNamespace(objects=pkg_objects,
                                                  Cluster=Cluster), 12, 40)
    engine = Engine().attach(cluster)
    sched = Scheduler(load(churn.CHURN_PROFILE))
    rng = np.random.default_rng(1)
    serial = 0
    for cycle in range(3):
        serial = churn.churn_events(SimpleNamespace(objects=pkg_objects),
                                    cluster, rng, churn.CHURN_TEST_SHAPE,
                                    cycle, 1000 * (cycle + 1), serial)
        run(sched, cluster, 1000 * (cycle + 1), engine)
    assert engine.refresh(cluster, [], now_ms=5000, **device_kw) is not None
    return cluster, engine


def _port_served():
    return _served(port_objects, PCluster, ServeEngine, PScheduler,
                   load_profile,
                   lambda s, c, now, e: port_cycle.run_cycle(
                       s, c, now, serve=e, device=CPU), {"device": CPU})


def _jax_served():
    return _served(jax_objects, JCluster, JServeEngine, JScheduler, j_load,
                   lambda s, c, now, e: j_run_cycle(s, c, now, serve=e), {})


class TestCheckpointInterchange:
    def test_port_checkpoint_restores_in_jax(self, jax_package):
        """JAX's engine restores a port checkpoint: equal resident
        columns, and its first refresh verifies without a divergence."""
        cluster, engine = _port_served()
        data = engine.checkpoint_bytes()
        jcluster, jengine = _jax_served()
        fresh = JServeEngine().attach(jcluster)
        assert fresh.restore_checkpoint(data)
        for k, v in jengine._node_columns().items():
            np.testing.assert_array_equal(
                np.asarray(fresh._node_columns()[k]), np.asarray(v), k)
        assert fresh.refresh(jcluster, [], now_ms=9000) is not None
        assert fresh.antientropy_divergences == 0
        assert fresh.rebases == 0

    def test_jax_checkpoint_restores_in_port(self, jax_package):
        jcluster, jengine = _jax_served()
        data = jengine.checkpoint_bytes()
        cluster, engine = _port_served()
        fresh = ServeEngine().attach(cluster)
        assert fresh.restore_checkpoint(data, device=CPU)
        for k, v in engine._node_columns(engine._nodes).items():
            assert torch.equal(getattr(fresh._nodes, k), v), k
        assert fresh.refresh(cluster, [], now_ms=9000,
                             device=CPU) is not None
        assert fresh.antientropy_divergences == 0
        assert fresh.rebases == 0

    def test_daemon_sigterm_checkpoint_read_by_jax(self, jax_package,
                                                   tmp_path):
        """A port daemon process (`--serve --checkpoint`) fed over TCP, its
        binds folded in by a later served cycle (an unschedulable pod keeps
        the cycles refreshing), then SIGTERM: rc 0, and JAX's engine
        restores the checkpoint with every fed pod counted in the resident
        columns."""
        profile = edge.write_profile(str(tmp_path))
        ckpt = tmp_path / "serve.ckpt"
        proc = subprocess.Popen(
            [sys.executable, "-m", "scheduler_plugins_tpu_torch",
             "--profile", profile, "--serve", "--checkpoint", str(ckpt),
             "--device", CPU, "--health-port", "-1", "--no-ledger",
             "--cycle-interval-s", "0.05"],
            cwd=REPO, env=_port_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            ready = proc.stdout.readline()
            assert ready.startswith("daemon ready "), ready
            host, port = json.loads(ready[13:])["feed"].rsplit(":", 1)
            client = FeedClient(host, int(port))
            events = edge.bootstrap_events(SimpleNamespace(
                objects=port_objects), dict(n_nodes=6, prefill=20))
            events += [edge.pod_event(port_objects.Pod(
                name=f"new{i}", containers=[port_objects.Container(
                    requests={"cpu": 300})])) for i in range(5)]
            assert all(client.send(e)["ok"] for e in events)
            deadline = time.monotonic() + 60
            while (client.send({"op": "sync"})["pending"]
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert client.send(edge.pod_event(port_objects.Pod(
                name="huge", containers=[port_objects.Container(
                    requests={"cpu": 10 ** 9})])))["ok"]
            time.sleep(1.0)  # served cycles fold the binds in
            client.close()
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, err
        assert json.loads(out.strip().splitlines()[-1])["daemon_exit"]
        jengine = JServeEngine().attach(JCluster())
        assert jengine.restore_checkpoint(str(ckpt))
        cols = {k: np.asarray(v) for k, v in jengine._node_columns().items()}
        assert jengine._names == [e["name"] for e in events[:6]]
        assert cols["alloc"][:6, 0].tolist() == [64_000] * 6
        assert int(cols["pod_count"].sum()) == 25
        cpu = sum(c["requests"].get("cpu", 0) for e in events[6:]
                  for c in e["containers"])
        assert int(cols["requested"][:, 0].sum()) == cpu
        assert (cols["nonzero_requested"][:, 0]
                >= cols["requested"][:, 0]).all()


class TestBundleInterchange:
    def _record_port(self, tmp_path):
        pf.recorder.start(capacity=4)
        try:
            cluster = churn.churn_cluster(churn_ns(), 8, 16)
            for i in range(6):
                cluster.add_pod(port_objects.Pod(
                    name=f"q{i}", creation_ms=i,
                    containers=[port_objects.Container(requests={
                        "cpu": 700 + 100 * i, "memory": 1 << 30})]))
            sched = PScheduler(load_profile(churn.CHURN_PROFILE))
            port_cycle.run_cycle(sched, cluster, now=1000, device=CPU)
            pf.recorder.save(str(tmp_path / "bundle"))
        finally:
            pf.recorder.stop()
        return str(tmp_path / "bundle")

    def test_jax_replays_port_bundle(self, jax_package, tmp_path):
        """JAX's `load_bundle` / `replay_cycle` replays a bundle the port
        saved: the digest holds and the placements match."""
        path = self._record_port(tmp_path)
        loaded = jf.load_bundle(path)
        assert loaded
        result = jf.replay_cycle(loaded[0])
        assert result["digest_ok"] and result["placements_match"], result
        # and the port replays its own bundle the same way
        assert pf.replay_cycle(pf.load_bundle(path)[0], device=CPU)[
            "placements_match"]

    def test_port_replays_jax_bundle(self, jax_package, tmp_path):
        jf.recorder.start(capacity=4)
        try:
            cluster = churn.churn_cluster(SimpleNamespace(
                objects=jax_objects, Cluster=JCluster), 8, 16)
            for i in range(6):
                cluster.add_pod(jax_objects.Pod(
                    name=f"q{i}", creation_ms=i,
                    containers=[jax_objects.Container(requests={
                        "cpu": 700 + 100 * i, "memory": 1 << 30})]))
            j_run_cycle(JScheduler(j_load(churn.CHURN_PROFILE)), cluster,
                        now=1000)
            jf.recorder.save(str(tmp_path / "jb"))
        finally:
            jf.recorder.stop()
        loaded = pf.load_bundle(str(tmp_path / "jb"))[0]
        result = pf.replay_cycle(loaded, device=CPU)
        assert result["digest_ok"] and result["placements_match"], result


# --- the inline bind -----------------------------------------------------------

def _inline_case():
    cluster = churn.churn_cluster(churn_ns(), 16, 64)
    engine = ServeEngine().attach(cluster)
    return cluster, engine, PScheduler(load_profile(churn.CHURN_PROFILE))


def _churn_run(step):
    """Eight churn cycles through `step(sched, cluster, now, engine)`;
    returns each cycle's (bound, failed) and the final placements."""
    cluster, engine, sched = _inline_case()
    rng = np.random.default_rng(4)
    serial, reports = 0, []
    for cycle in range(8):
        now = 1000 * (cycle + 1)
        serial = churn.churn_events(churn_ns(), cluster, rng,
                                    churn.CHURN_TEST_SHAPE, cycle, now,
                                    serial)
        r = step(sched, cluster, now, engine)
        reports.append((dict(r.bound), list(r.failed)))
    return reports, {u: p.node_name for u, p in cluster.pods.items()}


class TestInlineBind:
    def test_async_bind_false_starts_no_flusher(self):
        cluster, engine, sched = _inline_case()
        before = {t.name for t in threading.enumerate()}
        pipe = PipelinedCycle(sched, cluster, serve=engine,
                              async_bind=False, device=CPU)
        assert pipe._flusher is None
        report = pipe.tick(1000)
        # the bind ran on this thread inside tick: nothing to fence
        assert pipe._bind_future is None and pipe.inflight <= 1
        assert all(cluster.pods[u].node_name == n
                   for u, n in report.bound.items())
        pipe.close()
        after = {t.name for t in threading.enumerate()}
        assert not [n for n in after - before
                    if n.startswith("spt-bind-flusher")]

    def test_decisions_equal_flusher_and_run_cycle(self):
        pipes = {}

        def piped(async_bind):
            def step(sched, cluster, now, engine):
                key = id(cluster)
                if key not in pipes:
                    pipes[key] = PipelinedCycle(sched, cluster, serve=engine,
                                                async_bind=async_bind,
                                                device=CPU)
                report = pipes[key].tick(now)
                pipes[key].fence()
                return report
            return step

        inline = _churn_run(piped(False))
        flusher = _churn_run(piped(True))
        serial = _churn_run(lambda s, c, now, e: port_cycle.run_cycle(
            s, c, now, serve=e, device=CPU))
        for pipe in pipes.values():
            pipe.close()
        assert inline == flusher == serial
        assert sum(len(b) for b, _ in inline[0]) > 0


# --- threads, device, profile ------------------------------------------------

def _assigned_thread_names() -> list:
    """Every thread name (or name prefix) the port's code assigns:
    `threading.Thread(name=...)` and `ThreadPoolExecutor(thread_name_
    prefix=...)` keyword arguments, f-strings reduced to their literal
    head."""
    out = []
    root = REPO / "scheduler_plugins_tpu_torch"
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = ast.unparse(node.func)
            for kw in node.keywords:
                wanted = (kw.arg == "name" and callee.endswith("Thread")) or \
                    kw.arg == "thread_name_prefix"
                if not wanted:
                    continue
                value = kw.value
                if isinstance(value, ast.Constant):
                    out.append((path.name, value.value, kw.arg))
                elif isinstance(value, ast.JoinedStr):
                    head = value.values[0]
                    lit = head.value if isinstance(head, ast.Constant) else ""
                    out.append((path.name, lit + "x", kw.arg))
                else:
                    out.append((path.name, None, kw.arg))
    return out


def test_thread_names_match_patterns():
    """Every thread the port names matches `THREAD_PATTERNS` (a pool's
    threads are "<prefix>_<n>"), and every pattern but the stdlib ones
    names a thread the code makes, so the list cannot rot."""
    names = _assigned_thread_names()
    assert len(names) >= 9, names
    used = set()
    for where, name, kind in names:
        if name is None:
            continue  # a name passed in (the watchdog worker's default)
        probe = f"{name}_0" if kind == "thread_name_prefix" else name
        hits = [p for p in port_main.THREAD_PATTERNS
                if fnmatch.fnmatch(probe, p)]
        assert hits, (where, name)
        used.update(hits)
    # names built from a parameter: the watchdog worker's default and the
    # shadow tuner's worker
    assert {"solve-watchdog", "shadow-tuner"} <= set(
        port_main.THREAD_PATTERNS)
    assert set(port_main.THREAD_PATTERNS) - used - {
        "MainThread", "Thread-*", "solve-watchdog", "shadow-tuner"} == set()


def test_no_card_without_device_cpu_exits_nonzero(tmp_path):
    """Without a card and without `--device cpu` the daemon refuses to
    start (no fallback); with `--device cpu` it runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    profile = edge.write_profile(str(tmp_path))
    base = [sys.executable, "-m", "scheduler_plugins_tpu_torch",
            "--profile", profile, "--max-cycles", "1", "--health-port", "-1",
            "--cycle-interval-s", "0.01"]
    proc = subprocess.run(base, cwd=REPO, env=_port_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'device="cpu"' in proc.stderr
    proc = subprocess.run(base + ["--device", CPU], cwd=REPO,
                          env=_port_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_json_profile_needs_no_yaml(tmp_path, monkeypatch):
    """A JSON profile decodes with PyYAML absent; a YAML one then names
    the missing module."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "p.json"
    path.write_text(json.dumps({"profiles": [{"plugins": [
        "NodeResourcesAllocatable"]}]}))
    assert port_main.decode_profile_file(str(path)) == {
        "plugins": ["NodeResourcesAllocatable"]}
    yml = tmp_path / "p.yaml"
    yml.write_text("plugins:\n  - NodeResourcesAllocatable\n")
    with pytest.raises(ImportError):
        port_main.decode_profile_file(str(yml))


def test_healthz_memory_block_on_cpu(tmp_path):
    """An in-process daemon on the CPU: `/healthz` carries the memory block
    with `available: false` after a tick."""
    import urllib.request

    daemon = edge.make_daemon(PORT_PKG, edge.write_profile(str(tmp_path)),
                              ["--device", CPU])
    try:
        daemon.tick(now_ms=1000)
        health = json.loads(urllib.request.urlopen(
            "http://%s:%d/healthz" % daemon.health.address,
            timeout=5).read())
        assert health["memory"]["available"] is False
        assert health["threads"]["unknown"] == []
    finally:
        daemon.shutdown()
