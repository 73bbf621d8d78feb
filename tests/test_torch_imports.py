"""The port stands alone: importing every module of
`scheduler_plugins_tpu_torch`, and `chip_smoke`, loads no JAX and runs
nothing; its entry points default to the CUDA card and, without one,
raise an error that names `device="cpu"` instead of falling back."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.models import allocatable_scenario
from scheduler_plugins_tpu_torch.state import build_snapshot

REPO = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import pkgutil, sys
import scheduler_plugins_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    __import__(name)
import chip_smoke
assert len(names) >= 40, names
assert {"scheduler_plugins_tpu_torch.framework.runtime",
        "scheduler_plugins_tpu_torch.framework.cycle",
        "scheduler_plugins_tpu_torch.framework.preemption",
        "scheduler_plugins_tpu_torch.api.config",
        "scheduler_plugins_tpu_torch.tuning.quality",
        "scheduler_plugins_tpu_torch.plugins.coscheduling",
        "scheduler_plugins_tpu_torch.ops.normalize",
        "scheduler_plugins_tpu_torch.parallel.pipeline",
        "scheduler_plugins_tpu_torch.utils.flightrec",
        "scheduler_plugins_tpu_torch.ops.trimaran",
        "scheduler_plugins_tpu_torch.plugins.trimaran",
        "scheduler_plugins_tpu_torch.state.collector",
        "scheduler_plugins_tpu_torch.ops.numa",
        "scheduler_plugins_tpu_torch.plugins.noderesourcetopology",
        "scheduler_plugins_tpu_torch.ops.assign",
        "scheduler_plugins_tpu_torch.parallel.solver",
        "scheduler_plugins_tpu_torch.state.nrt_cache",
        "scheduler_plugins_tpu_torch.ops.network",
        "scheduler_plugins_tpu_torch.plugins.networkaware",
        "scheduler_plugins_tpu_torch.state.scheduling",
        "scheduler_plugins_tpu_torch.ops.selectors",
        "scheduler_plugins_tpu_torch.plugins.intree",
        "scheduler_plugins_tpu_torch.plugins.sysched",
        "scheduler_plugins_tpu_torch.plugins.podstate",
        "scheduler_plugins_tpu_torch.plugins.qos",
        "scheduler_plugins_tpu_torch.plugins.preemptiontoleration",
        "scheduler_plugins_tpu_torch.plugins.crossnodepreemption",
        "scheduler_plugins_tpu_torch.ops.packing",
        "scheduler_plugins_tpu_torch.tuning.gates",
        "scheduler_plugins_tpu_torch.utils.observability",
        "scheduler_plugins_tpu_torch.resilience.faults",
        "scheduler_plugins_tpu_torch.serving.deltas",
        "scheduler_plugins_tpu_torch.serving.engine",
        "scheduler_plugins_tpu_torch.resilience.watchdog",
        "scheduler_plugins_tpu_torch.resilience.hostsolve",
        "scheduler_plugins_tpu_torch.gangs.topology",
        "scheduler_plugins_tpu_torch.gangs.elastic",
        "scheduler_plugins_tpu_torch.gangs.waves",
        "scheduler_plugins_tpu_torch.gangs.phase",
        "scheduler_plugins_tpu_torch.obs.ledger",
        "scheduler_plugins_tpu_torch.framework.pipeline_cycle",
        "scheduler_plugins_tpu_torch.parallel.lanes",
        "scheduler_plugins_tpu_torch.framework.laned_cycle",
        "scheduler_plugins_tpu_torch.utils.sanitize",
        "scheduler_plugins_tpu_torch.utils.racecheck",
        "scheduler_plugins_tpu_torch.tools.replay",
        "scheduler_plugins_tpu_torch.tuning.sweep",
        "scheduler_plugins_tpu_torch.tuning.promotion",
        "scheduler_plugins_tpu_torch.tuning.shadow",
        "scheduler_plugins_tpu_torch.tools.tune"} <= set(names), names
bad = sorted(m for m in sys.modules if m in ("jax", "scheduler_plugins_tpu") or m.startswith(("jax.", "scheduler_plugins_tpu.")))
assert not bad, bad
print("clean", len(names))
"""


def test_no_jax_anywhere():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


@pytest.mark.parametrize("helper", sorted(
    p.name for p in (REPO / "tests").glob("torch_*_cases.py")))
def test_case_helpers_import_no_package(helper):
    """The `tests/torch_*_cases.py` helpers `chip_smoke.py` loads import
    neither package nor JAX at their top level: each builds its cases
    from the package objects its caller passes in."""
    lines = (REPO / "tests" / helper).read_text().splitlines()
    imports = [line for line in lines
               if line.startswith(("import ", "from "))]
    assert imports
    assert not [line for line in imports
                if "jax" in line or "scheduler_plugins_tpu" in line], imports


def test_chip_smoke_alone_fails_without_result(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


class TestDeviceDefault:
    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_snapshot_raises(self, no_cuda):
        cluster = allocatable_scenario(4, 8)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cluster.snapshot(cluster.pending_pods())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build_snapshot(list(cluster.nodes.values()), cluster.pending_pods())

    def test_carry_across_raises(self, no_cuda):
        cluster = allocatable_scenario(4, 8)
        snap, _ = cluster.snapshot(cluster.pending_pods(), device="cpu")
        tree = snap.numpy() | {"gangs": None, "quota": None}
        with pytest.raises(RuntimeError, match='device="cpu"'):
            snapshot_from_numpy(tree)
        carried = snapshot_from_numpy(tree, device="cpu")
        assert np.array_equal(carried.nodes.alloc.numpy(), tree["nodes"]["alloc"])

    def test_solve_raises(self, no_cuda):
        cluster = allocatable_scenario(4, 8)
        sched = chip_smoke.flagship_scheduler()
        snap, meta = cluster.snapshot(cluster.pending_pods(), device="cpu")
        sched.prepare(meta, cluster)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            sched.solve(snap)
        state = sched.initial_state(snap)
        tree = {"free": state.free.numpy()}
        with pytest.raises(RuntimeError, match='device="cpu"'):
            state_from_numpy(tree)
        result = sched.solve(snap, state_from_numpy(tree, device="cpu"),
                             device="cpu")
        assert result.assignment.device.type == "cpu"
        assert (result.assignment >= 0).all()

    def test_flightrec_entry_points_raise(self, no_cuda):
        """The flight recorder's replay and explain of a bundle default to
        the card too."""
        from scheduler_plugins_tpu_torch.utils import flightrec

        loaded = flightrec.load_bundle(
            str(REPO / "tests" / "fixtures" / "flightrec"))[0]
        with pytest.raises(RuntimeError, match='device="cpu"'):
            flightrec.replay_cycle(loaded)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            flightrec.explain_record(loaded, "default/huge")
        assert flightrec.replay_cycle(loaded, device="cpu")[
            "placements_match"]

    def test_intree_entry_points_raise(self, no_cuda):
        """The in-tree slice's entry points (the snapshot with its
        scheduling tables, the solve, the batched solve through the
        validators, the post-eviction tables' device) default to the card
        too."""
        from types import SimpleNamespace

        from scheduler_plugins_tpu_torch.api import objects
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import Scheduler
        from scheduler_plugins_tpu_torch.parallel.solver import (
            profile_batch_solve,
        )
        from scheduler_plugins_tpu_torch.state import Cluster

        sys.path.insert(0, str(REPO / "tests"))
        try:
            from torch_intree_cases import INTREE, intree_cluster
        finally:
            sys.path.remove(str(REPO / "tests"))
        cluster = intree_cluster(SimpleNamespace(objects=objects,
                                                 Cluster=Cluster),
                                 8, 16, 4)
        sched = Scheduler(load_profile(INTREE))
        pending = cluster.pending_pods()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cluster.snapshot(pending)
        snap, meta = cluster.snapshot(pending, device="cpu")
        sched.prepare(meta, cluster)
        assert snap.scheduling is not None
        with pytest.raises(RuntimeError, match='device="cpu"'):
            sched.solve(snap)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            profile_batch_solve(sched, snap)
        assert (profile_batch_solve(sched, snap, device="cpu")[0]
                >= 0).any()
        hyp = cluster.post_eviction_tables(snap, meta, [
            p.uid for p in cluster.pods.values() if p.node_name][:2])
        assert hyp.scheduling.track_base.device.type == "cpu"

    def test_packing_entry_points_raise(self, no_cuda):
        """The packing slice's entry points (the scenario's snapshot, the
        packing-mode solve, the cycle) default to the card too."""
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
        from scheduler_plugins_tpu_torch.models import packing_scenario
        from scheduler_plugins_tpu_torch.parallel.solver import (
            packing_profile_solve,
        )

        with pytest.raises(RuntimeError, match='device="cpu"'):
            packing_scenario(8, 0.5, 0.25)
        cluster, snap, meta, _ = packing_scenario(8, 0.5, 0.25, device="cpu")
        sched = Scheduler(load_profile({
            "plugins": ["NodeResourcesAllocatable"],
            "solveMode": "packing"}))
        sched.prepare(meta, cluster)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            sched.solve(snap)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            packing_profile_solve(sched, snap)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_cycle(sched, cluster, now=1000)
        view = sched.solve(snap, device="cpu")
        assert view.assignment.device.type == "cpu"
        assert (view.assignment >= 0).any()

    def test_serving_entry_points_raise(self, no_cuda):
        """The serving slice's entry points (the engine's refresh, the
        served cycle) default to the card too."""
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
        from scheduler_plugins_tpu_torch.serving import ServeEngine

        cluster = allocatable_scenario(4, 8)
        engine = ServeEngine().attach(cluster)
        sched = Scheduler(load_profile(
            {"plugins": ["NodeResourcesAllocatable"]}))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            engine.refresh(cluster, cluster.pending_pods())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_cycle(sched, cluster, now=1000, serve=engine)
        report = run_cycle(sched, cluster, now=1000, serve=engine,
                           device="cpu")
        assert report.bound and engine.resident_nodes.alloc.device.type == (
            "cpu")

    def test_resilience_and_gang_entry_points_raise(self, no_cuda):
        """The resilience and gang slice's entry points (the watchdog's
        cycle solve, the checkpoint restore, the gang phase, the gang and
        wave solves) default to the card too: a watchdog without a card
        raises before it dispatches, never failing over to the host."""
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import Scheduler, run_cycle
        from scheduler_plugins_tpu_torch.gangs import (
            GangPhase,
            gang_solve,
            wave_gang_solve,
        )
        from scheduler_plugins_tpu_torch.gangs.topology import initial_state
        from scheduler_plugins_tpu_torch.models import rank_gang_scenario
        from scheduler_plugins_tpu_torch.resilience import Resilience
        from scheduler_plugins_tpu_torch.serving import ServeEngine

        cluster = allocatable_scenario(4, 8)
        sched = Scheduler(load_profile(
            {"plugins": ["NodeResourcesAllocatable"]}))
        rz = Resilience()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_cycle(sched, cluster, now=1000, resilience=rz)
        assert rz.mode == "fast" and rz.failovers == 0
        engine = ServeEngine().attach(cluster)
        run_cycle(sched, cluster, now=1000, serve=engine, device="cpu")
        ckpt = engine.checkpoint_bytes()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ServeEngine().attach(cluster).restore_checkpoint(ckpt)
        gangs = rank_gang_scenario(n_nodes=8, n_mpi=1, mpi_ranks=2, n_dl=0)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_cycle(sched, gangs, now=1000, gangs=GangPhase())
        state = gangs.pending_pods()
        assert all(p.node_name is None for p in state)
        from scheduler_plugins_tpu_torch.gangs.phase import (
            build_rank_gang_problem,
        )

        prob = build_rank_gang_problem(gangs, gangs.pending_pods(), 0,
                                       device="cpu")
        args = (prob["gangs"], prob["free0"], prob["eq_used0"],
                prob["node_mask"])
        with pytest.raises(RuntimeError, match='device="cpu"'):
            wave_gang_solve(*args)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            initial_state(*args[:3])
        state0 = initial_state(*args[:3], device="cpu")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            gang_solve(prob["gangs"], state0,
                       torch.from_numpy(prob["node_mask"]))

    def test_chip_smoke_refuses_without_card(self, no_cuda, capsys):
        assert chip_smoke.main() != 0
        assert '"ok"' not in capsys.readouterr().out

    def test_pipelined_entry_points_raise(self, no_cuda):
        """The pipelined slice's entry points (`PipelinedCycle`, the
        streaming engine's refresh) default to the card too: without one
        they raise, naming `device="cpu"`, and never fall back."""
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import (
            PipelinedCycle,
            Scheduler,
        )
        from scheduler_plugins_tpu_torch.serving import StreamingServeEngine

        cluster = allocatable_scenario(4, 8)
        engine = StreamingServeEngine().attach(cluster)
        sched = Scheduler(load_profile(
            {"plugins": ["NodeResourcesAllocatable"]}))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PipelinedCycle(sched, cluster, serve=engine)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            engine.refresh(cluster, cluster.pending_pods())
        pipe = PipelinedCycle(sched, cluster, serve=engine, device="cpu")
        report = pipe.tick(now=1000)
        pipe.close()
        assert report.bound and engine.resident_nodes.alloc.device.type == (
            "cpu")

    def test_laned_entry_points_raise(self, no_cuda):
        """The K-lane slice's entry points (`LaneSolver`, `LanedCycle`)
        default to the card too: without one they raise, naming
        `device="cpu"`, and never fall back."""
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import (
            LanedCycle,
            Scheduler,
        )
        from scheduler_plugins_tpu_torch.parallel.lanes import LaneSolver

        cluster = allocatable_scenario(4, 8)
        sched = Scheduler(load_profile(
            {"plugins": ["NodeResourcesAllocatable"]}))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            LaneSolver(sched, k=2)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            LanedCycle(sched, cluster, k=2)
        laned = LanedCycle(sched, cluster, k=2, device="cpu")
        report = laned.tick(now=1000)
        laned.close()
        assert report.bound and report.lanes["k"] == 2
