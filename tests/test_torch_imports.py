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
        "scheduler_plugins_tpu_torch.plugins.intree"} <= set(names), names
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

    def test_chip_smoke_refuses_without_card(self, no_cuda, capsys):
        assert chip_smoke.main() != 0
        assert '"ok"' not in capsys.readouterr().out
