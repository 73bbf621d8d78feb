"""The port's compiled reference-shaped baselines
(`scheduler_plugins_tpu_torch.bridge.ref_baseline` over its copy of
`ref_baseline.cc`) against the JAX package's, exactly:

- the cases of `tests/test_ref_baseline.py` run again on the port, every
  JAX name they call swapped for the port's (snapshots on the CPU);
- each of the five baselines on the same numpy-made snapshot
  (`allocatable_scenario`, `trimaran_scenario`, `numa_scenario`,
  `gang_quota_scenario`, `network_scenario` at the JAX file's sizes) gives
  the placed count and the assignment of JAX's;
- the host build (`_build.build_host`) names a library by a hash of its
  source: an edited source builds a new library, never the stale one, and
  a missing g++ raises."""

import ctypes
import shutil

import numpy as np
import pytest

import scheduler_plugins_tpu.api.objects as jax_objects
import scheduler_plugins_tpu.plugins as jax_plugins
import scheduler_plugins_tpu.state.cluster as jax_cluster
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.models as port_models
import scheduler_plugins_tpu_torch.plugins as port_plugins
import tests.test_ref_baseline as jax_tables
from scheduler_plugins_tpu.bridge import ref_baseline as j_rb
from scheduler_plugins_tpu_torch import _build
from scheduler_plugins_tpu_torch.bridge import ref_baseline as p_rb
from scheduler_plugins_tpu_torch.framework import Profile as PProfile
from scheduler_plugins_tpu_torch.framework import Scheduler as PScheduler
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_table_runner import run_case, swap, table_params

CPU = "cpu"
PLUGINS = ("TargetLoadPacking", "LoadVariationRiskBalancing",
           "NodeResourceTopologyMatch", "NetworkOverhead")


class _CPUScheduler(PScheduler):
    def solve(self, snap, state0=None, *, device=CPU, **kw):
        return super().solve(snap, state0, device=device, **kw)


class _CPUCluster(PCluster):
    def snapshot(self, pending, now_ms=0, device=CPU, **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


def _cpu(scenario):
    """A port scenario whose store lowers on the CPU by default."""
    def build(*args, **kw):
        cluster = scenario(*args, **kw)
        cluster.__class__ = _CPUCluster
        return cluster
    return build


def port_snap(cluster, plugins=()):
    """JAX's `tests/test_ref_baseline.py` `_snap` on the port."""
    sched = _CPUScheduler(PProfile(plugins=list(plugins)))
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0, device=CPU)
    sched.prepare(meta, cluster)
    return sched, snap, meta, len(pending)


@pytest.mark.parametrize("cls,method", table_params(
    [jax_tables.TestCompiledBaselines]))
def test_table_against_port(cls, method, monkeypatch, request):
    swap(monkeypatch, jax_tables, {
        "rb": p_rb, "_snap": port_snap,
        **{name: _cpu(getattr(port_models, name)) for name in (
            "allocatable_scenario", "gang_quota_scenario",
            "network_scenario", "numa_scenario", "trimaran_scenario")},
    })
    swap(monkeypatch, jax_plugins,
         {name: getattr(port_plugins, name) for name in PLUGINS})
    swap(monkeypatch, jax_objects, {
        name: getattr(port_objects, name)
        for name in ("Container", "ElasticQuota", "Node", "Pod")})
    swap(monkeypatch, jax_cluster, {"Cluster": _CPUCluster})
    run_case(cls, method, request)


# --- the five baselines on one snapshot, JAX's and the port's --------------

def _pair(scenario, size, plugins=()):
    """(JAX (snap, meta, plugin objects), port (snap, meta, plugins)) of
    one scenario at `size`."""
    j_plugins = [getattr(jax_plugins, p)() for p in plugins]
    p_plugins = [getattr(port_plugins, p)() for p in plugins]
    j_cluster = getattr(jax_tables, scenario)(**size)
    p_cluster = _cpu(getattr(port_models, scenario))(**size)
    _, j_snap, j_meta, _ = jax_tables._snap(j_cluster, j_plugins)
    _, p_snap, p_meta, _ = port_snap(p_cluster, p_plugins)
    return (j_snap, j_meta, j_plugins), (p_snap, p_meta, p_plugins)


def _weights(meta):
    return np.asarray(meta.index.encode({"cpu": 1 << 20, "memory": 1}),
                      np.int64)


BASELINES = {
    "alloc": ("allocatable_scenario", dict(n_nodes=32, n_pods=256), (),
              lambda rb, snap, meta, pl: rb.compiled_alloc_baseline(
                  snap, _weights(meta))),
    "trimaran": ("trimaran_scenario", dict(n_nodes=64, n_pods=128),
                 PLUGINS[:2], lambda rb, snap, meta, pl:
                 rb.compiled_trimaran_baseline(snap)),
    "numa": ("numa_scenario", dict(n_nodes=16, n_pods=64, zones=4),
             PLUGINS[2:3], lambda rb, snap, meta, pl:
             rb.compiled_numa_baseline(snap)),
    "gang_quota": ("gang_quota_scenario",
                   dict(n_gangs=8, gang_size=16, n_nodes=64), (),
                   lambda rb, snap, meta, pl:
                   rb.compiled_gang_quota_baseline(snap, _weights(meta))),
    "network": ("network_scenario", dict(n_nodes=64, n_pods=128),
                PLUGINS[3:], lambda rb, snap, meta, pl:
                rb.compiled_network_baseline(
                    snap, pl[0]._zone_cost, pl[0]._region_cost)),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_equals_jax(name):
    scenario, size, plugins, call = BASELINES[name]
    (j_snap, j_meta, j_pl), (p_snap, p_meta, p_pl) = _pair(
        scenario, size, plugins)
    _, j_placed, j_out = call(j_rb, j_snap, j_meta, j_pl)
    rate, placed, out = call(p_rb, p_snap, p_meta, p_pl)
    assert rate > 0 and placed > 0
    assert placed == j_placed
    assert out.dtype == j_out.dtype and (out == j_out).all()


# --- the host build ----------------------------------------------------------

PROBE = '\nextern "C" int spt_build_probe() { return 7; }\n'


@pytest.fixture
def host_copy(tmp_path, monkeypatch):
    """The compiled baselines' source copied under `tmp_path`, the host
    build pointed at it and at a build directory there."""
    src = tmp_path / "ref_baseline.cc"
    shutil.copy(_build.HOST_SOURCES["ref_baseline"], src)
    monkeypatch.setitem(_build.HOST_SOURCES, "ref_baseline", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "native")
    return src


def test_edited_source_builds_a_new_library(host_copy):
    first = _build.build_host("ref_baseline")
    assert first.parent == _build.HOST_BUILD_DIR
    assert _build.build_host("ref_baseline") == first  # reused, unchanged
    with pytest.raises(AttributeError):
        ctypes.CDLL(str(first)).spt_build_probe
    host_copy.write_text(host_copy.read_text() + PROBE)
    second = _build.build_host("ref_baseline")
    assert second != first and second.exists()
    assert ctypes.CDLL(str(second)).spt_build_probe() == 7


def test_missing_compiler_raises(host_copy, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host("ref_baseline")
