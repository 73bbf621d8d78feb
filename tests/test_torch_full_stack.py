"""`tests/test_full_stack.py`'s twenty cycles with every subsystem active
(allocatable and Trimaran scoring, NUMA with the over-reserve cache,
gangs, an elastic quota, network-aware constraints, preemption, the
controllers) on the port, cycle by cycle against the JAX package: every
report's decisions, every controller event and the store's placements,
gang phases and quota `used` equal after each cycle (tolerance 0), and
the JAX case's own invariants checked on the port's store."""

import pytest

import scheduler_plugins_tpu_torch.api.config as port_config
import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.api.resources as port_resources
import scheduler_plugins_tpu_torch.controllers as port_controllers
import scheduler_plugins_tpu_torch.framework as port_framework
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.state.nrt_cache as port_nrt_cache
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_table_runner import mirror, swap

try:
    import tests.test_full_stack as jax_tables
except ImportError:
    jax_tables = None

CPU = "cpu"


@pytest.fixture
def jax_package():
    if jax_tables is None:
        pytest.skip("the JAX package is not importable here")


class _CPUCluster(PCluster):
    def snapshot(self, pending, now_ms=0, device=CPU, **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


def _cpu_run_cycle(s, c, now=None, stream_chunk=None, **kw):
    return port_cycle.run_cycle(s, c, now, stream_chunk, device=CPU, **kw)


def _recording(monkeypatch, log):
    """Wrap the case's cycle and controller calls (whatever package they
    are) so each cycle's report, events and store state land in `log`."""
    run, pods, quotas = (jax_tables.run_cycle, jax_tables.reconcile_pod_groups,
                         jax_tables.reconcile_elastic_quotas)

    def run_cycle(scheduler, cluster, now=None, **kw):
        r = run(scheduler, cluster, now=now, **kw)
        log.append(("cycle", now, dict(r.bound), sorted(r.failed),
                    dict(r.reserved), sorted(r.rejected_gangs),
                    sorted(r.preempted) if r.preempted else []))
        return r

    def reconcile_pod_groups(cluster, now_ms=0):
        events = pods(cluster, now_ms=now_ms)
        log.append(("podgroups", events,
                    {k: (str(g.phase), g.running, g.succeeded, g.failed)
                     for k, g in cluster.pod_groups.items()}))
        return events

    def reconcile_elastic_quotas(cluster):
        events = quotas(cluster)
        log.append(("quotas", events,
                    {k: dict(q.used) for k, q in cluster.quotas.items()},
                    {u: p.node_name for u, p in cluster.pods.items()}))
        return events

    swap(monkeypatch, jax_tables, {
        "run_cycle": run_cycle, "reconcile_pod_groups": reconcile_pod_groups,
        "reconcile_elastic_quotas": reconcile_elastic_quotas})


def _port_names(monkeypatch):
    mirror(monkeypatch, jax_tables, port_objects,
           CPU=port_resources.CPU, MEMORY=port_resources.MEMORY,
           PODS=port_resources.PODS, load_profile=port_config.load_profile,
           Scheduler=port_framework.Scheduler, run_cycle=_cpu_run_cycle,
           Cluster=_CPUCluster,
           OverReserveCache=port_nrt_cache.OverReserveCache,
           reconcile_pod_groups=port_controllers.reconcile_pod_groups,
           reconcile_elastic_quotas=port_controllers.reconcile_elastic_quotas)


def test_twenty_cycles_equal_jax(jax_package, monkeypatch):
    want = []
    with monkeypatch.context() as m:
        _recording(m, want)
        jax_tables.TestFullStack().test_twenty_cycles_all_subsystems()
    got = []
    _port_names(monkeypatch)
    _recording(monkeypatch, got)
    jax_tables.TestFullStack().test_twenty_cycles_all_subsystems()
    assert len(got) == len(want) == 60
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a[0])
    assert sum(len(entry[2]) for entry in got if entry[0] == "cycle") > 20
