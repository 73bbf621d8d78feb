"""The port's CRD status controllers (`controllers.podgroup`
`reconcile_pod_groups`, `controllers.elasticquota`
`reconcile_elastic_quotas`) against the JAX package's: the cases of
`tests/test_controllers.py` run again on the port, and one seeded stream
of member phase changes, losses, arrivals and quota pods goes through
both packages' stores and controllers, with every emitted event, phase,
count and quota `used` equal at every step."""

import numpy as np
import pytest

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.api.resources as port_resources
import scheduler_plugins_tpu_torch.controllers as port_controllers
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_table_runner import mirror, run_case, table_params

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.controllers as jax_controllers
    import scheduler_plugins_tpu.state.cluster as jax_cluster
    import tests.test_controllers as jax_tables
except ImportError:
    jax_objects = None


@pytest.fixture
def jax_package():
    if jax_objects is None:
        pytest.skip("the JAX package is not importable here")


def _tables():
    if jax_objects is None:
        return []
    return table_params([jax_tables.TestPodGroupController,
                         jax_tables.TestElasticQuotaController])


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch, request):
    """Each case of `tests/test_controllers.py` on the port's objects,
    store and controllers."""
    mirror(monkeypatch, jax_tables, port_objects, CPU=port_resources.CPU,
           Cluster=PCluster,
           reconcile_elastic_quotas=port_controllers.reconcile_elastic_quotas,
           reconcile_pod_groups=port_controllers.reconcile_pod_groups)
    run_case(cls, method, request)


def _stream(o, Cluster, controllers, seed: int) -> list:
    """Seeded gangs and quotas through 30 reconcile steps: members arrive,
    change phase and leave; the log holds each step's events and every
    gang's and quota's status."""
    rng = np.random.default_rng(seed)
    c = Cluster()
    for ns in ("a", "b"):
        c.add_quota(o.ElasticQuota(name=f"q-{ns}", namespace=ns,
                                   min={"cpu": 1000}, max={"cpu": 9000}))
    for g in range(4):
        c.add_pod_group(o.PodGroup(name=f"g{g}", namespace="a" if g % 2
                                   else "b", min_member=int(g % 3 + 1),
                                   creation_ms=g))
    phases = [o.PodPhase.PENDING, o.PodPhase.RUNNING, o.PodPhase.SUCCEEDED,
              o.PodPhase.FAILED]
    log, serial = [], 0
    for step in range(30):
        for _ in range(int(rng.integers(0, 4))):
            g = int(rng.integers(0, 5))
            ns = "a" if g % 2 else "b"
            labels = {o.POD_GROUP_LABEL: f"g{g}"} if g < 4 else {}
            serial += 1
            c.add_pod(o.Pod(name=f"m{serial}", namespace=ns, labels=labels,
                            containers=[o.Container(requests={
                                "cpu": int(rng.integers(100, 900))})]))
        uids = list(c.pods)
        for uid in uids:
            roll = rng.random()
            if roll < 0.25:
                c.pods[uid].phase = phases[int(rng.integers(0, 4))]
            elif roll < 0.3:
                c.remove_pod(uid)
        events = controllers.reconcile_pod_groups(c, now_ms=1000 * step)
        events += controllers.reconcile_elastic_quotas(c)
        log.append((events,
                    {k: (str(g.phase), g.occupied_by, g.running, g.succeeded,
                         g.failed, g.schedule_start_ms)
                     for k, g in c.pod_groups.items()},
                    {k: dict(q.used) for k, q in c.quotas.items()}))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stream_equals_jax(jax_package, seed):
    want = _stream(jax_objects, jax_cluster.Cluster, jax_controllers, seed)
    got = _stream(port_objects, PCluster, port_controllers, seed)
    assert got == want
    assert any(events for events, _, _ in got)
