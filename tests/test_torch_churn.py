"""Multi-cycle churn through the port's `run_cycle(serve=)` against its
full-resnapshot cycle and against the JAX package, cycle for cycle
(`tests/torch_churn_cases.py`).

- The flagship profile's thirty churn cycles and ten drain cycles
  (`tests/test_churn.py`, without its controller reconciles, on both
  sides): the served port equals the plain port, and the served port
  equals the served JAX package, every cycle's bound, failed, reserved
  and rejected gangs and the engine's counters; no invariant breaks and
  every plain pod binds in the end.
- Bench config 7's churn loop at a cut shape (62 nodes, 512 bound pods,
  14 cycles with node adds, a padding-bucket growth and two node
  deletes): served equals the full-resnapshot baseline, 0 capacity
  violations, and the placements, rebases and generation equal JAX's.

Integers with tolerance 0."""

from types import SimpleNamespace

import pytest

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.api.config import load_profile
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.serving import ServeEngine as PServeEngine
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_churn_cases import (
    CHURN_PROFILE,
    CHURN_TEST_SHAPE,
    capacity_violations,
    churn_cluster,
    flagship_churn,
    run_churn,
)

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.serving import ServeEngine as JServeEngine
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
except ImportError:
    jax_objects = None

PORT = SimpleNamespace(
    objects=port_objects, Cluster=PCluster, Profile=PProfile,
    Scheduler=PScheduler, plugins=port_plugins, Engine=PServeEngine,
    run=lambda s, c, now, e: port_cycle.run_cycle(s, c, now=now, serve=e,
                                                  device="cpu"),
)
JAX = None if jax_objects is None else SimpleNamespace(
    objects=jax_objects, Cluster=JCluster, Profile=JProfile,
    Scheduler=JScheduler, plugins=jax_plugins, Engine=JServeEngine,
    run=lambda s, c, now, e: jax_cycle.run_cycle(s, c, now=now, serve=e),
)


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def engine_state(engine):
    return (engine.generation, engine.rebases, engine.gang_fallbacks,
            engine.antientropy_divergences)


def served(pkg):
    return lambda cluster: pkg.Engine().attach(cluster)


class TestFlagshipChurn:
    def test_thirty_cycle_churn(self):
        """The plain run keeps every invariant and binds every plain pod
        (`tests/test_churn.py` `test_thirty_cycle_churn`)."""
        plain = flagship_churn(PORT, PORT.run)
        assert plain["violations"] == []
        assert plain["plain_left"] == []
        assert plain["placements"]

    def test_thirty_cycle_churn_serve_mode_parity(self, jax_package):
        """Served equals plain on the port, cycle for cycle, and the
        served port equals the served JAX package, the engine's counters
        included."""
        plain = flagship_churn(PORT, PORT.run)
        port = flagship_churn(PORT, PORT.run, serve=served(PORT))
        jax = flagship_churn(JAX, JAX.run, serve=served(JAX))
        assert port["reports"] == plain["reports"]
        assert port["placements"] == plain["placements"]
        assert port["violations"] == [] and port["plain_left"] == []
        assert port["reports"] == jax["reports"]
        assert port["placements"] == jax["placements"]
        assert engine_state(port["engine"]) == engine_state(jax["engine"])


def config7_run(pkg, make_scheduler, serve: bool):
    shape = CHURN_TEST_SHAPE
    cluster = churn_cluster(pkg, shape["n_nodes"], shape["prefill"])
    engine = pkg.Engine().attach(cluster) if serve else None
    out = run_churn(pkg, cluster, make_scheduler(), shape, pkg.run,
                    engine=engine)
    out["violations"] = capacity_violations(cluster)
    out["engine"] = engine_state(engine) if engine is not None else None
    out["npad"] = engine.npad if engine is not None else None
    return out


class TestConfig7Drivers:
    def test_serve_equals_baseline(self):
        def sched():
            return PScheduler(load_profile(CHURN_PROFILE))

        serve = config7_run(PORT, sched, serve=True)
        base = config7_run(PORT, sched, serve=False)
        assert serve["reports"] == base["reports"]
        assert serve["placements"] == base["placements"]
        assert serve["violations"] == 0 == base["violations"]
        # the first refresh and the two node deletes rebuild; a node add
        # grows the padding bucket in between
        assert serve["engine"][1] == 3
        assert serve["npad"] == 64
        assert sum(serve["decided"]) > 0

    def test_port_equals_jax(self, jax_package):
        port = config7_run(
            PORT, lambda: PScheduler(load_profile(CHURN_PROFILE)), True)
        jax = config7_run(JAX, lambda: JScheduler(JProfile(
            plugins=[jax_plugins.NodeResourcesAllocatable()])), True)
        assert port["reports"] == jax["reports"]
        assert port["placements"] == jax["placements"]
        assert port["engine"] == jax["engine"]
        assert port["decided"] == jax["decided"]
        assert port["violations"] == 0 == jax["violations"]
