"""The port's Lease elector (`bridge.leader.LeaseElector`: the
conditional update on resourceVersion, release on shutdown) against the
JAX package's: the cases of `tests/test_leader.py` run again on the port
(the two-daemon takeover case runs `python -m scheduler_plugins_tpu_torch
--device cpu` processes where JAX's ran its own daemon; it is marked slow
there, so the tier-1 run leaves it out on both sides), and one scripted
sequence of acquire, standby, renew, takeover, conflict and release steps
against the fake apiserver gives both electors the same decisions and
the same Lease objects."""

import subprocess

import pytest

from scheduler_plugins_tpu_torch.bridge.leader import LeaseElector
from torch_table_runner import PortSubprocess, run_case, swap, table_params

try:
    import scheduler_plugins_tpu.bridge.leader as jax_leader
    import tests.test_leader as jax_tables
    from tests.fake_apiserver import FakeApiServer
except ImportError:
    jax_leader = None


@pytest.fixture
def jax_package():
    if jax_leader is None:
        pytest.skip("the JAX package is not importable here")


def _tables():
    if jax_leader is None:
        return []
    return table_params([jax_tables.TestLeaseElector,
                         jax_tables.TestLeaderElectedDaemons,
                         jax_tables.TestConditionalUpdateRace])


@pytest.mark.parametrize("cls,method", _tables())
def test_table_against_port(cls, method, monkeypatch, request):
    """Each case of `tests/test_leader.py` with the port's elector (and
    the port's daemon for the process cases)."""
    swap(monkeypatch, jax_tables, {
        "LeaseElector": LeaseElector,
        "subprocess": PortSubprocess(subprocess, "scheduler_plugins_tpu",
                                     "scheduler_plugins_tpu_torch",
                                     ("--device", "cpu")),
    })
    run_case(cls, method, request)


def _script(Elector) -> list:
    """Two electors on one Lease through a fixed sequence of steps at
    chosen clock times; returns each step's decision and the Lease's
    spec and resourceVersion after it."""
    out = []
    with FakeApiServer() as srv:
        a = Elector(srv.url, "a", lease_duration_s=10.0)
        b = Elector(srv.url, "b", lease_duration_s=10.0)
        lease = ("/apis/coordination.k8s.io/v1/namespaces/kube-system/"
                 "leases/scheduler-plugins-tpu")

        def state():
            with srv.lock:
                obj = srv.objects.get(lease) or {}
            spec = dict(obj.get("spec") or {})
            return (spec.get("holderIdentity"),
                    spec.get("leaseTransitions"),
                    (obj.get("metadata") or {}).get("resourceVersion"))

        for who, now in ((a, 1000.0), (b, 1001.0), (a, 1004.0),
                         (b, 1020.0), (a, 1021.0), (b, 1025.0)):
            out.append((who.identity, who.step(now=now), who.is_leader,
                        who.observed_holder, state()))
        b.release()
        out.append(("release", b.is_leader, state()))
        a.release()  # not the holder: nothing happens
        out.append(("release-a", a.is_leader, state()))
    return out


def test_script_equals_jax(jax_package):
    got = _script(LeaseElector)
    assert got == _script(jax_leader.LeaseElector)
    assert [s[1] for s in got[:6]] == [True, False, True, True, False, True]
