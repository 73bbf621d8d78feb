"""The port's cluster-side agent (`bridge.agent`: the watch-event
translation with its quantity conversions, `ClusterAgent.replay` and
`list_then_watch`) against the JAX package's.

- The cases of `tests/test_agent.py` run again on the port with every
  translator (`translate`, `pod_event`, `nrt_event`,
  `quantity_to_units`) a differential twin: each call runs the port's and
  JAX's on the same recorded event and requires equal results (tolerance
  0), so every recorded event of those cases is compared.
- The cases of `tests/test_agent_live.py` (LIST bootstrap, resourceVersion
  resume, BOOKMARKs, relist on 410, reconnect backoff, bearer auth)
  against `tests/fake_apiserver.py`, on the port's agent, feed and store,
  its translations compared the same way."""

import pytest

import scheduler_plugins_tpu_torch.bridge.agent as port_agent
from test_torch_feed import swap_feed_stack
from torch_table_runner import run_case, swap, table_params

try:
    import scheduler_plugins_tpu.bridge.agent as jax_agent
    import tests.test_agent as jax_tables
    import tests.test_agent_live as jax_live
except ImportError:
    jax_agent = None

#: the translators compared call by call
TRANSLATORS = ("translate", "pod_event", "nrt_event", "quantity_to_units")


@pytest.fixture
def compared(monkeypatch):
    """Each port translator replaced by a twin that also runs JAX's and
    requires the same result; yields the list of compared calls."""
    calls = []

    def twin(name):
        port_fn, jax_fn = getattr(port_agent, name), getattr(jax_agent, name)

        def fn(*args, **kw):
            got = port_fn(*args, **kw)
            assert got == jax_fn(*args, **kw), (name, args)
            calls.append(name)
            return got
        return fn

    twins = {name: twin(name) for name in TRANSLATORS}
    # the port agent's own calls (ClusterAgent.replay reads its module's
    # `translate`) and the JAX tables' direct ones
    swap(monkeypatch, port_agent, twins)
    yield twins, calls


def _tables(module, classes):
    if jax_agent is None:
        return []
    return table_params([getattr(module, c) for c in classes])


@pytest.mark.parametrize("cls,method", _tables(jax_tables, [
    "TestQuantities", "TestTranslate", "TestRecordedStreamEndToEnd"]) if
    jax_agent is not None else [])
def test_agent_table_against_port(cls, method, compared, monkeypatch,
                                  request):
    twins, calls = compared
    swap_feed_stack(monkeypatch)
    swap(monkeypatch, jax_tables, {"ClusterAgent": port_agent.ClusterAgent,
                                   **{n: twins[n] for n in TRANSLATORS}})
    run_case(cls, method, request)
    if cls.__name__ != "TestQuantities":
        assert "translate" in calls or "pod_event" in calls \
            or "nrt_event" in calls


@pytest.mark.parametrize("cls,method", _tables(jax_live, [
    "TestListThenWatchWire", "TestLiveEndToEnd", "TestListPhaseTimeouts"])
    if jax_agent is not None else [])
def test_live_table_against_port(cls, method, compared, monkeypatch,
                                 request):
    swap_feed_stack(monkeypatch)
    swap(monkeypatch, jax_live, {"ClusterAgent": port_agent.ClusterAgent})
    run_case(cls, method, request)
