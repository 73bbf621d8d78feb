"""The port's NRT cache tier (`scheduler_plugins_tpu_torch.state.nrt_cache`,
the store's cache hooks, the snapshot's stale nodes, the NUMA plugin's
cache install and the cycle's resync and maybe-overreserved marking)
against the JAX package.

Every case of the JAX decision tables `tests/test_nrt_cache.py` and
`tests/test_nrt_cache_machine.py` runs twice: once as written, once with
every JAX name it calls (objects, caches, store, scheduler, cycle, plugin,
fingerprint) swapped for the port's. In both runs the cache classes are
traced: every call of a cache method logs its arguments, its result and
the cache's whole bookkeeping after it (`torch_numa_cases.cache_state`:
NRT copies, pending reports, assumed map, flag sets, generation,
reservations, the view and its stale nodes). The two logs must be equal,
so the port replays the same event script into the same states, call by
call, and the table's own asserts hold on the port too.

`nrt_cache_script` then runs through JAX `run_cycle` and the port's cycle
by cycle: reports, store and the cache's state equal after every cycle.
Tolerance 0 everywhere: all of it is integers, strings and sets.

The `cuda`-marked test runs on a card only (`python -m pytest
tests/test_torch_nrt_cache.py -m cuda`); it needs no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.state.nrt_cache as port_nrt
from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.plugins import NodeResourceTopologyMatch
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_numa_cases import cache_state, nrt_cache_script

try:
    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.state.cluster as jax_store
    import scheduler_plugins_tpu.state.nrt_cache as jax_nrt
    import tests.test_nrt_cache as jax_tables
    import tests.test_nrt_cache_machine as jax_machine
    from tests.test_torch_cycle import JAX, PORT, report_diff, store_diff
    from tests.test_torch_numa import _CPUCluster, _CPUScheduler
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    JAX = None

GIB = 1 << 30

#: the cache methods the trace records
TRACED = ("update_nrt", "delete_nrt", "track_pod", "reserve", "unreserve",
          "post_bind", "mark_maybe_overreserved", "view", "desynced_nodes",
          "resync")
CACHES = ("OverReserveCache", "DiscardReservedCache", "PassthroughCache")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def plain(value):
    """A call's argument or result as plain data both packages share."""
    if hasattr(value, "zones") and hasattr(value, "node_name"):
        return ("nrt", value.node_name, int(value.policy), int(value.scope),
                value.pod_fingerprint, value.pod_fingerprint_method,
                [(z.numa_id, sorted(z.available.items()))
                 for z in value.zones])
    if hasattr(value, "uid") and hasattr(value, "containers"):
        return ("pod", value.uid, value.node_name)
    if isinstance(value, (set, frozenset)):
        return sorted(plain(v) for v in value)
    if isinstance(value, dict):
        return sorted((plain(k), plain(v)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def traced(cls, log):
    """`cls` with every TRACED method logging (name, args, result, the
    cache's state after the call)."""
    def wrap(name):
        def method(self, *args, **kwargs):
            out = getattr(super(sub, self), name)(*args, **kwargs)
            if not getattr(self, "_in_trace", False):
                self._in_trace = True
                try:
                    log.append((name, plain(args), plain(out),
                                cache_state(self)))
                finally:
                    self._in_trace = False
            return out
        return method

    sub = type(cls.__name__, (cls,),
               {name: wrap(name) for name in TRACED if hasattr(cls, name)})
    return sub


def _port_run_cycle(s, c, now=None, **kw):
    return port_cycle.run_cycle(s, c, now=now, device="cpu", **kw)


def _swap_to_port(mp, table_module, log):
    """Every JAX name the table module calls, at its module level and in
    the JAX modules its function-level imports read, swapped for the
    port's (the caches traced into `log`)."""
    port_caches = {name: traced(getattr(port_nrt, name), log)
                   for name in CACHES}
    for name in CACHES:
        mp.setattr(port_nrt, name, port_caches[name])
        mp.setattr(jax_nrt, name, port_caches[name])
    for name in ("compute_pod_fingerprint", "uses_exclusive_resources"):
        mp.setattr(jax_nrt, name, getattr(port_nrt, name))
    objects = ("Container", "Node", "NodeResourceTopology", "NUMAZone",
               "Pod", "PodPhase", "TopologyManagerPolicy",
               "TopologyManagerScope")
    for name in objects:
        mp.setattr(jax_objects, name, getattr(port_objects, name))
    mp.setattr(jax_cycle, "_resync_nrt_cache", port_cycle._resync_nrt_cache)
    mp.setattr(jax_store, "Cluster", _CPUCluster)
    mp.setattr(jax_plugins, "NodeResourceTopologyMatch",
               NodeResourceTopologyMatch)
    replacements = {
        **{name: getattr(port_objects, name) for name in objects},
        **port_caches,
        "compute_pod_fingerprint": port_nrt.compute_pod_fingerprint,
        "uses_exclusive_resources": port_nrt.uses_exclusive_resources,
        "Cluster": _CPUCluster, "Scheduler": _CPUScheduler,
        "Profile": Profile, "run_cycle": _port_run_cycle,
        "NodeResourceTopologyMatch": NodeResourceTopologyMatch,
    }
    for name, value in replacements.items():
        if hasattr(table_module, name):
            mp.setattr(table_module, name, value)


def _trace_jax(mp, table_module, log):
    """The JAX caches traced into `log`, the rest of the table as is."""
    for name in CACHES:
        cls = traced(getattr(jax_nrt, name), log)
        mp.setattr(jax_nrt, name, cls)
        if hasattr(table_module, name):
            mp.setattr(table_module, name, cls)


def _cases():
    if JAX is None:
        return []
    out = []
    for module in (jax_tables, jax_machine):
        for cls_name, cls in sorted(vars(module).items()):
            if not (cls_name.startswith("Test") and isinstance(cls, type)):
                continue
            for name in sorted(vars(cls)):
                if name.startswith("test_"):
                    out.append(pytest.param(
                        module, cls, name,
                        id=f"{module.__name__.rsplit('.', 1)[1]}."
                           f"{cls_name}.{name}"))
    return out


@pytest.mark.parametrize("module,cls,method", _cases())
def test_decision_table_replays_like_jax(module, cls, method, monkeypatch):
    """One case of the JAX cache tables: the JAX run's and the port's
    traces are equal call by call."""
    logs = []
    for swap in (_trace_jax, _swap_to_port):
        log = []
        with monkeypatch.context() as mp:
            swap(mp, module, log)
            getattr(cls(), method)()
        logs.append(log)
    jax_log, port_log = logs
    assert len(port_log) == len(jax_log)
    for k, (want, got) in enumerate(zip(jax_log, port_log)):
        assert got == want, (k, want[0])


def test_the_tables_are_all_replayed():
    """Every test of both JAX files is a case here (a JAX case added
    later joins without an edit), and the traces are not empty."""
    names = {p.id.split(".", 1)[1] for p in _cases()}
    for module in (jax_tables, jax_machine):
        for cls_name, cls in vars(module).items():
            if cls_name.startswith("Test") and isinstance(cls, type):
                for name in vars(cls):
                    if name.startswith("test_"):
                        assert f"{cls_name}.{name}" in names
    assert len(names) >= 50


class TestFingerprint:
    @pytest.mark.parametrize("seed", range(4))
    def test_same_string_as_jax(self, seed):
        rng = np.random.default_rng(seed)
        pods = {(f"ns-{int(rng.integers(0, 5))}",
                 f"pod-{int(rng.integers(0, 1000))}")
                for _ in range(int(rng.integers(0, 40)))}
        want = jax_nrt.compute_pod_fingerprint(pods)
        assert port_nrt.compute_pod_fingerprint(pods) == want
        assert port_nrt.compute_pod_fingerprint(list(pods)[::-1]) == want
        assert want.startswith("pfp0v1:") and len(want) == 7 + 16

    def test_exclusive_resources_match_jax(self):
        rng = np.random.default_rng(3)
        kinds = ("cpu", "memory", "hugepages-2Mi", "vendor.com/nic",
                 "kubernetes.io/batch-cpu")
        for _ in range(200):
            pkgs = []
            seed = int(rng.integers(1 << 30))
            for o in (jax_objects, port_objects):
                r = np.random.default_rng(seed)
                containers = []
                for _ in range(int(r.integers(1, 3))):
                    req = {k: int(r.integers(0, 3)) * 500 for k in kinds
                           if r.random() < 0.5}
                    lim = dict(req) if r.random() < 0.5 else {}
                    containers.append(o.Container(
                        requests=req, limits=lim,
                        restart_policy_always=bool(r.random() < 0.5)))
                pkgs.append(o.Pod(name="p", containers=containers[1:],
                                  init_containers=containers[:1]))
            assert (port_nrt.uses_exclusive_resources(pkgs[1])
                    == jax_nrt.uses_exclusive_resources(pkgs[0]))


# --- the cache through run_cycle ------------------------------------------

def _pkg(base, nrt_module):
    return SimpleNamespace(**vars(base), nrt_cache=nrt_module)


def run_cache_script(script, **kw):
    """Both packages through `script`: reports, store and cache state
    equal after every cycle. Returns the port's cluster, reports and the
    cache states after each cycle."""
    jpkg, ppkg = _pkg(JAX, jax_nrt), _pkg(PORT, port_nrt)
    jc, js, jsteps = script(jpkg, **kw)
    pc, ps, psteps = script(ppkg, **kw)
    reports, states = [], []
    for k, ((now, jmut), (_, pmut)) in enumerate(zip(jsteps, psteps)):
        if jmut is not None:
            jmut(jpkg, jc)
            pmut(ppkg, pc)
        jr, pr = JAX.run(js, jc, now), PORT.run(ps, pc, now)
        assert report_diff(jr, pr) == [], (k, jr, pr)
        assert store_diff(jc, pc) == [], (k, store_diff(jc, pc))
        state = cache_state(pc.nrt_cache)
        assert state == cache_state(jc.nrt_cache), k
        reports.append(pr)
        states.append(state)
    return pc, reports, states


class TestCacheCycles:
    @pytest.mark.parametrize("mode", ["Dedicated", "Shared"])
    def test_script_matches_jax(self, mode):
        run_cache_script(nrt_cache_script, informer_mode=mode)

    def test_script_reaches_its_outcomes(self):
        """What `nrt_cache_script` is for, on the port's side: cycle 2's
        overcommit is blocked by the assumed deduction and its failures
        mark the nodes; the foreign pod makes n4 stale; cycle 3's resync
        flushes the matching reports in one generation and its pods
        bind."""
        c, (r1, r2, r3, r4), states = run_cache_script(nrt_cache_script)
        assert len(r1.bound) == 6 and not r1.failed
        assert r2.failed and set(r2.failed_by.values()) == {
            "NodeResourceTopologyMatch"}
        assert "n4" in states[1]["stale"]
        assert {"n0", "n1", "n2", "n3"} <= set(states[1]["maybe_overreserved"])
        assert states[1]["generation"] == 0
        # cycle 3's resync took the matching reports (their fingerprints
        # now in the flushed copies) and left n2's and n3's pending
        assert states[2]["generation"] == 1
        flushed = {t[0] for t in states[2]["nrts"] if t[4]}
        assert flushed == {"n0", "n1", "n4"}
        assert {t[0] for t in states[2]["pending"]} == {"n2", "n3"}
        assert "n4" not in states[2]["stale"]
        assert r3.bound
        assert states[3]["assumed"] != states[2]["assumed"]
        assert "n0" in r4.bound.values()

    def test_stale_nodes_reach_the_snapshot(self):
        """The snapshot's `numa.fresh` equals JAX's with the cache's stale
        nodes, and moves to the device with the other zone tables."""
        jpkg, ppkg = _pkg(JAX, jax_nrt), _pkg(PORT, port_nrt)
        out = []
        for pkg in (jpkg, ppkg):
            c, s, steps = nrt_cache_script(pkg)
            pkg.run(s, c, steps[0][0])
            steps[1][1](pkg, c)
            kw = {} if pkg is jpkg else {"device": "cpu"}
            snap, _ = c.snapshot(c.pending_pods(), now_ms=0, **kw)
            out.append((np.asarray(snap.numa.fresh),
                        np.asarray(snap.numa.available)))
        (jf, ja), (pf, pa) = out
        assert np.array_equal(jf, pf) and not pf.all()
        assert np.array_equal(ja, pa)


class TestConfig:
    CACHE_CONFIGS = [
        {"cacheResyncPeriodSeconds": 5},
        {"cacheResyncPeriodSeconds": 0},
        {"discardReservedNodes": True},
        {"cacheResyncPeriodSeconds": 3,
         "cache": {"foreignPodsDetect": "OnlyExclusiveResources",
                   "resyncMethod": "All", "informerMode": "Shared"}},
        {"cache": {}},
    ]

    @pytest.mark.parametrize("args", CACHE_CONFIGS,
                             ids=range(len(CACHE_CONFIGS)))
    def test_load_profile_and_spec_round_trip(self, args):
        """`load_profile` takes the cache arguments and builds the cache
        JAX builds; `profile_spec` exports what JAX's exports, and the
        spec loads back to the same spec."""
        config = {"plugins": ["NodeResourceTopologyMatch"],
                  "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                                    "args": args}]}
        jp = jax_config.load_profile(config).plugins[0]
        pp = port_config.load_profile(config).plugins[0]
        assert pp._cache_signature() == jp._cache_signature()
        assert pp._cache_args_given == jp._cache_args_given
        assert (cache_state(pp.make_cache({"a", "b"}))
                == cache_state(jp.make_cache({"a", "b"})))
        spec = port_config.profile_spec(port_config.load_profile(config))
        assert spec == jax_config.profile_spec(jax_config.load_profile(config))
        assert port_config.profile_spec(port_config.load_profile(spec)) == spec

    @pytest.mark.parametrize("args,match", [
        ({"cacheResyncPeriodSeconds": -1}, ">= 0"),
        ({"cache": {"foreignPodsDetect": "Some"}}, "foreignPodsDetect"),
        ({"cache": {"resyncMethod": "Never"}}, "resyncMethod"),
        ({"cache": {"informerMode": "Private"}}, "informerMode"),
    ])
    def test_invalid_args_raise_like_jax(self, args, match):
        config = {"plugins": ["NodeResourceTopologyMatch"],
                  "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                                    "args": args}]}
        with pytest.raises(ValueError, match=match):
            jax_config.load_profile(config)
        with pytest.raises(ValueError, match=match):
            port_config.load_profile(config)

    def test_install_once_per_signature(self):
        """`configure_cluster` seeds the cache from the store's NRTs and
        pods, keeps it while the signature holds, and replaces it when
        the arguments change; a plugin without cache arguments installs
        nothing."""
        c, _, _ = nrt_cache_script(_pkg(PORT, port_nrt))
        NodeResourceTopologyMatch().configure_cluster(c)
        assert c.nrt_cache is None
        plugin = NodeResourceTopologyMatch(cache_resync_period_seconds=2)
        plugin.configure_cluster(c)
        first = c.nrt_cache
        assert isinstance(first, port_nrt.OverReserveCache)
        assert sorted(first.nrts) == sorted(c.nrts)
        assert first.resync_period_ms == 2000
        plugin.configure_cluster(c)
        assert c.nrt_cache is first
        NodeResourceTopologyMatch(
            discard_reserved_nodes=True).configure_cluster(c)
        assert isinstance(c.nrt_cache, port_nrt.DiscardReservedCache)


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card (CUDA is not available)")
        return torch.device("cuda")

    @pytest.fixture(autouse=True)
    def jax_package(self):
        """The card test needs no JAX: it overrides the module's guard."""

    def test_card_equals_cpu(self, card):
        """`nrt_cache_script` with every cycle solved on the card equals
        the CPU's: reports, pods' nodes and the cache's state."""
        from scheduler_plugins_tpu_torch.plugins import noderesourcetopology

        runs = []
        for device in (card, torch.device("cpu")):
            pkg = SimpleNamespace(
                o=port_objects, Cluster=PCluster, Profile=Profile,
                Scheduler=Scheduler, plugins=noderesourcetopology,
                nrt_cache=port_nrt)
            c, s, steps = nrt_cache_script(pkg)
            out = []
            for now, mutate in steps:
                if mutate is not None:
                    mutate(pkg, c)
                r = port_cycle.run_cycle(s, c, now=now, device=device)
                out.append((r.bound, r.failed, r.failed_by,
                            cache_state(c.nrt_cache),
                            {u: p.node_name for u, p in c.pods.items()}))
            runs.append(out)
        assert runs[0] == runs[1]
