"""The port's profile loader (`scheduler_plugins_tpu_torch.api.config`)
against JAX `load_profile` for the whole roster (the flagship three, the
four Trimaran plugins, NodeResourceTopologyMatch, the network-aware pair,
the in-tree four, SySched, PodState, QOSSort and the two preemption
plugins): arguments and their defaults, weights, the auto-selected
preemption engine (its mode, toleration, sampling and cross-node pool),
the queue sort, and the validation errors (mirrors tests/test_config.py).
The port loads every plugin JAX does. `profile_spec`, the loader's
inverse, must export what JAX's does and load back to the same profile
(mirrors tests/test_tuning.py TestWeightsRoundTrip); for the Trimaran
plugins that export is lossy in both packages alike
(`TestTrimaranSpec`)."""

import pytest

import scheduler_plugins_tpu.api.config as jax_config
from scheduler_plugins_tpu_torch.api import config as port_config

#: the plugins the port loaded before the rest of the roster
EARLIER = ("CapacityScheduling", "Coscheduling", "InterPodAffinity",
           "LoadVariationRiskBalancing", "LowRiskOverCommitment",
           "NetworkOverhead", "NodeAffinity", "NodeResourceTopologyMatch",
           "NodeResourcesAllocatable", "Peaks", "PodTopologySpread",
           "TaintToleration", "TargetLoadPacking", "TopologicalSort")
#: the rest of the roster
REST = ("CrossNodePreemption", "PodState", "PreemptionToleration",
        "QOSSort", "SySched")
PORTED = tuple(sorted(EARLIER + REST))

#: per plugin, the attributes its constructor arguments land in
ATTRS = {
    "Coscheduling": ("permit_waiting_seconds", "pod_group_backoff_seconds",
                     "reject_percentage"),
    "NodeResourcesAllocatable": ("resources", "mode_sign"),
    "CapacityScheduling": ("min_candidate_nodes_percentage",
                           "min_candidate_nodes_absolute"),
    "TargetLoadPacking": ("target", "watcher_address", "metric_provider",
                          "default_request_cpu_millis",
                          "default_requests_multiplier"),
    "LoadVariationRiskBalancing": ("margin", "sensitivity",
                                   "watcher_address", "metric_provider"),
    "LowRiskOverCommitment": ("smoothing_window", "w_cpu", "w_mem",
                              "watcher_address", "metric_provider"),
    "Peaks": ("node_power_model", "watcher_address", "metric_provider"),
    "NodeResourceTopologyMatch": ("strategy", "resources"),
    "NetworkOverhead": ("weights_name", "network_topology_name",
                        "namespaces"),
    "TopologicalSort": ("namespaces",),
    # NodeAffinity's terms are objects of each package: `_added` compares
    # them
    "NodeAffinity": (),
    "TaintToleration": (),
    "PodTopologySpread": (),
    "InterPodAffinity": ("hard_pod_affinity_weight", "ignore_preferred"),
    "SySched": ("default_profile_namespace", "default_profile_name"),
    "PodState": (),
    "QOSSort": (),
    "PreemptionToleration": ("min_candidate_nodes_percentage",
                             "min_candidate_nodes_absolute"),
    "CrossNodePreemption": ("max_pool",),
}

TRIMARAN = ("TargetLoadPacking", "LoadVariationRiskBalancing",
            "LowRiskOverCommitment", "Peaks")

CONFIGS = [
    {"plugins": [p for p in PORTED if p != "NodeResourceTopologyMatch"]},
    {"plugins": ["Coscheduling"],
     "pluginConfig": [{"name": "Coscheduling",
                       "args": {"permitWaitingTimeSeconds": 10}}]},
    {"profileName": "gangs",
     "plugins": ["NodeResourcesAllocatable", "Coscheduling",
                 "CapacityScheduling"],
     "pluginConfig": [
         {"name": "Coscheduling",
          "args": {"permitWaitingTimeSeconds": 30,
                   "podGroupBackoffSeconds": 5,
                   "podGroupRejectPercentage": 40}},
         {"name": "NodeResourcesAllocatable",
          "args": {"resources": [["cpu", 3], ["memory", 2]],
                   "mode": "Most"}},
         {"name": "CapacityScheduling",
          "args": {"minCandidateNodesPercentage": 30,
                   "minCandidateNodesAbsolute": 4}},
     ],
     "weights": [3, 1, 2]},
    {"plugins": ["CapacityScheduling", "NodeResourcesAllocatable"],
     "weights": [1, 7], "solveMode": "sequential"},
    {"plugins": []},
    {"plugins": list(TRIMARAN)},
    {"profileName": "load-aware",
     "plugins": ["TargetLoadPacking", "LoadVariationRiskBalancing",
                 "LowRiskOverCommitment", "Peaks"],
     "pluginConfig": [
         {"name": "TargetLoadPacking",
          "args": {"targetUtilization": 60,
                   "watcherAddress": "http://watcher:2020",
                   "defaultRequests": {"cpu": 2000},
                   "defaultRequestsMultiplier": "2.5"}},
         {"name": "LoadVariationRiskBalancing",
          "args": {"safeVarianceMargin": 2.0,
                   "safeVarianceSensitivity": 0.5,
                   "metricProvider": {"type": "Prometheus",
                                      "address": "http://prom:9090"}}},
         {"name": "LowRiskOverCommitment",
          "args": {"smoothingWindowSize": 3,
                   "riskLimitWeights": {"cpu": 0.2, "memory": 0.8}}},
         {"name": "Peaks",
          "args": {"nodePowerModel": {"node-a": [10.0, 2.0, 0.05]},
                   "metricProvider": {"type": "KubernetesMetricsServer",
                                      "address": "https://api:6443"}}},
     ],
     "weights": [2, 1, 1, 3]},
]


NUMA_CONFIGS = [
    {"plugins": ["NodeResourceTopologyMatch"]},
    {"plugins": ["NodeResourcesAllocatable", "NodeResourceTopologyMatch"],
     "pluginConfig": [{"name": "NodeResourceTopologyMatch", "args": {
         "scoringStrategy": "BalancedAllocation",
         "resources": [["cpu", 2], ["memory", 3]]}}],
     "weights": [1, 4]},
]

NETWORK_CONFIGS = [
    {"plugins": ["NetworkOverhead", "TopologicalSort"]},
    {"profileName": "net",
     "plugins": ["TopologicalSort", "NodeResourcesAllocatable",
                 "NetworkOverhead"],
     "pluginConfig": [
         {"name": "NetworkOverhead",
          "args": {"weightsName": "Custom",
                   "networkTopologyName": "nt-west",
                   "namespaces": ["a", "b"]}},
         {"name": "TopologicalSort", "args": {"namespaces": ["a"]}}],
     "weights": [1, 2, 5]},
]


def summary(profile):
    plugins = [
        (type(p).__name__, p.name, p.weight,
         tuple(getattr(p, a) for a in ATTRS[type(p).__name__]))
        for p in profile.plugins
    ]
    engine = profile.preemption
    pre = None if engine is None else (
        engine.mode.value, engine.min_candidate_nodes_percentage,
        engine.min_candidate_nodes_absolute, engine.toleration,
        engine.CROSS_NODE_MAX_POOL,
    )
    qs = profile.queue_sort
    return (profile.name, profile.solve_mode, plugins, pre,
            None if qs is None else qs.name)


@pytest.mark.parametrize("config", CONFIGS, ids=range(len(CONFIGS)))
def test_load_profile_matches_jax(config):
    assert (summary(port_config.load_profile(config))
            == summary(jax_config.load_profile(config)))


@pytest.mark.parametrize("config", NUMA_CONFIGS,
                         ids=range(len(NUMA_CONFIGS)))
def test_numa_load_profile_matches_jax(config):
    assert (summary(port_config.load_profile(config))
            == summary(jax_config.load_profile(config)))


@pytest.mark.parametrize("config", NETWORK_CONFIGS,
                         ids=range(len(NETWORK_CONFIGS)))
def test_network_load_profile_and_spec_match_jax(config):
    """The network-aware pair loads as JAX's loader builds it (arguments,
    weights, TopologicalSort as the queue sort), exports JAX's spec and
    round-trips."""
    assert (summary(port_config.load_profile(config))
            == summary(jax_config.load_profile(config)))
    spec = port_config.profile_spec(port_config.load_profile(config))
    assert spec == jax_config.profile_spec(jax_config.load_profile(config))
    assert port_config.profile_spec(port_config.load_profile(spec)) == spec
    assert port_config.load_profile(config).queue_sort.name == \
        "TopologicalSort"


INTREE_CONFIGS = [
    {"plugins": ["NodeAffinity", "TaintToleration", "PodTopologySpread",
                 "InterPodAffinity"]},
    {"profileName": "intree",
     "plugins": ["NodeResourcesAllocatable", "NodeAffinity",
                 "TaintToleration", "PodTopologySpread", "InterPodAffinity"],
     "pluginConfig": [
         {"name": "NodeAffinity", "args": {"addedAffinity": [
             {"match_expressions": [
                 {"key": "pool", "operator": "In", "values": ["gpu", "tpu"]},
                 {"key": "spot", "operator": "DoesNotExist", "values": None}],
              "match_fields": None},
             {"match_fields": [{"key": "metadata.name", "operator": "In",
                                "values": ["n7"]}]}]}},
         {"name": "InterPodAffinity",
          "args": {"hardPodAffinityWeight": 7,
                   "ignorePreferredTermsOfExistingPods": True}}],
     "weights": [1, 2, 1, 3, 2]},
    {"plugins": ["InterPodAffinity"],
     "pluginConfig": [{"name": "InterPodAffinity",
                       "args": {"hardPodAffinityWeight": 0}}]},
    {"plugins": ["NodeAffinity", "NodeResourcesAllocatable"],
     "pluginConfig": [{"name": "NodeAffinity",
                       "args": {"addedAffinity": []}}]},
]


def _added(profile):
    """NodeAffinity's addedAffinity terms as plain tuples."""
    def req(r):
        return (r.key, r.operator, tuple(r.values))

    return [tuple((tuple(req(r) for r in t.match_expressions),
                   tuple(req(r) for r in t.match_fields))
                  for t in p.added_affinity)
            for p in profile.plugins if p.name == "NodeAffinity"]


@pytest.mark.parametrize("config", INTREE_CONFIGS,
                         ids=range(len(INTREE_CONFIGS)))
def test_intree_load_profile_and_spec_match_jax(config):
    """The in-tree four load as JAX's loader builds them (addedAffinity
    from its wire form, with JSON nulls; the InterPodAffinity args), export
    JAX's spec and round-trip as JAX's do. Both exports leave out
    ignorePreferredTermsOfExistingPods (stored under another name) and
    addedAffinity terms (objects); a reload of such a spec has no terms,
    which both then export as `addedAffinity: []`, and from there the
    spec is stable."""
    port, jax = (port_config.load_profile(config),
                 jax_config.load_profile(config))
    assert summary(port) == summary(jax)
    assert _added(port) == _added(jax)
    spec = port_config.profile_spec(port)
    assert spec == jax_config.profile_spec(jax)
    again = port_config.profile_spec(port_config.load_profile(spec))
    assert again == jax_config.profile_spec(jax_config.load_profile(spec))
    assert port_config.profile_spec(port_config.load_profile(again)) == again
    assert summary(port_config.load_profile(spec)) == summary(
        jax_config.load_profile(spec))


def test_defaults_and_capacity_engine():
    profile = port_config.load_profile({
        "plugins": ["Coscheduling", "CapacityScheduling"],
        "pluginConfig": [{"name": "Coscheduling",
                          "args": {"permitWaitingTimeSeconds": 10}}],
    })
    cosched = profile.plugins[0]
    assert cosched.permit_waiting_seconds == 10
    assert cosched.reject_percentage == 10  # defaults.go:29-47
    assert profile.preemption.mode.value == "CapacityScheduling"
    assert port_config.available_plugins() == PORTED


BAD = [
    ({"plugins": ["Bogus"]}, "unknown plugin"),
    ({"plugins": ["Coscheduling"],
      "pluginConfig": [{"name": "Coscheduling", "args": {"nope": 1}}]},
     "unknown arg"),
    ({"plugins": ["Coscheduling"],
      "pluginConfig": [{"name": "Coscheduling",
                        "args": {"permitWaitingTimeSeconds": -5}}]},
     "non-negative"),
    ({"plugins": ["Coscheduling"],
      "pluginConfig": [{"name": "Coscheduling",
                        "args": {"podGroupRejectPercentage": 101}}]},
     "reject percentage"),
    ({"plugins": ["NodeResourcesAllocatable"],
      "pluginConfig": [{"name": "NodeResourcesAllocatable",
                        "args": {"mode": "Sideways"}}]},
     "invalid mode"),
    ({"plugins": ["NodeResourcesAllocatable"],
      "pluginConfig": [{"name": "NodeResourcesAllocatable",
                        "args": {"resources": [["cpu", 0]]}}]},
     "positive"),
    ({"plugins": ["CapacityScheduling"],
      "pluginConfig": [{"name": "CapacityScheduling",
                        "args": {"minCandidateNodesPercentage": 0,
                                 "minCandidateNodesAbsolute": 0}}]},
     "cannot both be zero"),
    ({"plugins": ["TargetLoadPacking"],
      "pluginConfig": [{"name": "TargetLoadPacking",
                        "args": {"targetUtilization": 0}}]},
     "target utilization"),
    ({"plugins": ["TargetLoadPacking"],
      "pluginConfig": [{"name": "TargetLoadPacking",
                        "args": {"defaultRequestsMultiplier": "x"}}]},
     "invalid defaultRequestsMultiplier"),
    ({"plugins": ["TargetLoadPacking"],
      "pluginConfig": [{"name": "TargetLoadPacking",
                        "args": {"defaultRequestsMultiplier": 0.5}}]},
     "must be >= 1"),
    ({"plugins": ["LoadVariationRiskBalancing"],
      "pluginConfig": [{"name": "LoadVariationRiskBalancing",
                        "args": {"safeVarianceMargin": -1}}]},
     "non-negative"),
    ({"plugins": ["Peaks"],
      "pluginConfig": [{"name": "Peaks",
                        "args": {"metricProvider": {"type": "Bogus"}}}]},
     "invalid metric provider type"),
    ({"plugins": ["LowRiskOverCommitment"],
      "pluginConfig": [{"name": "LowRiskOverCommitment",
                        "args": {"metricProvider": {"type": "SignalFx",
                                                    "address": "x"}}}]},
     "external SDK"),
    ({"plugins": ["TargetLoadPacking"],
      "pluginConfig": [{"name": "TargetLoadPacking",
                        "args": {"metricProvider": {"type": "Prometheus"}}}]},
     "requires an address"),
    ({"plugins": ["NodeResourceTopologyMatch"],
      "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                        "args": {"scoringStrategy": "Fewest"}}]},
     "illegal scoring strategy"),
    ({"plugins": ["NodeResourceTopologyMatch"],
      "pluginConfig": [{"name": "NodeResourceTopologyMatch",
                        "args": {"cacheResyncPeriodSeconds": -1}}]},
     "cacheResyncPeriodSeconds"),
    ({"plugins": ["InterPodAffinity"],
      "pluginConfig": [{"name": "InterPodAffinity",
                        "args": {"hardPodAffinityWeight": 101}}]},
     "hardPodAffinityWeight must be in"),
    ({"plugins": ["NodeAffinity"],
      "pluginConfig": [{"name": "NodeAffinity",
                        "args": {"addedAffinity": [], "bogus": 1}}]},
     "unknown arg 'bogus'"),
    ({"plugins": ["Coscheduling"], "weights": [1, 2]}, "weights list"),
    ({"plugins": ["Coscheduling"], "weights": [0]}, "weight must be"),
    ({"plugins": ["Coscheduling"], "solveMode": "bogus"},
     "unknown solveMode"),
]


@pytest.mark.parametrize("config,match", BAD, ids=[m for _, m in BAD])
def test_validation_errors_match_jax(config, match):
    with pytest.raises(ValueError, match=match):
        jax_config.load_profile(config)
    with pytest.raises(ValueError, match=match):
        port_config.load_profile(config)


def test_roster_is_the_jax_roster():
    assert port_config.ROSTER == jax_config.available_plugins()
    assert set(port_config.ROSTER) == set(port_config.available_plugins())


@pytest.mark.parametrize("name", REST)
def test_ported_plugin_loads_like_jax(name):
    """Each plugin of the rest of the roster loads in both packages to
    the same plugin, arguments, engine and queue sort."""
    config = {"plugins": ["Coscheduling", name]}
    port, jax = (port_config.load_profile(config),
                 jax_config.load_profile(config))
    assert type(port.plugins[1]).__name__ == type(jax.plugins[1]).__name__
    assert summary(port) == summary(jax)


REST_CONFIGS = [
    {"plugins": ["SySched"], "pluginConfig": [
        {"name": "SySched", "args": {"defaultProfileNamespace": "ops",
                                     "defaultProfileName": "full"}}]},
    {"plugins": ["NodeResourcesAllocatable", "PreemptionToleration"],
     "pluginConfig": [
         {"name": "PreemptionToleration",
          "args": {"minCandidateNodesPercentage": 20,
                   "minCandidateNodesAbsolute": 7}}]},
    {"plugins": ["NodeResourcesAllocatable", "CrossNodePreemption"],
     "pluginConfig": [{"name": "CrossNodePreemption",
                       "args": {"maxPool": 5}}]},
    {"profileName": "roster",
     "plugins": ["QOSSort", "NodeResourcesAllocatable", "SySched",
                 "PodState", "PreemptionToleration"],
     "weights": [1, 2, 3, 1, 1]},
]


@pytest.mark.parametrize("config", REST_CONFIGS,
                         ids=range(len(REST_CONFIGS)))
def test_rest_load_profile_and_spec_match_jax(config):
    """SySched's two default-profile arguments, PreemptionToleration's
    sampling arguments and CrossNodePreemption's maxPool load as JAX's
    loader builds them, export JAX's spec and round-trip."""
    port, jax = (port_config.load_profile(config),
                 jax_config.load_profile(config))
    assert summary(port) == summary(jax)
    spec = port_config.profile_spec(port)
    assert spec == jax_config.profile_spec(jax)
    assert port_config.profile_spec(port_config.load_profile(spec)) == spec
    assert summary(port_config.load_profile(spec)) == summary(
        jax_config.load_profile(spec))


@pytest.mark.parametrize("config,match", [
    ({"plugins": ["CrossNodePreemption"], "pluginConfig": [
        {"name": "CrossNodePreemption", "args": {"maxPool": 0}}]},
     "max_pool"),
    ({"plugins": ["PreemptionToleration"], "pluginConfig": [
        {"name": "PreemptionToleration",
         "args": {"minCandidateNodesPercentage": 101}}]},
     "minCandidateNodesPercentage"),
    ({"plugins": ["SySched"], "pluginConfig": [
        {"name": "SySched", "args": {"profile": "x"}}]}, "unknown arg"),
], ids=["max_pool", "percentage", "sysched_arg"])
def test_rest_validation_errors_match_jax(config, match):
    with pytest.raises(ValueError, match=match):
        jax_config.load_profile(config)
    with pytest.raises(ValueError, match=match):
        port_config.load_profile(config)


def test_packing_mode_raises_not_implemented():
    config = {"plugins": ["NodeResourcesAllocatable"], "solveMode": "packing"}
    jax_config.load_profile(config)
    with pytest.raises(NotImplementedError, match="packing"):
        port_config.load_profile(config)


@pytest.mark.parametrize("config", CONFIGS, ids=range(len(CONFIGS)))
def test_profile_spec_matches_jax_and_round_trips(config):
    spec = port_config.profile_spec(port_config.load_profile(config))
    assert spec == jax_config.profile_spec(jax_config.load_profile(config))
    # loading the spec back rebuilds a profile with the same spec
    assert port_config.profile_spec(port_config.load_profile(spec)) == spec


def test_profile_spec_weights_and_defaults():
    from scheduler_plugins_tpu import plugins as jax_plugins
    from scheduler_plugins_tpu.framework import Profile as JProfile
    from scheduler_plugins_tpu_torch import plugins as port_plugins
    from scheduler_plugins_tpu_torch.framework import Profile as PProfile

    specs = []
    for plugins, profile, config in (
            (jax_plugins, JProfile, jax_config),
            (port_plugins, PProfile, port_config)):
        default = config.profile_spec(profile(
            plugins=[plugins.NodeResourcesAllocatable()]))
        assert "weights" not in default
        tuned = [plugins.NodeResourcesAllocatable(mode="Most"),
                 plugins.CapacityScheduling(min_candidate_nodes_absolute=3)]
        tuned[0].weight = 46
        spec = config.profile_spec(profile(plugins=tuned, name="tuned"))
        assert spec["weights"] == [46, 1]
        assert [p.weight for p in config.load_profile(spec).plugins] == [
            46, 1]
        specs.append((default, spec))
    assert specs[0] == specs[1]


class TestTrimaranSpec:
    def test_target_utilization_builds_what_jax_builds(self):
        config = {"plugins": ["TargetLoadPacking"], "pluginConfig": [
            {"name": "TargetLoadPacking",
             "args": {"targetUtilization": 60}}]}
        port = port_config.load_profile(config).plugins[0]
        jax = jax_config.load_profile(config).plugins[0]
        assert port.target == jax.target == 60.0
        assert (port.default_requests_multiplier,
                port.default_request_cpu_millis) == (
            jax.default_requests_multiplier, jax.default_request_cpu_millis)

    def test_export_is_lossy_like_jax(self):
        """The Trimaran constructors keep targetUtilization,
        safeVariance*, smoothingWindowSize, riskLimitWeights and
        defaultRequests under other names, and neither package exports
        them: the spec keeps only the args stored under their kwarg's
        name (watcherAddress, metricProvider, defaultRequestsMultiplier,
        nodePowerModel), so a reload falls back to the defaults for the
        rest, in both packages alike."""
        config = CONFIGS[-1]
        spec = port_config.profile_spec(port_config.load_profile(config))
        assert spec == jax_config.profile_spec(jax_config.load_profile(config))
        args = {e["name"]: e["args"] for e in spec["pluginConfig"]}
        assert args["TargetLoadPacking"] == {
            "watcherAddress": "http://watcher:2020",
            "defaultRequestsMultiplier": 2.5}
        assert "LowRiskOverCommitment" not in args
        assert args["Peaks"]["nodePowerModel"] == {
            "node-a": [10.0, 2.0, 0.05]}
        reloaded = port_config.load_profile(spec)
        assert reloaded.plugins[0].target == 40.0
        assert summary(reloaded) == summary(jax_config.load_profile(spec))
