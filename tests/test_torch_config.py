"""The port's profile loader (`scheduler_plugins_tpu_torch.api.config`)
against JAX `load_profile` for the three ported plugins: arguments and
their defaults, weights, the auto-selected preemption engine, and the
validation errors (mirrors tests/test_config.py). Plugins JAX has and the
port does not raise NotImplementedError naming them. `profile_spec`, the
loader's inverse, must export what JAX's does and load back to the same
profile (mirrors tests/test_tuning.py TestWeightsRoundTrip)."""

import pytest

import scheduler_plugins_tpu.api.config as jax_config
from scheduler_plugins_tpu_torch.api import config as port_config

PORTED = ("CapacityScheduling", "Coscheduling", "NodeResourcesAllocatable")

#: per plugin, the attributes its constructor arguments land in
ATTRS = {
    "Coscheduling": ("permit_waiting_seconds", "pod_group_backoff_seconds",
                     "reject_percentage"),
    "NodeResourcesAllocatable": ("resources", "mode_sign"),
    "CapacityScheduling": ("min_candidate_nodes_percentage",
                           "min_candidate_nodes_absolute"),
}

CONFIGS = [
    {"plugins": list(PORTED)},
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
        engine.min_candidate_nodes_absolute,
    )
    qs = profile.queue_sort
    return (profile.name, profile.solve_mode, plugins, pre,
            None if qs is None else qs.name)


@pytest.mark.parametrize("config", CONFIGS, ids=range(len(CONFIGS)))
def test_load_profile_matches_jax(config):
    assert (summary(port_config.load_profile(config))
            == summary(jax_config.load_profile(config)))


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


@pytest.mark.parametrize(
    "name", sorted(set(port_config.ROSTER) - set(PORTED)))
def test_unported_plugin_raises_not_implemented(name):
    jax_config.load_profile({"plugins": [name]})  # a real plugin in JAX
    with pytest.raises(NotImplementedError, match=name):
        port_config.load_profile({"plugins": ["Coscheduling", name]})


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
