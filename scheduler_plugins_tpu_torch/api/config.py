"""Profile configuration (port of `scheduler_plugins_tpu.api.config`).

A plain mapping, the KubeSchedulerConfiguration-equivalent surface, lowers
to a `framework.Profile`:

    {
      "profileName": "tpu-scheduler",
      "plugins": ["NodeResourcesAllocatable", "Coscheduling",
                  "CapacityScheduling"],
      "pluginConfig": [
        {"name": "Coscheduling", "args": {"permitWaitingTimeSeconds": 10}},
      ],
      "weights": [1, 1, 1],
    }

`profile_spec` is its inverse. The plugin constructors carry the
reference's defaulting and validation (each raises ValueError on invalid
args, validation_pluginargs.go). The port loads the JAX package's whole
roster (`ROSTER`); an unknown plugin name or arg is a ValueError.
"""

from __future__ import annotations

from typing import Mapping

from scheduler_plugins_tpu_torch.framework.runtime import (
    SOLVE_MODES,
    Profile,
)

#: camelCase arg name -> plugin constructor kwarg, per ported plugin
_ARG_MAPS: dict[str, dict[str, str]] = {
    "Coscheduling": {
        "permitWaitingTimeSeconds": "permit_waiting_seconds",
        "podGroupBackoffSeconds": "pod_group_backoff_seconds",
        "podGroupRejectPercentage": "reject_percentage",
    },
    "NodeResourcesAllocatable": {"resources": "resources", "mode": "mode"},
    "TargetLoadPacking": {
        "targetUtilization": "target_utilization_percent",
        "watcherAddress": "watcher_address",
        "metricProvider": "metric_provider",
        "defaultRequests": "default_requests",
        "defaultRequestsMultiplier": "default_requests_multiplier",
    },
    "LoadVariationRiskBalancing": {
        "safeVarianceMargin": "safe_variance_margin",
        "safeVarianceSensitivity": "safe_variance_sensitivity",
        "watcherAddress": "watcher_address",
        "metricProvider": "metric_provider",
    },
    "LowRiskOverCommitment": {
        "smoothingWindowSize": "smoothing_window_size",
        "riskLimitWeights": "risk_limit_weights",
        "watcherAddress": "watcher_address",
        "metricProvider": "metric_provider",
    },
    "Peaks": {
        "nodePowerModel": "node_power_model",
        "watcherAddress": "watcher_address",
        "metricProvider": "metric_provider",
    },
    "CapacityScheduling": {
        "minCandidateNodesPercentage": "min_candidate_nodes_percentage",
        "minCandidateNodesAbsolute": "min_candidate_nodes_absolute",
    },
    "NodeResourceTopologyMatch": {
        "scoringStrategy": "scoring_strategy",
        "resources": "resources",
        "cacheResyncPeriodSeconds": "cache_resync_period_seconds",
        "discardReservedNodes": "discard_reserved_nodes",
        "cache": "cache",
    },
    "NetworkOverhead": {
        "weightsName": "weights_name",
        "networkTopologyName": "network_topology_name",
        "namespaces": "namespaces",
    },
    "TopologicalSort": {"namespaces": "namespaces"},
    "SySched": {
        "defaultProfileNamespace": "default_profile_namespace",
        "defaultProfileName": "default_profile_name",
    },
    "PreemptionToleration": {
        "minCandidateNodesPercentage": "min_candidate_nodes_percentage",
        "minCandidateNodesAbsolute": "min_candidate_nodes_absolute",
    },
    "PodState": {},
    "QOSSort": {},
    "NodeAffinity": {"addedAffinity": "added_affinity"},
    "TaintToleration": {},
    "PodTopologySpread": {},
    "InterPodAffinity": {
        "hardPodAffinityWeight": "hard_pod_affinity_weight",
        "ignorePreferredTermsOfExistingPods":
            "ignore_preferred_terms_of_existing_pods",
    },
    "CrossNodePreemption": {"maxPool": "max_pool"},
}

#: the JAX package's full plugin roster, every name of which the port
#: loads
ROSTER = (
    "CapacityScheduling", "Coscheduling", "CrossNodePreemption",
    "InterPodAffinity", "LoadVariationRiskBalancing",
    "LowRiskOverCommitment", "NetworkOverhead", "NodeAffinity",
    "NodeResourceTopologyMatch", "NodeResourcesAllocatable", "Peaks",
    "PodState", "PodTopologySpread", "PreemptionToleration", "QOSSort",
    "SySched", "TaintToleration", "TargetLoadPacking", "TopologicalSort",
)


def _registry():
    from scheduler_plugins_tpu_torch import plugins as p

    return {
        "Coscheduling": p.Coscheduling,
        "CapacityScheduling": p.CapacityScheduling,
        "NodeResourcesAllocatable": p.NodeResourcesAllocatable,
        "TargetLoadPacking": p.TargetLoadPacking,
        "LoadVariationRiskBalancing": p.LoadVariationRiskBalancing,
        "LowRiskOverCommitment": p.LowRiskOverCommitment,
        "Peaks": p.Peaks,
        "NodeResourceTopologyMatch": p.NodeResourceTopologyMatch,
        "NetworkOverhead": p.NetworkOverhead,
        "TopologicalSort": p.TopologicalSort,
        "NodeAffinity": p.NodeAffinity,
        "TaintToleration": p.TaintToleration,
        "PodTopologySpread": p.PodTopologySpread,
        "InterPodAffinity": p.InterPodAffinity,
        "SySched": p.SySched,
        "PodState": p.PodState,
        "QOSSort": p.QOSSort,
        "PreemptionToleration": p.PreemptionToleration,
        "CrossNodePreemption": p.CrossNodePreemption,
    }


def available_plugins() -> tuple[str, ...]:
    """The plugins the port can load, sorted."""
    return tuple(sorted(_registry()))


#: arg exporters for the plugins whose constructor args are not stored
#: under the kwarg's own attribute name (`profile_spec` tries that first)
_SPEC_OVERRIDES = {
    "NodeResourcesAllocatable": lambda p: {
        "resources": [list(r) for r in p.resources],
        "mode": "Least" if p.mode_sign < 0 else "Most",
    },
    "NodeResourceTopologyMatch": lambda p: {
        "scoringStrategy": p.strategy,
        "resources": [list(r) for r in p.resources],
    },
}


def _json_safe(value):
    """`value` in JSON-encodable form, or None when it has none (tuples
    become lists; other objects are dropped)."""
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    if isinstance(value, (tuple, list)):
        items = [_json_safe(v) for v in value]
        return items if all(
            v is not None or o is None for v, o in zip(items, value)
        ) else None
    if isinstance(value, Mapping):
        out = {}
        for k, v in value.items():
            if not isinstance(k, str):
                return None
            safe = _json_safe(v)
            if safe is None and v is not None:
                return None
            out[k] = safe
        return out
    return None


def profile_spec(profile: Profile) -> dict:
    """The inverse of `load_profile`: a {profileName, plugins,
    pluginConfig, weights} mapping that rebuilds `profile`'s roster. Args
    come from the attributes the constructors keep (`_SPEC_OVERRIDES` for
    the renamed ones); what is not JSON-able is left out, and so is an
    arg whose plugin keeps it under another name with no override (the
    Trimaran plugins' targetUtilization, safeVariance*, smoothingWindowSize,
    riskLimitWeights and defaultRequests, InterPodAffinity's
    ignorePreferredTermsOfExistingPods: the JAX package's export drops
    them too, and the port's matches it). NodeAffinity's addedAffinity
    terms are objects, not JSON, and are left out as JAX leaves them out;
    `load_profile` takes their wire form. NodeResourceTopologyMatch
    exports its cacheResyncPeriodSeconds and discardReservedNodes even at
    their defaults (0, False), and no `cache` block, as JAX's does: a
    reload of the spec then counts them as given and installs the
    passthrough cache. `weights` is
    exported only when some weight differs from its class default. The
    port's profiles are all "sequential", so no `solveMode` is exported."""
    names = []
    plugin_config = []
    for plugin in profile.plugins:
        cls = type(plugin).__name__
        names.append(cls)
        override = _SPEC_OVERRIDES.get(cls)
        args = dict(override(plugin)) if override else {}
        for camel, kwarg in _ARG_MAPS.get(cls, {}).items():
            if camel in args:
                continue
            value = _json_safe(getattr(plugin, kwarg, None))
            if value is not None:
                args[camel] = value
        if args:
            plugin_config.append({"name": cls, "args": args})
    spec = {"profileName": profile.name, "plugins": names}
    if plugin_config:
        spec["pluginConfig"] = plugin_config
    if any(p.weight != type(p).weight for p in profile.plugins):
        spec["weights"] = [int(p.weight) for p in profile.plugins]
    return spec


def load_profile(config: Mapping) -> Profile:
    """Lower a configuration mapping into a Profile. Unknown plugin names
    or args raise ValueError; per-plugin validation happens in the
    constructors."""
    registry = _registry()
    args_by_plugin: dict[str, Mapping] = {}
    for entry in config.get("pluginConfig", []):
        args_by_plugin[entry["name"]] = entry.get("args", {})

    plugins = []
    for name in config.get("plugins", []):
        cls = registry.get(name)
        if cls is None:
            raise ValueError(f"unknown plugin {name!r}")
        arg_map = _ARG_MAPS.get(name, {})
        kwargs = {}
        for key, value in args_by_plugin.get(name, {}).items():
            if key not in arg_map:
                raise ValueError(f"unknown arg {key!r} for plugin {name}")
            kwargs[arg_map[key]] = value
        plugins.append(cls(**kwargs))
    weights = config.get("weights")
    if weights is not None:
        if len(weights) != len(plugins):
            raise ValueError(
                f"weights list has {len(weights)} entries for "
                f"{len(plugins)} plugins"
            )
        for plugin, w in zip(plugins, weights):
            w = int(w)
            if w < 1:
                raise ValueError(f"plugin weight must be >= 1, got {w}")
            plugin.weight = w
    solve_mode = config.get("solveMode", "sequential")
    if solve_mode == "packing" or "packingConfig" in config:
        raise NotImplementedError(
            "solveMode 'packing' comes with the packing slice "
            "(ops/packing.py)"
        )
    if solve_mode not in SOLVE_MODES:
        raise ValueError(
            f"unknown solveMode {solve_mode!r}; expected one of "
            f"{SOLVE_MODES + ('packing',)}"
        )
    return Profile(
        plugins=plugins, name=config.get("profileName", "tpu-scheduler"),
        solve_mode=solve_mode,
    )
