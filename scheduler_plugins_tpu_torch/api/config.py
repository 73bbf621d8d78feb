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

The plugin constructors carry the reference's defaulting and validation
(each raises ValueError on invalid args, validation_pluginargs.go).
Plugins the JAX package has and the port does not yet raise
NotImplementedError naming them; a name neither knows is a ValueError.
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
    "CapacityScheduling": {
        "minCandidateNodesPercentage": "min_candidate_nodes_percentage",
        "minCandidateNodesAbsolute": "min_candidate_nodes_absolute",
    },
}

#: the JAX package's full plugin roster: the names the port has not
#: ported yet raise NotImplementedError, not "unknown plugin"
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
    }


def available_plugins() -> tuple[str, ...]:
    """The plugins the port can load, sorted."""
    return tuple(sorted(_registry()))


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
            if name in ROSTER:
                raise NotImplementedError(
                    f"plugin {name!r} is not ported yet: the port has "
                    f"{available_plugins()}"
                )
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
