"""Synthetic cluster scenario generators."""

from scheduler_plugins_tpu_torch.models.scenarios import (  # noqa: F401
    allocatable_scenario,
    gang_quota_scenario,
    mixed_scenario,
    network_scenario,
    numa_scenario,
    trimaran_scenario,
)
