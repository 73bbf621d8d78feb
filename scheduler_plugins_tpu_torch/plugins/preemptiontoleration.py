"""PreemptionToleration (port of
`scheduler_plugins_tpu.plugins.preemptiontoleration`).

The PostFilter plugin: DefaultPreemption whose victims a PriorityClass's
toleration policy can exempt (upstream pkg/preemptiontoleration,
ExemptedFromPreemption, preemption_toleration.go:124-181). It adds no
Filter or Score tensors; it selects the cycle's preemption engine
(`framework.preemption`) with toleration on, and carries the candidate
sampling arguments (PreemptionTolerationArgs are upstream's
DefaultPreemptionArgs, checked at load time).
"""

from __future__ import annotations

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.framework.preemption import (
    PreemptionEngine,
    PreemptionMode,
)


class PreemptionToleration(Plugin):
    name = "PreemptionToleration"

    def __init__(self, min_candidate_nodes_percentage: int = None,
                 min_candidate_nodes_absolute: int = None):
        PreemptionEngine.validate_sampling_args(
            min_candidate_nodes_percentage, min_candidate_nodes_absolute
        )
        self.min_candidate_nodes_percentage = min_candidate_nodes_percentage
        self.min_candidate_nodes_absolute = min_candidate_nodes_absolute

    def events_to_register(self):
        # a victim's deletion admits the preemptor (upstream
        # DefaultPreemption registers Pod/Delete)
        return (ev.POD_DELETE,)

    def preemption_engine(self) -> PreemptionEngine:
        return PreemptionEngine(
            PreemptionMode.DEFAULT, toleration=True,
            min_candidate_nodes_percentage=self.min_candidate_nodes_percentage,
            min_candidate_nodes_absolute=self.min_candidate_nodes_absolute,
        )
