"""CrossNodePreemption (port of
`scheduler_plugins_tpu.plugins.crossnodepreemption`).

A brute-force victim search across nodes (PostFilter). The reference
ships the plugin commented out with its registration disabled
(cross_node_preemption.go:19-224, "don't use this in production"); the
JAX package implements that spec as an opt-in, and so does the port:
enabling the plugin selects the `PreemptionMode.CROSS_NODE` engine, which
enumerates victim subsets in the dead code's depth-first order and ranks
the candidates by the upstream pickOneNode criteria. The pool is the
`max_pool` lowest-priority pods, so the 2^n search stays bounded: the one
deliberate departure from the uncapped spec.
"""

from __future__ import annotations

from scheduler_plugins_tpu_torch.api import events as ev
from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.framework.preemption import (
    PreemptionEngine,
    PreemptionMode,
)


class CrossNodePreemption(Plugin):
    name = "CrossNodePreemption"

    def __init__(self, max_pool: int = 12):
        if max_pool < 1:
            raise ValueError(f"max_pool must be >= 1, got {max_pool}")
        self.max_pool = max_pool

    def events_to_register(self):
        # a victim's deletion admits the preemptor
        return (ev.POD_DELETE,)

    def preemption_engine(self) -> PreemptionEngine:
        return PreemptionEngine(
            PreemptionMode.CROSS_NODE, cross_node_max_pool=self.max_pool
        )
