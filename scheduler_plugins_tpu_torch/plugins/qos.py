"""QOSSort (port of `scheduler_plugins_tpu.plugins.qos`).

The QueueSort plugin: priority descending, then QoS class (Guaranteed >
Burstable > BestEffort), then the queue timestamp (upstream
pkg/qos/queue_sort.go:42-84), the namespace/name last for a total order.
Host only.
"""

from __future__ import annotations

from scheduler_plugins_tpu_torch.framework.plugin import Plugin


class QOSSort(Plugin):
    name = "QOSSort"

    def queue_key(self, pod, cluster):
        # tuples sort ascending: priority and QoS precedence negated
        return (-pod.priority, -int(pod.qos_class()), pod.creation_ms,
                f"{pod.namespace}/{pod.name}")
