"""ElasticQuota status reconciler.

Mirror of pkg/controllers/elasticquota_controller.go:50-109:
recompute `status.Used` as the sum of effective requests of RUNNING pods in
the quota's namespace, patch when changed, emit a Synced event.
"""

from __future__ import annotations

from scheduler_plugins_tpu_torch.api.objects import PodPhase
from scheduler_plugins_tpu_torch.api.resources import add_quantities
from scheduler_plugins_tpu_torch.state.cluster import Cluster


def reconcile_elastic_quotas(cluster: Cluster) -> list[str]:
    """One reconcile pass over every ElasticQuota; returns emitted events.
    Single sweep over pods bucketed by namespace — O(pods + quotas)."""
    by_ns: dict[str, dict[str, int]] = {}
    for pod in cluster.pods.values():
        if pod.phase != PodPhase.RUNNING:
            continue
        by_ns[pod.namespace] = add_quantities(
            by_ns.get(pod.namespace, {}), pod.effective_request()
        )
    events = []
    for eq in cluster.quotas.values():
        used = by_ns.get(eq.namespace, {})
        if used != dict(eq.used):
            eq.used = used
            events.append(f"Normal Synced {eq.namespace}/{eq.name}")
    return events
