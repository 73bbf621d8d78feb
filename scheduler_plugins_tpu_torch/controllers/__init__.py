"""CRD status controllers (port of `scheduler_plugins_tpu.controllers`): the
companion controller binary's reconcilers (cmd/controller,
pkg/controllers), host code over the port's `Cluster`."""

from scheduler_plugins_tpu_torch.controllers.elasticquota import (  # noqa: F401
    reconcile_elastic_quotas,
)
from scheduler_plugins_tpu_torch.controllers.podgroup import (  # noqa: F401
    reconcile_pod_groups,
)
