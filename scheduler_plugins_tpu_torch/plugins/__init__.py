"""The plugin suite (port of `scheduler_plugins_tpu.plugins`), the JAX
package's whole roster: the flagship profile's three plugins, the
Trimaran family, NodeResourceTopologyMatch, the network-aware pair
(NetworkOverhead, TopologicalSort), the in-tree four (NodeAffinity,
TaintToleration, PodTopologySpread, InterPodAffinity), SySched, PodState,
QOSSort and the two preemption plugins (PreemptionToleration,
CrossNodePreemption)."""

from scheduler_plugins_tpu_torch.plugins.capacityscheduling import (  # noqa: F401
    CapacityScheduling,
)
from scheduler_plugins_tpu_torch.plugins.coscheduling import Coscheduling  # noqa: F401
from scheduler_plugins_tpu_torch.plugins.crossnodepreemption import (  # noqa: F401
    CrossNodePreemption,
)
from scheduler_plugins_tpu_torch.plugins.intree import (  # noqa: F401
    InterPodAffinity,
    NodeAffinity,
    PodTopologySpread,
    TaintToleration,
)
from scheduler_plugins_tpu_torch.plugins.networkaware import (  # noqa: F401
    NetworkOverhead,
    TopologicalSort,
)
from scheduler_plugins_tpu_torch.plugins.noderesources import (  # noqa: F401
    NodeResourcesAllocatable,
)
from scheduler_plugins_tpu_torch.plugins.noderesourcetopology import (  # noqa: F401
    NodeResourceTopologyMatch,
)
from scheduler_plugins_tpu_torch.plugins.podstate import PodState  # noqa: F401
from scheduler_plugins_tpu_torch.plugins.preemptiontoleration import (  # noqa: F401
    PreemptionToleration,
)
from scheduler_plugins_tpu_torch.plugins.qos import QOSSort  # noqa: F401
from scheduler_plugins_tpu_torch.plugins.sysched import SySched  # noqa: F401
from scheduler_plugins_tpu_torch.plugins.trimaran import (  # noqa: F401
    LoadVariationRiskBalancing,
    LowRiskOverCommitment,
    Peaks,
    TargetLoadPacking,
)
