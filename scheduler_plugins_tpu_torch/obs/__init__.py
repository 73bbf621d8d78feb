"""Pod-level observability plane (the cross-cycle complement of
`utils.observability`; port of `scheduler_plugins_tpu.obs`).

`obs.ledger` follows a POD across scheduling cycles: first-seen, queued,
backoff-held, gang-gated, nominated/reserved, bound-or-blamed.
`obs.memory` stamps the card's allocator watermarks once a cycle (the
counterpart of the JAX package's `obs.costmodel.stamp_device_memory`);
the rest of `obs.costmodel` reads XLA's cost analysis and has no PyTorch
subject, so it is not carried over.
"""

from . import ledger
from .ledger import LEDGER, Ledger, STAGES

__all__ = ["ledger", "LEDGER", "Ledger", "STAGES"]
