"""scheduler_plugins_tpu_torch — the PyTorch/CUDA port of `scheduler_plugins_tpu`.

The port mirrors the JAX package's module layout so each module's
counterpart is easy to find (`state.snapshot`, `ops.assign`,
`parallel.solver`, ...). Inside, it is plain PyTorch: dataclasses of
tensors instead of `flax.struct`, eager functions on tensors with an
explicit device, and Python loops where JAX used `lax.while_loop`.

The slice ported so far is the flagship batched step:

    Cluster store -> snapshot lowering -> PreFilter admission (gang +
    elastic quota) -> static allocatable ranking -> targeted waterfill wave
    solve with the node axis in S rank blocks on one card -> queue-order
    namespace-quota prefix -> gang quorum Permit.

Every cross-block exchange of the blocked wave solve runs through a CUDA
kernel written by hand (`csrc/election.cu`, bound in `parallel.kernels`).

Quantities are int64 in the reference's own units, exactly as in the JAX
package. Entry points take `device=None`, which means CUDA; the CPU is used
only when a caller asks for it with `device="cpu"`.
"""

__version__ = "0.1.0"
