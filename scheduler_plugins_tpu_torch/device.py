"""Device resolution and device-to-host fetches shared by the port's
entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; anything else is taken as given.

    There is no silent CPU fallback: a caller without a card must ask for
    the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def map_tensors(fn, tree):
    """`fn` applied to every tensor of a tuple / list / dict tree; other
    leaves unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A copy of the host array `array` (as `dtype` when given) on
    `device`, staged through pinned memory and non-blocking on the card,
    so the caller never waits for it."""
    t = torch.tensor(np.ascontiguousarray(array), dtype=dtype)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def start_fetch(result, device):
    """Queue the copy of `result`'s tensors to the host behind the work
    that made them: (host tree, event) on the card, (tree, None) on the
    CPU. `finish_fetch` completes it."""
    if device.type != "cuda":
        return result, None

    def to_pinned(t):
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    host = map_tensors(to_pinned, result)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return host, event


def finish_fetch(pending):
    """Wait for a `start_fetch` copy and return its tree as numpy."""
    host, event = pending
    if event is not None:
        event.synchronize()
    return map_tensors(lambda t: t.numpy(), host)
