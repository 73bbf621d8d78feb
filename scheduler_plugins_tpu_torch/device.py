"""Device resolution shared by the port's entry points."""

from __future__ import annotations

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
