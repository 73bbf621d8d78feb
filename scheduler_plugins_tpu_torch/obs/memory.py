"""Device-memory watermarks: the port's counterpart of the JAX package's
`obs.costmodel.device_memory_block` / `stamp_device_memory`.

The daemon stamps them once a cycle into the `DEVICE_BYTES_IN_USE` /
`DEVICE_PEAK_BYTES` gauges and serves the block on `/healthz`. They read
PyTorch's caching-allocator counters (`torch.cuda.memory_stats(i)`,
`allocated_bytes.all.current` and `.peak`) for each card: host-side
counters, so the read neither syncs the card nor copies anything. Without
a card the block reports `available: false` with null totals.
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.utils import observability as obs


def device_memory_block() -> dict:
    """JSON-ready device-memory snapshot: per card, the bytes the caching
    allocator has handed out now and at its peak, and their sums."""
    per_device = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            per_device.append({
                "id": i,
                "bytes_in_use": int(
                    stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(
                    stats.get("allocated_bytes.all.peak", 0)),
            })
    return {
        "backend": "cuda" if per_device else "cpu",
        "available": bool(per_device),
        "bytes_in_use": sum(d["bytes_in_use"] for d in per_device)
        if per_device else None,
        "peak_bytes_in_use": sum(d["peak_bytes_in_use"] for d in per_device)
        if per_device else None,
        "devices": per_device,
    }


def stamp_device_memory(metrics=None) -> dict:
    """Read the allocator counters once and set the two gauges (last write
    wins); returns the `/healthz` memory block. Without a card the gauges
    are left unset."""
    block = device_memory_block()
    if metrics is None:
        metrics = obs.metrics
    if block["available"]:
        metrics.set_gauge(obs.DEVICE_BYTES_IN_USE, block["bytes_in_use"])
        metrics.set_gauge(obs.DEVICE_PEAK_BYTES, block["peak_bytes_in_use"])
    return block
