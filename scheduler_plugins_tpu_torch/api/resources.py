"""Resource vocabulary and integer quantity encoding (port of
`scheduler_plugins_tpu.api.resources`).

Quantities are int64 in the reference's units — CPU in millicores,
memory in bytes, extended resources as raw counts — on one ordered
resource axis R shared by every tensor of a snapshot. The canonical four
slots come first, in fixed order; extended resources are appended.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np

CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

#: The first four slots of every resource axis, in fixed order.
CANONICAL = (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)


class ResourceIndex:
    """Ordered resource-name <-> axis-position mapping for one snapshot.

    `encode` turns a {name: int} mapping into a dense int64 vector on the
    fixed axis; unknown names raise (an index is built from the union of
    names up front — a silent drop would corrupt quota sums)."""

    def __init__(self, extended: Iterable[str] = ()):
        names = list(CANONICAL)
        for name in extended:
            if name not in names:
                names.append(name)
        self._names: tuple[str, ...] = tuple(names)
        self._pos = {name: i for i, name in enumerate(self._names)}

    @classmethod
    def union(cls, *mappings: Mapping[str, int]) -> "ResourceIndex":
        """An index covering every resource named in `mappings`."""
        extended = []
        for m in mappings:
            for name in m:
                if name not in CANONICAL and name not in extended:
                    extended.append(name)
        return cls(extended)

    @property
    def names(self) -> tuple[str, ...]:
        return self._names

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name: str) -> bool:
        return name in self._pos

    def position(self, name: str) -> int:
        return self._pos[name]

    def encode(self, quantities: Mapping[str, int], default: int = 0) -> np.ndarray:
        vec = np.full(len(self._names), default, dtype=np.int64)
        for name, qty in quantities.items():
            vec[self._pos[name]] = int(qty)
        return vec


def add_quantities(a: Mapping[str, int], b: Mapping[str, int]) -> dict[str, int]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def max_quantities(a: Mapping[str, int], b: Mapping[str, int]) -> dict[str, int]:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0), v)
    return out
