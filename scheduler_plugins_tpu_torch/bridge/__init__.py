"""Native bridge (port of `scheduler_plugins_tpu.bridge`): the C++ columnar
cluster-state store behind a ctypes ABI.

The event-ingestion and snapshot-lowering hot path of the host shell, the
part the reference keeps in Go informer caches, in host C++
(`snapshot_store.cc`, the JAX package's source) and read here without
per-object Python work: `state.cluster.Cluster.attach_native_store`
mirrors the store's hot node columns into it, and the snapshot takes them
from `export_nodes`. The shared library builds with g++ on first use into
`build/native/` at the root of the checkout (`_build.build_host`), named by
a hash of the source and the flags. It is host code: nothing here touches
the card.
"""

from __future__ import annotations

import ctypes

import numpy as np

from scheduler_plugins_tpu_torch import _build

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _load():
    lib = ctypes.CDLL(str(_build.build_host("snapshot_store")))
    lib.store_new.restype = ctypes.c_void_p
    lib.store_new.argtypes = [ctypes.c_int]
    lib.store_free.argtypes = [ctypes.c_void_p]
    lib.store_upsert_node.argtypes = [ctypes.c_void_p, ctypes.c_int64, _I64, _I64]
    lib.store_upsert_pod.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _I64, _I64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.store_upsert_nodes_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _I64, _I64, _I64,
    ]
    lib.store_upsert_pods_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64] + [_I64] * 7
    lib.store_bind.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.store_delete_pod.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.store_num_nodes.restype = ctypes.c_int64
    lib.store_num_nodes.argtypes = [ctypes.c_void_p]
    lib.store_num_pending.restype = ctypes.c_int64
    lib.store_num_pending.argtypes = [ctypes.c_void_p]
    lib.store_export_nodes.argtypes = [ctypes.c_void_p] + [_I64] * 6 + [_I32] * 2
    lib.store_export_pending.argtypes = [ctypes.c_void_p] + [_I64] * 5
    lib.store_dirty_count.restype = ctypes.c_int64
    lib.store_dirty_count.argtypes = [ctypes.c_void_p]
    lib.store_generation.restype = ctypes.c_int64
    lib.store_generation.argtypes = [ctypes.c_void_p]
    lib.store_export_dirty.restype = ctypes.c_int64
    lib.store_export_dirty.argtypes = (
        [ctypes.c_void_p] + [_I64] * 6 + [_I32] * 2
    )
    return lib


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _ptr64(arr: np.ndarray):
    return arr.ctypes.data_as(_I64)


def _ptr32(arr: np.ndarray):
    return arr.ctypes.data_as(_I32)


class NativeStore:
    """Columnar cluster store (C++). Quantities are int64 vectors on the
    fixed resource axis (cpu-milli, memory-bytes, ephemeral, pods, ...)."""

    def __init__(self, num_resources: int):
        self._lib = _get_lib()
        self.R = num_resources
        self._handle = ctypes.c_void_p(self._lib.store_new(num_resources))

    def close(self):
        if self._handle:
            self._lib.store_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC path
        try:
            self.close()
        except Exception:  # graft-lint: ignore[GL010] — GC finalizer: nothing to route a close failure to
            pass

    def upsert_node(self, node_id: int, alloc: np.ndarray, capacity=None):
        alloc = np.ascontiguousarray(alloc, np.int64)
        cap = alloc if capacity is None else np.ascontiguousarray(capacity, np.int64)
        self._lib.store_upsert_node(self._handle, node_id, _ptr64(alloc), _ptr64(cap))

    def upsert_pod(self, pod_id: int, req, limits=None, priority=0,
                   creation_ms=0, node_id=-1, terminating=False):
        req = np.ascontiguousarray(req, np.int64)
        lim = (
            np.zeros_like(req)
            if limits is None
            else np.ascontiguousarray(limits, np.int64)
        )
        self._lib.store_upsert_pod(
            self._handle, pod_id, _ptr64(req), _ptr64(lim),
            priority, creation_ms, node_id, 1 if terminating else 0,
        )

    def upsert_nodes_batch(self, ids, alloc, capacity=None):
        ids = np.ascontiguousarray(ids, np.int64)
        alloc = np.ascontiguousarray(alloc, np.int64)
        cap = alloc if capacity is None else np.ascontiguousarray(capacity, np.int64)
        self._lib.store_upsert_nodes_batch(
            self._handle, len(ids), _ptr64(ids), _ptr64(alloc), _ptr64(cap)
        )

    def upsert_pods_batch(self, ids, req, limits=None, priority=None,
                          creation_ms=None, node_ids=None, flags=None):
        k = len(ids)
        ids = np.ascontiguousarray(ids, np.int64)
        req = np.ascontiguousarray(req, np.int64)
        z = lambda v, fill=0: np.ascontiguousarray(
            np.full(k, fill, np.int64) if v is None else v, np.int64
        )
        lim = np.zeros_like(req) if limits is None else np.ascontiguousarray(limits, np.int64)
        self._lib.store_upsert_pods_batch(
            self._handle, k, _ptr64(ids), _ptr64(req), _ptr64(lim),
            _ptr64(z(priority)), _ptr64(z(creation_ms)), _ptr64(z(node_ids, -1)),
            _ptr64(z(flags)),
        )

    def bind(self, pod_id: int, node_id: int):
        self._lib.store_bind(self._handle, pod_id, node_id)

    def delete_pod(self, pod_id: int):
        self._lib.store_delete_pod(self._handle, pod_id)

    @property
    def num_nodes(self) -> int:
        return self._lib.store_num_nodes(self._handle)

    @property
    def num_pending(self) -> int:
        return self._lib.store_num_pending(self._handle)

    def export_nodes(self):
        """Dense node tensors: dict of numpy arrays (ids, alloc, capacity,
        requested, nonzero_requested, limits, pod_count, terminating)."""
        n, R = self.num_nodes, self.R
        out = {
            "ids": np.zeros(n, np.int64),
            "alloc": np.zeros((n, R), np.int64),
            "capacity": np.zeros((n, R), np.int64),
            "requested": np.zeros((n, R), np.int64),
            "nonzero_requested": np.zeros((n, R), np.int64),
            "limits": np.zeros((n, R), np.int64),
            "pod_count": np.zeros(n, np.int32),
            "terminating": np.zeros(n, np.int32),
        }
        self._lib.store_export_nodes(
            self._handle, _ptr64(out["ids"]), _ptr64(out["alloc"]),
            _ptr64(out["capacity"]), _ptr64(out["requested"]),
            _ptr64(out["nonzero_requested"]), _ptr64(out["limits"]),
            _ptr32(out["pod_count"]), _ptr32(out["terminating"]),
        )
        return out

    @property
    def dirty_count(self) -> int:
        """Rows touched since the last `export_dirty` drain."""
        return self._lib.store_dirty_count(self._handle)

    @property
    def generation(self) -> int:
        """Drain generation (bumped by every `export_dirty`)."""
        return self._lib.store_generation(self._handle)

    def export_dirty(self):
        """Streaming-delta export: ONLY the node rows whose columns
        changed since the last drain (first-touch order) — the
        O(changed) bridge seam a downstream mirror ingests instead of
        the O(cluster) `export_nodes`. Clears the dirty window and
        bumps `generation` (single-consumer semantics). A fresh store's
        first drain is a full resync by construction. Returns a dict of
        numpy arrays plus the post-drain generation."""
        n, R = self.dirty_count, self.R
        out = {
            "ids": np.zeros(n, np.int64),
            "alloc": np.zeros((n, R), np.int64),
            "capacity": np.zeros((n, R), np.int64),
            "requested": np.zeros((n, R), np.int64),
            "nonzero_requested": np.zeros((n, R), np.int64),
            "limits": np.zeros((n, R), np.int64),
            "pod_count": np.zeros(n, np.int32),
            "terminating": np.zeros(n, np.int32),
        }
        written = self._lib.store_export_dirty(
            self._handle, _ptr64(out["ids"]), _ptr64(out["alloc"]),
            _ptr64(out["capacity"]), _ptr64(out["requested"]),
            _ptr64(out["nonzero_requested"]), _ptr64(out["limits"]),
            _ptr32(out["pod_count"]), _ptr32(out["terminating"]),
        )
        assert written == n, (written, n)
        out["generation"] = self.generation
        return out

    def export_pending(self):
        """Pending-pod tensors in (creation_ms, id) queue order."""
        p, R = self.num_pending, self.R
        out = {
            "ids": np.zeros(p, np.int64),
            "req": np.zeros((p, R), np.int64),
            "limits": np.zeros((p, R), np.int64),
            "priority": np.zeros(p, np.int64),
            "creation_ms": np.zeros(p, np.int64),
        }
        self._lib.store_export_pending(
            self._handle, _ptr64(out["ids"]), _ptr64(out["req"]),
            _ptr64(out["limits"]), _ptr64(out["priority"]),
            _ptr64(out["creation_ms"]),
        )
        return out
