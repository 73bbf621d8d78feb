"""ctypes bindings of the compiled reference-shaped baselines (port of
`scheduler_plugins_tpu.bridge.ref_baseline`): the compiled denominator
beside the card's solve.

The reference is compiled Go; a pure-Python loop as the only denominator
would flatter every speedup. Each entry runs the full per-pod x per-node
sequential scan in C++ (`ref_baseline.cc`, the port's copy of the JAX
package's source) on the port's snapshot, read on the host: a tensor on
the card is copied to the host first. Each returns (pods_per_sec, placed,
assignment) as JAX's does. The library builds with g++ into
`build/native/` on first use (`_build.build_host`); without g++ the first
call raises. It is host code by nature: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from scheduler_plugins_tpu_torch import _build
from scheduler_plugins_tpu_torch.api.resources import CANONICAL

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F64 = ctypes.POINTER(ctypes.c_double)

_PODS_I = CANONICAL.index("pods")


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build.build_host("ref_baseline")))
    c64, c32 = ctypes.c_int64, ctypes.c_int32
    lib.ref_seq_alloc.restype = c64
    lib.ref_seq_alloc.argtypes = [c64] * 3 + [_I64] * 4 + [_I32]
    lib.ref_seq_trimaran.restype = c64
    lib.ref_seq_trimaran.argtypes = (
        [c64] * 3 + [_I64] * 3 + [_F64, _U8] + [_F64] * 4 + [_I64] * 2
        + [ctypes.c_double] * 3 + [_I32]
    )
    lib.ref_seq_numa.restype = c64
    lib.ref_seq_numa.argtypes = [c64] * 4 + [_I64] * 4 + [_U8] * 2 + [_I32]
    lib.ref_seq_gang_quota.restype = c64
    lib.ref_seq_gang_quota.argtypes = (
        [c64] * 3 + [_I64] * 5 + [_I64, c64] + [_I64] * 2 + [_U8, _I64]
        + [_I64, c64] + [_I64] * 2 + [_I32] * 2
    )
    lib.ref_seq_network.restype = c64
    lib.ref_seq_network.argtypes = (
        [c64] * 3 + [_I64] * 2 + [_I32] * 2 + [c64, c64, _I32]
        + [_I64] * 2 + [c64, _I64] + [_I32, c64] + [_I32, _I64, _U8] + [_I32]
    )
    _lib = lib
    return lib


def _arr(a, dtype):
    """A contiguous host COPY of `a` in `dtype`: a tensor on the card is
    copied to the host explicitly, and a CPU tensor or numpy array is
    copied too (the scans write into some of these buffers)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", copy=True).numpy()
    return np.array(a, dtype=dtype, order="C")


def _ptr(a):
    dt = {np.dtype(np.int64): _I64, np.dtype(np.int32): _I32,
          np.dtype(np.uint8): _U8, np.dtype(np.float64): _F64}[a.dtype]
    return a.ctypes.data_as(dt)


def _real_counts(snap, n_nodes, n_pods):
    """Trim padding: the baseline must scan the REAL cluster shape, not the
    snapshot's power-of-two padded buckets — otherwise the denominator does
    extra work per pod and the reported multiplier inflates. Padding rows are
    appended after the real rows, so mask prefixes give the real counts when
    the caller doesn't pass them."""
    if n_nodes is None:
        n_nodes = int(_arr(snap.nodes.mask, np.int64).sum())
    if n_pods is None:
        n_pods = int(_arr(snap.pods.mask, np.int64).sum())
    return n_nodes, n_pods


def _fit_inputs(snap, n_nodes=None, n_pods=None):
    """(alloc, free0, req) trimmed to the real (node, pod) rows, with
    unschedulable nodes fenced and the pods slot set to 1
    (ops.fit.pod_fit_demand semantics)."""
    n_nodes, n_pods = _real_counts(snap, n_nodes, n_pods)
    alloc = _arr(snap.nodes.alloc, np.int64)[:n_nodes]
    requested = _arr(snap.nodes.requested, np.int64)[:n_nodes]
    free0 = alloc - requested
    node_mask = _arr(snap.nodes.mask, np.uint8).astype(bool)[:n_nodes]
    free0[~node_mask] = -1  # cordoned/invalid: never feasible
    req = _arr(snap.pods.req, np.int64)[:n_pods].copy()
    req[:, _PODS_I] = 1
    pod_mask = _arr(snap.pods.mask, np.uint8).astype(bool)[:n_pods]
    req[~pod_mask] = np.iinfo(np.int64).max // 4  # gated rows never place
    return alloc, free0, req


def compiled_alloc_baseline(snap, weights, n_nodes=None, n_pods=None):
    """Config 1/flagship: allocatable Least score + fit (pods/s, placed)."""
    lib = _load()
    alloc, free0, req = _fit_inputs(snap, n_nodes, n_pods)
    N, R = alloc.shape
    P = req.shape[0]
    w = _arr(weights, np.int64)
    out = np.empty(P, np.int32)
    start = time.perf_counter()
    placed = lib.ref_seq_alloc(N, P, R, _ptr(alloc), _ptr(free0), _ptr(req),
                               _ptr(w), _ptr(out))
    elapsed = time.perf_counter() - start
    return P / elapsed, int(placed), out


def compiled_trimaran_baseline(snap, target=40.0, margin=1.0, sensitivity=1.0,
                               n_nodes=None, n_pods=None):
    """Config 2: TLP piecewise + LVRB risk scores over live metrics."""
    lib = _load()
    _, free0, req = _fit_inputs(snap, n_nodes, n_pods)
    N, R = free0.shape
    P = req.shape[0]
    m = snap.metrics
    cap = _arr(snap.nodes.capacity, np.int64)[:N, CANONICAL.index("cpu")]
    cpu_tlp = _arr(m.cpu_tlp, np.float64)[:N]
    cpu_valid = _arr(m.cpu_tlp_valid, np.uint8)[:N]
    cpu_avg = _arr(m.cpu_avg, np.float64)[:N]
    cpu_std = _arr(m.cpu_std, np.float64)[:N]
    mem_avg = _arr(m.mem_avg, np.float64)[:N]
    mem_std = _arr(m.mem_std, np.float64)[:N]
    missing = _arr(m.missing_cpu_millis, np.int64)[:N]
    pred = _arr(snap.pods.predicted_cpu_millis, np.int64)[:P]
    out = np.empty(P, np.int32)
    start = time.perf_counter()
    placed = lib.ref_seq_trimaran(
        N, P, R, _ptr(free0), _ptr(req), _ptr(cap), _ptr(cpu_tlp),
        _ptr(cpu_valid), _ptr(cpu_avg), _ptr(cpu_std), _ptr(mem_avg),
        _ptr(mem_std), _ptr(missing), _ptr(pred),
        float(target), float(margin), float(sensitivity), _ptr(out))
    elapsed = time.perf_counter() - start
    return P / elapsed, int(placed), out


def compiled_numa_baseline(snap, n_nodes=None, n_pods=None):
    """Config 3: single-numa zone bitmask fit + LeastAllocated min-over-zones
    with pessimistic all-zone commit."""
    lib = _load()
    _, free0, req = _fit_inputs(snap, n_nodes, n_pods)
    N, R = free0.shape
    P = req.shape[0]
    numa = snap.numa
    zavail = _arr(numa.available, np.int64)[:N]
    zalloc = _arr(numa.allocatable, np.int64)[:N]
    zmask = _arr(numa.zone_mask, np.uint8)[:N]
    reported = _arr(numa.reported, np.uint8)[:N]
    Z = zavail.shape[1]
    out = np.empty(P, np.int32)
    start = time.perf_counter()
    placed = lib.ref_seq_numa(N, P, R, Z, _ptr(free0), _ptr(req),
                              _ptr(zavail), _ptr(zalloc), _ptr(zmask),
                              _ptr(reported), _ptr(out))
    elapsed = time.perf_counter() - start
    return P / elapsed, int(placed), out


def compiled_gang_quota_baseline(snap, weights, n_nodes=None, n_pods=None):
    """Config 4: elastic-quota admission + allocatable score + gang quorum."""
    lib = _load()
    alloc, free0, req = _fit_inputs(snap, n_nodes, n_pods)
    # quota admission uses the RAW effective request (pods slot 0), matching
    # ops.quota.quota_admit; the fit demand (pods slot 1) is only for fitting
    N, R = alloc.shape
    P = req.shape[0]
    quota_req = _arr(snap.pods.req, np.int64)[:P]
    w = _arr(weights, np.int64)
    quota = snap.quota
    if quota is not None:
        q_min = _arr(quota.min, np.int64)
        q_max = _arr(quota.max, np.int64)
        q_used = _arr(quota.used, np.int64)
        has_q = _arr(quota.has_quota, np.uint8)
        ns = _arr(snap.pods.ns, np.int64)[:P]
    else:
        q_min = q_max = q_used = np.zeros((1, R), np.int64)
        has_q = np.zeros(1, np.uint8)
        ns = np.full(P, -1, np.int64)
    M = q_min.shape[0]
    gangs = snap.gangs
    if gangs is not None:
        gang = _arr(snap.pods.gang, np.int64)[:P]
        g_min = _arr(gangs.min_member, np.int64)
        g_assigned = _arr(gangs.assigned, np.int64)
    else:
        gang = np.full(P, -1, np.int64)
        g_min = g_assigned = np.zeros(1, np.int64)
    G = g_min.shape[0]
    out = np.empty(P, np.int32)
    out_wait = np.empty(P, np.int32)
    start = time.perf_counter()
    placed = lib.ref_seq_gang_quota(
        N, P, R, _ptr(alloc), _ptr(free0), _ptr(req), _ptr(quota_req), _ptr(w),
        _ptr(ns), M, _ptr(q_min), _ptr(q_max), _ptr(has_q), _ptr(q_used),
        _ptr(gang), G, _ptr(g_min), _ptr(g_assigned), _ptr(out),
        _ptr(out_wait))
    elapsed = time.perf_counter() - start
    return P / elapsed, int(placed), out


def compiled_network_baseline(snap, zone_cost, region_cost,
                              n_nodes=None, n_pods=None):
    """Config 5: dependency satisfied/violated tallies + cost accumulation."""
    lib = _load()
    _, free0, req = _fit_inputs(snap, n_nodes, n_pods)
    N, R = free0.shape
    P = req.shape[0]
    net = snap.network
    node_zone = _arr(snap.nodes.zone, np.int32)[:N]
    node_region = _arr(snap.nodes.region, np.int32)[:N]
    zone_region = _arr(net.zone_region, np.int32)
    zc = _arr(zone_cost, np.int64)
    rc = _arr(region_cost, np.int64)
    ZC = zc.shape[0]
    RC = rc.shape[0]
    placed0 = _arr(net.placed_node, np.int64)[:, :N].copy()
    W = placed0.shape[0]
    pod_wl = _arr(net.pod_workload, np.int32)[:P]
    dep_wl = _arr(net.dep_workload, np.int32)[:P]
    dep_cost = _arr(net.dep_max_cost, np.int64)[:P]
    dep_mask = _arr(net.dep_mask, np.uint8)[:P]
    D = dep_wl.shape[1]
    out = np.empty(P, np.int32)
    start = time.perf_counter()
    placed = lib.ref_seq_network(
        N, P, R, _ptr(free0), _ptr(req), _ptr(node_zone), _ptr(node_region),
        ZC, RC, _ptr(zone_region), _ptr(zc), _ptr(rc), W, _ptr(placed0),
        _ptr(pod_wl), D, _ptr(dep_wl), _ptr(dep_cost), _ptr(dep_mask),
        _ptr(out))
    elapsed = time.perf_counter() - start
    return P / elapsed, int(placed), out
