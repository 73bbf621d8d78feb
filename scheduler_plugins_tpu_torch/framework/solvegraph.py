"""The parity solve's pod loop replayed from one CUDA graph.

On a CUDA card `Scheduler.solve` hands the loop after the presolve
(`runtime.solve_steps`: every `_solve_step` of the batch and the Permit
tail) to the scheduler's `SolveGraphs`. Eagerly the loop launches some
60 small kernels a pod from the host, one at a time; here the loop is
captured once per input structure as one `torch.cuda.CUDAGraph`, and each
later solve of the same structure refills the graph's input buffers and
replays it, so nothing is launched from Python per pod. The captured
loop is the eager one: the same Python runs once under capture, so the
graph's kernels are the eager path's, and its outputs equal the eager
ones bit for bit.

- Eligible: every plugin declares `step_reads_inputs_only` (its step
  methods read no tensor but the snapshot's, the carried state's and its
  own `prepare_solve` result), no sanitizer call is open on the thread
  (its error tensor is made per call), the batch has pods, and every leaf
  of the snapshot, the initial state and the presolves is a tensor on the
  card, None or a host static. Anything else solves eagerly.
- Keyed on what the step's Python bakes into the graph: the plugins (and
  their `static_key`), their weight ints (`Scheduler.weights_key`), and
  the inputs' structure: each leaf's shape, dtype and device, each None,
  each host static. An eligible solve runs over the snapshot with its
  gang, namespace and nominee rows padded to their buckets (`bucketed`),
  as the node and pod rows already are, so a nomination's coming or
  going, or one more gang, leaves the key as it was; the carries come
  back cut to their rows (`trimmed`).
- The cost model (an H100, 5,120 nodes; a graph node is about one torch
  call): an eager solve takes 10-23 us of host time a call, a capture
  18-51 us (the solve's Python under capture, then the graph's
  instantiation, about half each) and holds 4.5-8.4 KB of host memory a
  node. So a capture costs 1.4-4 eager solves of its key (two of 19
  measured took 7) and a replay a tenth of one: a key seen twice and
  never again loses about three eager solves, one that keeps coming back
  repays its capture within about five sightings. A key therefore solves
  eagerly the first time it is seen, which counts the torch calls of its
  first pod's step (times the pods: every step runs the same Python), and
  is captured the second time, when those calls stay within `NODE_LIMIT`:
  a one-off shape costs no capture. `SLOTS` graphs are kept; the least
  recently used goes with its memory pool. `NODE_LIMIT` is what holds the
  cache's host memory to `CACHE_BYTES`.
- Every tensor the captured steps read is a buffer the graph owns: each
  leaf of the snapshot and the initial state and each plugin's presolve.
  The presolve stays eager and outside the graph; a replay copies the
  caller's leaves into the buffers, replays, and returns clones of the
  graph's outputs, so a result a caller holds is never overwritten by the
  next replay.
- One lock guards the cache, the buffers and each capture and replay (the
  watchdog's worker solves off the main thread); capture is in
  "thread_local" error mode, so other threads may use the card meanwhile.
- Counters (`obs.tracer`, while it is on): `solve.graph_capture` (each
  capture and its ns), `solve.graph_replay` (each graph launch, the one
  after a capture included), `solve.eager` (each card solve that ran
  eagerly). The hit share is replays over all card solves.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import torch
from torch.overrides import TorchFunctionMode

from scheduler_plugins_tpu_torch.state.snapshot import pad_rows
from scheduler_plugins_tpu_torch.utils import observability as obs
from scheduler_plugins_tpu_torch.utils import sanitize

#: graphs kept at once (one an input structure): in daemon runs whose
#: nominations and gangs came and went, two held every key in use
SLOTS = 2
#: keys remembered between their first sighting and their capture
SIGHTINGS = 64
#: host memory a captured graph holds a node: the most measured on an
#: H100 (4.5-6.2 KB a node, 8.1-8.4 KB in a process's first capture)
NODE_BYTES = 8192
#: host memory the cache's graphs may hold together
CACHE_BYTES = 1 << 31
#: the most graph nodes (torch calls: pods x calls a step) a solve may
#: make to be captured: SLOTS such graphs fill CACHE_BYTES (131,072
#: nodes, a capture of about 3-7 s); larger solves stay eager
NODE_LIMIT = CACHE_BYTES // (SLOTS * NODE_BYTES)

#: host values a leaf may hold besides a tensor: the graph bakes them in,
#: so they are part of the key
_STATICS = (bool, int, float, str, type(None))


class _Unowned(Exception):
    """A leaf that no buffer of the graph can stand in for."""


def _spec(tree, tensors: list):
    """The structure of `tree` (dataclasses, tuples, lists and dicts over
    tensors and host statics) as a hashable tuple, appending its tensor
    leaves to `tensors` in a fixed order; each tensor stands as its shape,
    dtype and device."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
        return (tuple(tree.shape), tree.dtype, str(tree.device))
    if isinstance(tree, _STATICS):
        return (type(tree).__name__, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree),) + tuple(
            _spec(getattr(tree, f.name), tensors)
            for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_spec(x, tensors) for x in tree)
    if isinstance(tree, dict):
        return (dict,) + tuple((k, _spec(v, tensors)) for k, v in
                               tree.items())
    raise _Unowned(type(tree).__name__)


def _rebuild(tree, tensors):
    """`tree` with its tensor leaves replaced, in `_spec`'s order, by the
    next ones of the iterator `tensors`."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, _STATICS):
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), tensors)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(x, tensors) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, tensors) for x in tree)
    return {k: _rebuild(v, tensors) for k, v in tree.items()}


def eligible(plugins) -> bool:
    """Whether every plugin declares that its step reads only its inputs
    (`Plugin.step_reads_inputs_only`)."""
    return all(getattr(p, "step_reads_inputs_only", False) for p in plugins)


def bucketed(snap, state0):
    """(snap, state0) with the gang, namespace and nominee rows padded to
    their buckets (`ClusterSnapshot.bucketed`), and the carries over
    those rows alike: a pad row's gang has placed nothing, its namespace
    used nothing."""
    snap = snap.bucketed()
    pads = {}
    if state0.eq_used is not None and snap.quota is not None:
        pads["eq_used"] = pad_rows(state0.eq_used, snap.quota.used.shape[0])
    for name in ("gang_scheduled", "gang_inflight"):
        carry = getattr(state0, name)
        if carry is not None and snap.gangs is not None:
            pads[name] = pad_rows(carry, snap.gangs.mask.shape[0])
    return snap, state0.replace(**pads)


def trimmed(result, state0):
    """`result` with each carry cut back to the rows it has in `state0`
    (the solve's own initial state, before `bucketed`)."""
    cut = {}
    for f in dataclasses.fields(state0):
        was, now = getattr(state0, f.name), getattr(result.state, f.name)
        if was is not None and now is not None and (
                now.shape[0] != was.shape[0]):
            cut[f.name] = now[:was.shape[0]]
    if not cut:
        return result
    return dataclasses.replace(result, state=result.state.replace(**cut))


def graph_key(plugins, snap, state0, presolves, device_type="cuda"):
    """(key, tensors) of a solve: the key of the graph that replays it and
    the tensors that graph reads, in its buffers' order; None when the
    solve cannot be captured (module docstring)."""
    if not eligible(plugins):
        return None
    if sanitize.current() is not None or snap.num_pods == 0:
        return None
    tensors = []
    try:
        structure = _spec((snap, state0, presolves), tensors)
    except _Unowned:
        return None
    if any(t.device.type != device_type for t in tensors):
        return None
    key = (tuple(map(id, plugins)),
           tuple(int(p.weight) for p in plugins),
           tuple(p.static_key() for p in plugins),
           structure)
    return key, tensors


class _TorchCalls(TorchFunctionMode):
    """Counts the torch calls made inside it on this thread: an upper
    bound of the kernels, copies and fills they launch (the flagship's
    step makes 66 calls and 61 ATen ops that are not views). A function
    mode, not a dispatch mode: entering the latter imports the compiler
    stack, over a second of host time."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def _bind(plugins, presolves) -> None:
    for plugin, ctx in zip(plugins, presolves):
        plugin.bind_presolve(ctx)


class Graph:
    """One captured solve: the buffers its steps read, the graph, and the
    outputs the graph writes. `_capture` and `_launch` are the two calls
    that need the card."""

    def __init__(self, plugins, tensors, snap, state0, presolves, steps):
        #: the plugins whose ids the key holds stay alive with the graph
        self.plugins = plugins
        self.device = tensors[0].device
        self.inputs = [torch.empty_like(t) for t in tensors]
        torch._foreach_copy_(self.inputs, tensors)
        s_snap, s_state0, s_presolves = _rebuild(
            (snap, state0, presolves), iter(self.inputs))

        def run():
            _bind(plugins, s_presolves)
            return steps(plugins, s_snap, s_state0)

        self.result = self._capture(run)
        self.outputs = []
        _spec(self.result, self.outputs)

    def _capture(self, run):
        """Record `run()` into the graph; returns its outputs, which each
        replay overwrites."""
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                result = run()
            finally:
                self.graph.capture_end()
        current.wait_stream(side)
        return result

    def _launch(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    def replay(self, tensors):
        """The solve of the inputs `tensors` (in the key's order): copied
        into the buffers, replayed, its outputs cloned."""
        torch._foreach_copy_(self.inputs, tensors)
        self._launch()
        return _rebuild(self.result, iter([t.clone() for t in
                                           self.outputs]))

    def release(self) -> None:
        """Free the graph and its memory pool."""
        graph = getattr(self, "graph", None)
        if graph is not None:
            graph.reset()
        self.graph = self.result = None
        self.inputs = self.outputs = []


class SolveGraphs:
    """The graph cache of the parity solve (module docstring).
    `device_type` and `graph` are the card and `Graph`; the CPU tests run
    the cache's policy with a stand-in for both."""

    def __init__(self, device_type="cuda", graph=Graph):
        self.slots = SLOTS
        self.node_limit = NODE_LIMIT
        self.device_type = device_type
        self.graph = graph
        self._lock = threading.Lock()
        self._graphs: OrderedDict = OrderedDict()  # key -> Graph
        #: key -> its solve's torch calls, counted at its first sighting
        self._seen: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._graphs)

    def solve(self, plugins, snap, state0, presolves, steps):
        """`steps(plugins, snap, state0)` with the presolves bound: replayed
        from a graph, captured, or eager, by the policy above."""
        found = graph_key(plugins, snap, state0, presolves, self.device_type)
        if found is None:
            obs.tracer.count("solve.eager")
            return steps(plugins, snap, state0)
        key, tensors = found
        with self._lock:
            graph = self._graphs.get(key)
            seen = self._seen.get(key)
            if graph is None and seen is not None and (
                    seen <= self.node_limit):
                graph = self._capture(key, plugins, tensors, snap, state0,
                                      presolves, steps)
            if graph is not None:
                self._graphs.move_to_end(key)
                obs.tracer.count("solve.graph_replay")
                return graph.replay(tensors)
        obs.tracer.count("solve.eager")
        if seen is not None:
            return steps(plugins, snap, state0)
        probe = _TorchCalls()
        result = steps(plugins, snap, state0, first_step=probe)
        with self._lock:
            self._seen[key] = probe.calls * snap.num_pods
            while len(self._seen) > SIGHTINGS:
                self._seen.popitem(last=False)
        return result

    def _capture(self, key, plugins, tensors, snap, state0, presolves,
                 steps):
        """Capture the key's graph (the lock held), making room first."""
        while len(self._graphs) >= self.slots:
            _, old = self._graphs.popitem(last=False)
            old.release()
        t0 = time.perf_counter_ns()
        try:
            graph = self.graph(plugins, tensors, snap, state0, presolves,
                               steps)
        finally:
            # the capture bound the graph's buffers: give the plugins back
            # the solve's own presolves
            _bind(plugins, presolves)
        obs.tracer.add_ns("solve.graph_capture", time.perf_counter_ns() - t0)
        self._seen.pop(key, None)
        self._graphs[key] = graph
        return graph
