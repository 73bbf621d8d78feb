"""Cycle flight recorder: deterministic record and replay bundles, and the
"why this node" table (port of `scheduler_plugins_tpu.utils.flightrec`).

Three layers:

- **FlightRecorder** (`recorder`, process-global, OFF by default): a
  bounded ring of `CycleRecord`s. When it is on, every cycle engine
  (`framework.cycle.run_cycle`, `PipelinedCycle`, `LanedCycle`) captures
  the cycle's full solver inputs at the snapshot boundary: every snapshot
  tensor (content-addressed by digest), the queue order
  (`SnapshotMeta.pod_names`), each plugin's `aux()` tensors, `static_key`,
  weight and cluster-derived `host_state`, and the profile; then its
  outputs after the solve's host copy and the
  report's bound / failed_by maps at the commit. A record enters the ring
  when the cycle opens it, so a crash mid-solve still leaves the inputs
  that provoked it. Off, each engine hook costs one attribute read.
- **Bundles**: `recorder.save(dir)` writes the ring as a `cycles.jsonl`
  manifest and a `blobs/<digest>.npy` array store, every file through
  `observability.atomic_write`, the blobs first and the manifest last, so
  a kill mid-save never leaves a manifest naming missing blobs.
  `load_bundle(dir)` and `replay_cycle(loaded, device=)` re-run a record
  through the sequential parity solve (`Scheduler.solve`) with the
  recorded aux tensors bound and diff the placements. The snapshot's
  structs are the JAX package's, field for field, so a bundle either
  package wrote loads and replays in the other.
- **Explain**: `explain_solver` formats the per-(pod, cycle) score table
  from `Scheduler.explain_rows` (or `parallel.solver.batch_explain_rows`);
  `explain_record` rebuilds it for a ring record or a bundle cycle.

Digests are the JAX package's: `array_digest` is blake2b-128 over dtype,
shape and C-order bytes; a cycle's digest is blake2b-128 over its
canonical (sorted-key, compact) manifest JSON with the digest field
blanked, so "same digest" means "bit-identical record". Outputs are
recorded in the JAX package's dtypes (assignment and failure codes int32,
admitted and wait bool), so a port record and a JAX record of the same
cycle name the same output blobs.

Every recorded array is a host COPY: the serving engine adds into its
resident node columns in place, and on the CPU a tensor's `.numpy()` is
a view, so a record of views would save the next refresh's contents
under this cycle's digest.

Privacy: a bundle carries the full solver inputs (pod and node names,
namespaces, requests). Treat it as an apiserver dump, not a metrics
scrape.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.utils import observability as obs

#: manifest format version (bump on incompatible schema changes)
FORMAT = 1

#: the fit-margin sentinel of masked nodes (`Scheduler.explain_rows`); also
#: the shift that ranks infeasible nodes after every feasible one
MARGIN_MASKED = -(2 ** 62)



# ---------------------------------------------------------------------------
# array digests and tree (de)serialization
# ---------------------------------------------------------------------------


def array_digest(arr: np.ndarray) -> str:
    """Content address of one array: blake2b-128 over dtype, shape and
    C-order bytes (dtype and shape first, so a reshape or a cast never
    collides with the original)."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.dtype).encode())
    h.update(b":")
    h.update(",".join(map(str, arr.shape)).encode())
    h.update(b":")
    h.update(arr.tobytes())
    return h.hexdigest()


def _struct_registry() -> dict:
    """Class name -> dataclass for every snapshot struct type
    (`state.snapshot` and `state.scheduling`)."""
    from scheduler_plugins_tpu_torch.state import scheduling as _scheduling
    from scheduler_plugins_tpu_torch.state import snapshot as _snapshot

    registry = {}
    for mod in (_snapshot, _scheduling):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                registry[obj.__name__] = obj
    return registry


def pack_pytree(value, blobs: Optional[dict]) -> object:
    """Lower a tree of snapshot structs, containers, scalars and arrays
    (numpy or tensors) into a JSON-able spec, each array by its
    `array_digest`. With a `blobs` dict, every array lands there as a host
    copy keyed by digest; with None only the spec is built (a digest needs
    no copy)."""
    if value is None:
        return None
    if isinstance(value, (bool, int, float, str)):
        return {"v": value}
    if isinstance(value, np.generic):
        return {"v": value.item()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {"s": type(value).__name__,
                "f": {f.name: pack_pytree(getattr(value, f.name), blobs)
                      for f in dataclasses.fields(value)}}
    if isinstance(value, (tuple, list)):
        return {"t": [pack_pytree(v, blobs) for v in value],
                "k": "tuple" if isinstance(value, tuple) else "list"}
    if isinstance(value, dict):
        return {"d": {str(k): pack_pytree(v, blobs)
                      for k, v in value.items()}}
    if isinstance(value, torch.Tensor):
        value = value.detach()
        value = (value.cpu().numpy() if blobs is None
                 else value.to("cpu", copy=True).numpy())
    elif blobs is not None:
        value = np.array(value)  # a copy
    arr = np.asarray(value)
    if arr.dtype == object:
        raise TypeError(f"unrecordable value of type {type(value).__name__}")
    digest = array_digest(arr)
    if blobs is not None:
        blobs[digest] = arr
    return {"a": digest, "dtype": str(arr.dtype), "shape": list(arr.shape)}


def unpack_pytree(spec, blobs: dict, registry: Optional[dict] = None):
    """Inverse of `pack_pytree`; arrays come back as host numpy. An unknown
    struct or field raises."""
    if spec is None:
        return None
    if registry is None:
        registry = _struct_registry()
    if "v" in spec:
        return spec["v"]
    if "a" in spec:
        arr = blobs[spec["a"]]
        expect = (spec["dtype"], tuple(spec["shape"]))
        if (str(arr.dtype), arr.shape) != expect:
            raise ValueError(
                f"blob {spec['a']}: dtype/shape {arr.dtype}/{arr.shape} "
                f"does not match manifest {expect}"
            )
        return arr
    if "t" in spec:
        items = [unpack_pytree(v, blobs, registry) for v in spec["t"]]
        return tuple(items) if spec.get("k") == "tuple" else items
    if "d" in spec:
        return {k: unpack_pytree(v, blobs, registry)
                for k, v in spec["d"].items()}
    name = spec["s"]
    cls = registry.get(name)
    if cls is None:
        raise ValueError(f"unknown struct {name!r} in bundle")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(spec["f"]) - known
    if unknown:
        raise ValueError(f"unknown fields {sorted(unknown)} of struct "
                         f"{name!r} in bundle")
    return cls(**{
        k: unpack_pytree(v, blobs, registry) for k, v in spec["f"].items()
    })


def pack_digest(tree) -> str:
    """blake2b-128 of `tree`'s canonical spec (`pack_pytree`): equal to
    the JAX package's `_pack_digest` of the same arrays."""
    return hashlib.blake2b(
        _canonical_json(pack_pytree(tree, None)).encode(), digest_size=16
    ).hexdigest()


def pack_meta(meta) -> dict:
    """`SnapshotMeta` -> JSON (the host name <-> code tables; the resource
    axis as the full ordered name list). The port's `device` and
    `scheduling_s` are not recorded: a replay chooses its own device."""
    from scheduler_plugins_tpu_torch.api.resources import CANONICAL

    names = list(meta.index.names)
    if tuple(names[: len(CANONICAL)]) != CANONICAL:
        raise ValueError("resource index does not start with CANONICAL")
    return {
        "resources": names,
        "node_names": list(meta.node_names),
        "pod_names": list(meta.pod_names),
        "namespaces": list(meta.namespaces),
        "gang_names": list(meta.gang_names),
        "regions": list(meta.regions),
        "zones": list(meta.zones),
        "workloads": list(meta.workloads),
    }


def unpack_meta(spec: dict, device=None):
    """The `SnapshotMeta` of `pack_meta`'s spec, its `device` the replay's
    (None = the CUDA card)."""
    from scheduler_plugins_tpu_torch.api.resources import (
        CANONICAL,
        ResourceIndex,
    )
    from scheduler_plugins_tpu_torch.state.snapshot import SnapshotMeta

    index = ResourceIndex(spec["resources"][len(CANONICAL):])
    if tuple(index.names) != tuple(spec["resources"]):
        raise ValueError("resource axis did not round-trip")
    return SnapshotMeta(
        index=index,
        node_names=list(spec["node_names"]),
        pod_names=list(spec["pod_names"]),
        namespaces=list(spec["namespaces"]),
        gang_names=list(spec["gang_names"]),
        regions=list(spec["regions"]),
        zones=list(spec["zones"]),
        workloads=list(spec["workloads"]),
        device=resolve_device(device),
    )


def _canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# cycle records and the ring
# ---------------------------------------------------------------------------


@dataclass
class CycleRecord:
    """One recorded cycle: inputs captured at the snapshot boundary,
    outputs after the solve's host copy. `manifest` is the JSON-able view
    (arrays as digest references); `blobs` holds the arrays."""

    seq: int
    now_ms: int
    profile: str
    seed: object = None
    manifest: dict = field(default_factory=dict)
    blobs: dict = field(default_factory=dict)
    complete: bool = False
    #: host seconds the engine spent capturing this record (kept off the
    #: manifest, so it does not enter the digest)
    capture_s: float = 0.0

    def capture_inputs(self, snap, meta, scheduler, stream_chunk=None,
                       profile_config=None) -> None:
        """Record the full solver input surface of the cycle. Runs AFTER
        `scheduler.prepare(meta, ...)`, so the captured `aux()` tensors are
        what the solve reads. `profile_config` is the exact profile
        mapping when the caller knows it (the daemon's decoded profile
        file), else `api.config.profile_spec` exports it. "plugins" is
        written last: `find` takes a record without it for one still being
        captured."""
        self.manifest["snapshot"] = pack_pytree(snap, self.blobs)
        self.manifest["meta"] = pack_meta(meta)
        self.manifest["stream_chunk"] = stream_chunk
        if profile_config is None:
            from scheduler_plugins_tpu_torch.api.config import profile_spec

            profile_config = profile_spec(scheduler.profile)
        self.manifest["profile_config"] = profile_config
        self.manifest["plugins"] = [
            {
                "name": p.name,
                "class": type(p).__name__,
                "weight": int(p.weight),
                "static_key": repr(p.static_key()),
                "aux": pack_pytree(p.aux(), self.blobs),
                # cluster-derived specialization (the NRT uniform scope,
                # NetworkOverhead's cost matrices) a rebuild without a
                # Cluster cannot recompute: restored on replay
                "host_state": pack_pytree(p.host_state(), self.blobs),
            }
            for p in scheduler.profile.plugins
        ]

    def capture_outputs(self, mode: str, assignment, admitted, wait,
                        failed_plugin=None) -> None:
        """The solve's outputs (host arrays), in the JAX package's
        dtypes."""
        self.manifest["outputs"] = {
            "mode": mode,
            "assignment": pack_pytree(_as(assignment, np.int32), self.blobs),
            "admitted": pack_pytree(_as(admitted, bool), self.blobs),
            "wait": pack_pytree(_as(wait, bool), self.blobs),
            "failed_plugin": (
                None if failed_plugin is None
                else pack_pytree(_as(failed_plugin, np.int32), self.blobs)
            ),
        }

    def commit(self, report=None, drift=None) -> None:
        if report is not None:
            self.manifest["report"] = {
                "bound": dict(report.bound),
                "reserved": dict(report.reserved),
                "failed": list(report.failed),
                "failed_by": dict(report.failed_by),
            }
            # the placement-quality stamp, which a replay can recompute
            if getattr(report, "quality", None) is not None:
                self.manifest["report"]["quality"] = dict(report.quality)
        self.manifest["drift"] = drift
        self.complete = True
        obs.metrics.inc(obs.FLIGHTREC_CYCLES)

    def to_manifest(self) -> dict:
        line = {
            "format": FORMAT,
            "cycle": self.seq,
            "now_ms": self.now_ms,
            "profile": self.profile,
            "seed": self.seed,
            "complete": self.complete,
            **self.manifest,
        }
        line["digest"] = record_digest(line)
        return line

    @property
    def pod_names(self) -> list:
        return self.manifest.get("meta", {}).get("pod_names", [])


def _as(x, dtype) -> np.ndarray:
    """A host array of `x` in `dtype` (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype)


def record_digest(manifest: dict) -> str:
    """Cycle digest: blake2b-128 over the canonical manifest JSON with the
    digest field blanked. Arrays contribute through their content digests,
    so equal digest == bit-identical inputs AND outputs."""
    scrubbed = {k: v for k, v in manifest.items() if k != "digest"}
    return hashlib.blake2b(
        _canonical_json(scrubbed).encode(), digest_size=16
    ).hexdigest()


class FlightRecorder:
    """Bounded ring of `CycleRecord`s. OFF by default; off, `begin()`
    returns None and the engine hooks cost one attribute read. `start`
    arms it; a record enters the ring as soon as `begin` returns (partial
    records are visible: a flight recorder exists for the crash that
    prevented a tidy commit). The lock guards the ring only; no capture
    runs under it."""

    def __init__(self):
        self._enabled = False
        self._ring: deque = deque(maxlen=8)
        self._seq = 0
        self._lock = threading.Lock()
        #: the exact profile config, when the caller knows it (the daemon
        #: sets its decoded profile file here); None exports it through
        #: `api.config.profile_spec`
        self.profile_config: Optional[dict] = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    def start(self, capacity: int = 8) -> None:
        with self._lock:
            self._ring = deque(maxlen=max(int(capacity), 1))
            self._seq = 0
            self._enabled = True

    def stop(self) -> None:
        self._enabled = False

    def resume(self) -> None:
        """Re-arm WITHOUT resetting the ring (`start` resets; `stop` is the
        pause): interleaved on/off measurements keep the corpus."""
        with self._lock:
            self._enabled = True

    def begin(self, now_ms: int, profile: str) -> Optional[CycleRecord]:
        if not self._enabled:
            return None
        with self._lock:
            self._seq += 1
            rec = CycleRecord(seq=self._seq, now_ms=now_ms, profile=profile)
            self._ring.append(rec)
        return rec

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def find(self, uid: str, cycle: Optional[int] = None):
        """Newest COMPLETE record whose batch holds `uid` (or the exact
        `cycle` number when given); failing that, the newest record with
        its inputs captured (outputs missing: crash postmortems). A record
        still inside `capture_inputs` (the current cycle, seen from
        another thread) is never returned."""
        recs = self.records()
        for want_complete in (True, False):
            for rec in reversed(recs):
                if cycle is not None and rec.seq != cycle:
                    continue
                if rec.complete is not want_complete:
                    continue
                if "plugins" not in rec.manifest:  # capture in flight
                    continue
                if uid in rec.pod_names:
                    return rec
        return None

    def save(self, directory: str) -> dict:
        """Write the ring as a bundle: `blobs/<digest>.npy` (each written
        atomically), then the `cycles.jsonl` manifest LAST, so a crash
        mid-save leaves at worst orphan blobs, never a manifest naming
        missing data. An existing manifest in `directory` is appended to
        (blobs are content-addressed, so successive saves accumulate into
        one bundle); records already present verbatim are not duplicated.
        Returns a small summary dict."""
        records = [r for r in self.records() if r.manifest.get("snapshot")]
        os.makedirs(os.path.join(directory, "blobs"), exist_ok=True)
        written = 0
        seen: set = set()
        for rec in records:
            for digest, arr in list(rec.blobs.items()):
                if digest in seen:
                    continue
                seen.add(digest)
                path = os.path.join(directory, "blobs", f"{digest}.npy")
                if os.path.exists(path):
                    continue
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
                obs.atomic_write(path, buf.getvalue())
                written += 1
        # the JAX package stamps its compiled-cost manifest here
        # (`_save_cost_stamp`, from `obs/costmodel.py`); the port compiles
        # no program and has no cost manifest, which is JAX's own "no cost
        # manifest, no stamp" case: nothing is written
        manifest_path = os.path.join(directory, "cycles.jsonl")
        lines: list = []
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        have = set(lines)
        lines += [
            line for rec in records
            if (line := _canonical_json(rec.to_manifest())) not in have
        ]
        obs.atomic_write(manifest_path,
                         "\n".join(lines) + ("\n" if lines else ""))
        ledger_pods = self._save_ledger_segment(directory)
        return {
            "cycles": len(lines),
            "blobs_written": written,
            "ledger_pods": ledger_pods,
            "path": directory,
        }

    @staticmethod
    def _save_ledger_segment(directory: str) -> int:
        """Write the pod-lifecycle ledger (`obs.ledger.LEDGER`) beside the
        manifest when it is on: `ledger.json` holds each pod's cross-cycle
        story next to the cycle-level replay evidence. Returns the pod
        records written (0 when the ledger is off or empty)."""
        from scheduler_plugins_tpu_torch.obs import ledger as podledger

        led = podledger.LEDGER
        if not led.enabled:
            return 0
        export = led.export()
        n = len(export["retired"]) + len(export["live"])
        if n == 0:
            return 0
        obs.atomic_write(os.path.join(directory, "ledger.json"),
                         json.dumps(export, sort_keys=True))
        return n


#: the process-global recorder, off by default
recorder = FlightRecorder()


# ---------------------------------------------------------------------------
# bundle loading and replay
# ---------------------------------------------------------------------------


def _on_device(tree, device):
    """`tree` (an unpacked aux or host state) with every array as a tensor
    on `device`."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on_device(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return tree


def _solver_snapshot(snap, device):
    """An unpacked (host numpy) snapshot as the port's solve takes it, on
    `device`. The JAX package lowers the scheduling tables' index and code
    arrays as int32 where the port uses int64: a JAX bundle's are cast."""
    if snap.scheduling is not None:
        sched = snap.scheduling
        snap = dataclasses.replace(snap, scheduling=dataclasses.replace(
            sched, **{
                f.name: getattr(sched, f.name).astype(np.int64)
                for f in dataclasses.fields(sched)
                if isinstance(getattr(sched, f.name), np.ndarray)
                and getattr(sched, f.name).dtype == np.int32
            }))
    return snap.to(device)


def rebuild_scheduler(manifest: dict, blob_resolver, profile_name=None, *,
                      device=None):
    """(Scheduler, meta, faithful): THE profile rebuild of the replay and
    explain paths. `load_profile` on the recorded config, the recorded
    weights, `prepare(meta, None)` on `device` (no Cluster at replay), then
    each plugin's recorded `host_state` restored, so the rebuilt plugins
    take the branches the recorded solve took. `faithful` is False when a
    rebuilt plugin's class or `static_key` still disagrees with the record
    (a lossy config export). `blob_resolver` lowers a packed spec back to
    host arrays."""
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.framework.runtime import Scheduler

    device = resolve_device(device)
    profile = load_profile(manifest["profile_config"])
    profile.name = (profile_name if profile_name is not None
                    else manifest.get("profile", profile.name))
    recorded = manifest["plugins"]
    faithful = len(profile.plugins) == len(recorded)
    if faithful:
        for plugin, rec in zip(profile.plugins, recorded):
            plugin.weight = int(rec.get("weight", plugin.weight))
    scheduler = Scheduler(profile)
    meta = unpack_meta(manifest["meta"], device)
    scheduler.prepare(meta, None)
    if faithful:
        for plugin, rec in zip(profile.plugins, recorded):
            hs = rec.get("host_state")
            if hs is not None:
                plugin.restore_host_state(blob_resolver(hs))
            if type(plugin).__name__ != rec["class"] or repr(
                    plugin.static_key()) != rec["static_key"]:
                faithful = False
    return scheduler, meta, faithful


class LoadedCycle:
    """One manifest line and lazy, digest-checked blob access from a
    bundle directory."""

    def __init__(self, manifest: dict, blob_dir: str):
        self.manifest = manifest
        self._blob_dir = blob_dir
        self._cache: dict = {}

    def blob(self, digest: str) -> np.ndarray:
        arr = self._cache.get(digest)
        if arr is None:
            arr = np.load(os.path.join(self._blob_dir, f"{digest}.npy"),
                          allow_pickle=False)
            if array_digest(arr) != digest:
                raise ValueError(f"blob {digest} content does not match name")
            self._cache[digest] = arr
        return arr

    def _blobs_for(self, spec) -> dict:
        digests: set = set()

        def walk(node):
            if node is None:
                return
            if "a" in node:
                digests.add(node["a"])
            for child in node.get("f", {}).values():
                walk(child)
            for child in node.get("t", []):
                walk(child)
            for child in node.get("d", {}).values():
                walk(child)

        walk(spec)
        return {d: self.blob(d) for d in digests}

    def _unpack(self, spec):
        return unpack_pytree(spec, self._blobs_for(spec))

    def snapshot(self):
        """The recorded snapshot, host numpy in the port's structs."""
        return self._unpack(self.manifest["snapshot"])

    def meta(self, device=None):
        return unpack_meta(self.manifest["meta"], device)

    def auxes(self) -> tuple:
        return tuple(self._unpack(p["aux"])
                     for p in self.manifest["plugins"])

    def output(self, name: str):
        spec = (self.manifest.get("outputs") or {}).get(name)
        return None if spec is None else self._unpack(spec)

    def scheduler(self, device=None):
        """(Scheduler, faithful): the recorded profile rebuilt, prepared on
        `device` and host-state-restored (`rebuild_scheduler`). A replay
        runs even when `faithful` is False, with the recorded aux tensors
        bound, so the configuration the solve reads is exact either
        way."""
        scheduler, _meta, faithful = rebuild_scheduler(
            self.manifest, self._unpack, device=device)
        return scheduler, faithful

    def digest_ok(self) -> bool:
        return record_digest(self.manifest) == self.manifest.get("digest")


def load_bundle(directory: str) -> list:
    """Parse a bundle directory into `LoadedCycle`s (manifest order)."""
    path = os.path.join(directory, "cycles.jsonl")
    blob_dir = os.path.join(directory, "blobs")
    cycles = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            manifest = json.loads(line)
            if manifest.get("format") != FORMAT:
                raise ValueError(
                    f"bundle format {manifest.get('format')!r} != {FORMAT}")
            cycles.append(LoadedCycle(manifest, blob_dir))
    return cycles


def replay_cycle(loaded: LoadedCycle, device=None) -> dict:
    """Re-run one recorded cycle on `device` (None = the CUDA card)
    through the bit-identical sequential parity solve with the RECORDED
    aux tensors bound, and diff the placements against the recorded
    outputs. The diff must be empty for a record of the sequential solve;
    a wave-mode record ("streamed", "packing") may differ on soft
    tie-breaking, so its diff is evidence, not an error."""
    from scheduler_plugins_tpu_torch.framework.runtime import bound_auxes

    device = resolve_device(device)
    scheduler, faithful = loaded.scheduler(device)
    snap = _solver_snapshot(loaded.snapshot(), device)
    meta = loaded.meta(device)
    auxes = loaded.auxes()
    plugins = scheduler.profile.plugins
    aux_match = all(pack_digest(plugin.aux()) == pack_digest(aux)
                    for plugin, aux in zip(plugins, auxes))
    # the mode is pinned: replay certifies the sequential semantics even
    # when the recorded profile selects another solve mode (packing)
    with bound_auxes(plugins, _on_device(auxes, device)):
        result = scheduler.solve(snap, device=device, mode="sequential")
        assignment = result.assignment.to("cpu", copy=True).numpy()
    recorded = loaded.output("assignment")
    mode = (loaded.manifest.get("outputs") or {}).get("mode")
    mismatches = []
    if recorded is not None:
        pod_names = loaded.manifest["meta"]["pod_names"]
        node_names = loaded.manifest["meta"]["node_names"]

        def node(ix):
            return node_names[ix] if 0 <= ix < len(node_names) else None

        for i in np.nonzero(assignment != recorded)[0][:64]:
            i = int(i)
            mismatches.append({
                "pod": pod_names[i] if i < len(pod_names) else f"<pad {i}>",
                "recorded": node(int(recorded[i])),
                "replayed": node(int(assignment[i])),
            })
    return {
        "cycle": loaded.manifest["cycle"],
        "mode": mode,
        "digest_ok": loaded.digest_ok(),
        "profile_faithful": faithful,
        "aux_match": bool(aux_match),
        "placed_recorded": (None if recorded is None
                            else int((recorded >= 0).sum())),
        "placed_replayed": int((assignment >= 0).sum()),
        "placements_match": recorded is not None and not mismatches,
        "mismatches": mismatches,
        "_assignment": assignment,
        "_scheduler": scheduler,
        "_snap": snap,
        "_meta": meta,
        "_auxes": auxes,
    }


# ---------------------------------------------------------------------------
# explain: the per-(pod, cycle) score table
# ---------------------------------------------------------------------------


def explain_solver(scheduler, snap, meta, uid: str, top_k: int = 5,
                   assignment=None, auxes=None, batched: bool = False,
                   cycle=None, *, device=None) -> dict:
    """The table for pod `uid` of one solved batch: the top-k candidate
    nodes with per-plugin weighted normalized score columns, the built-in
    fit margin (min over resources of free - demand; most negative
    binding) and each candidate's gap to the winner, all against the
    CYCLE-INITIAL state. `assignment` (the solve's, host numpy) fills in
    where the pod went; `auxes` binds a recorded cycle's `aux()` tensors;
    `batched=True` takes the rows through `batch_explain_rows`; `cycle` is
    the flight recorder's cycle number. The rows are computed on `device`
    (None = the CUDA card). Raises KeyError for a uid outside the
    batch."""
    try:
        pod_index = meta.pod_names.index(uid)
    except ValueError:
        raise KeyError(f"pod {uid!r} is not in this cycle's pending batch")
    if batched:
        from scheduler_plugins_tpu_torch.parallel.solver import (
            batch_explain_rows,
        )

        rows = batch_explain_rows(scheduler, snap, [pod_index], auxes=auxes,
                                  device=device)
    else:
        rows = scheduler.explain_rows(snap, [pod_index], auxes=auxes,
                                      device=device)
    plugins = scheduler.profile.plugins
    fail_names = scheduler.fail_plugin_names()
    n_real = len(meta.node_names)

    total = rows["total"][0][:n_real]
    feasible = rows["feasible"][0][:n_real]
    margin = rows["fit_margin"][0][:n_real]
    columns = rows["columns"][0][:, :n_real]
    admitted = bool(rows["admitted"][0])
    fail_code = int(rows["fail_code"][0])

    # infeasible nodes keep their relative order but rank after every
    # feasible node (scores stay far below 2^61, so the shift cannot
    # overflow or lift an infeasible node past a feasible one)
    masked = np.where(feasible, total, total + MARGIN_MASKED)
    # score descending, lowest node index on a tie: the solver's own rule
    order = np.lexsort((np.arange(n_real), -masked))
    any_feasible = bool(feasible.any())
    winner = int(order[0]) if any_feasible else None
    winner_total = int(total[winner]) if winner is not None else None
    runner_up_gap = None
    if any_feasible and int(feasible.sum()) >= 2:
        runner_up_gap = int(winner_total - masked[order[1]])

    assigned_node = None
    placed = None
    if assignment is not None:
        a = int(np.asarray(assignment)[pod_index])
        placed = a >= 0
        if placed and a < n_real:
            assigned_node = meta.node_names[a]
    failed_plugin = None
    if placed is not True and (not admitted or not any_feasible
                               or placed is False):
        failed_plugin = (fail_names[fail_code] if fail_code > 0
                         else fail_names[0])

    # feasible nodes first, then the best-scoring near misses: an
    # unschedulable pod's table shows its closest candidates, with the fit
    # margins saying why each missed
    candidates = []
    for n in order[: max(int(top_k), 1)]:
        n = int(n)
        candidates.append({
            "node": meta.node_names[n],
            "total": int(total[n]),
            "gap_to_winner": (
                None if winner_total is None else int(winner_total - total[n])
            ),
            "feasible": bool(feasible[n]),
            "fit_margin": (
                None if int(margin[n]) == MARGIN_MASKED else int(margin[n])
            ),
            "scores": {
                p.name: int(columns[l][n]) for l, p in enumerate(plugins)
            },
        })
    return {
        "uid": uid,
        "cycle": cycle,
        "pod_index": pod_index,
        "profile": scheduler.profile.name,
        "path": "batched" if batched else "sequential",
        "admitted": admitted,
        "placed": placed,
        "assigned": assigned_node,
        "failed_plugin": failed_plugin,
        "winner": meta.node_names[winner] if winner is not None else None,
        "winner_total": winner_total,
        "runner_up_gap": runner_up_gap,
        "weights": {p.name: int(p.weight) for p in plugins},
        "candidates": candidates,
    }


#: rebuilt schedulers for `explain_record`, keyed by record IDENTITY and
#: device: a polling caller explains the same ring record again and again,
#: and a rotated-out record ages out of this deque with it
_REBUILD_CACHE: deque = deque(maxlen=4)

#: serializes `explain_record`: concurrent callers would race on the cache
#: and bind auxes on the same rebuilt plugin objects
_EXPLAIN_LOCK = threading.Lock()


def _cached_rebuild(key, build):
    for k, value in _REBUILD_CACHE:
        if k[0] is key[0] and k[1] == key[1]:
            return value
    value = build()
    _REBUILD_CACHE.append((key, value))
    return value


def explain_record(rec, uid: str, top_k: int = 5, batched: bool = False, *,
                   device=None) -> dict:
    """Explain one pod of a ring `CycleRecord` or a bundle `LoadedCycle`
    on `device` (None = the CUDA card). Both the snapshot and a FRESH
    scheduler are rebuilt from the record's own arrays and profile config
    (a live scheduler is never re-prepared for an older record), and the
    recorded aux tensors are bound, so the columns are exactly what the
    recorded cycle's solve read. The rebuilt scheduler is cached per
    record and device. Thread-safe: callers serialize on a module lock."""
    with _EXPLAIN_LOCK:
        return _explain_record(rec, uid, top_k, batched,
                               resolve_device(device))


def _explain_record(rec, uid, top_k, batched, device) -> dict:
    if isinstance(rec, CycleRecord):
        def unpack(spec):
            return unpack_pytree(spec, rec.blobs)

        manifest = rec.manifest
        cycle = rec.seq
        scheduler, meta = _cached_rebuild(
            (rec, device),
            lambda: rebuild_scheduler(manifest, unpack,
                                      profile_name=rec.profile,
                                      device=device)[:2])
    else:
        unpack = rec._unpack
        manifest = rec.manifest
        cycle = manifest["cycle"]
        # prepared and host-state restored (the faithfulness flag is
        # `replay_cycle`'s to report)
        scheduler = _cached_rebuild((rec, device),
                                    lambda: rec.scheduler(device)[0])
        meta = rec.meta(device)
    snap = _solver_snapshot(unpack(manifest["snapshot"]), device)
    a_spec = (manifest.get("outputs") or {}).get("assignment")
    assignment = None if a_spec is None else unpack(a_spec)
    auxes = _on_device(tuple(unpack(p["aux"]) for p in manifest["plugins"]),
                       device)
    return explain_solver(scheduler, snap, meta, uid, top_k=top_k,
                          assignment=assignment, auxes=auxes,
                          batched=batched, cycle=cycle, device=device)
