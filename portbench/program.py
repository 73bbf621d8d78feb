"""The system under test, as the benchmark drives it: the port's store
(`state.cluster.Cluster`), a `Scheduler` of the configuration's profile,
`framework.cycle.run_cycle` (with a `serving.engine.ServeEngine` attached
when the mix serves, the daemon's `--serve` path), and the conversion of
the generator's records into the port's API objects, as the feed's
`apply_event` would deliver them.

The port is imported inside the functions: `run.py` fixes the cache
directories and checks for the card before anything of it loads."""

from __future__ import annotations


def make_node(spec):
    from scheduler_plugins_tpu_torch.api.objects import Node
    from scheduler_plugins_tpu_torch.api.resources import CPU, MEMORY, PODS

    return Node(name=spec.name,
                allocatable={CPU: spec.cpu_millis,
                             MEMORY: spec.memory_bytes, PODS: spec.pods},
                labels=dict(spec.labels))


def make_pod(spec, objects, res):
    """A port `Pod` of one container whose requests equal its limits,
    labelled with its PodGroup when it names one."""
    requests = {res.CPU: spec.cpu_millis, res.MEMORY: spec.memory_bytes}
    labels = dict(spec.labels)
    if spec.group is not None:
        labels[objects.POD_GROUP_LABEL] = spec.group
    spread = [
        objects.TopologySpreadConstraint(
            max_skew=c.max_skew, topology_key=c.topology_key,
            when_unsatisfiable=c.when_unsatisfiable,
            label_selector=objects.LabelSelector(
                match_labels=dict(c.match_labels)))
        for c in spec.spread
    ]
    return objects.Pod(
        name=spec.name, namespace=spec.namespace, uid=spec.uid,
        priority=spec.priority, creation_ms=spec.creation_ms,
        labels=labels, node_name=spec.node,
        containers=[objects.Container(requests=requests,
                                      limits=dict(requests))],
        topology_spread=spread,
    )


def make_pod_group(spec, objects):
    return objects.PodGroup(
        name=spec.name, namespace=spec.namespace,
        min_member=spec.min_member, creation_ms=spec.creation_ms,
        schedule_timeout_seconds=spec.schedule_timeout_seconds)


def make_quota(spec, objects, res):
    """The namespace's ElasticQuota, named after it (the store keeps one
    a namespace)."""
    return objects.ElasticQuota(
        name=spec.namespace, namespace=spec.namespace,
        min={res.CPU: spec.min_cpu_millis, res.MEMORY: spec.min_memory_bytes},
        max={res.CPU: spec.max_cpu_millis, res.MEMORY: spec.max_memory_bytes})


class System:
    """One store, one scheduler, optionally one serve engine, on `device`.

    `ingest` applies an iteration's removals and the generator's records
    through the store's mutators; `cycle` runs one `run_cycle` and returns
    its outcome as the store holds it after the cycle: ({uid: node name}
    of the `candidates` (uids pending before it) bound, {uid: node name}
    of every standing Permit reservation, {preemptor uid: (nominated node,
    [victim uids])} of the preemptions it made). The last snapshot the
    cycle took is kept (`last_snapshot`) so its node usage can be compared
    once the run is over."""

    def __init__(self, cell, nodes, fill, device):
        from scheduler_plugins_tpu_torch.api import objects, resources
        from scheduler_plugins_tpu_torch.api.config import load_profile
        from scheduler_plugins_tpu_torch.framework import Scheduler
        from scheduler_plugins_tpu_torch.framework.cycle import run_cycle
        from scheduler_plugins_tpu_torch.state.cluster import Cluster

        mix = cell.mix
        self._objects, self._res = objects, resources
        self._run_cycle = run_cycle
        self.device = device
        self.stream_chunk = mix.get("stream_chunk")
        self.cluster = Cluster()
        for spec in nodes:
            self.cluster.add_node(make_node(spec))
        self.ingest((), fill)
        self.scheduler = Scheduler(load_profile(cell.config["profile"]))
        self.engine = None
        if mix.get("serve"):
            from scheduler_plugins_tpu_torch.serving.engine import ServeEngine

            # attached after the fill: the first refresh rebases from the
            # full store, as a daemon's first served cycle does
            self.engine = ServeEngine().attach(self.cluster)
        self.last_snapshot = None
        self._wrap_snapshots()

    def _wrap_snapshots(self) -> None:
        """Keep the (snap, meta) each cycle assembles: one reference
        replaced per cycle, no copy."""
        def keep(fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                if out is not None:
                    self.last_snapshot = out
                return out
            return wrapped

        self.cluster.snapshot = keep(self.cluster.snapshot)
        if self.engine is not None:
            self.engine.refresh = keep(self.engine.refresh)

    def ingest(self, removals, records) -> None:
        """Each removed uid through `remove_pod`, then each record, in
        order, through the store's mutator for its kind, as the feed's
        `apply_event` applies the same objects."""
        cluster, objects, res = self.cluster, self._objects, self._res
        for uid in removals:
            cluster.remove_pod(uid)
        for spec in records:
            kind = spec.kind
            if kind == "pod":
                cluster.add_pod(make_pod(spec, objects, res))
            elif kind == "node":
                cluster.add_node(make_node(spec))
            elif kind == "node_delete":
                cluster.remove_node(spec.name)
            elif kind == "pod_group":
                cluster.add_pod_group(make_pod_group(spec, objects))
            elif kind == "quota":
                cluster.add_quota(make_quota(spec, objects, res))
            else:
                raise ValueError(f"unknown record kind {kind!r}")

    def cycle(self, now_ms: int, candidates, timings=None):
        report = self._run_cycle(self.scheduler, self.cluster, now_ms,
                                 self.stream_chunk, serve=self.engine,
                                 device=self.device, timings=timings)
        pods = self.cluster.pods
        bound = {}
        for uid in candidates:
            pod = pods.get(uid)
            if pod is not None and pod.node_name is not None:
                bound[uid] = pod.node_name
        preempted = {uid: (node, list(victims))
                     for uid, (node, victims) in report.preempted.items()}
        return bound, dict(self.cluster.reserved), preempted

    def placements(self) -> dict:
        """{uid: node name} of every bound pod in the store."""
        return {uid: p.node_name for uid, p in self.cluster.pods.items()
                if p.node_name is not None}

    def snapshot_usage(self):
        """The last cycle's snapshot node usage as host numpy: (names,
        (N, 3) int64 cpu, memory and pod count), or None."""
        if self.last_snapshot is None:
            return None
        import numpy as np

        snap, meta = self.last_snapshot
        res = self._res
        n = len(meta.node_names)
        req = snap.nodes.requested[:n].cpu().numpy()
        count = snap.nodes.pod_count[:n].cpu().numpy()
        usage = np.stack([req[:, meta.index.position(res.CPU)],
                          req[:, meta.index.position(res.MEMORY)],
                          count.astype(np.int64)], axis=1)
        return list(meta.node_names), usage

    def close(self) -> None:
        if self.engine is not None:
            self.engine.detach()
        self.engine = None
        self.cluster = None
        self.scheduler = None
        self.last_snapshot = None
