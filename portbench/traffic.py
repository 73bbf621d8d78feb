"""The traffic's common part: a configuration file (`configs/<name>.json`)
in, plain Python descriptions of the nodes and of the configuration's
pods out. What happens to them over a run (which pods are bound at
set-up, which arrive and which complete in an iteration) is the mix's
generator's: `generators/<name>.py`, named by the mix's `generator` key
(default `closed_loop`).

Nothing here imports the program or the reference: both sides are handed
the same records, in the same order. A record is one of
- `NodeSpec`: a node added (the cluster's nodes at set-up are these too);
- `NodeDelete`: a node deleted;
- `PodSpec`: a pod added, in its namespace, at its priority, a member of
  the PodGroup it names (`group`), bound at set-up when it has a `node`;
- `PodGroupSpec`: a PodGroup (Coscheduling's gang and its quorum);
- `QuotaSpec`: a namespace's ElasticQuota (CapacityScheduling's `min`
  and `max`, cpu and memory);
and says which by its `kind`. A pod's deletion is its uid among an
iteration's removals. Every draw comes from `--seed` through independent
NumPy streams, so one seed gives one cluster and one event sequence.

The scenario patterns follow `scheduler_plugins_tpu_torch.models.scenarios`
(`_nodes` / `_pods`: named nodes with an allocatable map, one-container pods
with increasing creation times), copied here so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import ClassVar

import numpy as np

#: keys of a configuration that scale the cluster or the traffic (what a
#: test may cut; the widths are never cut)
SCALE_KEYS = ("nodes", "init_pods", "measure_pods", "pod_ceiling")


@dataclass(frozen=True)
class SpreadSpec:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str
    match_labels: tuple  # sorted (key, value) pairs


@dataclass(frozen=True)
class NodeSpec:
    kind: ClassVar[str] = "node"
    name: str
    cpu_millis: int
    memory_bytes: int
    pods: int
    labels: dict


@dataclass(frozen=True)
class NodeDelete:
    kind: ClassVar[str] = "node_delete"
    name: str


@dataclass(frozen=True)
class PodGroupSpec:
    kind: ClassVar[str] = "pod_group"
    namespace: str
    name: str
    min_member: int
    creation_ms: int
    #: the Permit wait of each member; None: Coscheduling's default
    schedule_timeout_seconds: int | None = None


@dataclass(frozen=True)
class QuotaSpec:
    kind: ClassVar[str] = "quota"
    namespace: str
    min_cpu_millis: int
    min_memory_bytes: int
    max_cpu_millis: int
    max_memory_bytes: int


@dataclass
class PodSpec:
    kind: ClassVar[str] = "pod"
    uid: str
    name: str
    namespace: str
    creation_ms: int
    priority: int
    cpu_millis: int
    memory_bytes: int
    labels: dict
    spread: tuple = ()  # SpreadSpec, ...
    node: str | None = None  # bound at set-up (fill pods)
    group: str | None = None  # the name of its PodGroup, in its namespace

    def queue_key(self):
        """Upstream PrioritySort: priority descending, then creation
        time, then namespace/name."""
        return (-self.priority, self.creation_ms,
                f"{self.namespace}/{self.name}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _rng_streams(seed: int, n: int):
    """`n` independent generators from one seed of any size or sign."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [np.random.default_rng(s) for s in ss.spawn(n)]


#: the independent random streams of one seed, by name
STREAMS = ("zones", "fill", "events")


@dataclass
class Traffic:
    """The cluster and the pod factory of one (configuration, seed).

    `nodes` are built at construction; `pod(template, node)` makes the
    next pod of a template (its generator serial, and creation time, one
    more than the last), `pod_at` the pod of a given serial, in a PodGroup
    when `group` names one, `arrivals(n)` the next `n` pods of the
    measured template, and `rebuild` makes arrivals again from their first
    serial. A template sets the pods' `name_prefix`, `cpu_millis`,
    `memory_bytes`, and optionally `labels`, `spread`, `namespace`
    (default "default") and `priority` (default 0).
    `rng[name]` is the stream `name` of `STREAMS`: a generator draws from
    "fill" and "events"."""

    config: dict
    seed: int
    nodes: list = field(init=False)

    def __post_init__(self):
        self.rng = dict(zip(STREAMS, _rng_streams(self.seed, len(STREAMS))))
        self._serial = 0
        self.nodes = self._make_nodes()

    def _make_nodes(self) -> list:
        cfg = self.config
        tpl = cfg["node_template"]
        n = int(cfg["nodes"])
        zones = cfg.get("zones")
        zone_of = None
        if zones:
            # scheduler_perf's labelNodePrepareStrategy: one value drawn
            # per node
            zone_of = self.rng["zones"].integers(0, len(zones["values"]),
                                                 size=n)
        out = []
        for i in range(n):
            name = f"{tpl['name_prefix']}{i:05d}"
            labels = {k: v.format(name=name)
                      for k, v in cfg.get("node_labels", {}).items()}
            if zone_of is not None:
                labels[zones["key"]] = zones["values"][int(zone_of[i])]
            out.append(NodeSpec(name, int(tpl["cpu_millis"]),
                                int(tpl["memory_bytes"]), int(tpl["pods"]),
                                labels))
        return out

    def pod(self, template: dict, node: str | None = None) -> PodSpec:
        self._serial += 1
        return self.pod_at(template, self._serial, node)

    @staticmethod
    def pod_at(template: dict, serial: int, node: str | None = None,
               group: str | None = None) -> PodSpec:
        """The pod of generator serial `serial` (its creation time, in
        ms of the store's clock, is the serial too)."""
        name = f"{template['name_prefix']}{serial:08d}"
        namespace = template.get("namespace", "default")
        spread = tuple(
            SpreadSpec(int(c["max_skew"]), c["topology_key"],
                       c["when_unsatisfiable"],
                       tuple(sorted(c["match_labels"].items())))
            for c in template.get("spread", ())
        )
        return PodSpec(uid=f"{namespace}/{name}", name=name,
                       namespace=namespace, creation_ms=serial,
                       priority=int(template.get("priority", 0)),
                       cpu_millis=int(template["cpu_millis"]),
                       memory_bytes=int(template["memory_bytes"]),
                       labels=dict(template.get("labels", {})),
                       spread=spread, node=node, group=group)

    def arrivals(self, n: int) -> list:
        tpl = self.config["measure_pod_template"]
        return [self.pod(tpl) for _ in range(n)]

    def rebuild(self, first_serial: int, n: int) -> list:
        """The `n` arrivals whose serials start at `first_serial`, as
        `arrivals` made them: a run keeps only (first serial, count)."""
        tpl = self.config["measure_pod_template"]
        return [self.pod_at(tpl, first_serial + k) for k in range(n)]


class BoundSet:
    """The bound pods' uids in an indexable list (swap-remove), so a seeded
    draw of k of them costs O(k)."""

    def __init__(self):
        self._uids: list = []
        self._pos: dict = {}

    def add(self, uid: str) -> None:
        if uid not in self._pos:
            self._pos[uid] = len(self._uids)
            self._uids.append(uid)

    def discard(self, uid: str) -> None:
        i = self._pos.pop(uid, None)
        if i is None:
            return
        last = self._uids.pop()
        if i < len(self._uids):
            self._uids[i] = last
            self._pos[last] = i

    def draw(self, rng, k: int) -> list:
        """k distinct uids drawn from `rng`, removed from the set."""
        out = []
        for _ in range(min(k, len(self._uids))):
            uid = self._uids[int(rng.integers(0, len(self._uids)))]
            self.discard(uid)
            out.append(uid)
        return out
