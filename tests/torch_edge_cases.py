"""Bench config 7's churn (`tests/torch_churn_cases.py`, `SERVING_SHAPE`)
as feed-v2 events sent over TCP into scheduler daemons built in process,
shared by `tests/test_torch_daemon.py` (the port against JAX, cut to
`CHURN_TEST_SHAPE`) and `chip_smoke.py`'s edge phase (the card against
the CPU at the full shape).

Every function takes the package's names in a namespace and imports
neither package itself: `pkg.objects` (or `pkg.o`) for the object model,
`pkg.main` for the package's daemon module (`parse_args`, `Daemon`) and
`pkg.FeedClient`.

- `node_event` / `pod_event` turn an object of either package into the
  event an agent would send for it (`bridge/feed.py` is the contract).
- `FeedRecorder` stands in for a `Cluster` in `churn_cluster` /
  `churn_events`: every mutation becomes an event handed to `emit`, and
  the reads (`nodes`, `pods`) go to the store the events land in, so the
  churn draws see the daemon's own bindings.
- `make_daemon` builds a daemon from its command-line flags around a JSON
  profile file; `EdgeArm` is one daemon with its feed client.
- `run_edge_churn` bootstraps every arm with config 7's cluster, then
  runs `warmup + cycles` churn cycles: the cycle's events go to every
  arm, then every arm ticks once at the cycle's `now`.
- `edge_gates` lists the failed gates (empty = pass).
"""

from __future__ import annotations

import json
import os
import statistics
import time
from types import SimpleNamespace

import numpy as np

from torch_churn_cases import (
    CHURN_PROFILE,
    capacity_violations,
    churn_cluster,
    churn_events,
)


def _objects(pkg):
    return getattr(pkg, "objects", None) or pkg.o


def node_event(node) -> dict:
    """The `upsert_node` event of a Node."""
    event = {"op": "upsert_node", "name": node.name,
             "allocatable": dict(node.allocatable),
             "labels": dict(node.labels),
             "unschedulable": bool(node.unschedulable)}
    if node.taints:
        event["taints"] = [{"key": t.key, "value": t.value,
                            "effect": t.effect} for t in node.taints]
    return event


def pod_event(pod) -> dict:
    """The `upsert_pod` event of a plain Pod (containers, priority,
    creation time, labels and binding)."""
    return {
        "op": "upsert_pod", "name": pod.name, "namespace": pod.namespace,
        "uid": pod.uid, "priority": int(pod.priority),
        "creation_ms": int(pod.creation_ms), "labels": dict(pod.labels),
        "containers": [{"requests": dict(c.requests),
                        "limits": dict(c.limits)} for c in pod.containers],
        "node": pod.node_name,
    }


class FeedRecorder:
    """A `Cluster` stand-in whose mutations become feed-v2 events handed to
    `emit`; `nodes` and `pods` read `view`, the store the events land in
    (`churn_cluster` reads nothing, so the bootstrap needs none)."""

    def __init__(self, emit, view=None):
        self.emit = emit
        self.view = view

    @property
    def nodes(self):
        return self.view.nodes

    @property
    def pods(self):
        return self.view.pods

    def add_node(self, node):
        self.emit(node_event(node))

    def add_pod(self, pod):
        self.emit(pod_event(pod))

    def remove_pod(self, uid):
        self.emit({"op": "delete_pod", "uid": uid})

    def remove_node(self, name):
        self.emit({"op": "delete_node", "name": name})


def bootstrap_events(pkg, shape: dict, seed: int = 0) -> list:
    """Config 7's starting cluster (`churn_cluster`) as events: every node,
    then every bound pod, in the store's insertion order."""
    events: list = []
    ns = SimpleNamespace(objects=_objects(pkg),
                         Cluster=lambda: FeedRecorder(events.append))
    churn_cluster(ns, shape["n_nodes"], shape["prefill"], seed)
    return events


def write_profile(directory: str, config: dict = CHURN_PROFILE) -> str:
    """`config` as a JSON profile file under `directory` (a JSON profile
    needs no PyYAML)."""
    path = os.path.join(directory, "edge_profile.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def make_daemon(pkg, profile_path: str, flags=()):
    """`pkg.main.Daemon` from its command-line flags: feed on an ephemeral
    port, health server on another, no pod-lifecycle ledger (a process-
    wide table the arms would share)."""
    args = pkg.main.parse_args(["--profile", profile_path, "--no-ledger",
                                "--health-port", "0", *flags])
    return pkg.main.Daemon(args)


class EdgeArm:
    """One daemon and its feed client."""

    def __init__(self, label: str, pkg, daemon):
        self.label = label
        self.daemon = daemon
        host, port = daemon.feed.address
        self.client = pkg.FeedClient(host, port)
        self.reports: list = []
        self.tick_s: list = []
        self.ingest_s = 0.0
        self.ingest_events = 0

    def send(self, event: dict) -> dict:
        ack = self.client.send(event)
        if not ack.get("ok"):
            raise AssertionError(f"{self.label}: {event.get('op')} "
                                 f"refused: {ack}")
        return ack

    def close(self) -> None:
        self.client.close()
        self.daemon.shutdown()


def run_edge_churn(pkg, arms: list, shape: dict, seed: int = 0) -> dict:
    """Bootstrap every arm with config 7's cluster over its feed (timed per
    arm), then `warmup + cycles` churn cycles: the cycle's events (drawn
    from the first arm's store, `churn_events`' rng stream as in
    `run_churn`) go to every arm, then every arm ticks at `now = 1000 *
    (cycle + 1)`. Each arm collects its reports' (bound, failed) and its
    tick seconds. Returns the bootstrap event count and the cycles'
    event counts."""
    boot = bootstrap_events(pkg, shape, seed)
    for arm in arms:
        t0 = time.perf_counter()
        for event in boot:
            arm.send(event)
        arm.ingest_s = time.perf_counter() - t0
        arm.ingest_events = len(boot)
    rng = np.random.default_rng(seed + 1)
    serial = 0
    cycle_events = []

    def emit(event):
        cycle_events[-1] += 1
        for arm in arms:
            arm.send(event)

    recorder = FeedRecorder(emit, view=arms[0].daemon.cluster)
    for cycle in range(shape["warmup"] + shape["cycles"]):
        now = 1000 * (cycle + 1)
        cycle_events.append(0)
        serial = churn_events(pkg, recorder, rng, shape, cycle, now, serial)
        for arm in arms:
            t0 = time.perf_counter()
            report = arm.daemon.tick(now_ms=now)
            arm.tick_s.append(time.perf_counter() - t0)
            arm.reports.append((dict(report.bound), list(report.failed)))
    return {"bootstrap_events": len(boot), "cycle_events": cycle_events}


def store_state(cluster) -> tuple:
    """(node names in order, uid -> node of every pod): what two stores
    fed the same events and deciding alike must share."""
    return (list(cluster.nodes),
            {uid: p.node_name for uid, p in cluster.pods.items()})


def arm_line(arm) -> dict:
    """The per-arm numbers the smoke prints: bootstrap ingest, ticks/s and
    tick ms p50 / p99."""
    ticks = sorted(arm.tick_s)

    def pct(q):
        return ticks[min(len(ticks) - 1, int(q * len(ticks)))] * 1000

    return {
        "arm": arm.label, "ingest_s": arm.ingest_s,
        "ingest_events": arm.ingest_events,
        "events_per_s": arm.ingest_events / arm.ingest_s
        if arm.ingest_s else None,
        "ticks": len(ticks), "ticks_per_s": len(ticks) / sum(ticks),
        "tick_ms_p50": statistics.median(ticks) * 1000,
        "tick_ms_p99": pct(0.99),
        "bound": sum(len(b) for b, _ in arm.reports),
        "violations": capacity_violations(arm.daemon.cluster),
    }


def edge_gates(arms: list, reference=None) -> list:
    """Failed gates: every tick's (bound, failed) equal across the arms and
    to `reference` (a direct-mutation run's reports) when given, the
    final stores equal, no capacity violation."""
    bad = []
    first = arms[0]
    for arm in arms[1:]:
        if arm.reports != first.reports:
            cycles = [i for i, (a, b) in enumerate(zip(arm.reports,
                                                       first.reports))
                      if a != b]
            bad.append(f"{arm.label} != {first.label} at cycles {cycles}")
        if store_state(arm.daemon.cluster) != store_state(
                first.daemon.cluster):
            bad.append(f"store {arm.label} != {first.label}")
    if reference is not None and first.reports != reference:
        bad.append(f"{first.label} != the direct-mutation run")
    for arm in arms:
        n = capacity_violations(arm.daemon.cluster)
        if n:
            bad.append(f"{arm.label}: {n} capacity violations")
    return bad
