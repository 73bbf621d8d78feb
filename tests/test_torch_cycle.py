"""The port's scheduling cycle (`scheduler_plugins_tpu_torch.framework.cycle`,
with the store's bookkeeping, the preemption engine and the quality stamp)
against JAX `run_cycle`, cycle by cycle.

Each script builds the same cluster in both packages, runs the same
sequence of cycles and store mutations through JAX `run_cycle` and the
port's `run_cycle(device="cpu")`, and after every cycle requires, exactly
(tolerance 0, in insertion order):

- every `CycleReport` field the port has, `quality` included (the JAX
  report's other fields belong to options the port does not have yet and
  must sit at their defaults);
- the store's reserved, pod_deadline_ms, pod_attempts,
  pod_backoff_until_ms, unschedulable_since, event_seq, event_last,
  gang_backoff_until_ms, gang_last_failure_ms and recent_bindings (every
  bind, the nominee's and the fan-out's included, stamps it);
- every pod's node_name, nominated_node_name and deletion_ms.

The scripts mirror the JAX package's own cycle tests (named on each
case), plus seeded random churn scripts. The `cuda`-marked test runs a
script on the card and on the CPU (`python -m pytest
tests/test_torch_cycle.py -m cuda`); it needs no JAX."""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.framework.preemption as port_preemption
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.framework import (
    Profile as PProfile,
    Scheduler as PScheduler,
)
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.state import cluster as port_store
from scheduler_plugins_tpu_torch.tuning import quality as port_quality
from torch_cycle_scripts import (
    SCRIPT_COSCHED,
    cycle_script,
    pdb_nomination,
    pdb_script,
    script_outcomes,
)

try:
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.framework.preemption as jax_preemption
    import scheduler_plugins_tpu.plugins as jax_plugins
    from scheduler_plugins_tpu.framework import (
        Profile as JProfile,
        Scheduler as JScheduler,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    from scheduler_plugins_tpu.tuning import quality as jax_quality
except ImportError:
    # a card machine may lack the JAX package's own dependencies; only the
    # differential tests need it, never the cuda-marked one
    jax_objects = None

GIB = 1 << 30
CPU = "cpu"

PORT = SimpleNamespace(
    o=port_objects, Cluster=PCluster, plugins=port_plugins,
    Profile=PProfile, Scheduler=PScheduler, pre=port_preemption,
    cycle=port_cycle,
    run=lambda s, c, now: port_cycle.run_cycle(s, c, now=now, device=CPU),
)
JAX = None if jax_objects is None else SimpleNamespace(
    o=jax_objects, Cluster=JCluster, plugins=jax_plugins, Profile=JProfile,
    Scheduler=JScheduler, pre=jax_preemption, cycle=jax_cycle,
    run=lambda s, c, now: jax_cycle.run_cycle(s, c, now=now),
)

STORE_FIELDS = (
    "reserved", "pod_deadline_ms", "pod_attempts", "pod_backoff_until_ms",
    "unschedulable_since", "event_seq", "event_last",
    "gang_backoff_until_ms", "gang_last_failure_ms", "recent_bindings",
)
POD_FIELDS = ("node_name", "nominated_node_name", "deletion_ms")


@pytest.fixture
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


# --- comparison -------------------------------------------------------------

def ordered(value):
    """Dicts as ordered item lists, sequences as lists: == then compares
    insertion order too."""
    if isinstance(value, dict):
        return [(k, ordered(v)) for k, v in value.items()]
    if isinstance(value, (list, tuple)):
        return [ordered(v) for v in value]
    return value


def report_diff(want, got) -> list:
    """Names of the port report `got`'s fields that differ from `want`
    (a JAX or a port report). The port's report has every field of JAX's
    since the sanitizer's came in, so every field is compared."""
    return [f.name for f in fields(got)
            if ordered(getattr(want, f.name)) != ordered(getattr(got, f.name))]


def store_diff(jc, pc) -> list:
    bad = [k for k in STORE_FIELDS
           if ordered(getattr(jc, k)) != ordered(getattr(pc, k))]
    if list(jc.pods) != list(pc.pods):
        bad.append("pods")
    else:
        bad += [f"{uid}.{k}" for uid in jc.pods for k in POD_FIELDS
                if getattr(jc.pods[uid], k) != getattr(pc.pods[uid], k)]
    if list(jc.nodes) != list(pc.nodes):
        bad.append("nodes")
    return bad


# --- builders: the same objects in either package ---------------------------

def mknode(pkg, name, cpu=10_000, mem=32 * GIB, pods=110, **kw):
    return pkg.o.Node(name=name, allocatable={"cpu": cpu, "memory": mem,
                                              "pods": pods}, **kw)


def mkpod(pkg, name, cpu=100, mem=1 << 20, ns="default", gang=None,
          node=None, **kw):
    labels = dict(kw.pop("labels", {}))
    if gang:
        labels[pkg.o.POD_GROUP_LABEL] = gang
    pod = pkg.o.Pod(name=name, namespace=ns, labels=labels,
                    containers=[pkg.o.Container(
                        requests={"cpu": cpu, "memory": mem})], **kw)
    pod.node_name = node
    return pod


def mksched(pkg, *plugins, preemption=None):
    """A profile of `plugins`, each a name or (name, kwargs);
    `preemption="default"` selects the DEFAULT-mode engine."""
    built = []
    for spec in plugins:
        name, kwargs = (spec, {}) if isinstance(spec, str) else spec
        built.append(getattr(pkg.plugins, name)(**kwargs))
    engine = None
    if preemption == "default":
        engine = pkg.pre.PreemptionEngine(pkg.pre.PreemptionMode.DEFAULT)
    return pkg.Scheduler(pkg.Profile(plugins=built, preemption=engine))


ALLOC = "NodeResourcesAllocatable"


def cosched(**kw):
    return ("Coscheduling", kw)


def quota(pkg, ns, min_cpu, max_cpu, min_mem=10 * GIB, max_mem=20 * GIB):
    return pkg.o.ElasticQuota(name=f"eq-{ns}", namespace=ns,
                              min={"cpu": min_cpu, "memory": min_mem},
                              max={"cpu": max_cpu, "memory": max_mem})


# --- scripts ---------------------------------------------------------------
# each returns (cluster, scheduler, steps): steps are (now, mutate or None),
# `mutate(pkg, cluster)` applied just before that cycle

def basic_binds_pending(pkg):  # test_framework TestBasicCycle
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0"))
    c.add_node(mknode(pkg, "n1", cpu=2000))
    for i in range(3):
        c.add_pod(mkpod(pkg, f"p{i}", cpu=500))
    return c, mksched(pkg, ALLOC), [(1000, None)]


def basic_priority_orders_queue(pkg):
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=600, pods=10))
    c.add_pod(mkpod(pkg, "low", cpu=500, priority=1, creation_ms=1))
    c.add_pod(mkpod(pkg, "high", cpu=500, priority=10, creation_ms=2))
    return c, mksched(pkg, ALLOC), [(1000, None)]


def basic_unschedulable_reported(pkg):
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=100))
    c.add_pod(mkpod(pkg, "huge", cpu=99_000))
    return c, mksched(pkg, ALLOC), [(1000, None)]


def gang_cluster(pkg, min_member=3, members=3, cpu_each=1000,
                 node_cpu=10_000):
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=node_cpu))
    c.add_pod_group(pkg.o.PodGroup(name="g", namespace="default",
                                   min_member=min_member))
    for i in range(members):
        c.add_pod(mkpod(pkg, f"m{i}", cpu=cpu_each, gang="g", creation_ms=i))
    return c


def gang_full_binds(pkg):  # TestCoscheduling
    return gang_cluster(pkg), mksched(pkg, ALLOC, cosched()), [(1000, None)]


def gang_undersized_rejected(pkg):
    return (gang_cluster(pkg, min_member=5, members=3),
            mksched(pkg, ALLOC, cosched()), [(1000, None)])


def gang_waits_then_expires(pkg):
    c = gang_cluster(pkg, node_cpu=2000)
    s = mksched(pkg, ALLOC, cosched(permit_waiting_seconds=10,
                                    reject_percentage=100))
    return c, s, [(1000, None), (12_000, None), (23_000, None)]


def gang_quorum_completes(pkg):
    c = gang_cluster(pkg, node_cpu=2000)
    s = mksched(pkg, ALLOC, cosched(permit_waiting_seconds=300,
                                    reject_percentage=100))
    return c, s, [
        (1000, None),
        (2000, lambda pkg, c: c.add_node(mknode(pkg, "n1", cpu=2000))),
    ]


def gang_min_resources_check(pkg):
    c = gang_cluster(pkg, min_member=2, members=2, cpu_each=100)
    c.pod_groups["default/g"].min_resources = {"cpu": 50_000}
    return c, mksched(pkg, ALLOC, cosched()), [(1000, None)]


def gang_min_resources_own_members(pkg):
    c = gang_cluster(pkg, node_cpu=3000)
    c.pod_groups["default/g"].min_resources = {"cpu": 3000}
    return c, mksched(pkg, ALLOC, cosched()), [(1000, None)]


def gang_gated_blocks_quorum(pkg):
    c = gang_cluster(pkg, min_member=3, members=2)
    c.add_pod(mkpod(pkg, "m2", cpu=1000, gang="g", scheduling_gated=True))
    return c, mksched(pkg, ALLOC, cosched()), [(1000, None)]


def gang_reject_slack(pkg):
    c = gang_cluster(pkg, min_member=10, members=10, node_cpu=9000)
    s = mksched(pkg, ALLOC, cosched(permit_waiting_seconds=300))
    return c, s, [(1000, None)]


def gang_incomplete_not_backed_off(pkg):
    c = gang_cluster(pkg, min_member=5, members=2)
    s = mksched(pkg, ALLOC, cosched(pod_group_backoff_seconds=60))
    return c, s, [(1000, None)]


def gang_backoff_blocks_next_cycle(pkg):
    c = gang_cluster(pkg, node_cpu=2000)
    s = mksched(pkg, ALLOC, cosched(permit_waiting_seconds=5,
                                    pod_group_backoff_seconds=60))
    return c, s, [(1000, None), (2000, None), (62_000, None)]


def gang_failure_time_demotes(pkg):
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0"))
    c.add_pod_group(pkg.o.PodGroup(name="g", namespace="default",
                                   creation_ms=0))
    c.gang_last_failure_ms["default/g"] = 500
    c.add_pod(mkpod(pkg, "gp", gang="g", creation_ms=0))
    c.add_pod(mkpod(pkg, "pp", creation_ms=100))
    return c, mksched(pkg, ALLOC, cosched()), [(1000, None)]


def quota_cluster(pkg):  # TestCapacityScheduling
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=100_000))
    c.add_quota(quota(pkg, "a", 1000, 2000))
    c.add_quota(quota(pkg, "b", 1000, 3000))
    return c


def capsched(pkg):
    return mksched(pkg, ALLOC, "CapacityScheduling")


def quota_borrowing_admits(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "a1", cpu=1500, ns="a"))
    return c, capsched(pkg), [(1000, None)]


def quota_over_max_rejected(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "a1", cpu=2500, ns="a"))
    return c, capsched(pkg), [(1000, None)]


def quota_aggregate_over_min(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "b0", cpu=1900, ns="b", node="n0"))
    c.add_pod(mkpod(pkg, "a1", cpu=500, ns="a"))
    return c, capsched(pkg), [(1000, None)]


def quota_usage_accumulates(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "a1", cpu=1100, ns="a", creation_ms=1))
    c.add_pod(mkpod(pkg, "a2", cpu=1100, ns="a", creation_ms=2))
    return c, capsched(pkg), [(1000, None)]


def quota_nominated_counts(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "vip", cpu=1500, mem=999 * GIB, ns="a", priority=10,
                    creation_ms=1, nominated_node_name="n0"))
    c.add_pod(mkpod(pkg, "late", cpu=800, ns="a", priority=1, creation_ms=2))
    return c, capsched(pkg), [(1000, None)]


def quota_bound_nominee_once(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "vip", cpu=900, ns="a", priority=10, creation_ms=1,
                    nominated_node_name="n0"))
    c.add_pod(mkpod(pkg, "late", cpu=800, ns="a", priority=1, creation_ms=2))
    return c, capsched(pkg), [(1000, None)]


def quota_no_quota_namespace(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "free", cpu=50_000, ns="unquotaed"))
    return c, capsched(pkg), [(1000, None)]


def permit_cluster(pkg, members):  # TestPerPodPermitDeadlines
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=1000, mem=8 * GIB, pods=10))
    c.add_pod_group(pkg.o.PodGroup(name="g", min_member=members,
                                   creation_ms=0))
    for m in range(members):
        c.add_pod(mkpod(pkg, f"m{m}", cpu=1000, mem=GIB, gang="g",
                        creation_ms=m))
    return c, mksched(pkg, ALLOC, cosched(permit_waiting_seconds=10,
                                          reject_percentage=100))


def permit_staggered_deadlines(pkg):
    c, s = permit_cluster(pkg, 3)
    return c, s, [
        (1000, None),
        (5000, lambda pkg, c: c.add_node(
            mknode(pkg, "n1", cpu=1000, mem=8 * GIB, pods=10))),
        (12_000, None),
    ]


def permit_timer_not_early(pkg):
    c, s = permit_cluster(pkg, 2)
    return c, s, [(1000, None), (10_999, None), (11_000, None)]


def full_cluster(pkg):  # test_requeue
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=4000))
    c.add_pod(mkpod(pkg, "resident", cpu=4000, mem=GIB, node="n0"))
    c.add_pod(mkpod(pkg, "p", cpu=2000, mem=GIB))
    return c


def remove(uid):
    return lambda pkg, c: c.remove_pod(uid)


def nominate(uid, node):
    def mutate(pkg, c):
        c.pods[uid].nominated_node_name = node
    return mutate


def gating_skipped_until_event(pkg):  # TestEventGating
    return full_cluster(pkg), mksched(pkg, ALLOC), [(1000, None),
                                                    (2000, None)]


def gating_pod_delete_requeues(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None), (2000, remove("default/resident"))]


def gating_node_add_requeues(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None),
        (2000, lambda pkg, c: c.add_node(mknode(pkg, "n1", cpu=4000)))]


def gating_unregistered_event(pkg):
    # no enabled plugin registers ElasticQuota events (the JAX test uses a
    # SeccompProfile, an object the port's store does not hold yet)
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None),
        (2000, lambda pkg, c: c.add_quota(quota(pkg, "x", 1000, 2000)))]


def gating_flush_deadline(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None), (3000, None), (6001, None)]


#: the flush deadline this script runs with: the JAX store's field, the
#: port's module constant (`run_script` sets both)
gating_flush_deadline.requeue_flush_ms = 5000


def gating_nominated_retries(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None), (2000, nominate("default/p", "n0"))]


def gating_fresh_pods(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None),
        (2000, lambda pkg, c: c.add_pod(mkpod(pkg, "q", cpu=500, mem=GIB)))]


def backoff_bind_clears(pkg):  # TestRequeueBackoff
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None), (2500, remove("default/resident"))]


def backoff_event_inside_window(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None), (1100, remove("default/resident")), (2100, None)]


def backoff_hot_loop_paced(pkg):
    def tiny(k):
        return lambda pkg, c: c.add_node(mknode(pkg, f"tiny-{k}", cpu=100))
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000 + k * 1000, tiny(k)) for k in range(12)]


def backoff_nominated_bypasses(pkg):
    return full_cluster(pkg), mksched(pkg, ALLOC), [
        (1000, None), (1100, nominate("default/p", "n0"))]


def gang_new_sibling_activates(pkg):  # TestGangActivation
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "n0", cpu=10_000))
    c.add_pod_group(pkg.o.PodGroup(name="g", min_member=3))
    for i in range(2):
        c.add_pod(mkpod(pkg, f"m{i}", cpu=100, mem=GIB, gang="g"))
    return c, mksched(pkg, ALLOC, cosched()), [
        (1000, None), (2000, None),
        (3000, lambda pkg, c: c.add_pod(
            mkpod(pkg, "m2", cpu=100, mem=GIB, gang="g")))]


def attribution_builtin_fit(pkg):  # TestFailedByDecisionTable
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "a", cpu=8000))
    c.add_pod(mkpod(pkg, "huge", cpu=99_000, mem=GIB))
    c.add_pod(mkpod(pkg, "fits", cpu=100, mem=GIB))
    return c, mksched(pkg, ALLOC), [(1000, None)]


def attribution_coscheduling(pkg):
    c = pkg.Cluster()
    c.add_node(mknode(pkg, "a", cpu=8000))
    c.add_pod_group(pkg.o.PodGroup(name="g", namespace="default",
                                   min_member=3, creation_ms=0))
    c.add_pod(mkpod(pkg, "p", cpu=100, mem=GIB, gang="g"))
    return c, mksched(pkg, ALLOC, cosched()), [(1000, None)]


def attribution_capacity(pkg):
    c = quota_cluster(pkg)
    c.add_pod(mkpod(pkg, "a1", cpu=2500, ns="a"))
    c.add_pod(mkpod(pkg, "fits", cpu=50, ns="a"))
    return c, mksched(pkg, ALLOC, cosched(), "CapacityScheduling"), [
        (1000, None)]


def pre_node(pkg, name, cpu=4000):  # test_preemption
    return mknode(pkg, name, cpu=cpu)


def prepod(pkg, name, cpu, ns="default", priority=0, node=None, created=0):
    return mkpod(pkg, name, cpu=cpu, mem=GIB, ns=ns, priority=priority,
                 node=node, creation_ms=created)


def default_pre(pkg):
    return mksched(pkg, ALLOC, preemption="default")


def preempt_lower_priority(pkg):  # TestDefaultPreemption
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0"))
    c.add_pod(prepod(pkg, "low", 3000, priority=1, node="n0"))
    c.add_pod(prepod(pkg, "high", 3000, priority=10))
    return c, default_pre(pkg), [(1000, None)]


def preempt_not_equal_priority(pkg):
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0"))
    c.add_pod(prepod(pkg, "peer", 3000, priority=10, node="n0"))
    c.add_pod(prepod(pkg, "claimant", 3000, priority=10))
    return c, default_pre(pkg), [(1000, None)]


def preempt_reprieve_minimizes(pkg):
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0"))
    c.add_pod(prepod(pkg, "v1", 1500, priority=5, node="n0", created=1))
    c.add_pod(prepod(pkg, "v2", 1500, priority=1, node="n0", created=2))
    c.add_pod(prepod(pkg, "filler", 1000, priority=20, node="n0"))
    c.add_pod(prepod(pkg, "big", 1400, priority=10))
    return c, default_pre(pkg), [(1000, None)]


def preempt_lowest_victim_priority(pkg):
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "a"))
    c.add_node(pre_node(pkg, "b"))
    c.add_pod(prepod(pkg, "va", 3000, priority=8, node="a"))
    c.add_pod(prepod(pkg, "vb", 3000, priority=2, node="b"))
    c.add_pod(prepod(pkg, "claimant", 3000, priority=10))
    return c, default_pre(pkg), [(1000, None)]


def cap_pre_cluster(pkg):  # TestCapacityPreemption
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0"))
    for ns in ("a", "b"):
        c.add_quota(quota(pkg, ns, 2000, 4000, 8 * GIB, 16 * GIB))
    return c


def remove_terminating(pkg, c):
    """The kubelet finished every termination in flight."""
    for uid in [u for u, p in c.pods.items() if p.terminating]:
        c.remove_pod(uid)


def cap_pre_borrowing_evicted(pkg):
    # the nominee places in the next cycle once its victim is removed
    c = cap_pre_cluster(pkg)
    c.add_pod(prepod(pkg, "b1", 1500, ns="b", priority=5, node="n0",
                     created=1))
    c.add_pod(prepod(pkg, "b2", 1500, ns="b", priority=5, node="n0",
                     created=2))
    c.add_pod(prepod(pkg, "a1", 1500, ns="a", priority=1))
    return c, capsched(pkg), [(1000, None), (2000, None),
                              (3000, remove_terminating)]


def cap_pre_own_namespace(pkg):
    c = cap_pre_cluster(pkg)
    c.add_pod(prepod(pkg, "a-old", 2000, ns="a", priority=1, node="n0",
                     created=1))
    c.add_pod(prepod(pkg, "b-old", 1500, ns="b", priority=1, node="n0",
                     created=2))
    c.add_pod(prepod(pkg, "a-new", 1500, ns="a", priority=5))
    return c, capsched(pkg), [(1000, None), (2000, remove_terminating)]


def cap_pre_non_quota_spares(pkg):
    c = cap_pre_cluster(pkg)
    c.add_pod(prepod(pkg, "b1", 3000, ns="b", priority=1, node="n0"))
    c.add_pod(prepod(pkg, "free", 3000, ns="noquota", priority=10))
    return c, capsched(pkg), [(1000, None)]


def nom_keeps_while_terminating(pkg):  # TestPodEligibleToPreemptOthers
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0", cpu=3000))
    c.add_pod(prepod(pkg, "low", 3000, priority=1, node="n0"))
    c.add_pod(prepod(pkg, "high", 3000, priority=10))
    return c, default_pre(pkg), [(1000, None), (2000, None),
                                 (3000, remove("default/low"))]


def nom_lower_cannot_steal(pkg):  # TestNominatedCapacityHolds
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0", cpu=3000))
    c.add_pod(prepod(pkg, "low", 3000, priority=1, node="n0"))
    c.add_pod(prepod(pkg, "high", 3000, priority=10))

    def step(pkg, c):
        c.remove_pod("default/low")
        c.add_pod(prepod(pkg, "sneaky", 2000, priority=5, created=1500))
    return c, default_pre(pkg), [(1000, None), (2000, step)]


def nom_higher_ignores_hold(pkg):
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0", cpu=3000))
    c.add_pod(prepod(pkg, "low", 3000, priority=1, node="n0"))
    c.add_pod(prepod(pkg, "mid", 3000, priority=10))

    def step(pkg, c):
        c.remove_pod("default/low")
        c.add_pod(prepod(pkg, "vip", 3000, priority=50, created=1500))
    return c, default_pre(pkg), [(1000, None), (2000, step)]


def nom_no_double_booking(pkg):
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0", cpu=3000))
    c.add_pod(prepod(pkg, "low", 3000, priority=1, node="n0"))
    c.add_pod(prepod(pkg, "p1", 3000, priority=10))
    return c, default_pre(pkg), [
        (1000, None),
        (2000, lambda pkg, c: c.add_pod(
            prepod(pkg, "p2", 3000, priority=9, created=1500)))]


def nom_unresolvable_node_reelects(pkg):
    c = pkg.Cluster()
    c.add_node(pre_node(pkg, "n0", cpu=3000))
    c.add_node(pre_node(pkg, "n1", cpu=3000))
    c.add_pod(prepod(pkg, "v0", 3000, priority=1, node="n0"))
    c.add_pod(prepod(pkg, "v1", 3000, priority=1, node="n1"))
    c.add_pod(prepod(pkg, "high", 3000, priority=10))

    def cordon_nominated(pkg, c):
        c.nodes[c.pods["default/high"].nominated_node_name].unschedulable = True
    return c, default_pre(pkg), [(1000, None), (2000, cordon_nominated)]


def churn_script(seed, n_nodes=10, cycles=6):
    """A seeded cluster with three quota namespaces, gangs, bound pods and
    mixed priorities, then churn between cycles: new pods and gangs,
    finished terminations, a deleted bound pod, a new node. Every choice is
    drawn from numpy with the seed, against the store's own contents, so
    both packages make the same ones."""
    def build(pkg):
        rng = np.random.default_rng(seed)
        c = pkg.Cluster()
        for i in range(n_nodes):
            c.add_node(mknode(pkg, f"node-{i:02d}",
                              cpu=int(rng.integers(4, 12)) * 1000,
                              mem=int(rng.integers(8, 32)) * GIB,
                              pods=int(rng.integers(6, 20))))
        namespaces = ["team-a", "team-b", "team-c"]
        for k, ns in enumerate(namespaces):
            c.add_quota(quota(pkg, ns, 20_000 + 8000 * k, 40_000 + 8000 * k,
                              40 * GIB, 120 * GIB))
        for i in range(n_nodes):
            c.add_pod(mkpod(pkg, f"bound-{i:02d}",
                            cpu=int(rng.integers(500, 3000)), mem=GIB,
                            ns=namespaces[i % 3],
                            priority=int(rng.integers(0, 4)),
                            node=f"node-{i:02d}", creation_ms=-1))
        s = mksched(pkg, ALLOC, cosched(permit_waiting_seconds=3,
                                        pod_group_backoff_seconds=2,
                                        reject_percentage=50),
                    "CapacityScheduling")
        steps = [(1000 * (k + 1), arrivals(k)) for k in range(cycles)]
        return c, s, steps

    def arrivals(k):
        def mutate(pkg, c):
            rng = np.random.default_rng((seed, k))
            namespaces = ["team-a", "team-b", "team-c"]
            if k % 2 == 1:
                remove_terminating(pkg, c)
            if k == 3:
                c.add_node(mknode(pkg, "node-new", cpu=16_000, mem=64 * GIB))
            bound = [u for u, p in c.pods.items()
                     if p.node_name is not None and not p.terminating]
            if k == 4 and bound:
                c.remove_pod(bound[int(rng.integers(0, len(bound)))])
            gang = f"g{k}"
            size = int(rng.integers(2, 5))
            c.add_pod_group(pkg.o.PodGroup(
                name=gang, namespace=namespaces[k % 3],
                min_member=size + int(rng.integers(0, 2)),
                creation_ms=1000 * k))
            for m in range(size):
                c.add_pod(mkpod(pkg, f"{gang}-m{m}",
                                cpu=int(rng.integers(500, 4000)), mem=GIB,
                                ns=namespaces[k % 3], gang=gang,
                                priority=int(rng.integers(2, 6)),
                                creation_ms=1000 * k + m))
            for j in range(int(rng.integers(3, 7))):
                c.add_pod(mkpod(pkg, f"c{k}-p{j}",
                                cpu=int(rng.integers(200, 5000)),
                                mem=int(rng.integers(1, 6)) * GIB,
                                ns=namespaces[int(rng.integers(0, 3))],
                                priority=int(rng.integers(0, 12)),
                                creation_ms=1000 * k + 10 + j))
        return mutate

    build.__name__ = f"churn_seed{seed}"
    return build


def smoke_script(pkg):
    """`cycle_script` at 16 nodes: Permit Wait then fan-out,
    a parked pod skipped until a Node/Add, a permit timeout, a whole-gang
    rejection with backoff, and a quota preemption whose nominee binds
    once its victims are removed."""
    cluster, steps = cycle_script(pkg.o, pkg.Cluster, n_nodes=16)
    sched = mksched(pkg, ALLOC, cosched(**SCRIPT_COSCHED),
                    "CapacityScheduling")
    return cluster, sched, [
        (now, None if m is None else (lambda pkg, c, m=m: m(pkg.o, c)))
        for now, m in steps
    ]


def pdb_smoke_script(pkg, guard=True):
    """`pdb_script` at 16 nodes: `smoke_script`, then a preemption whose
    cheaper victim a PodDisruptionBudget guards (`guard`) or not."""
    cluster, steps = pdb_script(pkg.o, pkg.Cluster, n_nodes=16, guard=guard)
    sched = mksched(pkg, ALLOC, cosched(**SCRIPT_COSCHED),
                    "CapacityScheduling")
    return cluster, sched, [
        (now, None if m is None else (lambda pkg, c, m=m: m(pkg.o, c)))
        for now, m in steps
    ]


def pdb_smoke_script_unguarded(pkg):
    return pdb_smoke_script(pkg, guard=False)


SCRIPTS = [
    smoke_script, pdb_smoke_script, pdb_smoke_script_unguarded,
    basic_binds_pending, basic_priority_orders_queue,
    basic_unschedulable_reported,
    gang_full_binds, gang_undersized_rejected, gang_waits_then_expires,
    gang_quorum_completes, gang_min_resources_check,
    gang_min_resources_own_members, gang_gated_blocks_quorum,
    gang_reject_slack, gang_incomplete_not_backed_off,
    gang_backoff_blocks_next_cycle, gang_failure_time_demotes,
    quota_borrowing_admits, quota_over_max_rejected, quota_aggregate_over_min,
    quota_usage_accumulates, quota_nominated_counts, quota_bound_nominee_once,
    quota_no_quota_namespace,
    permit_staggered_deadlines, permit_timer_not_early,
    gating_skipped_until_event, gating_pod_delete_requeues,
    gating_node_add_requeues, gating_unregistered_event,
    gating_flush_deadline, gating_nominated_retries, gating_fresh_pods,
    backoff_bind_clears, backoff_event_inside_window, backoff_hot_loop_paced,
    backoff_nominated_bypasses, gang_new_sibling_activates,
    attribution_builtin_fit, attribution_coscheduling, attribution_capacity,
    preempt_lower_priority, preempt_not_equal_priority,
    preempt_reprieve_minimizes, preempt_lowest_victim_priority,
    cap_pre_borrowing_evicted, cap_pre_own_namespace, cap_pre_non_quota_spares,
    nom_keeps_while_terminating, nom_lower_cannot_steal,
    nom_higher_ignores_hold, nom_no_double_booking,
    nom_unresolvable_node_reelects,
    churn_script(0), churn_script(1), churn_script(2, n_nodes=6),
]


def run_script(script, monkeypatch=None):
    """Both packages through `script`; returns the port's cluster and
    reports after every cycle matched JAX's. A script that sets
    `requeue_flush_ms` needs `monkeypatch`."""
    jc, js, jsteps = script(JAX)
    pc, ps, psteps = script(PORT)
    flush = getattr(script, "requeue_flush_ms", None)
    if flush is not None:
        jc.requeue_flush_ms = flush
        monkeypatch.setattr(port_store, "REQUEUE_FLUSH_MS", flush)
    assert store_diff(jc, pc) == []
    reports = []
    for k, ((now, jmut), (_, pmut)) in enumerate(zip(jsteps, psteps)):
        if jmut is not None:
            jmut(JAX, jc)
            pmut(PORT, pc)
        jr, pr = JAX.run(js, jc, now), PORT.run(ps, pc, now)
        assert report_diff(jr, pr) == [], (k, jr, pr)
        assert store_diff(jc, pc) == [], (k, store_diff(jc, pc))
        reports.append(pr)
    return pc, reports


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__)
def test_cycle_matches_jax(jax_package, script, monkeypatch):
    run_script(script, monkeypatch)


class TestScriptsReachTheirOutcomes:
    """The outcome each mirrored JAX test asserts, on the port's side of
    a few scripts: the scripts exercise what they are named for."""

    def test_waits_then_expires(self, jax_package):
        c, (r1, r2, r3) = run_script(gang_waits_then_expires)
        assert not r1.bound and len(r1.reserved) == 2
        assert r2.expired_gangs == r3.expired_gangs == ["default/g"]
        assert sorted(c.pod_deadline_ms.values()) == [33_000, 33_000]

    def test_quorum_completes_through_fanout(self, jax_package):
        c, (r1, r2) = run_script(gang_quorum_completes)
        assert len(r1.reserved) == 2 and len(r2.bound) == 3
        assert not c.reserved

    def test_backoff_and_preemption_outcomes(self, jax_package):
        _, (r1, r2, r3) = run_script(gang_backoff_blocks_next_cycle)
        assert r1.rejected_gangs == ["default/g"]
        assert not r2.bound and not r2.reserved
        c, (r1, r2, r3) = run_script(cap_pre_borrowing_evicted)
        node, victims = r1.preempted["a/a1"]
        assert node == "n0" and victims[0].startswith("b/")
        assert r3.bound == {"a/a1": "n0"}
        assert c.pods["a/a1"].node_name == "n0"

    def test_smoke_script_outcomes(self, jax_package):
        _, reports = run_script(smoke_script)
        assert script_outcomes(reports) == []

    def test_pdb_flips_the_nomination(self, jax_package):
        """The PDB moves the claimant's nomination off the node of the
        cheaper (guarded) victim: the first pickOneNode key at work."""
        c, reports = run_script(pdb_smoke_script)
        _, unguarded = run_script(pdb_smoke_script_unguarded)
        assert script_outcomes(reports) == []
        assert pdb_nomination(reports) == ("pdb-b", ["default/batch"])
        assert pdb_nomination(unguarded) == ("pdb-a", ["default/web"])
        assert c.pods["default/batch"].terminating
        assert not c.pods["default/web"].terminating

    def test_event_gating(self, jax_package):
        _, (_, r2) = run_script(gating_skipped_until_event)
        assert r2.skipped == ["default/p"] and r2.quality is None
        _, reports = run_script(backoff_hot_loop_paced)
        attempts = [len(r.failed) for r in reports]
        assert 2 <= sum(attempts) <= 5


def test_reserved_pods_hold_capacity_and_quorum(jax_package):
    """A Permit-waiting (reserved) pod stays out of the next cycle's queue,
    and its capacity and quorum count in that cycle's snapshot: two
    members reserve on n0 (which fits two), and in cycle 2 the third
    places on the new node and releases them, with n0 never over
    capacity."""
    pc, (r1, r2) = run_script(gang_quorum_completes)
    assert sorted(r1.reserved) == ["default/m0", "default/m1"]
    c, s, _ = gang_quorum_completes(PORT)
    PORT.run(s, c, 1000)
    pending = c.pending_pods()
    assert [p.uid for p in pending] == ["default/m2"]
    snap, meta = c.snapshot(pending, device=CPU)
    n0 = meta.node_names.index("n0")
    assert int(snap.nodes.requested[n0, 0]) == 2000  # cpu of the two held
    assert int(snap.gangs.assigned[0]) == 2
    assert c.pods["default/m0"].node_name is None  # the stored pod unbound
    assert r2.bound == {"default/m2": "n1", "default/m0": "n0",
                        "default/m1": "n0"}


class TestStoreBookkeeping:
    """`mark_unschedulable`'s backoff (test_requeue.py TestRequeueBackoff):
    the same windows as the JAX store, attempt by attempt."""

    def test_backoff_window_table(self, jax_package):
        jc, pc = JAX.Cluster(), PORT.Cluster()
        for attempt in range(1, 8):
            for c in (jc, pc):
                c.mark_unschedulable("default/p", now_ms=attempt * 100_000)
            assert store_diff(jc, pc) == []
            dur = pc.pod_backoff_until_ms["default/p"] - attempt * 100_000
            base = min(1000 << (attempt - 1), 10_000)
            assert base // 2 <= dur <= base

    def test_same_cycle_double_mark_and_seed(self, jax_package,
                                             monkeypatch):
        monkeypatch.setattr(port_store, "BACKOFF_SEED", 7)
        jc, pc = JAX.Cluster(backoff_seed=7), PORT.Cluster()
        for c in (jc, pc):
            c.mark_unschedulable("ns/x", now_ms=1000)
            c.mark_unschedulable("ns/x", now_ms=1000)
        assert pc.pod_attempts["ns/x"] == 1
        assert store_diff(jc, pc) == []

    def test_mutator_events(self, jax_package):
        jc, _, _ = churn_script(3)(JAX)
        pc, _, _ = churn_script(3)(PORT)
        for c, pkg in ((jc, JAX), (pc, PORT)):
            c.add_node(mknode(pkg, "node-00"))  # update
            c.remove_node("node-01")
            c.remove_node("gone")
            c.mark_terminating("team-a/bound-00", 5)
            c.reserve("team-b/bound-01", "node-02")
            c.bind("team-b/bound-01", "node-02", 9)
            c.add_pod_group(pkg.o.PodGroup(name="g", min_member=2))
            c.add_pod_group(pkg.o.PodGroup(name="g", min_member=3))
            c.add_quota(quota(pkg, "team-a", 1, 2))
            c.remove_pod("team-c/bound-02")
            c.remove_pod("nobody")
        assert store_diff(jc, pc) == []
        assert list(jc.nodes) == list(pc.nodes)


# --- modules ----------------------------------------------------------------

def test_cycle_quality_np_matches(jax_package):
    rng = np.random.default_rng(5)
    N, P, R = 24, 40, 4
    alloc = rng.integers(0, 1 << 36, (N, R))
    view = SimpleNamespace(
        nodes=SimpleNamespace(alloc=alloc,
                              requested=alloc // rng.integers(1, 9, (N, R)),
                              mask=rng.random(N) < 0.8),
        pods=SimpleNamespace(req=rng.integers(0, 1 << 30, (P, R)),
                             mask=np.arange(P) < 33),
    )
    for k in range(4):
        assignment = rng.integers(-1, N, P).astype(np.int32)
        wait = rng.random(P) < 0.3 * k
        got = port_quality.cycle_quality_np(view, assignment, None, wait)
        want = jax_quality.cycle_quality_np(view, assignment, None, wait)
        assert ordered(got) == ordered(want)  # tolerance 0


class TestPreemptionEngine:
    def test_sampling_matches(self, jax_package):
        for pct, absolute in ((10, 100), (50, 0), (0, 3), (100, 1)):
            engines = [pkg.pre.PreemptionEngine(
                pkg.pre.PreemptionMode.CAPACITY,
                min_candidate_nodes_percentage=pct,
                min_candidate_nodes_absolute=absolute) for pkg in (JAX, PORT)]
            rng = np.random.default_rng(pct + absolute)
            for n in (1, 7, 40, 1000):
                assert (engines[0].calculate_num_candidates(n)
                        == engines[1].calculate_num_candidates(n))
                fits = rng.random(n) < 0.5
                (jr, jw), (pr, pw) = (e.sample_candidates(fits)
                                      for e in engines)
                assert jw == pw and np.array_equal(jr, pr)

    def test_validation_and_unported_modes(self, jax_package):
        """The sampling arguments validate alike, and the CROSS_NODE and
        toleration engines build with JAX's attributes."""
        for args in ((-1, None), (101, None), (None, -1), (0, 0)):
            with pytest.raises(ValueError):
                PORT.pre.PreemptionEngine.validate_sampling_args(*args)
            with pytest.raises(ValueError):
                JAX.pre.PreemptionEngine.validate_sampling_args(*args)

        def attrs(engine):
            return (engine.mode.value, engine.toleration,
                    engine.CROSS_NODE_MAX_POOL,
                    engine.min_candidate_nodes_percentage,
                    engine.min_candidate_nodes_absolute)

        for kw in ({"mode": "CROSS_NODE"},
                   {"mode": "CROSS_NODE", "cross_node_max_pool": 4},
                   {"toleration": True},
                   {"toleration": True, "min_candidate_nodes_absolute": 9}):
            built = []
            for pkg in (JAX, PORT):
                args = dict(kw)
                if "mode" in args:
                    args["mode"] = getattr(pkg.pre.PreemptionMode,
                                           args["mode"])
                built.append(attrs(pkg.pre.PreemptionEngine(**args)))
            assert built[0] == built[1], kw
        assert PORT.pre.PreemptionEngine.CROSS_NODE_MAX_POOL == \
            JAX.pre.PreemptionEngine.CROSS_NODE_MAX_POOL == 12

    @pytest.mark.parametrize("case", range(8))
    def test_pod_eligible_gate(self, jax_package, case):
        """test_preemption.py TestPodEligibleToPreemptOthers, each case
        evaluated by both engines on the same cluster."""
        def build(pkg):
            c = pkg.Cluster()
            c.add_node(pre_node(pkg, "n0", cpu=8000))
            c.add_node(pre_node(pkg, "n1", cpu=8000))
            over = case in (1, 2, 4)
            c.add_quota(pkg.o.ElasticQuota(
                name="a", namespace="a",
                min={"cpu": 2000 if over else 50_000, "memory": 1 << 42},
                max={"cpu": 90_000, "memory": 1 << 44}))
            c.add_quota(pkg.o.ElasticQuota(name="b", namespace="b",
                                           min={"cpu": 100},
                                           max={"cpu": 90_000}))
            spec = {
                0: (None, "a", 1000, 10),
                1: (("v", "a", 3000, 1), "a", 4000, 10),
                2: (("v", "a", 3000, 20), "a", 4000, 10),
                3: (("v", "b", 3000, 50), "a", 1000, 10),
                4: (("v", "b", 3000, 1), "a", 4000, 10),
                5: (("vq", "a", 2000, 1), "noq", 1000, 10),
                6: (("vf", "noq2", 2000, 1), "noq", 1000, 10),
                7: (("v", "default", 2000, 1), "default", 1000, 10),
            }[case]
            victim, p_ns, p_cpu, p_pri = spec
            if victim is not None:
                name, ns, cpu, pri = victim
                v = prepod(pkg, name, cpu, ns=ns, priority=pri, node="n0")
                v.deletion_ms = 500
                c.add_pod(v)
            p = prepod(pkg, "p", p_cpu, ns=p_ns, priority=p_pri)
            if case:
                p.nominated_node_name = "n0"
            c.add_pod(p)
            if case == 0:
                p.preemption_policy = "Never"
            mode = (pkg.pre.PreemptionMode.DEFAULT if case == 7
                    else pkg.pre.PreemptionMode.CAPACITY)
            pending = [q for q in c.pods.values()
                       if q.node_name is None and not q.terminating]
            kw = {"device": CPU} if pkg is PORT else {}
            snap, meta = c.snapshot(pending, now_ms=0, **kw)
            return pkg.pre.PreemptionEngine(mode).pod_eligible(c, p, snap,
                                                               meta)

        assert build(PORT) == build(JAX)

    def test_hold_order_independence(self, jax_package):
        """test_preemption.py TestHoldOrderIndependence: `_run_preemption`
        on a queue that is not priority-descending."""
        out = []
        for pkg in (JAX, PORT):
            c = pkg.Cluster()
            c.add_node(pre_node(pkg, "n0"))
            c.add_pod(prepod(pkg, "low", 3000, priority=1, node="n0"))
            nom = prepod(pkg, "nom", 3000, priority=10)
            nom.nominated_node_name = "n0"
            c.add_pod(nom)
            w0 = prepod(pkg, "w0", 3000, priority=0, created=1)
            w1 = prepod(pkg, "w1", 3000, priority=100, created=2)
            c.add_pod(w0)
            c.add_pod(w1)
            report = pkg.cycle.CycleReport()
            report.failed = [w0.uid, w1.uid]
            kw = {"device": CPU} if pkg is PORT else {}
            pkg.cycle._run_preemption(default_pre(pkg), c, [w0, w1], report,
                                      now=1000, **kw)
            out.append((c, report))
        (jc, jr), (pc, pr) = out
        assert ordered(pr.preempted) == ordered(jr.preempted)
        assert pr.preempted == {"default/w1": ("n0", ["default/low"])}
        assert store_diff(jc, pc) == []


def test_filter_verdicts_matches(jax_package):
    cluster_args = churn_script(4)
    jc, js, _ = cluster_args(JAX)
    pc, ps, _ = cluster_args(PORT)
    jsnap, jmeta = jc.snapshot(jc.pending_pods(), now_ms=0)
    psnap, pmeta = pc.snapshot(pc.pending_pods(), now_ms=0, device=CPU)
    js.prepare(jmeta, jc)
    ps.prepare(pmeta, pc)
    for p in range(3):
        assert np.array_equal(ps.filter_verdicts(psnap, p).numpy(),
                              np.asarray(js.filter_verdicts(jsnap, p)))


class TestUnportedOptions:
    @pytest.mark.parametrize("option", ["resilience", "gangs", "tuner"])
    def test_option_raises(self, option):
        """The `resilience`, `gangs` and `tuner` options raise on a value
        that is not a `Resilience` / `GangPhase` / `ShadowTuner` before
        any bind (the tuner at `begin_cycle`), so the store is
        untouched."""
        c, s, _ = basic_binds_pending(PORT)
        with pytest.raises(AttributeError, match="object has no attribute"):
            port_cycle.run_cycle(s, c, now=0, device=CPU, **{option: 4})
        assert all(p.node_name is None for p in c.pending_pods())

    def test_observe_only_tuner_keeps_placements(self):
        """An observe-only `ShadowTuner` through `run_cycle(tuner=)` with
        the recorder on (it sweeps every cycle once the ring holds its
        corpus) leaves every cycle's placements equal to a run with no
        tuner."""
        from scheduler_plugins_tpu_torch.tuning.shadow import ShadowTuner
        from scheduler_plugins_tpu_torch.utils import flightrec

        runs = []
        for tuned in (False, True):
            cluster, sched, steps = churn_script(5)(PORT)
            tuner = None
            if tuned:
                flightrec.recorder.start(capacity=4)
                tuner = ShadowTuner(sched, candidates=4, corpus_cycles=1,
                                    sweep_every=1, observe_only=True,
                                    sync=True, device=CPU)
            bound = []
            try:
                for now, mutate in steps:
                    mutate(PORT, cluster)
                    report = port_cycle.run_cycle(
                        sched, cluster, now=now, device=CPU, tuner=tuner)
                    bound.append(dict(report.bound))
            finally:
                flightrec.recorder.stop()
            runs.append((bound, tuner))
        (plain, _), (observed, tuner) = runs
        assert observed == plain and any(plain)
        assert tuner.sweeps >= 1 and tuner.promotions == 0
        assert tuner.sweep_failures == 0

    def test_serve_option_runs(self):
        """An attached engine serves the cycle; its first refresh builds
        the resident base."""
        from scheduler_plugins_tpu_torch.serving import ServeEngine

        c, s, _ = basic_binds_pending(PORT)
        engine = ServeEngine().attach(c)
        report = port_cycle.run_cycle(s, c, now=0, device=CPU, serve=engine)
        assert report.bound and engine.rebases == 1
        assert all(p.node_name is not None for p in c.pods.values())

    def test_explain_raises(self):
        """Explain raises KeyError for a pod outside the cycle's batch and
        RuntimeError for a cycle that ran no solve."""
        c, s, _ = basic_binds_pending(PORT)
        report = PORT.run(s, c, 0)
        with pytest.raises(KeyError, match="not/a-pod"):
            report.explain("not/a-pod")
        assert report.explain("default/p0")["placed"] is True
        empty = PORT.run(s, PORT.Cluster(), 0)
        with pytest.raises(RuntimeError, match="no solve"):
            empty.explain("default/p0")

    def test_timings_and_device_default(self, monkeypatch):
        c, s, _ = basic_binds_pending(PORT)
        timings = {}
        port_cycle.run_cycle(s, c, now=0, device=CPU, timings=timings)
        assert list(timings) == ["open", "pending", "snapshot",
                                 "scheduling_tables", "solve", "fence",
                                 "bind", "postbind", "finalize"]
        # the scheduling tables' host time is part of the snapshot stage
        assert 0 <= timings["scheduling_tables"] <= timings["snapshot"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        c, s, _ = basic_binds_pending(PORT)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            port_cycle.run_cycle(s, c, now=0)


def explain_tables(report, top_k=3):
    """Every pod of `report`'s batch -> its explain table, in queue order
    (the batch read from the report's explain context)."""
    meta = report._explain_ctx[2]
    return [(uid, report.explain(uid, top_k=top_k))
            for uid in meta.pod_names]


def test_explain_round_trips_through_cycle_script(jax_package):
    """`CycleReport.explain` of every pod of every cycle of `pdb_script`
    (16 nodes) equals JAX's table, and names the plugin the cycle's
    attribution recorded for each failed pod."""
    jc, js, jsteps = pdb_smoke_script(JAX)
    pc, ps, psteps = pdb_smoke_script(PORT)
    for (now, jmut), (_, pmut) in zip(jsteps, psteps):
        if jmut is not None:
            jmut(JAX, jc)
            pmut(PORT, pc)
        jr, pr = JAX.run(js, jc, now), PORT.run(ps, pc, now)
        assert report_diff(jr, pr) == [], now
        if getattr(pr, "_explain_ctx", None) is None:
            with pytest.raises(RuntimeError, match="no solve"):
                pr.explain("default/urgent")
            continue
        tables = explain_tables(pr)
        assert tables == explain_tables(jr), now
        for uid, table in tables:
            if uid in pr.failed_by:
                assert table["placed"] is False
                assert table["failed_plugin"] == pr.failed_by[uid], uid
            elif uid in pr.bound:
                assert table["assigned"] == pr.bound[uid], uid


@pytest.mark.cuda
def test_run_cycle_card_matches_cpu():
    """A churn script and `cycle_script` through `run_cycle` on the card
    and on the CPU: every report and the store identical after every
    cycle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    card = SimpleNamespace(**{**vars(PORT), "run": lambda s, c, now:
                              port_cycle.run_cycle(s, c, now=now,
                                                   device="cuda")})
    for script in (churn_script(0), pdb_smoke_script):
        cc, cs, csteps = script(card)
        hc, hs, hsteps = script(PORT)
        for (now, cmut), (_, hmut) in zip(csteps, hsteps):
            if cmut is not None:
                cmut(card, cc)
                hmut(PORT, hc)
            cr, hr = card.run(cs, cc, now), PORT.run(hs, hc, now)
            assert report_diff(hr, cr) == [], (now, hr, cr)
            assert store_diff(hc, cc) == [], now
