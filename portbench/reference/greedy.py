"""The plain reference scheduler: NumPy, one pod at a time, written from
the semantics the configurations state and from nothing of the program.

It holds a model of the cluster (each node's allocatable and usage, each
pod's node) built from the nodes at set-up, the generator's pod records
and the removals the run applied, and schedules a cycle as
kube-scheduler's framework does, pod by pod in queue order:

- PreFilter: Coscheduling and CapacityScheduling admit every pod (the
  configurations hold no PodGroup and no ElasticQuota; `Reference.add`
  refuses a pod that names a pod group, and every record that is not a
  pod: PodGroups, ElasticQuotas, node adds and deletes);
- Filter: resource fit (cpu, memory and one pod slot against the node's
  allocatable less its usage), then PodTopologySpread's DoNotSchedule
  constraints: the node carries the constraint's key, and the matching
  pods in its domain, plus one when the pod matches its own selector, less
  the least count over the domains, are at most maxSkew;
- Score: NodeResourcesAllocatable (Least mode, weights cpu 2^20 and
  memory 1, truncated to an integer), min-max normalized to 0..100 over
  the feasible nodes; the spread constraints here are all DoNotSchedule,
  so PodTopologySpread adds the same score to every node;
- Select: the highest score, the lowest node index on a tie;
- Reserve: the node's usage grows by the pod's requests.

It never waits in Permit and never preempts: its cycles reserve nothing
and make no victims, so a program's reservation or preemption in its
cells shows as a mismatch.
"""

from __future__ import annotations

import numpy as np

#: the label naming a pod's PodGroup (Coscheduling)
POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"
#: NodeResourcesAllocatable's default resource weights (cpu, memory)
ALLOCATABLE_WEIGHTS = np.array([1 << 20, 1, 0], dtype=np.int64)
MAX_NODE_SCORE = 100
SUPPORTED_PLUGINS = {"NodeResourcesAllocatable", "Coscheduling",
                     "CapacityScheduling", "PodTopologySpread"}


def _go_div(a: np.ndarray, b: int) -> np.ndarray:
    """Integer division truncating toward zero (Go's), b > 0."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


class Reference:
    """The cluster model and the reference cycle over it."""

    def __init__(self, nodes, plugins, broken: str | None = None):
        unknown = set(plugins) - SUPPORTED_PLUGINS
        if unknown:
            raise NotImplementedError(f"no reference for {sorted(unknown)}")
        self.plugins = tuple(plugins)
        self.spread_on = "PodTopologySpread" in self.plugins
        #: a guarantee to break (the control): "cpu_fit" ignores the cpu
        #: column in the fit, "spread" ignores the spread constraints
        self.broken = broken
        self.names = [n.name for n in nodes]
        self.index = {n.name: i for i, n in enumerate(nodes)}
        self.labels = [n.labels for n in nodes]
        self.alloc = np.array(
            [[n.cpu_millis, n.memory_bytes, n.pods] for n in nodes],
            dtype=np.int64)
        self.used = np.zeros_like(self.alloc)
        raw = _go_div(-(self.alloc * ALLOCATABLE_WEIGHTS).sum(axis=1),
                      int(ALLOCATABLE_WEIGHTS.sum()))
        self.alloc_raw = raw
        self.pods = {}  # uid -> PodSpec
        self.where = {}  # uid -> node index (bound pods only)
        #: (selector, namespace) -> (N,) count of bound matching pods
        self._match = {}
        #: topology key -> ((N,) domain code, -1 = key missing; D)
        self._domains = {}

    # -- the model ---------------------------------------------------------
    @staticmethod
    def _demand(pod) -> np.ndarray:
        return np.array([pod.cpu_millis, pod.memory_bytes, 1],
                        dtype=np.int64)

    def _match_counts(self, selector, namespace) -> np.ndarray:
        key = (selector, namespace)
        counts = self._match.get(key)
        if counts is None:
            counts = np.zeros(len(self.names), dtype=np.int64)
            sel = dict(selector)
            for uid, i in self.where.items():
                pod = self.pods[uid]
                if pod.namespace == namespace and all(
                        pod.labels.get(k) == v for k, v in sel.items()):
                    counts[i] += 1
            self._match[key] = counts
        return counts

    def _domain_codes(self, key: str):
        dom = self._domains.get(key)
        if dom is None:
            values = {}
            codes = np.full(len(self.names), -1, dtype=np.int64)
            for i, labels in enumerate(self.labels):
                if key in labels:
                    codes[i] = values.setdefault(labels[key], len(values))
            dom = (codes, len(values))
            self._domains[key] = dom
        return dom

    def _count_pod(self, pod, i: int, sign: int) -> None:
        for (selector, namespace), counts in self._match.items():
            if pod.namespace == namespace and all(
                    pod.labels.get(k) == v for k, v in selector):
                counts[i] += sign

    def add(self, record) -> None:
        """A record of the generator, in the order the program got it."""
        if record.kind != "pod":
            raise NotImplementedError(
                f"the reference does not model {record.kind} records")
        pod = record
        if pod.group is not None or POD_GROUP_LABEL in pod.labels:
            raise NotImplementedError("the reference holds no pod groups")
        self.pods[pod.uid] = pod
        if pod.node is not None:
            self.bind(pod.uid, self.index[pod.node])

    def bind(self, uid: str, i: int) -> None:
        pod = self.pods[uid]
        self.where[uid] = i
        self.used[i] += self._demand(pod)
        self._count_pod(pod, i, +1)

    def remove(self, uid: str) -> None:
        pod = self.pods.pop(uid)
        i = self.where.pop(uid, None)
        if i is not None:
            self.used[i] -= self._demand(pod)
            self._count_pod(pod, i, -1)

    def pending(self) -> list:
        return sorted((p for uid, p in self.pods.items()
                       if uid not in self.where),
                      key=lambda p: p.queue_key())

    # -- the cycle ---------------------------------------------------------
    def feasible(self, pod) -> np.ndarray:
        """(N,) bool: the Filter verdicts of `pod` on the current model."""
        free = self.alloc - self.used
        need = self._demand(pod)
        ok = free >= need
        if self.broken == "cpu_fit":
            ok[:, 0] = True
        ok = ok.all(axis=1)
        if self.spread_on and self.broken != "spread":
            for c in pod.spread:
                if c.when_unsatisfiable != "DoNotSchedule":
                    raise NotImplementedError("ScheduleAnyway scoring")
                codes, n_dom = self._domain_codes(c.topology_key)
                has = codes >= 0
                counts = self._match_counts(c.match_labels, pod.namespace)
                per_dom = np.bincount(codes[has], weights=counts[has],
                                      minlength=n_dom).astype(np.int64)
                least = per_dom.min() if n_dom else 0
                self_match = int(all(pod.labels.get(k) == v
                                     for k, v in c.match_labels))
                at = np.where(has, per_dom[np.maximum(codes, 0)], 0)
                ok &= has & (at + self_match - least <= c.max_skew)
        return ok

    def score(self, feasible: np.ndarray) -> np.ndarray:
        """(N,) int64: the weighted sum of the normalized plugin scores."""
        raw = self.alloc_raw
        lo, hi = raw[feasible].min(), raw[feasible].max()
        if hi == lo:
            return np.zeros_like(raw)
        return (raw - lo) * MAX_NODE_SCORE // (hi - lo)

    def choose(self, pod) -> int:
        ok = self.feasible(pod)
        if not ok.any():
            return -1
        total = np.where(ok, self.score(ok), np.iinfo(np.int64).min)
        return int(np.argmax(total))  # the first of the highest

    def cycle(self) -> tuple:
        """Schedule every pending pod in queue order, committing each
        placement before the next pod: the outcome ({uid: node name} of
        the pods bound, {} reserved, {} preempted); a pod that fits
        nowhere stays pending."""
        bound = {}
        for pod in self.pending():
            i = self.choose(pod)
            if i >= 0:
                self.bind(pod.uid, i)
                bound[pod.uid] = self.names[i]
        return bound, {}, {}

    # -- checks of a placement made elsewhere --------------------------------
    def judge(self, bound: dict, reserved: dict, preempted: dict,
              pending) -> tuple:
        """Another scheduler's cycle outcome ({uid: node name} of the pods
        it bound out of `pending`, the uids pending before it; its
        standing reservations, which hold capacity as binds do; its
        preemptions, whose victims the next iteration's removals delete),
        judged on the model without committing it: (pods bound or
        reserved to an unknown node or to a node whose usage then exceeds
        its allocatable, pods left pending that some node still fits by
        resources). The second is None under spread constraints: a pod
        that failed at its turn may fit once the cycle's later pods are
        placed, so a fit by resources says nothing."""
        binds = {**reserved, **bound}
        used = self.used.copy()
        bad, rows = set(), []
        for uid, name in binds.items():
            i = self.index.get(name)
            pod = self.pods.get(uid)
            if i is None or pod is None or uid in self.where:
                bad.add(uid)
                continue
            used[i] += self._demand(pod)
            rows.append((uid, i))
        over = (used > self.alloc).any(axis=1)
        bad.update(uid for uid, i in rows if over[i])
        if self.spread_on:
            return len(bad), None
        free = self.alloc - used
        stranded = sum(
            int((free >= self._demand(self.pods[u])).all(axis=1).any())
            for u in pending if u not in binds)
        return len(bad), stranded

    def apply(self, bound: dict, reserved: dict, preempted: dict) -> None:
        """Commit another scheduler's binds to the model (it holds no
        reservations and no nominations)."""
        for uid, name in bound.items():
            i = self.index.get(name)
            if i is not None and uid in self.pods and uid not in self.where:
                self.bind(uid, i)

    def usage(self) -> np.ndarray:
        return self.used.copy()
