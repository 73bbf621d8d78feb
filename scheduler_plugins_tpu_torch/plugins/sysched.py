"""SySched (port of `scheduler_plugins_tpu.plugins.sysched`).

Syscall-aware pod spreading, Score + Normalize (upstream
pkg/sysched/sysched.go:215-296). A pod's syscall set comes from the
SeccompProfile CRs it references (`state.snapshot._syscall_state`); the
score is the "extraneous syscall difference"

    |host - pod| + sum over the node's existing pods p of |(host ∪ pod) - p|

lower being better (DefaultNormalizeScore reversed). An empty node
scores 0 (sysched.go:255-259). A pod that resolves no profile, and has no
default all-syscalls CR to fall back to, scores NO_PROFILE_SCORE on every
node: the reference returns math.MaxInt64, clamped here to 2^53 so the
normalize multiply by 100 stays inside int64 (Go's silently wraps); the
reversed normalize then rates every node alike.

`score` is the JAX plugin's per-pod form over (N, S) bool sets, the sum
over existing pods decomposed per syscall as
pod_count * |newHost| - sum_s newHost[s] * counts[n, s]. `score_batch`
computes every row at once from one (P, S) x (S, N) product, host·pod:
|host - pod| = |host| - host·pod and |newHost| = |host| + |pod| -
host·pod, and since counts[n, s] is nonzero only inside the host's set
(the union of the very sets it counts), sum_s newHost[s] * counts[n, s]
is sum_s counts[n, s] for every pod. The product runs in float64 over
0/1 entries, so every partial sum is an integer below the syscall count,
exact in any order, and the cast back to int64 equals the per-pod score.
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops.normalize import default_normalize

NO_PROFILE_SCORE = 2**53


class SySched(Plugin):
    name = "SySched"

    def __init__(self, default_profile_namespace: str = "default",
                 default_profile_name: str = "all-syscalls"):
        # defaults.go:246-256
        self.default_profile_namespace = default_profile_namespace
        self.default_profile_name = default_profile_name

    def configure_cluster(self, cluster):
        """Install the default-profile fallback the snapshot lowers: a pod
        resolving no profile takes the configured all-syscalls CR's set
        (sysched.go:198-208)."""
        if cluster is not None:
            cluster.sysched_default_profile = (
                f"{self.default_profile_namespace}/{self.default_profile_name}"
            )

    def score(self, state, snap, p):
        sys = snap.syscalls
        if sys is None:
            return None
        pod = sys.pod_sets[p]  # (S,)
        host = sys.host_sets  # (N, S)
        new_host = host | pod[None, :]
        own_diff = (host & ~pod[None, :]).sum(dim=1)  # |host - pod|
        new_size = new_host.sum(dim=1)
        overlap = torch.where(new_host, sys.counts, 0).sum(dim=1)
        others = sys.host_pod_count.to(torch.int64) * new_size - overlap
        total = torch.where(sys.host_pod_count == 0, 0, own_diff + others)
        return torch.where(sys.has_profile[p], total, NO_PROFILE_SCORE)

    def score_batch(self, state, snap):
        sys = snap.syscalls
        if sys is None:
            return None
        # (P, N) |host ∩ pod|
        host_pod = (sys.pod_sets.to(torch.float64)
                    @ sys.host_sets.to(torch.float64).T).to(torch.int64)
        host_size = sys.host_sets.sum(dim=1)[None, :]
        pod_size = sys.pod_sets.sum(dim=1)[:, None]
        own_diff = host_size - host_pod
        new_size = host_size + pod_size - host_pod
        others = (sys.host_pod_count.to(torch.int64)[None, :] * new_size
                  - sys.counts.sum(dim=1)[None, :])
        total = torch.where(sys.host_pod_count[None, :] == 0, 0,
                            own_diff + others)
        return torch.where(sys.has_profile[:, None], total, NO_PROFILE_SCORE)

    def normalize(self, scores, feasible):
        return default_normalize(scores, feasible, reverse=True)
