"""PodState (port of `scheduler_plugins_tpu.plugins.podstate`).

Score-only: favours nodes that are freeing capacity (upstream
pkg/podstate/pod_state.go:40-90). The raw score is the node's terminating
pods minus its nominated pods, then min-max normalized as
NodeResourcesAllocatable's. The counts are snapshot columns and the score
rates the node, never the pod, so the solve computes it once
(`prepare_solve`) and every step and batch row reads that one column.
"""

from __future__ import annotations

import torch

from scheduler_plugins_tpu_torch.framework.plugin import Plugin
from scheduler_plugins_tpu_torch.ops.normalize import minmax_normalize


def node_state_scores(snap) -> torch.Tensor:
    """(N,) int64 terminating − nominated pods per node."""
    nodes = snap.nodes
    return nodes.terminating.to(torch.int64) - nodes.nominated.to(
        torch.int64)


class PodState(Plugin):
    name = "PodState"

    def prepare_solve(self, snap):
        return node_state_scores(snap)

    def score(self, state, snap, p):
        if self._presolve is None:
            return node_state_scores(snap)
        return self._presolve

    def score_batch(self, state, snap):
        col = self.score(state, snap, 0)
        return col[None, :].expand(snap.num_pods, -1)

    def normalize(self, scores, feasible):
        return minmax_normalize(scores, feasible)
