"""Framework-maintained selector and topology-domain carries (port of
`scheduler_plugins_tpu.ops.selectors`).

Four live carries, kept in lockstep by ONE built-in commit of the solve
(like the built-in capacity Reserve: never per plugin, which would apply
twice when both consumers are enabled):

- `SolverState.sel_counts` (TR, N): node-level matching-pod counts, read
  by PodTopologySpread when a node-inclusion policy excludes some keyed
  node (`spread_needs_node_counts`); otherwise not materialized.
- `SolverState.sel_dom_counts` (TR, D): the same counts per topology
  domain, read by InterPodAffinity always and by PodTopologySpread on its
  fast path.
- `SolverState.anti_domains` (E, D): anti-affinity domain presence bits.
- `SolverState.sym_counts` (E2, D): symmetric-score carrier counts.

Tables come from `state.scheduling.SchedulingState`:
    pend_match (S, P)  pod q matches selector group s
    track_sel / track_topo (TR,)  track -> (selector group, topology key)
    topo_code (K, N)  node -> domain code under key k (-1 = key absent)
    exist_anti_{sel,topo} (E,), exist_anti_carrier (E, P)

The JAX `.at[].add` scatters become `index_add` (one node column of
every track) and `scatter_add` (one domain a row); the boolean `.at[].max`
becomes `scatter_reduce("amax")` on a uint8 view of the bits. Each writes
a new tensor: the carries start as the snapshot's tables, which no commit
may write. No host read.
"""

from __future__ import annotations

import torch


def pod_column(table: torch.Tensor, p) -> torch.Tensor:
    """The pod columns `p` of an (X, P) table, (X, S): `p` a host int
    (the sequential solve; S = 1), a slice of pod rows, or an (S,) int64
    tensor (the batched solve's rows; its validator's pod index stays on
    the device)."""
    if isinstance(p, int):
        return table[:, p:p + 1]
    if isinstance(p, slice):
        return table[:, p]
    return table.index_select(1, p)


def node_column(table: torch.Tensor, node) -> torch.Tensor:
    """(rows, 1) column `node` ((1,) tensor, -1 reads column 0) of a
    (rows, N) table."""
    return table.index_select(1, torch.clamp(node, min=0).long())


def _scatter_add_rows(carry, dom, add):
    """carry[r, dom[r]] += add[r] for every row r, as a new tensor; a row
    whose `dom` is -1 adds nothing (its `add` is 0 there)."""
    return carry.scatter_add(1, torch.clamp(dom, min=0), add.to(carry.dtype))


def commit_tracks(state, sched, p, choice):
    """Fold pod `p`'s placement on `choice` ((1,) node index, -1 = none)
    into the carries."""
    if sched.topo_code is None:
        return state  # no selector tables: no carry
    placed = choice >= 0
    # (K, 1): the chosen node's domain under every key
    code_at = node_column(sched.topo_code, choice)
    if sched.track_base is not None and (
        state.sel_counts is not None or state.sel_dom_counts is not None
    ):
        # (TR, 1): the pod matches the track's selector group
        inc = pod_column(sched.pend_match, p)[sched.track_sel] & placed
        if state.sel_counts is not None:
            state = state.replace(sel_counts=torch.index_add(
                state.sel_counts, 1, torch.clamp(choice, min=0).long(),
                inc.to(state.sel_counts.dtype),
            ))
        if state.sel_dom_counts is not None:
            # the domain-level mirror (a key-less node has no domain: -1
            # contributes nothing)
            dom = code_at[sched.track_topo]
            state = state.replace(sel_dom_counts=_scatter_add_rows(
                state.sel_dom_counts, dom, inc & (dom >= 0)))
    if state.sym_counts is not None and sched.sym_sel is not None:
        dom = code_at[sched.sym_topo]  # (E2, 1)
        add = torch.where(placed & (dom >= 0),
                          pod_column(sched.sym_carrier, p), 0)
        state = state.replace(sym_counts=_scatter_add_rows(
            state.sym_counts, dom, add))
    if state.anti_domains is not None and sched.exist_anti_sel is not None:
        dom = code_at[sched.exist_anti_topo]
        mark = pod_column(sched.exist_anti_carrier, p) & placed & (dom >= 0)
        bits = state.anti_domains.view(torch.uint8).scatter_reduce(
            1, torch.clamp(dom, min=0), mark.view(torch.uint8), "amax")
        state = state.replace(anti_domains=bits.view(torch.bool))
    return state
