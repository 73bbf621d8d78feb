"""The "why this node" table and the content digests (port of
`explain_solver`, `array_digest` and `_pack_digest` from
`scheduler_plugins_tpu.utils.flightrec`).

`explain_solver` turns the explain rows of one pod (`Scheduler.explain_rows`,
or `parallel.solver.batch_explain_rows`) into the upstream `--v=10`
per-plugin score dump as a JSON-able dict. `pack_digest` is the content
address of a tree of arrays (blake2b over canonical bytes) that the
serving engine's anti-entropy check compares; it equals the JAX
package's digest of the same arrays. The JAX module's flight recorder,
its bundles and their replay come with their own slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

#: the fit-margin sentinel of masked nodes (`Scheduler.explain_rows`); also
#: the shift that ranks infeasible nodes after every feasible one
MARGIN_MASKED = -(2 ** 62)


def explain_solver(scheduler, snap, meta, uid: str, top_k: int = 5,
                   assignment=None, auxes=None, batched: bool = False, *,
                   device=None) -> dict:
    """The table for pod `uid` of one solved batch: the top-k candidate
    nodes with per-plugin weighted normalized score columns, the built-in
    fit margin (min over resources of free - demand; most negative
    binding) and each candidate's gap to the winner, all against the
    CYCLE-INITIAL state. `assignment` (the solve's, host numpy) fills in
    where the pod went; `auxes` binds a recorded cycle's `aux()` tensors;
    `batched=True` takes the rows through `batch_explain_rows`. The rows
    are computed on `device` (None = the CUDA card). Raises KeyError for a
    uid outside the batch."""
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
        # the flight recorder's cycle number; set by the recorder, which
        # comes with its own slice
        "cycle": None,
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


def pack_tree(value) -> object:
    """A JSON-able spec of a tree of dataclasses, containers, scalars and
    arrays (numpy or tensors, read to the host), each array by its
    `array_digest`: the JAX `pack_pytree`'s spec without the blobs."""
    if value is None:
        return None
    if isinstance(value, (bool, int, float, str)):
        return {"v": value}
    if isinstance(value, np.generic):
        return {"v": value.item()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {"s": type(value).__name__,
                "f": {f.name: pack_tree(getattr(value, f.name))
                      for f in dataclasses.fields(value)}}
    if isinstance(value, (tuple, list)):
        return {"t": [pack_tree(v) for v in value],
                "k": "tuple" if isinstance(value, tuple) else "list"}
    if isinstance(value, dict):
        return {"d": {str(k): pack_tree(v) for k, v in value.items()}}
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype == object:
        raise TypeError(f"undigestable value of type {type(value).__name__}")
    return {"a": array_digest(arr), "dtype": str(arr.dtype),
            "shape": list(arr.shape)}


def pack_digest(tree) -> str:
    """blake2b-128 of `tree`'s canonical spec (`pack_tree`)."""
    spec = json.dumps(pack_tree(tree), sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(spec.encode(), digest_size=16).hexdigest()
