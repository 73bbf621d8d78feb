"""The one promotion-gate body: sweep a corpus, rank, disqualify, accept
(port of `scheduler_plugins_tpu.tuning.promotion`).

Both tuning drivers, the offline corpus tuner (`tools/tune.py`) and the
online shadow lane (`tuning.shadow`), decide "may this candidate weight
vector become the profile?" with exactly this code: a candidate rejected
offline is rejected online.

The contract per candidate:

- every candidate replays through the numpy hard-constraint oracles
  (`tuning.gates`: fit, mask, queue-order quota, gang quorum); ANY
  violation anywhere in the corpus disqualifies;
- ranking is the sum of sense-adjusted objective deltas against lane 0
  (the in-band incumbent), in each objective's own dimensionless units;
- a candidate regressing ANY objective beyond `tolerance` is
  disqualified: a tune must not buy one objective by selling another;
- acceptance also needs a non-incumbent winner with a strictly positive
  rank score, at least one strict improvement, zero violations and zero
  anchor mismatches (a sequential record the incumbent lane cannot
  reproduce means the rebuild is unfaithful).

Corpus entries are `CorpusCycle`s, a view over either a bundle
`LoadedCycle` (offline) or a ring `CycleRecord` (online), so the body
never knows which driver called it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from scheduler_plugins_tpu_torch.tuning import gates, quality, sweep

#: objectives the promotion gate ranks on, in report order (preemption
#: and nomination counts belong to the recorded cycle's PostFilter, which
#: the sweep does not replay, so they are never ranked)
RANKED_OBJECTIVES = (
    "fragmentation", "util_imbalance", "gang_wait_frac", "unplaced_frac",
    "drift",
)


@dataclass
class CorpusCycle:
    """One recorded cycle as the promotion gate consumes it.

    `snap` and `auxes` live on the sweep's device. `prepare(scheduler)`
    re-prepares the shared replay scheduler for THIS cycle and restores
    its recorded host_state; it runs before every solve or score of the
    cycle. `anchor` is the recorded assignment when the record's weights
    equal the sweep's lane 0 (the incumbent); None means "no comparable
    anchor" (a ring record captured under pre-promotion weights), and the
    anchor-mismatch check and the drift yardstick then use lane 0's own
    replayed placements."""

    scheduler: object
    snap: object
    meta: object
    auxes: tuple
    anchor: Optional[np.ndarray]
    wait: Optional[np.ndarray]
    mode: Optional[str]
    prepare: Callable = field(default=lambda scheduler: None)


@dataclass
class PromotionVerdict:
    """The gate's output: per-candidate aggregates and the one
    accepted / rejected decision both drivers act on."""

    objectives: dict  # name -> (K,) float64 corpus means
    violations: np.ndarray  # (K,) int64 hard-constraint counts
    anchor_mismatches: int
    order: np.ndarray  # (K,) candidate indices, best first
    score: np.ndarray  # (K,) rank scores (-inf = disqualified)
    improvements: dict  # name -> (K,) sense-adjusted deltas vs lane 0
    best: int
    improved: list  # objective names the winner strictly improves
    accepted: bool

    @property
    def disqualified(self) -> int:
        return int(np.sum(~np.isfinite(self.score)))


def sweep_corpus(corpus, W, mutate=None, *, device=None):
    """Per-candidate objective means and gate verdicts over the corpus, on
    `device` (None = the CUDA card). Returns (objectives {name: (K,)
    mean}, violations (K,) int64, anchor_mismatches: sequential records
    whose incumbent lane did not reproduce the recorded placements).
    `mutate(A, admitted, wait)` post-processes each cycle's swept outputs
    BEFORE gating: the chaos harness's `tune.sweep` garbage site
    (`tuning.shadow`); production drivers pass None."""
    from scheduler_plugins_tpu_torch.parallel.solver import (
        profile_initial_scores,
    )

    K = W.shape[0]
    sums = {name: np.zeros(K) for name in RANKED_OBJECTIVES}
    violations = np.zeros(K, np.int64)
    anchor_mismatches = 0
    for cc in corpus:
        cc.prepare(cc.scheduler)
        A, adm, wt = sweep.sweep_cycle(cc.scheduler, cc.snap, W,
                                       auxes=cc.auxes, device=device)
        if mutate is not None:
            A, adm, wt = mutate(A, adm, wt)
        if (
            cc.mode == "sequential" and cc.anchor is not None
            and not (A[0] == cc.anchor).all()
        ):
            anchor_mismatches += 1
        q = quality.batch_quality(cc.snap, A, wt)
        for name in ("fragmentation", "util_imbalance", "gang_wait_frac",
                     "unplaced_frac"):
            sums[name] += np.asarray(q[name], np.float64)
        # drift on the INCUMBENT profile's cycle-initial objective against
        # the recorded sequential anchor (or, anchorless, lane 0's own
        # placements): the fixed yardstick every candidate is measured on
        scores = profile_initial_scores(cc.scheduler, cc.snap,
                                        auxes=cc.auxes,
                                        device=device)[0].cpu().numpy()
        ref = cc.anchor if cc.anchor is not None else A[0]
        sums["drift"] += np.array([
            quality.score_drift(scores, A[k], ref) for k in range(K)
        ])
        host = cc.snap.to("cpu")
        for k in range(K):
            violations[k] += gates.hard_violations(host, A[k],
                                                   wt[k])["total"]
    n = len(corpus)
    return (
        {name: s / n for name, s in sums.items()}, violations,
        anchor_mismatches,
    )


def rank_candidates(objectives, violations, tolerance: float,
                    rank_objectives=None, tolerances=None):
    """(order, scores, improvements): candidates ranked by summed
    sense-adjusted improvement against lane 0; disqualified lanes
    (hard-constraint violations, or any objective regressing beyond its
    tolerance) score -inf. Deltas are ABSOLUTE in each objective's own
    dimensionless units (every ranked objective is a fraction or a
    relative quantity in about [0, 1]).

    `rank_objectives` (default: every objective) selects the objectives
    that enter the rank SUM; the others stay disqualification rails.
    `tolerances` overrides the regression tolerance per objective. The
    offline tuner uses the defaults; the shadow lane ranks on the
    per-cycle objectives and keeps `drift` as a rail with its own looser
    tolerance (over a drifting mix the incumbent's score surface is what
    goes stale, so a drift term in the sum would veto every
    adaptation)."""
    K = len(violations)
    imps = {}
    for name, values in objectives.items():
        # sense-adjusted: positive = candidate better than baseline
        imps[name] = quality.SENSE[name] * (values - values[0])
    ranked = set(imps if rank_objectives is None else rank_objectives)
    tolerances = tolerances or {}
    score = np.zeros(K)
    for name, imp in imps.items():
        if name in ranked:
            score += imp
    for k in range(K):
        if violations[k] > 0 or any(
            imp[k] < -tolerances.get(name, tolerance)
            for name, imp in imps.items()
        ):
            score[k] = -np.inf
    order = np.argsort(-score, kind="stable")
    return order, score, imps


def strict_improvements(imps, k, eps: float = 1e-9) -> list:
    return [name for name, imp in imps.items() if imp[k] > eps]


def evaluate_candidates(corpus, W, tolerance: float, mutate=None,
                        rank_objectives=None, tolerances=None, *,
                        device=None) -> PromotionVerdict:
    """The whole gate in one call: sweep on `device` (None = the CUDA
    card), rank, disqualify, accept. The offline tuner emits a profile
    from the verdict, the shadow lane stages a live promotion from it."""
    W = np.asarray(W, np.int64)
    objectives, violations, anchor_mismatches = sweep_corpus(
        corpus, W, mutate=mutate, device=device
    )
    order, score, imps = rank_candidates(
        objectives, violations, tolerance,
        rank_objectives=rank_objectives, tolerances=tolerances,
    )
    best = int(order[0])
    improved = strict_improvements(
        {name: imp for name, imp in imps.items()
         if rank_objectives is None or name in set(rank_objectives)},
        best,
    )
    accepted = bool(
        best != 0 and np.isfinite(score[best]) and score[best] > 0
        and improved and violations[best] == 0
        # a sequential record the incumbent lane cannot reproduce means
        # the rebuild is unfaithful: never promote a vector ranked on it
        and anchor_mismatches == 0
    )
    return PromotionVerdict(
        objectives=objectives, violations=violations,
        anchor_mismatches=anchor_mismatches, order=order, score=score,
        improvements=imps, best=best, improved=improved, accepted=accepted,
    )


def weights_digest(weights) -> str:
    """Short content digest of a weight vector: the active-weights
    identity on the tuner's status, its gauge (as an int) and its state
    file, equal to the JAX package's for the same vector."""
    arr = np.ascontiguousarray(np.asarray(weights, np.int64))
    return hashlib.blake2b(arr.tobytes(), digest_size=6).hexdigest()
