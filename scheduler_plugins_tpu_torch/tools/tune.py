"""Counterfactual weight tuner over flight-recorder bundles, and its smoke
gate (port of the JAX package's `tools/tune.py`).

    python -m scheduler_plugins_tpu_torch.tools.tune tune BUNDLE \
        [--candidates K] [--seed S] [--tolerance T] [--out PROFILE.json] \
        [--explain UID] [--top N] [--device cpu]
    python -m scheduler_plugins_tpu_torch.tools.tune smoke [--out DIR] \
        [--device cpu]

`tune BUNDLE` replays every recorded cycle of a bundle under K candidate
plugin-weight vectors in ONE vmapped solve per cycle (`tuning.sweep`),
scores each candidate on the placement-quality objectives
(`tuning.quality`, plus score drift against the recorded sequential
anchor on the baseline profile's cycle-initial objective), replays every
candidate's placements through the numpy hard-constraint oracles
(`tuning.gates`), and emits a tuned profile JSON through the
`api.config.profile_spec` inverse ONLY when the shared gate body
(`tuning.promotion.evaluate_candidates`, the shadow lane's own) accepts
the winner. `--explain UID` renders the before / after per-plugin score
table (`flightrec.explain_solver`) of one recorded pod.

`smoke` records a reduced trimaran corpus (`SMOKE_SHAPE`) through the real
`run_cycle` hooks, sweeps `SMOKE_CANDIDATES` candidates, and requires an
emitted profile that re-solves every recorded cycle with zero violations,
and a sweep step that issues the same ATen ops at K = 1 and K =
`SMOKE_CANDIDATES` (the JAX gate's "one compile": the port compiles no
program, and a sweep that looped over its lanes would issue K times the
ops).

`--device` is where the sweeps run: the CUDA card by default, "cpu" when
asked for. One JSON line per action on stdout; rc 1 on any failure.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np

#: the reduced trimaran corpus of the smoke gate: two scoring plugins with
#: a packing-against-balance trade-off (synthetic per-node metrics), 3
#: cycles with distinct seeds
SMOKE_SHAPE = dict(n_nodes=96, n_pods=128, cycles=3)
SMOKE_CANDIDATES = 64


def _prepare_for_cycle(scheduler, lc, meta) -> None:
    """Re-prepare the shared scheduler for ONE recorded cycle and restore
    that cycle's recorded host_state; runs immediately before every solve
    or score of that cycle (cycles of one corpus can carry different
    layouts or cluster-derived specializations)."""
    scheduler.prepare(meta, None)
    for plugin, rec in zip(scheduler.profile.plugins, lc.manifest["plugins"]):
        hs = rec.get("host_state")
        if hs is not None:
            plugin.restore_host_state(lc._unpack(hs))


def _load_corpus(bundle_dir: str, device):
    """[(LoadedCycle, scheduler, snap, meta, auxes, anchor, wait, mode)]
    for every complete recorded cycle with outputs, snapshots and auxes on
    `device`, with ONE rebuilt scheduler shared across the corpus
    (callers `_prepare_for_cycle` before touching any one cycle)."""
    from scheduler_plugins_tpu_torch.utils import flightrec

    cycles = flightrec.load_bundle(bundle_dir)
    if not cycles:
        raise SystemExit(f"no cycles in bundle {bundle_dir!r}")
    scheduler = None
    corpus = []
    for lc in cycles:
        if not lc.manifest.get("complete"):
            continue
        anchor = lc.output("assignment")
        if anchor is None:
            continue
        if scheduler is None:
            scheduler, _faithful = lc.scheduler(device)
        snap = flightrec._solver_snapshot(lc.snapshot(), device)
        meta = lc.meta(device)
        auxes = flightrec._on_device(lc.auxes(), device)
        mode = (lc.manifest.get("outputs") or {}).get("mode")
        corpus.append((lc, scheduler, snap, meta, auxes, np.asarray(anchor),
                       np.asarray(lc.output("wait")), mode))
    if not corpus:
        raise SystemExit("bundle has no complete cycles with outputs")
    return corpus


def _promotion_corpus(corpus):
    """`_load_corpus` tuples as `tuning.promotion.CorpusCycle`s: the gate
    body itself lives in `tuning.promotion`, shared with the shadow
    lane."""
    from scheduler_plugins_tpu_torch.tuning.promotion import CorpusCycle

    return [
        CorpusCycle(
            scheduler=scheduler, snap=snap, meta=meta, auxes=auxes,
            anchor=anchor, wait=wait, mode=mode,
            prepare=(lambda sched, lc=lc, meta=meta:
                     _prepare_for_cycle(sched, lc, meta)),
        )
        for lc, scheduler, snap, meta, auxes, anchor, wait, mode in corpus
    ]


def _tuned_spec(corpus, W, k) -> dict:
    """The tuned profile JSON via the `profile_spec` inverse: the recorded
    profile config with candidate k's weights."""
    from scheduler_plugins_tpu_torch.api.config import (
        load_profile,
        profile_spec,
    )

    manifest = corpus[0][0].manifest
    profile = load_profile(manifest["profile_config"])
    profile.name = manifest.get("profile", profile.name)
    for plugin, w in zip(profile.plugins, W[k]):
        plugin.weight = int(w)
    return profile_spec(profile)


def _explain_pair(corpus, W, k, uid, top, device):
    """(baseline table, tuned table) of one recorded pod: the before /
    after score breakdown (`flightrec.explain_solver` on a scheduler
    rebuilt with each weight vector)."""
    from scheduler_plugins_tpu_torch.utils import flightrec

    for lc, _s, snap, meta, auxes, anchor, _w, _mode in corpus:
        if uid not in meta.pod_names:
            continue

        def table(weights, assignment):
            scheduler, _m, _f = flightrec.rebuild_scheduler(
                lc.manifest, lc._unpack, device=device)
            for plugin, w in zip(scheduler.profile.plugins, weights):
                plugin.weight = int(w)
            return flightrec.explain_solver(
                scheduler, snap, meta, uid, top_k=top,
                assignment=assignment, auxes=auxes,
                cycle=lc.manifest["cycle"], device=device,
            )

        return table(W[0], anchor), table(W[k], None)
    raise SystemExit(f"uid {uid!r} not found in any recorded cycle")


def sweep_ops(scheduler, snap, W, auxes, device) -> int:
    """The ATen ops one `sweep_cycle` of `W` issues (a dispatch mode
    counts them; on the card each is one launch, copy or fill at most):
    equal at every K when the sweep runs one program a step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from scheduler_plugins_tpu_torch.tuning import sweep

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        sweep.sweep_cycle(scheduler, snap, W, auxes=auxes, device=device)
    return count[0]


def cmd_tune(args) -> int:
    from scheduler_plugins_tpu_torch.device import resolve_device
    from scheduler_plugins_tpu_torch.tuning import promotion, sweep
    from scheduler_plugins_tpu_torch.utils import observability as obs

    device = resolve_device(args.device)
    corpus = _load_corpus(args.bundle, device)
    scheduler = corpus[0][1]
    base = [int(p.weight) for p in scheduler.profile.plugins]
    W = sweep.candidate_weights(base, args.candidates, seed=args.seed)
    verdict = promotion.evaluate_candidates(
        _promotion_corpus(corpus), W, args.tolerance, device=device
    )
    # the K-independence of a sweep step, on the first cycle: the ATen
    # ops at K = 1 against K = len(W)
    lc, _s, snap, meta, auxes = corpus[0][:5]
    _prepare_for_cycle(scheduler, lc, meta)
    ops = {"k1": sweep_ops(scheduler, snap, W[:1], auxes, device),
           f"k{len(W)}": sweep_ops(scheduler, snap, W, auxes, device)}
    best = verdict.best
    out = {
        "metric": "tune",
        "bundle": args.bundle,
        "device": str(device),
        "cycles": len(corpus),
        "candidates": int(W.shape[0]),
        "sweep_ops": ops,
        "plugins": [p.name for p in scheduler.profile.plugins],
        "baseline_weights": base,
        "baseline_objectives": {
            name: round(float(v[0]), 6)
            for name, v in verdict.objectives.items()
        },
        "tuned_weights": [int(w) for w in W[best]],
        "tuned_objectives": {
            name: round(float(v[best]), 6)
            for name, v in verdict.objectives.items()
        },
        "improvement_pct": {
            name: round(100.0 * float(imp[best]), 3)
            for name, imp in verdict.improvements.items()
        },
        "improved_objectives": verdict.improved,
        "hard_violations": int(verdict.violations[best]),
        "anchor_mismatches": int(verdict.anchor_mismatches),
        "candidates_disqualified": verdict.disqualified,
        "accepted": verdict.accepted,
    }
    if verdict.accepted and args.out:
        spec = _tuned_spec(corpus, W, best)
        obs.atomic_write(
            args.out, json.dumps(spec, indent=2, sort_keys=True) + "\n"
        )
        out["profile"] = args.out
    if args.explain:
        before, after = _explain_pair(corpus, W, best, args.explain,
                                      args.top, device)
        out["explain"] = {"uid": args.explain, "before": before,
                          "after": after}
    print(json.dumps(out))
    return 0 if verdict.accepted else 1


# ---------------------------------------------------------------------------
# quality over a bundle (shared with tools/replay.py quality)
# ---------------------------------------------------------------------------


def bundle_quality(bundle_dir: str, device=None) -> dict:
    """Per-cycle quality of a bundle's RECORDED placements (the tensor
    objectives on `device`, None = the CUDA card), against the recorded
    per-cycle stamp when one exists, and the corpus-level gang admission
    latency."""
    from scheduler_plugins_tpu_torch.device import resolve_device
    from scheduler_plugins_tpu_torch.tuning import quality
    from scheduler_plugins_tpu_torch.utils import flightrec

    device = resolve_device(device)
    rows = []
    latency_feed = []
    for lc in flightrec.load_bundle(bundle_dir):
        assignment = lc.output("assignment")
        if assignment is None:
            continue
        host = lc.snapshot()
        wait = lc.output("wait")
        wait = (np.zeros(len(np.asarray(assignment)), bool)
                if wait is None else np.asarray(wait))
        q = quality.cycle_quality(flightrec._solver_snapshot(host, device),
                                  np.asarray(assignment),
                                  lc.output("admitted"), wait)
        recorded = (lc.manifest.get("report") or {}).get("quality")
        row = {
            "cycle": lc.manifest["cycle"],
            "quality": {k: round(v, 6) for k, v in q.items()},
        }
        if recorded is not None:
            row["recorded_quality"] = recorded
            row["matches_recorded"] = all(
                abs(q[k] - recorded[k]) < 1e-9 for k in q if k in recorded
            )
        rows.append(row)
        if host.gangs is not None:
            latency_feed.append(
                (lc.manifest["meta"]["gang_names"], np.asarray(host.pods.gang),
                 np.asarray(assignment), wait)
            )
    out = {"bundle": bundle_dir, "cycles": rows}
    if latency_feed:
        lat = quality.gang_admission_latency(latency_feed)
        out["gang_latency_cycles"] = (
            round(float(np.mean(list(lat.values()))), 3) if lat else None
        )
    return out


# ---------------------------------------------------------------------------
# the smoke gate
# ---------------------------------------------------------------------------


def _record_smoke_corpus(out_dir: str, device) -> None:
    """Record the reduced trimaran corpus through the real `run_cycle`
    hooks: one shared Scheduler, a fresh seeded cluster a cycle (a cycle
    binds its pods), distinct seeds so the corpus is not one cycle three
    times."""
    from scheduler_plugins_tpu_torch import plugins as P
    from scheduler_plugins_tpu_torch.framework import (
        Profile,
        Scheduler,
        run_cycle,
    )
    from scheduler_plugins_tpu_torch.models import trimaran_scenario
    from scheduler_plugins_tpu_torch.utils import flightrec

    scheduler = Scheduler(Profile(plugins=[
        P.TargetLoadPacking(), P.LoadVariationRiskBalancing(),
    ]))

    def one_cycle(seed):
        cluster = trimaran_scenario(
            n_nodes=SMOKE_SHAPE["n_nodes"], n_pods=SMOKE_SHAPE["n_pods"],
            seed=seed,
        )
        return run_cycle(scheduler, cluster, now=1000 + seed, device=device)

    one_cycle(0)  # warm-up, recorder off
    flightrec.recorder.start(capacity=SMOKE_SHAPE["cycles"] + 1)
    try:
        for seed in range(SMOKE_SHAPE["cycles"]):
            one_cycle(seed)
        flightrec.recorder.save(out_dir)
    finally:
        flightrec.recorder.stop()


def cmd_smoke(args) -> int:
    from scheduler_plugins_tpu_torch.api.config import load_profile
    from scheduler_plugins_tpu_torch.device import resolve_device
    from scheduler_plugins_tpu_torch.framework import Scheduler
    from scheduler_plugins_tpu_torch.framework.runtime import bound_auxes
    from scheduler_plugins_tpu_torch.tuning import gates

    device = resolve_device(args.device)
    out_dir = args.out or os.path.join(
        tempfile.mkdtemp(prefix="tune_smoke_"), "bundle"
    )
    _record_smoke_corpus(out_dir, device)
    profile_path = os.path.join(out_dir, "tuned_profile.json")
    ns = argparse.Namespace(
        bundle=out_dir, candidates=SMOKE_CANDIDATES, seed=0,
        tolerance=0.05, out=profile_path, explain=None, top=5,
        device=args.device,
    )
    # capture cmd_tune's JSON line so the smoke emits ONE line
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cmd_tune(ns)
    tune = json.loads(buf.getvalue())

    # re-verify the EMITTED profile independently: load it back through
    # api.config, re-solve every recorded cycle with the tuned weights
    # through the replay path, and re-run the hard-constraint oracles
    emitted_violations = None
    if tune.get("profile"):
        with open(tune["profile"]) as f:
            tuned_sched = Scheduler(load_profile(json.load(f)))
        emitted_violations = 0
        for lc, _s, snap, meta, auxes, _a, _w, _m in _load_corpus(out_dir,
                                                                  device):
            _prepare_for_cycle(tuned_sched, lc, meta)
            with bound_auxes(tuned_sched.profile.plugins, auxes):
                result = tuned_sched.solve(snap, device=device,
                                           mode="sequential")
            emitted_violations += gates.hard_violations(
                snap.to("cpu"), result.assignment, result.wait)["total"]
    ops = list(tune.get("sweep_ops", {}).values())
    ok = (
        tune.get("accepted") is True
        and len(ops) == 2 and ops[0] == ops[1] > 0
        and tune.get("candidates", 0) >= SMOKE_CANDIDATES
        and tune.get("hard_violations", 1) == 0
        and emitted_violations == 0
    )
    print(json.dumps({
        "metric": "tune_smoke",
        "bundle": out_dir,
        "device": tune.get("device"),
        "sweep_ops": tune.get("sweep_ops"),
        "candidates": tune.get("candidates"),
        "improved_objectives": tune.get("improved_objectives"),
        "improvement_pct": tune.get("improvement_pct"),
        "tuned_weights": tune.get("tuned_weights"),
        "baseline_weights": tune.get("baseline_weights"),
        "emitted_profile": tune.get("profile"),
        "emitted_profile_violations": emitted_violations,
        "accepted": tune.get("accepted"),
        "ok": bool(ok),
    }))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m scheduler_plugins_tpu_torch.tools.tune",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_tune = sub.add_parser(
        "tune", help="sweep a bundle corpus, rank candidates, emit a gated "
        "tuned profile")
    p_tune.add_argument("bundle")
    p_tune.add_argument("--candidates", type=int, default=64)
    p_tune.add_argument("--seed", type=int, default=0)
    p_tune.add_argument("--tolerance", type=float, default=0.01,
                        help="max regression allowed on any objective "
                             "(default 0.01)")
    p_tune.add_argument("--out", default=None,
                        help="tuned profile JSON path (emitted only when "
                             "the gates accept)")
    p_tune.add_argument("--explain", default=None, metavar="UID",
                        help="render the before / after per-plugin score "
                             "table of this recorded pod")
    p_tune.add_argument("--top", type=int, default=5)
    p_smoke = sub.add_parser("smoke", help="the tuner's smoke gate")
    p_smoke.add_argument("--out", default=None,
                         help="corpus directory (default: a temp dir)")
    for p in (p_tune, p_smoke):
        p.add_argument("--device", default=None,
                       help="where the sweeps run (default: the CUDA card; "
                            "'cpu' on a machine without one)")
    args = ap.parse_args(argv)
    return {"tune": cmd_tune, "smoke": cmd_smoke}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
