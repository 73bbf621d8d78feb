"""Flight-recorder replay and explain over bundles, and the replay smoke
gate (port of the JAX package's `tools/replay.py`).

    python -m scheduler_plugins_tpu_torch.tools.replay info BUNDLE
    python -m scheduler_plugins_tpu_torch.tools.replay replay BUNDLE \
        [--cycle K] [--device cpu]
    python -m scheduler_plugins_tpu_torch.tools.replay explain BUNDLE \
        --uid UID [--cycle K] [--top N] [--batched] [--device cpu]
    python -m scheduler_plugins_tpu_torch.tools.replay quality BUNDLE \
        [--device cpu]
    python -m scheduler_plugins_tpu_torch.tools.replay timeline BUNDLE \
        [--uid UID]
    python -m scheduler_plugins_tpu_torch.tools.replay smoke [--out DIR] \
        [--device cpu]

Bundles come from `utils.flightrec.recorder.save(dir)`, the port's or the
JAX package's (`tests/fixtures/flightrec` is JAX's committed one).

- `info`: each recorded cycle's digest (and whether it still matches),
  mode, batch size and completeness.
- `replay`: re-run recorded cycles through the bit-identical sequential
  parity solve (`Scheduler.solve`) with the RECORDED aux tensors bound,
  and diff the placements. A "sequential" record that does not replay
  bit-identically is an error (rc 1); a wave-mode record's ("streamed",
  "packing") diff is evidence of soft tie-breaking and fails nothing.
- `explain`: the per-plugin score table of one recorded pod (the
  upstream `--v=10` score dump), checked against `EXPLAIN_SCHEMA`.
- `quality`: the placement-quality objectives of every recorded cycle's
  placements (`tools/tune.py` `bundle_quality`), against the stamp
  `run_cycle` recorded; rc 1 on a mismatch.
- `timeline`: one pod's cross-cycle lifecycle from the bundle's
  pod-ledger segment (`ledger.json`); without `--uid`, the bundle's SLI
  summary and its pods.
- `smoke`: record a reduced bench config 4 cycle (`SMOKE_SHAPE`) through
  the real `run_cycle` hooks, save and load the bundle, replay it (the
  diff must be empty), check the explain table against the schema, and
  bound the recorder's overhead by interleaved off / on pairs: the median
  of the paired deltas within max(`SPT_RECORD_BOUND_PCT`, default 2 %,
  the off series' p10-p90 spread).

`--device` is where the replay runs: the CUDA card by default, "cpu" when
asked for. One JSON line per action on stdout; rc 1 on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

#: the reduced gang + quota roster of the smoke gate (bench config 4's
#: generator at 4 gangs of 8 on 64 nodes)
SMOKE_SHAPE = dict(n_gangs=4, gang_size=8, n_nodes=64)
#: interleaved off / on pairs; the statistic is the median of the PAIRED
#: deltas
SMOKE_RUNS = 17

#: field -> allowed types (None in the tuple = nullable)
EXPLAIN_SCHEMA = {
    "uid": (str,),
    "cycle": (int, None),
    "pod_index": (int,),
    "profile": (str,),
    "path": (str,),
    "admitted": (bool,),
    "placed": (bool, None),
    "assigned": (str, None),
    "failed_plugin": (str, None),
    "winner": (str, None),
    "winner_total": (int, None),
    "runner_up_gap": (int, None),
    "weights": (dict,),
    "candidates": (list,),
}

CANDIDATE_SCHEMA = {
    "node": (str,),
    "total": (int,),
    "gap_to_winner": (int, None),
    "feasible": (bool,),
    "fit_margin": (int, None),
    "scores": (dict,),
}


def _check_fields(obj: dict, schema: dict, where: str) -> list[str]:
    errors = []
    for name, types in schema.items():
        if name not in obj:
            errors.append(f"{where}: missing field {name!r}")
            continue
        value = obj[name]
        if value is None:
            if None not in types:
                errors.append(f"{where}.{name}: unexpected null")
            continue
        concrete = tuple(t for t in types if t is not None)
        # bool is an int subclass: reject bools where ints are expected
        if isinstance(value, bool) and bool not in concrete:
            errors.append(f"{where}.{name}: bool where {concrete} expected")
        elif not isinstance(value, concrete):
            errors.append(
                f"{where}.{name}: {type(value).__name__} not in "
                f"{[t.__name__ for t in concrete]}"
            )
    return errors


def validate_explain(obj) -> list[str]:
    """The structural errors of one explain table (empty = valid),
    including the invariant that each candidate's score columns sum to its
    total."""
    if not isinstance(obj, dict):
        return ["explain payload is not an object"]
    errors = _check_fields(obj, EXPLAIN_SCHEMA, "explain")
    for name, weight in (obj.get("weights") or {}).items():
        if not isinstance(name, str) or isinstance(weight, bool) or not (
                isinstance(weight, int)):
            errors.append(f"explain.weights[{name!r}]: not str -> int")
    candidates = obj.get("candidates")
    if isinstance(candidates, list):
        if not candidates:
            errors.append("explain.candidates: empty")
        for i, cand in enumerate(candidates):
            if not isinstance(cand, dict):
                errors.append(f"candidates[{i}]: not an object")
                continue
            errors += _check_fields(cand, CANDIDATE_SCHEMA,
                                    f"candidates[{i}]")
            scores = cand.get("scores")
            if isinstance(scores, dict):
                if set(scores) != set(obj.get("weights") or {}):
                    errors.append(
                        f"candidates[{i}].scores: plugin set != weights set")
                if all(isinstance(v, int) and not isinstance(v, bool)
                       for v in scores.values()) and isinstance(
                        cand.get("total"), int):
                    if sum(scores.values()) != cand["total"]:
                        errors.append(
                            f"candidates[{i}]: score columns sum "
                            f"{sum(scores.values())} != total "
                            f"{cand['total']}")
    return errors


def _cost_stamp(bundle: str):
    """The bundle's `cost.json` (the JAX package stamps its compiled-cost
    manifest there) against the current one. The port keeps no cost
    manifest, so a stamped bundle gets the JAX tool's "nothing to compare
    against" answer, and an unstamped one None."""
    try:
        with open(os.path.join(bundle, "cost.json")) as f:
            recorded = json.load(f)
    except (OSError, ValueError):
        return None
    return {"recorded_digest": recorded.get("manifest_digest"),
            "current_digest": None, "drifted": None,
            "warning": "no committed cost manifest to compare against"}


def cmd_info(args) -> int:
    from scheduler_plugins_tpu_torch.utils import flightrec

    out = []
    for lc in flightrec.load_bundle(args.bundle):
        m = lc.manifest
        out.append({
            "cycle": m["cycle"],
            "digest": m.get("digest"),
            "digest_ok": lc.digest_ok(),
            "profile": m.get("profile"),
            "mode": (m.get("outputs") or {}).get("mode"),
            "pods": len(m.get("meta", {}).get("pod_names", [])),
            "nodes": len(m.get("meta", {}).get("node_names", [])),
            "seed": m.get("seed"),
            "complete": m.get("complete"),
        })
    print(json.dumps({"bundle": args.bundle, "cycles": out,
                      "cost_shape": _cost_stamp(args.bundle)}))
    return 0


def cmd_replay(args) -> int:
    from scheduler_plugins_tpu_torch.utils import flightrec

    cycles = flightrec.load_bundle(args.bundle)
    if args.cycle is not None:
        cycles = [c for c in cycles if c.manifest["cycle"] == args.cycle]
        if not cycles:
            print(json.dumps({"error": f"cycle {args.cycle} not in bundle"}))
            return 1
    failed = False
    results = []
    for lc in cycles:
        out = flightrec.replay_cycle(lc, device=args.device)
        public = {k: v for k, v in out.items() if not k.startswith("_")}
        # bit-identical replay is the contract of a sequential record; a
        # wave-mode record's diff is evidence of soft tie-breaking
        must_match = out["mode"] == "sequential"
        ok = out["digest_ok"] and (out["placements_match"] or not must_match)
        public["ok"] = ok
        failed |= not ok
        results.append(public)
    print(json.dumps({"bundle": args.bundle, "replays": results,
                      "ok": not failed}))
    return 1 if failed else 0


def cmd_explain(args) -> int:
    from scheduler_plugins_tpu_torch.utils import flightrec

    chosen = None
    for lc in reversed(flightrec.load_bundle(args.bundle)):
        if args.cycle is not None and lc.manifest["cycle"] != args.cycle:
            continue
        if args.uid in lc.manifest.get("meta", {}).get("pod_names", []):
            chosen = lc
            break
    if chosen is None:
        print(json.dumps({
            "error": f"uid {args.uid!r} not found in bundle"
            + (f" cycle {args.cycle}" if args.cycle is not None else "")
        }))
        return 1
    table = flightrec.explain_record(chosen, args.uid, top_k=args.top,
                                     batched=args.batched,
                                     device=args.device)
    errors = validate_explain(table)
    table["schema_errors"] = errors
    print(json.dumps(table))
    return 1 if errors else 0


def cmd_timeline(args) -> int:
    """One pod's cross-cycle lifecycle from a bundle's pod-ledger segment
    (`ledger.json`, written by `FlightRecorder.save` when the ledger was
    on): its events with (cycle, lane, seq) coordinates, the per-stage
    latency decomposition and the observing cycles' meta. Without
    `--uid`, the bundle's SLI summary and its recorded pods."""
    path = os.path.join(args.bundle, "ledger.json")
    if not os.path.exists(path):
        print(json.dumps({
            "error": "bundle has no ledger.json (the pod-lifecycle "
                     "ledger was off when the bundle was saved)"
        }))
        return 1
    with open(path) as f:
        export = json.load(f)
    records = export.get("retired", []) + export.get("live", [])
    if not args.uid:
        print(json.dumps({
            "bundle": args.bundle,
            "sli": export.get("sli"),
            "pods": [
                {"uid": r["uid"], "outcome": r["outcome"],
                 "e2e_ms": r["e2e_ms"], "attempts": r["attempts"]}
                for r in records
            ],
        }))
        return 0
    rec = next((r for r in records if r["uid"] == args.uid), None)
    if rec is None:
        print(json.dumps(
            {"error": f"uid {args.uid!r} not in the bundle's ledger"}))
        return 1
    cycles = {m["cycle"]: m for m in export.get("cycles", [])}
    rec = dict(rec)
    rec["cycles"] = [
        cycles[c] for c in sorted({e["cycle"] for e in rec["events"]})
        if c in cycles
    ]
    # the decomposition invariant, re-checked on the persisted copy
    if rec["e2e_ms"] is not None:
        rec["stages_sum_ms"] = sum(rec["stages_ms"].values())
        rec["decomposition_exact"] = (
            abs(rec["stages_sum_ms"] - rec["e2e_ms"]) < 1e-6
        )
    print(json.dumps(rec))
    return 0


def cmd_quality(args) -> int:
    """The quality objectives of a bundle's recorded placements
    (`tools/tune.py` `bundle_quality`, so the tuner and this view cannot
    diverge)."""
    from scheduler_plugins_tpu_torch.tools.tune import bundle_quality

    out = bundle_quality(args.bundle, device=args.device)
    mismatched = [row["cycle"] for row in out["cycles"]
                  if row.get("matches_recorded") is False]
    out["ok"] = not mismatched
    print(json.dumps(out))
    return 1 if mismatched else 0


def _smoke_cycle(scheduler, device):
    """(seconds, report) of one `run_cycle` on a fresh seed-0 config-4
    cluster (a cycle binds its pending pods, so a cluster serves once);
    the scheduler is shared, so every measured cycle is warm."""
    from scheduler_plugins_tpu_torch.framework import run_cycle
    from scheduler_plugins_tpu_torch.models import gang_quota_scenario

    cluster = gang_quota_scenario(**SMOKE_SHAPE)
    start = time.perf_counter()
    report = run_cycle(scheduler, cluster, now=1000, device=device)
    return time.perf_counter() - start, report


def cmd_smoke(args) -> int:
    from scheduler_plugins_tpu_torch import plugins as P
    from scheduler_plugins_tpu_torch.device import resolve_device
    from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
    from scheduler_plugins_tpu_torch.utils import flightrec

    device = resolve_device(args.device)
    bound_pct = float(os.environ.get("SPT_RECORD_BOUND_PCT", 2.0))
    out_dir = args.out or os.path.join(
        tempfile.mkdtemp(prefix="replay_smoke_"), "bundle")
    scheduler = Scheduler(Profile(plugins=[
        P.NodeResourcesAllocatable(), P.Coscheduling(),
        P.CapacityScheduling(),
    ]))
    rec = flightrec.recorder
    _smoke_cycle(scheduler, device)  # warm-up, recorder off
    # the first capture pays one-time imports: keep it out of the pairs
    rec.start(capacity=2)
    _smoke_cycle(scheduler, device)
    off, on, pair_pct = [], [], []
    report = None
    try:
        for _ in range(SMOKE_RUNS):
            rec.stop()
            t_off, _r = _smoke_cycle(scheduler, device)
            off.append(t_off)
            rec.start(capacity=2)
            t_on, report = _smoke_cycle(scheduler, device)
            on.append(t_on)
            pair_pct.append(100.0 * (t_on - t_off) / t_off)
        save = rec.save(out_dir)
    finally:
        rec.stop()
    median_off = sorted(off)[len(off) // 2]
    median_on = sorted(on)[len(on) // 2]
    overhead_pct = sorted(pair_pct)[len(pair_pct) // 2]
    # the noise floor: the off series' own p10-p90 spread
    off_sorted = sorted(off)
    spread_pct = 100.0 * (
        off_sorted[int(0.9 * (len(off) - 1))]
        - off_sorted[int(0.1 * (len(off) - 1))]
    ) / median_off
    bound = max(bound_pct, spread_pct)

    cycles = flightrec.load_bundle(out_dir)
    replay = flightrec.replay_cycle(cycles[-1], device=device)
    replay_ok = (replay["digest_ok"] and replay["placements_match"]
                 and replay["aux_match"] and replay["mode"] == "sequential")
    # explain a failed pod when the cycle had one, else the first pod
    pod_names = cycles[-1].manifest["meta"]["pod_names"]
    uid = report.failed[0] if report.failed else pod_names[0]
    table = flightrec.explain_record(cycles[-1], uid, device=device)
    schema_errors = validate_explain(table)
    ok = (replay_ok and not schema_errors and overhead_pct <= bound
          and bool(report.bound))
    print(json.dumps({
        "metric": "replay_smoke",
        "device": str(device),
        "off_cycle_ms": round(median_off * 1000, 2),
        "on_cycle_ms": round(median_on * 1000, 2),
        "overhead_pct": round(overhead_pct, 2),
        "bound_pct": round(bound, 2),
        "noise_floor_pct": round(spread_pct, 2),
        "bundle": save,
        "replay": {k: v for k, v in replay.items()
                   if not k.startswith("_")},
        "replay_ok": replay_ok,
        "explain_uid": uid,
        "explain_schema_errors": schema_errors[:5],
        "ok": ok,
    }))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m scheduler_plugins_tpu_torch.tools.replay",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_info = sub.add_parser("info", help="list a bundle's recorded cycles")
    p_info.add_argument("bundle")
    p_replay = sub.add_parser(
        "replay", help="re-run recorded cycles through Scheduler.solve and "
        "diff placements")
    p_replay.add_argument("bundle")
    p_replay.add_argument("--cycle", type=int, default=None)
    p_explain = sub.add_parser(
        "explain", help="the per-plugin score table of one recorded pod")
    p_explain.add_argument("bundle")
    p_explain.add_argument("--uid", required=True)
    p_explain.add_argument("--cycle", type=int, default=None)
    p_explain.add_argument("--top", type=int, default=5)
    p_explain.add_argument("--batched", action="store_true",
                           help="derive the columns through the batched "
                                "solve's whole-batch rows")
    p_quality = sub.add_parser(
        "quality", help="placement-quality objectives of every recorded "
        "cycle (tuning.quality)")
    p_quality.add_argument("bundle")
    p_timeline = sub.add_parser(
        "timeline", help="one pod's cross-cycle lifecycle from the "
        "bundle's pod-ledger segment (ledger.json)")
    p_timeline.add_argument("bundle")
    p_timeline.add_argument("--uid", default=None,
                            help="pod uid (omit to list the recorded pods "
                                 "and the bundle's SLI summary)")
    p_smoke = sub.add_parser("smoke", help="the replay smoke gate")
    p_smoke.add_argument("--out", default=None,
                         help="bundle output directory (default: a temp "
                              "dir)")
    for p in (p_replay, p_explain, p_quality, p_smoke):
        p.add_argument("--device", default=None,
                       help="where the replay runs (default: the CUDA "
                            "card; 'cpu' on a machine without one)")
    args = ap.parse_args(argv)
    return {"info": cmd_info, "replay": cmd_replay,
            "explain": cmd_explain, "quality": cmd_quality,
            "timeline": cmd_timeline, "smoke": cmd_smoke}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
