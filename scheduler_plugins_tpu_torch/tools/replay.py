"""Flight-recorder replay and explain over bundles (port of the JAX
package's `tools/replay.py`).

    python -m scheduler_plugins_tpu_torch.tools.replay info BUNDLE
    python -m scheduler_plugins_tpu_torch.tools.replay replay BUNDLE \
        [--cycle K] [--device cpu]
    python -m scheduler_plugins_tpu_torch.tools.replay explain BUNDLE \
        --uid UID [--cycle K] [--top N] [--batched] [--device cpu]

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

`--device` is where the replay runs: the CUDA card by default, "cpu" when
asked for. One JSON line per action on stdout; rc 1 on any failure. The
JAX tool's `quality` (it needs `tools/tune.py`'s `bundle_quality`),
`timeline` and `smoke` come with the rest of `tuning/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    for p in (p_replay, p_explain):
        p.add_argument("--device", default=None,
                       help="where the replay runs (default: the CUDA "
                            "card; 'cpu' on a machine without one)")
    args = ap.parse_args(argv)
    return {"info": cmd_info, "replay": cmd_replay,
            "explain": cmd_explain}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
