#!/usr/bin/env python3
"""What reading a `torch.profiler` profile costs the smoke's profiled
phases, and that the raw records read the same numbers.

    python3 tools/profiler_cost.py [--gangs 32]

On the card, profiles one `Scheduler.solve` of the first 128 queued pods
of bench config 4's cluster (`gang_quota_scenario(gangs, 64, 1024)`, the
flagship profile; `chip_smoke.launches_per_step`'s longer solve) after a
warm solve, then reads the one profile two ways and times each on the
host clock:

- torch's event tree: `prof.events()` (device records, the host calls
  enqueueing device work by name, device microseconds) and then
  `prof.key_averages()` (self CPU time by op);
- the raw records: `chip_smoke.profile_records` and
  `chip_smoke.host_self_us`, what the smoke reads since they came in.

Prints one `[profiler_cost]` line with both times, the record count and
the card's name and power limit, and exits non-zero unless the two reads
agree: the same device records, the same host calls by name, device
microseconds within 1e-6 relative, and the same total self CPU time within
0.1 %.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PODS = 128


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from scheduler_plugins_tpu_torch.models import gang_quota_scenario

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gangs", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_cost: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    cluster = gang_quota_scenario(args.gangs, 64, 1024)
    sched = cs.flagship_scheduler()
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending[:PODS], now_ms=0, device=device,
                                  pad_pods=PODS)
    sched.prepare(meta, cluster)
    sched.solve(snap, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.solve(snap, device=device)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    tree = (len(kernels),
            Counter(e.name for e in events
                    if e.device_type == DeviceType.CPU
                    and e.name.startswith("cu")
                    and any(w in e.name for w in cs.WORK_CALLS)),
            sum(e.time_range.elapsed_us() for e in kernels))
    t1 = time.perf_counter()
    tree_self = sum(a.self_cpu_time_total for a in prof.key_averages())
    t2 = time.perf_counter()
    records = cs.profile_records(prof)
    dev = [r for r in records if r[1]]
    raw = (len(dev),
           Counter(r[0] for r in records
                   if not r[1] and r[0].startswith("cu")
                   and any(w in r[0] for w in cs.WORK_CALLS)),
           sum(t_end - t_start for _, _, t_start, t_end, _ in dev) / 1e3)
    t3 = time.perf_counter()
    raw_self = sum(us for _, us in cs.host_self_us(records).values())
    t4 = time.perf_counter()

    agree = (tree[0] == raw[0] and tree[1] == raw[1]
             and abs(tree[2] - raw[2]) <= 1e-6 * max(tree[2], 1.0)
             and abs(tree_self - raw_self) <= 1e-3 * max(tree_self, 1.0))
    print(f"[profiler_cost] card={smi!r} gangs={args.gangs} pods={PODS} "
          f"records={len(records)} events_s={t1 - t0} "
          f"key_averages_s={t2 - t1} profile_records_s={t3 - t2} "
          f"host_self_us_s={t4 - t3} device_records={tree[0]} / {raw[0]} "
          f"work_calls={sum(tree[1].values())} / {sum(raw[1].values())} "
          f"device_us={tree[2]} / {raw[2]} self_cpu_us={tree_self} / "
          f"{raw_self} agree={agree}", flush=True)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
