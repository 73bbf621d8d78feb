"""The smoke's profiler reads (`chip_smoke.profile_records`,
`chip_smoke.host_self_us`) against torch's own event tree on the CPU: for
the same profile, every op's calls and self CPU microseconds equal
`prof.key_averages()` (tolerance 1e-3 µs, the float sums' rounding), and
the host records count the `validate_wave` walks and launches
`chip_smoke.walk_launches_per_row` reads. The device half (device records,
work calls, device µs) is held on the card by `tools/profiler_cost.py`."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke
from scheduler_plugins_tpu_torch.models import gang_quota_scenario


def _ops():
    x = torch.randn(32, 32, generator=torch.Generator().manual_seed(0))
    for _ in range(50):
        (x @ x).relu().sum()
        torch.where(x > 0, x, 0).cumsum(0)[3:10].clone()


def _nested():
    x = torch.arange(64, dtype=torch.int64)
    for _ in range(20):
        with record_function("validate_wave"):
            with record_function("inner"):
                x.index_add(0, x % 8, x).sum()
            x.scatter_add(0, x % 4, x)


def _parity_solve():
    cluster = gang_quota_scenario(2, 4, 8)
    sched = chip_smoke.flagship_scheduler()
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0, device="cpu")
    sched.prepare(meta, cluster)
    sched.solve(snap, device="cpu")


@pytest.mark.parametrize("work", [_ops, _nested, _parity_solve],
                         ids=lambda f: f.__name__.strip("_"))
def test_host_self_us_equals_key_averages(work):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    records = chip_smoke.profile_records(prof)
    assert records and not any(on_device for _, on_device, *_ in records)
    mine = chip_smoke.host_self_us(records)
    want = {a.key: (a.count, a.self_cpu_time_total)
            for a in prof.key_averages()}
    assert set(mine) == set(want)
    for name, (calls, self_us) in want.items():
        assert mine[name][0] == calls, name
        assert mine[name][1] == pytest.approx(self_us, abs=1e-3), name


def test_records_time_the_walks():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested()
    records = chip_smoke.profile_records(prof)
    walks = [(t0, t1) for name, _, t0, t1, _ in records
             if name == "validate_wave"]
    assert len(walks) == 20 and all(t0 < t1 for t0, t1 in walks)
    # every index_add of `_nested` starts inside a walk
    adds = [t0 for name, _, t0, _, _ in records if name == "aten::index_add"]
    assert len(adds) == 20
    assert all(any(lo <= t <= hi for lo, hi in walks) for t in adds)
