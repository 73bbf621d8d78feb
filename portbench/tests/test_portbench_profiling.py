"""The trace readers: the device's busy union, its idle gaps by host
stage, and the traced iteration's plumbing (on the CPU it finds no
device records, so the device metrics stay silent)."""

import time

from portbench import harness, profiling

from pbhelpers import small_cell


def test_busy_union_and_gaps():
    iv = [(10, 20, "a"), (15, 30, "b"), (50, 60, "c")]
    assert profiling.busy_ns(iv) == 30
    assert profiling.idle_gaps(iv, 0, 100) == [(0, 10), (30, 50), (60, 100)]


def test_breakdown_names_the_stages():
    stages = [("ingest", 0, 10), ("snapshot", 10, 40), ("solve", 40, 100)]
    iv = [(12, 14, "void k<1>(int)"), (50, 58, "Memcpy DtoD")]
    gaps = profiling.idle_gaps(iv, 0, 100)
    out = profiling.breakdown(iv, gaps, stages)
    assert out["device_ops"][0] == ["Memcpy DtoD [solve]", 8e-09]
    assert out["device_ops"][1] == ["k<1>(int) [snapshot]", 2e-09]
    assert out["idle_gaps"][0] == ["solve", 42e-09]
    assert out["idle_gaps"][1] == ["snapshot>solve", 36e-09]
    assert out["idle_gaps"][2] == ["ingest>snapshot", 12e-09]


def test_stage_spans_follow_the_cycle_order():
    spans = profiling.stage_spans(100, harness.CYCLE_STAGES,
                                  {"open": 1e-9, "snapshot": 5e-9,
                                   "solve": 2e-9}, (0, 100))
    assert spans == [("ingest", 0, 100), ("open", 100, 101),
                     ("snapshot", 101, 106), ("solve", 106, 108)]


def test_traced_iteration_on_the_cpu():
    cell = small_cell("basic_5k.churn")
    out = harness.drive(cell, 4, 0.2, True, "cpu", time.perf_counter())
    prof = out["record"].profile
    assert out["correct"]
    assert prof["window_s"] > 0 and prof["pods"] > 0
    assert prof["device_records"] == 0
    metrics = harness.metrics_of(cell, out["record"], True)
    assert "device_idle_pct" not in metrics
    assert metrics["snapshot_ms"]["value"] > 0
