"""The port's runtime race checker (`SPT_RACE=1`,
`scheduler_plugins_tpu_torch.utils.racecheck`) on the CPU.

- `tests/test_race_audit.py` TestRacecheck, for the port: `install` is a
  no-op without the variable; the proxies catch a lock-order inversion,
  a non-owner release and a double acquire (raised); stdlib locks stay
  raw; and locks of the JAX package's modules are never wrapped.
- The three-seed composite (`tests/torch_race_cases.py`) at a small cut:
  `PipelinedCycle` with the watchdog and a planted hang, no violation,
  and every seed's decisions equal to a run without the checker."""

import threading
from types import SimpleNamespace

import pytest

import chip_smoke
from scheduler_plugins_tpu_torch.framework import PipelinedCycle
from scheduler_plugins_tpu_torch.utils import racecheck
from torch_race_cases import (
    RACE_SEEDS,
    RACE_TEST_SHAPE,
    race_composite,
    race_gates,
)


class TestRacecheck:
    def test_install_noop_without_env(self, monkeypatch):
        monkeypatch.delenv("SPT_RACE", raising=False)
        assert racecheck.install(seed=0) is False
        assert threading.Lock is racecheck._state.get(
            "orig", {}).get("Lock", threading.Lock)

    def test_proxies_catch_violations(self, monkeypatch):
        monkeypatch.setenv("SPT_RACE", "1")
        assert racecheck.install(seed=0, extra_prefixes=(__name__,))
        try:
            a, b = threading.Lock(), threading.Lock()
            with a:
                with b:
                    pass
            with b:  # the reverse order
                with a:
                    pass
            lock = threading.Lock()
            t = threading.Thread(target=lock.acquire, name="rc-owner",
                                 daemon=True)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            lock.release()  # from a thread that never acquired it
            held = threading.Lock()
            held.acquire()
            with pytest.raises(RuntimeError, match="double acquire"):
                held.acquire()  # a certain self-deadlock: raised too
            kinds = {v["kind"] for v in racecheck.violations()}
            assert kinds == {"lock-order-inversion", "non-owner-release",
                             "double-acquire"}
            rep = racecheck.report()
            assert rep["locks_created"] == 4
            assert rep["order_edges"] >= 2
        finally:
            racecheck.uninstall()
        assert threading.Lock is racecheck._state["orig"]["Lock"]

    def test_stdlib_locks_stay_raw(self, monkeypatch):
        monkeypatch.setenv("SPT_RACE", "1")
        assert racecheck.install(seed=0)
        try:
            cond = threading.Condition()  # allocates its own lock
            with cond:
                cond.notify_all()
            assert racecheck.report()["locks_created"] == 0
        finally:
            racecheck.uninstall()

    def test_only_the_ports_modules_are_wrapped(self, monkeypatch):
        """A lock made from the port's modules is checked; one made from a
        module of the JAX package (a name sharing the prefix) is not."""
        from scheduler_plugins_tpu_torch.serving.deltas import DeltaSink

        monkeypatch.setenv("SPT_RACE", "1")
        assert racecheck.install(seed=0)
        try:
            sink = DeltaSink()
            assert isinstance(sink._lock, racecheck.CheckedLock)
            foreign = {"__name__": "scheduler_plugins_tpu.serving.deltas",
                       "threading": threading}
            exec("made = threading.Lock()", foreign)
            assert not isinstance(foreign["made"], racecheck.CheckedLock)
        finally:
            racecheck.uninstall()


def _namespace():
    ns = chip_smoke._life_namespace("cpu")
    return SimpleNamespace(
        **vars(ns),
        PipelinedResilient=lambda s, c, e, rz: PipelinedCycle(
            s, c, serve=e, resilience=rz, device="cpu"),
    )


def test_three_seed_pipelined_composite(monkeypatch):
    """Three seeds of the checker over the same composite, and one run
    without it: no violation, the hang fired in each, and every tick's
    decisions and the final store equal across all four."""
    monkeypatch.setenv("SPT_RACE", "1")
    pkg = _namespace()
    control = race_composite(pkg, racecheck, RACE_TEST_SHAPE, race=False)
    runs = [race_composite(pkg, racecheck, RACE_TEST_SHAPE, seed=s)
            for s in RACE_SEEDS]
    assert race_gates(runs, control) == []
    assert all(run["racecheck"]["locks_created"] > 0
               and run["racecheck"]["yields"] > 0 for run in runs)
    assert any(bound for bound, _, _ in control["ticks"])
