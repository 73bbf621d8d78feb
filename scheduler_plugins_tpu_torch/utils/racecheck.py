"""Runtime race checker, `SPT_RACE=1` (port of
`scheduler_plugins_tpu.utils.racecheck`).

`install(seed)` replaces `threading.Lock` / `threading.RLock` /
`threading.Event` with factories that return CHECKED proxies, but ONLY
for primitives created from inside `scheduler_plugins_tpu_torch` (the
creating frame's module is inspected): stdlib internals (Condition,
queue, concurrent.futures) keep raw primitives, so their lock internals
are never disturbed. A primitive made before `install` (a module-level
lock) stays raw.

What the proxies check, per operation:

- **lock-order inversion**: a global acquisition-order graph (edge A->B
  when B is acquired while A is held, with the acquiring thread);
  acquiring B while holding A after B->A was observed on any thread is a
  recorded violation;
- **non-owner release**: releasing a lock another thread holds;
- **double acquire**: a blocking re-acquire of a non-reentrant Lock by
  its holder (a certain self-deadlock), recorded AND raised, since
  letting it proceed would hang the run;
- **seeded cooperative yields**: a `random.Random(seed)` injector sleeps
  a few hundred microseconds around acquire / release points and before
  `Event.set`, steering the interleaving differently per seed. The same
  composite replayed under N seeds explores N schedules, deterministic
  enough to compare end states bit for bit.

Usage:
    racecheck.install(seed=3)
    try:
        ... drive the composite ...
        assert not racecheck.violations()
    finally:
        racecheck.uninstall()

`install` is a no-op (returns False) unless SPT_RACE=1, so nothing else
pays for any of this. Host Python only: it touches no tensor.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time

_WRAP_PREFIX = "scheduler_plugins_tpu_torch"

_state = {
    "installed": False,
    "orig": {},
    "rng": None,
    "lock": threading.Lock(),   # guards the shared tables below
    "edges": {},                # (a_name, b_name) -> provenance str
    "violations": [],
    "locks_created": 0,
    "events_created": 0,
    "yields": 0,
}
_held = threading.local()       # per-thread stack of held CheckedLocks


def _caller_module(depth: int = 2) -> str:
    try:
        return sys._getframe(depth).f_globals.get("__name__", "")
    except ValueError:
        return ""


def _should_wrap(extra_prefixes) -> bool:
    mod = _caller_module(3)
    prefixes = (_WRAP_PREFIX,) + tuple(extra_prefixes)
    return any(mod == p or mod.startswith(p + ".") for p in prefixes)


def _maybe_yield():
    rng = _state["rng"]
    if rng is None:
        return
    # Random() is GIL-atomic enough for a perturbation source; the point
    # is a seed-deterministic *sequence* of sleep decisions, not a
    # per-thread reproducible schedule
    if rng.random() < 0.5:
        _state["yields"] += 1
        time.sleep(rng.random() * 0.0005)


def _record(kind: str, detail: str):
    with _state["lock"]:
        _state["violations"].append({"kind": kind, "detail": detail})


class CheckedLock:
    """Non-reentrant Lock proxy: ownership, order-graph, seeded yields."""

    _REENTRANT = False

    def __init__(self, real, name: str):
        self._real = real
        self.name = name
        self._owner = None
        self._count = 0

    # -- checks -----------------------------------------------------------

    def _check_order(self):
        held = getattr(_held, "stack", None) or []
        me = threading.current_thread().name
        with _state["lock"]:
            for h in held:
                if h is self:
                    continue
                fwd = (h.name, self.name)
                rev = (self.name, h.name)
                if rev in _state["edges"]:
                    _state["violations"].append({
                        "kind": "lock-order-inversion",
                        "detail": (
                            f"{me} acquires {self.name!r} while holding "
                            f"{h.name!r}, but the opposite order was "
                            f"observed at {_state['edges'][rev]}"
                        ),
                    })
                _state["edges"].setdefault(fwd, me)

    def acquire(self, blocking=True, timeout=-1):
        me = threading.current_thread()
        if (not self._REENTRANT and self._owner is me and blocking
                and timeout == -1):
            _record(
                "double-acquire",
                f"{me.name} blocking re-acquire of non-reentrant lock "
                f"{self.name!r} it already holds (guaranteed deadlock)",
            )
            raise RuntimeError(
                f"racecheck: double acquire of {self.name!r}"
            )
        self._check_order()
        _maybe_yield()
        if timeout == -1:
            got = self._real.acquire(blocking)
        else:
            got = self._real.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._count += 1
            stack = getattr(_held, "stack", None)
            if stack is None:
                stack = _held.stack = []
            stack.append(self)
        return got

    def release(self):
        me = threading.current_thread()
        if self._owner is not me:
            owner = self._owner.name if self._owner else "<nobody>"
            _record(
                "non-owner-release",
                f"{me.name} releases {self.name!r} held by {owner}",
            )
        self._count -= 1
        if self._count <= 0:
            self._owner = None
        stack = getattr(_held, "stack", None)
        if stack and self in stack:
            stack.remove(self)
        self._real.release()
        _maybe_yield()

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class CheckedRLock(CheckedLock):
    _REENTRANT = True


class CheckedEvent:
    """Event proxy: seeded yields around set() (the cross-thread handoff
    edge the injector most wants to perturb)."""

    def __init__(self, real):
        self._real = real

    def set(self):
        _maybe_yield()
        self._real.set()

    def clear(self):
        self._real.clear()

    def is_set(self):
        return self._real.is_set()

    def wait(self, timeout=None):
        return self._real.wait(timeout)


def install(seed: int = 0, extra_prefixes=()) -> bool:
    """Patch threading's factories; False (no-op) unless SPT_RACE=1."""
    if os.environ.get("SPT_RACE") != "1" or _state["installed"]:
        return False
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    orig_event = threading.Event

    def make_lock():
        if not _should_wrap(extra_prefixes):
            return orig_lock()
        with _state["lock"]:
            _state["locks_created"] += 1
            n = _state["locks_created"]
        name = f"{_caller_module(2)}#L{n}"
        return CheckedLock(orig_lock(), name)

    def make_rlock():
        if not _should_wrap(extra_prefixes):
            return orig_rlock()
        with _state["lock"]:
            _state["locks_created"] += 1
            n = _state["locks_created"]
        name = f"{_caller_module(2)}#R{n}"
        return CheckedRLock(orig_rlock(), name)

    def make_event():
        if not _should_wrap(extra_prefixes):
            return orig_event()
        _state["events_created"] += 1
        return CheckedEvent(orig_event())

    _state["orig"] = {
        "Lock": orig_lock, "RLock": orig_rlock, "Event": orig_event,
    }
    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Event = make_event
    _state["rng"] = random.Random(seed)
    _state["edges"].clear()
    _state["violations"].clear()
    _state["locks_created"] = 0
    _state["events_created"] = 0
    _state["yields"] = 0
    _state["installed"] = True
    return True


def uninstall():
    if not _state["installed"]:
        return
    threading.Lock = _state["orig"]["Lock"]
    threading.RLock = _state["orig"]["RLock"]
    threading.Event = _state["orig"]["Event"]
    _state["rng"] = None
    _state["installed"] = False


def violations():
    with _state["lock"]:
        return list(_state["violations"])


def report() -> dict:
    with _state["lock"]:
        return {
            "violations": list(_state["violations"]),
            "locks_created": _state["locks_created"],
            "events_created": _state["events_created"],
            "order_edges": len(_state["edges"]),
            "yields": _state["yields"],
        }
