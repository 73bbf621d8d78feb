"""The sanitizer mode, `SPT_SANITIZE=1` (port of
`scheduler_plugins_tpu.utils.sanitize`).

The JAX package instruments its solve programs with checkify: index
out-of-bounds on the commit scatters, NaN production and division by zero,
which XLA otherwise clamps, drops or propagates silently. Eager PyTorch
has no such transform, and `torch.cuda.set_sync_debug_mode` catches host
syncs, not bad indices or NaNs. The port checks explicitly instead, at
the choke points where those faults would land:

- an index-range check in the commit scatters: `utils.intmath.add_rows`
  (the step's free, quota and gang commits), `ops.selectors
  ._scatter_add_rows`, the served delta apply and compaction
  (`serving.deltas`), and the sharded wave solve's kernel launches (the
  proposals `fused_election` reads by, and the winner ids it returns);
- a NaN check on the float score columns of the batched solve and on the
  float keys the sharded wave solve's kernels exchange;
- a zero-divisor check on `utils.intmath.go_div`, the integer division
  (a zero divisor divides as 1, so the call finishes).

An out-of-range index on the card is a device-side assert that poisons
the CUDA context, so a checked scatter also redirects the bad rows to row
0 with a zero update before it launches (as XLA drops an out-of-range
update): the call finishes, the report says `out-of-bounds`, and the
context keeps working.

Checks run only inside a CHECKED CALL (`checked(program)`, or the
`checked_call(program)` decorator), opened by the wrap points, which
mirror the JAX package's: `profile_batch_solve` and
`packing_profile_solve`, each chunk solve of `run_chunk_pipeline`
(`streamed_profile_solve`'s chunks), the served delta apply, and
`sharded_wave_solve`. Every check ORs one bit into a device error tensor
of the call; the call reads it once, when it ends, so a clean step adds
device work but no host read. A call nested in another joins the outer
one. The sanitizer keeps the hand-written CUDA kernels on its path (JAX
turns Pallas off, since checkify cannot instrument a `pallas_call`) and
checks the data around each launch instead.

Each checked call appends a report, `{"sanitize": program, "ok": bool}`
plus `"error"` when a check fired (also printed as one JSON line on
stderr); `drain()` hands the reports over and clears them. The cycle
engines drain foreign reports before the snapshot and fill
`CycleReport.sanitize_errors` / `sanitize_checked` after the solve. The
variable is read at each call (the port caches no program). Off, a choke
point costs one thread-local attribute read and adds no operation.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
from contextlib import contextmanager
from typing import Optional

import torch

_REPORTS: list[dict] = []
#: the checked call open on this thread, or None
_local = threading.local()


def enabled() -> bool:
    return os.environ.get("SPT_SANITIZE", "") == "1"


class Check:
    """The findings of one checked call: each label owns one bit of an
    int64 error tensor per device, named on the host in the order the
    checks first ran."""

    #: bits of the error tensor; labels past the last share it
    MAX_LABELS = 63

    def __init__(self, program: str):
        self.program = program
        self.labels: list[str] = []
        self.errors: dict = {}  # device -> (,) int64 tensor

    def flag(self, bad: torch.Tensor, label: str) -> None:
        """OR the 0-d bool `bad` into the call's error under `label`."""
        try:
            bit = self.labels.index(label)
        except ValueError:
            bit = min(len(self.labels), self.MAX_LABELS - 1)
            if bit == len(self.labels):
                self.labels.append(label)
        term = bad.to(torch.int64) << bit
        err = self.errors.get(term.device)
        self.errors[term.device] = term if err is None else err | term

    def index(self, index: torch.Tensor, size: int, site: str):
        """(index with every entry outside [0, size) sent to 0, ok mask):
        flags `out-of-bounds` when any entry is outside. The caller zeroes
        the update of each row `ok` is False for."""
        ok = (index >= 0) & (index < size)
        self.flag(~ok.all(), f"out-of-bounds index in {site}")
        return torch.where(ok, index, 0), ok

    def rows(self, index: torch.Tensor, size: int, site: str, *srcs):
        """(index, *srcs) for a scatter-add of each src's rows at `index`
        into `size` rows: an entry outside [0, size) is flagged and goes to
        row 0 with a zero update (as XLA drops an out-of-range update)."""
        index, ok = self.index(index, size, site)
        return (index,) + tuple(
            torch.where(ok.view((-1,) + (1,) * (src.dim() - 1)), src,
                        torch.zeros_like(src))
            for src in srcs)

    def nan(self, x: torch.Tensor, site: str) -> None:
        if x.is_floating_point():
            self.flag(torch.isnan(x).any(), f"NaN in {site}")

    def divisor(self, b, site: str):
        """`b` with any zero entry flagged and replaced by 1 (a Python
        number passes through)."""
        if not isinstance(b, torch.Tensor):
            return b
        zero = b == 0
        self.flag(zero.any(), f"division by zero in {site}")
        return torch.where(zero, torch.ones_like(b), b)

    def finish(self) -> dict:
        """Read the error once and record the call's report."""
        mask = 0
        for err in self.errors.values():
            mask |= int(err)
        entry = {"sanitize": self.program, "ok": mask == 0}
        if mask:
            fired = [label for bit, label in enumerate(self.labels)
                     if mask >> bit & 1]
            entry["error"] = "; ".join(fired)[:400]
            print(json.dumps(entry), file=sys.stderr, flush=True)
        _REPORTS.append(entry)
        return entry


def current() -> Optional[Check]:
    """The checked call open on this thread, or None (checks off)."""
    return getattr(_local, "check", None)


@contextmanager
def checked(program: str):
    """Open a checked call named `program` when the mode is on and none is
    open on this thread (yields the `Check`; a nested call yields the
    outer one, which reports for both); else yields what is open, or
    None. The report is recorded when the block ends without raising."""
    outer = current()
    if outer is not None or not enabled():
        yield outer
        return
    check = Check(program)
    _local.check = check
    try:
        yield check
    finally:
        _local.check = None
    check.finish()


def checked_call(program: str):
    """Decorator: each call of the function runs inside `checked(program)`
    (the wrap points' form)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with checked(program):
                return fn(*args, **kwargs)

        return call

    return wrap


def drain() -> list[dict]:
    """Every report since the last drain (clears them)."""
    out = list(_REPORTS)
    _REPORTS.clear()
    return out
