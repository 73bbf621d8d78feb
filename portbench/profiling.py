"""Reading one profiled iteration: the profiler's raw records, the
device's busy time, the host calls that put work on the card, and the
breakdown of device time and idle gaps by the host stage they fell in.

`profile_records` is a copy of `chip_smoke.py`'s function of the same
name (`chip_smoke.py:873`), kept here so that a change to the program
cannot move the yardstick. It reads the profiler's raw results, not
`prof.events()`, whose Python event tree costs seconds a profile."""

from __future__ import annotations

from collections import defaultdict

#: host calls that enqueue device work (CUDA runtime / driver names)
WORK_CALLS = ("LaunchKernel", "Memcpy", "Memset")


def profile_records(prof) -> list:
    """Every record `prof` (a finished `torch.profiler.profile`) took, as
    (name, on_device, start_ns, end_ns, thread), read from the
    profiler's raw results. Copied from `chip_smoke.profile_records`."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def annotation_names(prof) -> set:
    """Names of the user ranges (`record_function`) in `prof`: the
    profiler mirrors each on the device's timeline."""
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()}


def work_calls(records, t0: int, t1: int) -> int:
    """Host calls inside [t0, t1] that enqueue device work: the runtime's
    and the driver's launch, copy and fill calls."""
    return sum(1 for name, on_device, s, _, _ in records
               if not on_device and t0 <= s <= t1
               and name.startswith("cu")
               and any(w in name for w in WORK_CALLS))


def device_intervals(records, t0: int, t1: int) -> list:
    """The device records' [start, end] clipped to [t0, t1], sorted."""
    out = []
    for name, on_device, s, e, _ in records:
        if on_device and e > t0 and s < t1:
            out.append((max(s, t0), min(e, t1), name))
    out.sort()
    return out


def busy_ns(intervals) -> int:
    """The length of the union of `intervals`."""
    total, end = 0, None
    start = None
    for s, e, _ in intervals:
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def idle_gaps(intervals, t0: int, t1: int) -> list:
    """The gaps in [t0, t1] where no device record ran: [(start, end)]."""
    gaps, cursor = [], t0
    for s, e, _ in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    return gaps


def stage_at(stages, t: int) -> str:
    """The host stage ([(name, start_ns, end_ns)]) running at `t`."""
    for name, s, e in stages:
        if s <= t < e:
            return name
    return "between stages"


def stages_over(stages, t0: int, t1: int) -> str:
    """The host stages that overlap [t0, t1], in order, joined by '>'."""
    names = [name for name, s, e in stages if s < t1 and e > t0]
    return ">".join(names) or "between stages"


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its return type, cut to `width`."""
    if name.startswith("void "):
        name = name[5:]
    return name if len(name) <= width else name[:width] + "..."


def breakdown(intervals, gaps, stages, top: int = 10) -> dict:
    """The device operations that took most time, by name and the host
    stage each started in, and the longest idle gaps by the host stages
    they span: seconds, unrounded."""
    by_op = defaultdict(int)
    for s, e, name in intervals:
        by_op[f"{short_name(name)} [{stage_at(stages, s)}]"] += e - s
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name, ns / 1e9] for name, ns in ops],
        "idle_gaps": [[stages_over(stages, s, e), (e - s) / 1e9]
                      for s, e in longest],
    }


def stage_spans(start_ns: int, order, timings: dict, ingest_ns: tuple):
    """[(stage, start_ns, end_ns)] of one profiled iteration: the
    harness's ingest span, then `run_cycle`'s stages laid end to end from
    the cycle span's start in the order the cycle runs them (`timings`
    gives each stage's wall seconds; the gaps between them are a few
    clock reads)."""
    spans = [("ingest",) + tuple(ingest_ns)]
    t = start_ns
    for name in order:
        if name in timings:
            d = int(timings[name] * 1e9)
            spans.append((name, t, t + d))
            t += d
    return spans
