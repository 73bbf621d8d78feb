"""snapshot_ms (ms): `run_cycle`'s `pending` and `snapshot` stages (queue
sort, then the snapshot lowered from the store or assembled by the serve
engine, and the plugins' prepare), summed over the window's cycles, per
cycle."""

STAGES = ("pending", "snapshot")


def read(record):
    cycles = [t for t in record.window_cycles if t]
    if not cycles:
        return None
    return sum(t.get(s, 0.0) for t in cycles for s in STAGES) \
        / len(cycles) * 1e3
