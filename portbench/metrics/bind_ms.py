"""bind_ms (ms): `run_cycle`'s `bind` and `postbind` stages (the store's
binds, reservations and parks, Permit, preemption), summed over the
window's cycles, per cycle."""

STAGES = ("bind", "postbind")


def read(record):
    cycles = [t for t in record.window_cycles if t]
    if not cycles:
        return None
    return sum(t.get(s, 0.0) for t in cycles for s in STAGES) \
        / len(cycles) * 1e3
