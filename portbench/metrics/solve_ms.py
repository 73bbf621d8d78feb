"""solve_ms (ms): `run_cycle`'s `solve` and `fence` stages (the dispatch,
and the host waiting for the card and copying the outputs), summed over
the window's cycles, per cycle."""

STAGES = ("solve", "fence")


def read(record):
    cycles = [t for t in record.window_cycles if t]
    if not cycles:
        return None
    return sum(t.get(s, 0.0) for t in cycles for s in STAGES) \
        / len(cycles) * 1e3
