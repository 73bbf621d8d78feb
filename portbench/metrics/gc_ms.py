"""gc_ms (ms): the seconds the interpreter's cyclic garbage collector ran
in the window (every generation, from `gc.callbacks`), per cycle. The
collector walks every tracked object of the process, the store's pods
among them, so it grows with the cluster the program holds."""


def read(record):
    cycles = len(record.window_cycles)
    if not cycles:
        return None
    return record.gc_s / cycles * 1e3
