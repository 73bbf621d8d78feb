"""pods_per_s (pods/s): every pod bound in the window over the window's
whole wall time, arrivals, completions and cycles included; the window
ends when the last cycle started within `--seconds` ends."""


def read(record):
    if record.window_s <= 0:
        return None
    return record.window_bound / record.window_s
