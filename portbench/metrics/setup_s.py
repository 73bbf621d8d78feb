"""setup_s (s): process start to the first measured cycle: the port's
import, the cluster built from the seed, the serve engine's first rebase
where the mix serves, and one warm-up iteration of the window's shape."""


def read(record):
    return record.setup_s
