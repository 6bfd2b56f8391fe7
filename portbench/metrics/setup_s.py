"""setup_s: process start to the first timed segment (imports, the card, the kernel library, the pool, the warm-up)."""


def read(run):
    return run["setup_s"]
