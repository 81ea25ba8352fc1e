"""Set-up seconds: from the process's start (before any import) to the window's start:
imports, the card's start, the kernels' build (or their load from the build cache),
the seeded weights, and the warm-up the cell's traffic needs."""

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(run):
    return run.setup_s
