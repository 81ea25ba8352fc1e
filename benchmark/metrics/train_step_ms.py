"""Milliseconds per GAN step: the whole window (each step's batch copied to the card,
`train_step`, and the card finishing the last one) over its steps."""

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(run):
    return run.elapsed_s * 1e3 / len(run.units)
