"""The 90th percentile over all of the window's batches of a batch's host ms, from its
call (inputs on the host) to its int16 audio on the host."""

import statistics

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(run):
    ms = [u["host_ms"] for u in run.units]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[-1]
