"""Seconds of audio synthesised per second of the window: every batch's items × frames
× hop / sample rate, over the window from the first batch's call to the last batch's
int16 audio on the host."""

LAYER, SOURCE, MOVES = None, "host_clock", None


def read(run):
    return sum(u["work"] for u in run.units) / run.elapsed_s
