"""The share of the traced slice in which no operation ran on the card: 100 × (1 − the
union of the device's operations / the slice's length)."""

from benchmark.readers import idle_percent

LAYER, SOURCE, MOVES = "device", "device_trace", "train_step_ms"


def read(run):
    return idle_percent(run)
