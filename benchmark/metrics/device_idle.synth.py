"""The share of the traced slice in which no operation ran on the card: 100 × (1 − the
union of the device's operations / the slice's length)."""

from benchmark.readers import idle_percent

LAYER, SOURCE, MOVES = "device", "device_trace", "synth_audio_s_per_s"


def read(run):
    return idle_percent(run)
