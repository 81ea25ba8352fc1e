"""The whole synthesis step's share of the card's bf16 peak (989 TFLOP/s): the text
model's and the generator's operations over every frame of the window's batches
(counted from the configuration's shapes, no window halo), over the window's seconds on
the host's clock, outside the profiler."""

from benchmark.readers import synthesis_mfu

LAYER, SOURCE, MOVES = "model step", "host_clock", "synth_audio_s_per_s"


def read(run):
    return synthesis_mfu(run)
