"""Device ms per step of the operations launched inside the discriminators' forwards
(MPD and MSD, on y and ŷ, in both phases of the step), over the traced slice's steps."""

from benchmark.readers import span_ms_per_unit

LAYER, SOURCE, MOVES = "discriminators", "device_trace", "train_step_ms"
SPANS = {"bench.disc_fwd": ["model.mpd.forward", "model.msd.forward"]}


def read(run):
    return span_ms_per_unit(run, "bench.disc_fwd")
