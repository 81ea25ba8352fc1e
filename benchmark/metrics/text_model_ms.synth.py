"""Device ms per batch of the operations launched inside the text model's call that
`Cubegan.infer` makes first (`model.lang.infer`: both towers, durations, pitch, VUV and
the conditioning), over the traced slice's batches."""

from benchmark.readers import span_ms_per_unit

LAYER, SOURCE, MOVES = "text model", "device_trace", "synth_audio_s_per_s"
SPANS = {"bench.text_model": "model.lang.infer"}


def read(run):
    return span_ms_per_unit(run, "bench.text_model")
