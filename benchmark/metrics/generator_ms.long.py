"""Device ms per batch of the operations launched inside the generator's calls that
`Cubegan.infer` makes on the conditioning (`model.gen.fused`, once per batch, or once
per window in `generate_chunked`), over the traced slice's batches."""

from benchmark.readers import span_ms_per_unit

LAYER, SOURCE, MOVES = "generator", "device_trace", "synth_long_audio_s_per_s"
SPANS = {"bench.generator": "model.gen.fused"}


def read(run):
    return span_ms_per_unit(run, "bench.generator")
