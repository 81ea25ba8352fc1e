"""Device ms per step of the operations launched inside the LM encoder's forward
(`model.hf`, BERT over the token windows), over the traced slice's steps."""

from benchmark.readers import span_ms_per_unit

LAYER, SOURCE, MOVES = "LM encoder", "device_trace", "train_step_ms"
SPANS = {"bench.lm_encoder": "model.hf.forward"}


def read(run):
    return span_ms_per_unit(run, "bench.lm_encoder")
