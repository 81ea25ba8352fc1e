"""Device ms per step of the operations launched inside the optimizers' `step` calls
(AdamW for the d, g and t partitions, Adam for b), over the traced slice's steps."""

from benchmark.readers import span_ms_per_unit

LAYER, SOURCE, MOVES = "optimizer", "device_trace", "train_step_ms"
SPANS = {"bench.optimizer": "state.optimizers.*.step"}


def read(run):
    return span_ms_per_unit(run, "bench.optimizer")
