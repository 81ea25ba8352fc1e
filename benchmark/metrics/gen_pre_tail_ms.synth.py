"""Device ms per batch of the operations launched inside the program's spans
`tts.gen.pre` (conv_pre) and `tts.gen.stage<i>` for every generator stage but the last
(v1: stages 0-2, everything before the fused tail B1), on the window's thread, over the
traced slice's batches. Read from the program's own spans
(`benchmark/program_spans.py`); None where it opens none."""

from benchmark.program_spans import launched_ms, per_unit, spans, stages_before_last

LAYER, SOURCE, MOVES = "generator", "device_trace", "synth_audio_s_per_s"


def read(run):
    found = spans(run.trace, stages_before_last(run.trace))
    return per_unit(run, launched_ms(run.trace, found))
