"""Milliseconds per batch in which no operation ran on the card while the window's
thread was inside the program's span `tts.text` (`Languasito2.infer`: both towers,
durations, pitch, conditioning), over the traced slice's batches: the host-paced idle
time of the text model, which `text_model_ms.synth` (device time) leaves out. Read
from the program's own spans (`benchmark/program_spans.py`); None where it opens none."""

from benchmark.program_spans import idle_ms, per_unit, spans

LAYER, SOURCE, MOVES = "text model", "device_trace", "synth_audio_s_per_s"


def read(run):
    return per_unit(run, idle_ms(run.trace, spans(run.trace, {"tts.text"})))
