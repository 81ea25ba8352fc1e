"""Milliseconds per batch in which no operation ran on the card while the window's
thread was inside the program's span `tts.text` (`Languasito2.infer`: both towers,
durations, pitch, conditioning at 2,048 frames), over the traced slice's batches: the
host-paced idle time of the text model, which `text_model_ms.long` (device time) leaves
out. Read from the program's own spans (`benchmark/program_spans.py`); None where it
opens none."""

from benchmark.program_spans import idle_ms, per_unit, spans

LAYER, SOURCE, MOVES = "text model", "device_trace", "synth_long_audio_s_per_s"


def read(run):
    return per_unit(run, idle_ms(run.trace, spans(run.trace, {"tts.text"})))
