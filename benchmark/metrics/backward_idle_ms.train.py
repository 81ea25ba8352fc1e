"""Milliseconds per step in which no operation ran on the card while the step's thread
was inside the program's spans `tts.train.d_backward` or `tts.train.gt_backward`, over
the traced slice's steps: the backward's host-paced idle time, whichever thread was
launching (autograd launches the backward from a thread of its own while the step's
thread waits in `.backward()`, so the spans bound it by time). Read from the program's
own spans (`benchmark/program_spans.py`); None where it opens none."""

from benchmark.program_spans import BACKWARD, idle_ms, per_unit, spans

LAYER, SOURCE, MOVES = "model step", "device_trace", "train_step_ms"


def read(run):
    return per_unit(run, idle_ms(run.trace, spans(run.trace, BACKWARD)))
