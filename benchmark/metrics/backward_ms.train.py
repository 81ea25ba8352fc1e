"""Device ms per step of the operations launched, from any thread, while the step's
thread was inside the program's spans `tts.train.d_backward` or `tts.train.gt_backward`
(`loss.backward()` of the discriminators' and of the generator and text losses), over
the traced slice's steps. Launches are matched by time, not by thread: autograd
launches the backward from a thread of its own while the step's thread waits in
`.backward()`. Read from the program's own spans (`benchmark/program_spans.py`); None
where it opens none."""

from benchmark.program_spans import BACKWARD, launched_ms, per_unit, spans

LAYER, SOURCE, MOVES = "model step", "device_trace", "train_step_ms"


def read(run):
    return per_unit(run, launched_ms(run.trace, spans(run.trace, BACKWARD), any_thread=True))
