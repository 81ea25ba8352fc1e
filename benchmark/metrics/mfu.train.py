"""The whole GAN step's share of the card's bf16 peak (989 TFLOP/s): the operations of
the window's steps, forward and backward of every part (counted from the shapes), over
the window's seconds on the host's clock, outside the profiler."""

from benchmark.counts.flops import train_step
from benchmark.counts.roofline import mfu_percent

LAYER, SOURCE, MOVES = "model step", "host_clock", "train_step_ms"


def read(run):
    flops = sum(train_step(run.config, **u["shape"]) for u in run.units)
    return mfu_percent(flops, run.elapsed_s)
