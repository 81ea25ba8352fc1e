"""Kernel B2's share of its roofline in training: the least time its work needs on the
card (fp32 operations on the faster of the fp32 cores and 3xTF32, or bytes at the
memory's rate, whichever is larger), over the device time of its launches in the traced
slice. Its work is the last stage's backward over the crop of each step."""

from benchmark.counts.flops import tail_grad
from benchmark.counts.roofline import bound_ms

LAYER, SOURCE, MOVES = "kernels", "device_trace", "train_step_ms"
KERNELS = ("tail_grad_kernel",)


def read(run):
    ms = run.trace.kernel_ms(KERNELS)
    if ms is None:
        return None
    c = run.config
    crop = c["training"]["crop_frames"]
    bound = sum(bound_ms(*tail_grad(c, u["shape"]["batch"], min(crop, u["shape"]["frames"])),
                         "fp32") for u in run.sliced)
    return 100.0 * bound / ms
