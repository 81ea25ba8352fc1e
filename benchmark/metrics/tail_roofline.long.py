"""Kernel B1's share of its roofline in synthesis: the least time its work needs on
the card (operations at the bf16 peak with bf16 storage, else fp32's; or bytes at the
memory's rate, whichever is larger), over the device time of its launches in the traced
slice. Its work is the generator's last stage over each call's frames: the whole
utterance, or each window of `chunk_frames` + 2 × `halo_frames` frames."""

from benchmark.readers import tail_synthesis_roofline

LAYER, SOURCE, MOVES = "kernels", "device_trace", "synth_long_audio_s_per_s"
KERNELS = ("tail_kernel",)


def read(run):
    return tail_synthesis_roofline(run, KERNELS)
