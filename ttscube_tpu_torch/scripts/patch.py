"""Regenerate the `.pitch` files of a processed corpus folder: the port's copy of
`scripts/patch.py`, with the same flags and the same files, and no JAX.

    python -m ttscube_tpu_torch.scripts.patch --folder data/processed/train \
        [--sample-rate 24000] [--hop-size 240]

Each `{name}.wav` is read at the sample rate and its RAPT pitch (`dsp/pitch.rapt_pitch`,
60-400 Hz) written to `{name}.pitch` with `np.save`. Host work: no device is touched.
"""

import os
from argparse import ArgumentParser

import numpy as np


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch .pitch regeneration")
    p.add_argument("--folder", default="data/processed/train")
    p.add_argument("--sample-rate", type=int, default=24000)
    p.add_argument("--hop-size", type=int, default=240)
    return p


def main(argv=None) -> list:
    """Rewrites every `.pitch` under `--folder`; returns the bases it wrote."""
    from ttscube_tpu_torch.dsp.pitch import rapt_pitch
    from ttscube_tpu_torch.utils.wavio import read_wav

    args = parser().parse_args(argv)
    done = []
    for f in sorted(os.listdir(args.folder)):
        if not f.endswith(".wav"):
            continue
        base = os.path.join(args.folder, f[:-4])
        wav, _ = read_wav(base + ".wav", target_sr=args.sample_rate)
        pitch = rapt_pitch(wav, args.sample_rate, args.hop_size, 60.0, 400.0)
        with open(base + ".pitch", "wb") as out:
            np.save(out, pitch)
        print(base)
        done.append(base)
    return done


if __name__ == "__main__":
    main()
