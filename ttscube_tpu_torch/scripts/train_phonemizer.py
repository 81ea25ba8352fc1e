"""The phonemizer trainer of the port: counterpart of `scripts/train_phonemizer.py`, with
the same flags and the same files.

    python -m ttscube_tpu_torch.scripts.train_phonemizer --train-file data/phonemizer.train \
        --dev-file data/phonemizer.dev --output-base data/phonemizer \
        [--model-type aligned|m2m] [--device cpu]

It writes `{base}.encodings` (computed from the train set, or read back with
`--resume`), trains with AdamW (lr 2e-4, weight decay 0.01) through `train/loop.py`
selecting on the dev loss (`.best`, `.last`, `.opt.last`), and at every epoch's end
scores PACC/SACC on the dev set and keeps the best parameters of each as `.pacc.best`
and `.sacc.best`. The M2M model (the default, as in the reference) is scored by a
free-running decode. `--resume` restores the whole state from `{base}.opt.last`. The
files are the JAX package's: either package resumes the other's run. Training runs on
the card unless `--device cpu`. `TTSCube` and `export_model` take the aligned model.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch phonemizer trainer")
    p.add_argument("--output-base", dest="output_base", default="data/phonemizer")
    p.add_argument("--train-file", dest="train_file", default="data/phonemizer-train.json")
    p.add_argument("--dev-file", dest="dev_file", default="data/phonemizer-dev.json")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=32)
    p.add_argument("--lr", dest="lr", type=float, default=2e-4)
    p.add_argument("--model-type", dest="model_type", choices=["aligned", "m2m"],
                   default="m2m", help="the reference trains m2m")
    p.add_argument("--max-epochs", dest="max_epochs", type=int, default=-1)
    p.add_argument("--max-steps", dest="max_steps", type=int, default=-1)
    p.add_argument("--cache-batches", dest="cache_batches", action="store_true",
                   default=False, help="collate every train and dev batch once and keep "
                   "them on the device (composition frozen, order shuffled per epoch)")
    p.add_argument("--resume", dest="resume", action="store_true")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to train on the CPU (default: the card)")
    return p


def dev_scores(state, devset, collate, batch_size: int, device):
    """(PACC, SACC): the means over the dev batches of `phonemizer_val_step`'s, or None
    for an empty dev set."""
    import numpy as np

    from ttscube_tpu_torch.data.datasets import batch_iterator
    from ttscube_tpu_torch.models.cubegan import batch_to_torch
    from ttscube_tpu_torch.train.states import phonemizer_val_step

    accs = [phonemizer_val_step(state, batch_to_torch(b, device))
            for b in batch_iterator(devset, batch_size, collate, shuffle=False)]
    if not accs:
        return None
    return (float(np.mean([float(a["pacc"]) for a in accs])),
            float(np.mean([float(a["sacc"]) for a in accs])))


def main(argv=None):
    """Train as the flags say; returns the final SimpleState (train/states.py)."""
    import os

    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import PhonemizerCollate
    from ttscube_tpu_torch.data.datasets import PhonemizerDataset
    from ttscube_tpu_torch.data.encodings import PhonemizerEncodings
    from ttscube_tpu_torch.models.phonemizer import Phonemizer, PhonemizerConfig, PhonemizerM2M
    from ttscube_tpu_torch.train.loop import train
    from ttscube_tpu_torch.train.states import create_phonemizer_state, phonemizer_train_step
    from ttscube_tpu_torch.train.states import phonemizer_val_step
    from ttscube_tpu_torch.utils.checkpoint import save_params

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    trainset = PhonemizerDataset(args.train_file)
    devset = PhonemizerDataset(args.dev_file)
    enc_path = args.output_base + ".encodings"
    encodings = PhonemizerEncodings()
    if os.path.exists(enc_path) and args.resume:
        encodings.load(enc_path)
    else:
        encodings.compute(trainset)
        encodings.save(enc_path)

    cfg = PhonemizerConfig(num_graphemes=len(encodings.graphemes),
                           num_phonemes=len(encodings.phonemes))
    model = (PhonemizerM2M if args.model_type == "m2m" else Phonemizer)(cfg)
    state = create_phonemizer_state(init_random(model, 0).to(device), lr=args.lr)
    collate = PhonemizerCollate(encodings)
    best = {"pacc": -1.0, "sacc": -1.0}

    def on_epoch_end(epoch, st):
        scores = dev_scores(st, devset, collate, args.batch_size, device)
        if scores is None:
            return
        pacc, sacc = scores
        if pacc > best["pacc"]:
            best["pacc"] = pacc
            save_params(args.output_base + ".pacc.best", st.model)
        if sacc > best["sacc"]:
            best["sacc"] = sacc
            save_params(args.output_base + ".sacc.best", st.model)
        sys.stdout.write(f"\tPACC={pacc:.4f} SACC={sacc:.4f}\n")

    return train(state=state, train_step=phonemizer_train_step, val_step=phonemizer_val_step,
                 trainset=trainset, devset=devset, collate=collate,
                 batch_size=args.batch_size, output_base=args.output_base,
                 selection_metric="loss", device=device, max_epochs=args.max_epochs,
                 max_steps=args.max_steps, resume=args.resume, on_epoch_end=on_epoch_end,
                 epoch_generation=1, cache_batches=args.cache_batches)


if __name__ == "__main__":
    main()
