"""The Textcoder trainer of the port: counterpart of `scripts/train_textcoder.py`, with
the same flags and the same files.

    python -m ttscube_tpu_torch.scripts.train_textcoder --train-folder data/processed/train \\
        --dev-folder data/processed/dev --output-base data/textcoder [--pframes 3] \\
        [--device cpu]

It writes `{base}.encodings` (computed from the train set, or read back with
`--resume`) and `{base}.yaml` (sample_rate, hop_size, pframes), and trains
`CubenetTextcoder` through `train/loop.py` with AdamW at lr / (1 + 1e-5 · step),
selecting on the dev loss (`.best`, `.last`, `.opt.last`, the last holding the
PostNet's running averages). `--resume` restores the whole state from
`{base}.opt.last`. The files are the JAX package's: either package resumes the other's
run. Training runs on the card unless `--device cpu`.
"""

from __future__ import annotations

from argparse import ArgumentParser


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch textcoder trainer")
    p.add_argument("--output-base", dest="output_base", default="data/textcoder")
    p.add_argument("--train-folder", dest="train_folder", default="data/processed/train")
    p.add_argument("--dev-folder", dest="dev_folder", default="data/processed/dev")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--sample-rate", dest="sample_rate", type=int, default=24000)
    p.add_argument("--hop-size", dest="hop_size", type=int, default=240)
    p.add_argument("--pframes", dest="pframes", type=int, default=3)
    p.add_argument("--lr", dest="lr", type=float, default=2e-4)
    p.add_argument("--max-epochs", dest="max_epochs", type=int, default=-1)
    p.add_argument("--max-steps", dest="max_steps", type=int, default=-1)
    p.add_argument("--cache-batches", dest="cache_batches", action="store_true",
                   default=False, help="collate every train and dev batch once and keep "
                   "them on the device (composition frozen, order shuffled per epoch)")
    p.add_argument("--resume", dest="resume", action="store_true")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to train on the CPU (default: the card)")
    return p


def main(argv=None):
    """Train as the flags say; returns the final SimpleState (train/states.py)."""
    import os

    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import TextcoderCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import TextcoderEncodings
    from ttscube_tpu_torch.models.textcoder import CubenetTextcoder, TextcoderConfig
    from ttscube_tpu_torch.train.loop import train
    from ttscube_tpu_torch.train.states import (create_textcoder_state, textcoder_train_step,
                                                textcoder_val_step)
    from ttscube_tpu_torch.utils.checkpoint import save_config

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    trainset = CubeganDataset(args.train_folder, hop_size=args.hop_size,
                              sample_rate=args.sample_rate)
    devset = CubeganDataset(args.dev_folder, hop_size=args.hop_size,
                            sample_rate=args.sample_rate)
    enc_path = args.output_base + ".encodings"
    encodings = TextcoderEncodings()
    if os.path.exists(enc_path) and args.resume:
        encodings.load(enc_path)
    else:
        encodings.compute(trainset)
        encodings.save(enc_path)
    save_config(args.output_base, {"sample_rate": args.sample_rate,
                                   "hop_size": args.hop_size, "pframes": args.pframes})

    cfg = TextcoderConfig(num_phones=len(encodings.phon2int),
                          num_speakers=len(encodings.speaker2int),
                          max_pitch=int(encodings.max_pitch),
                          max_duration=int(encodings.max_duration),
                          pframes=args.pframes, lr=args.lr)
    model = init_random(CubenetTextcoder(cfg), 0).to(device)
    state = create_textcoder_state(model, lr=args.lr)
    return train(state=state, train_step=textcoder_train_step, val_step=textcoder_val_step,
                 trainset=trainset, devset=devset,
                 collate=TextcoderCollate(encodings, hop=args.hop_size),
                 batch_size=args.batch_size, output_base=args.output_base,
                 selection_metric="loss", device=device, max_epochs=args.max_epochs,
                 max_steps=args.max_steps, resume=args.resume,
                 cache_batches=args.cache_batches)


if __name__ == "__main__":
    main()
