"""The dual-rate WaveRNN vocoder trainer of the port: counterpart of
`scripts/train_vocoder.py`, with the same flags (and `--cache-dir`, `--device`) and the
same files.

    python -m ttscube_tpu_torch.scripts.train_vocoder --train-folder data/wav-train \\
        --dev-folder data/wav-dev --output-base data/vocoder [--output mol] [--device cpu]

It writes `{base}.yaml` (the rates, hop, head and widths) and trains `CubenetVocoder`
(2 GRU layers of 512 at 24 kHz and at 2.4 kHz by default, crops of `--max-segment`
samples) through `train/loop.py` with the global-norm clip at 5 and AdamW at
1e-4 / (1 + 5e-5 · step), selecting on the dev loss (`.best`, `.last`, `.opt.last`).
At every epoch's end it keeps each net's parameters of its best dev loss as
`{base}.lr.best` and `{base}.hr.best`. The features of each wav are computed on the
training device (the mel in fp64) and cached in `--cache-dir`. The files are the JAX package's. Training runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

from argparse import ArgumentParser


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch vocoder trainer")
    p.add_argument("--output-base", dest="output_base", default="data/vocoder")
    p.add_argument("--train-folder", dest="train_folder", default="data/wav-train")
    p.add_argument("--dev-folder", dest="dev_folder", default="data/wav-dev")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--sample-rate", dest="sample_rate", type=int, default=24000)
    p.add_argument("--sample-rate-low", dest="sample_rate_low", type=int, default=2400)
    p.add_argument("--hop-size", dest="hop_size", type=int, default=240)
    p.add_argument("--max-segment", dest="max_segment", type=int, default=24000)
    p.add_argument("--layers-lr", dest="layers_lr", type=int, default=2)
    p.add_argument("--size-lr", dest="size_lr", type=int, default=512)
    p.add_argument("--layers-hr", dest="layers_hr", type=int, default=2)
    p.add_argument("--size-hr", dest="size_hr", type=int, default=512)
    p.add_argument("--output", dest="output", default="mol",
                   choices=["mol", "gm", "beta", "mulaw", "raw"])
    p.add_argument("--lr", dest="lr", type=float, default=1e-4)
    p.add_argument("--max-epochs", dest="max_epochs", type=int, default=-1)
    p.add_argument("--max-steps", dest="max_steps", type=int, default=-1)
    p.add_argument("--cache-batches", dest="cache_batches", action="store_true",
                   default=False, help="collate every train and dev batch once and keep "
                   "them on the device (composition frozen, order shuffled per epoch)")
    p.add_argument("--cache-dir", dest="cache_dir", default="data/cache",
                   help="where each wav's features are cached")
    p.add_argument("--resume", dest="resume", action="store_true")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to train on the CPU (default: the card)")
    return p


def main(argv=None):
    """Train as the flags say; returns the final SimpleState (train/states.py)."""
    import sys

    import numpy as np

    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import VocoderCollate
    from ttscube_tpu_torch.data.datasets import VocoderDataset, batch_iterator
    from ttscube_tpu_torch.models.cubegan import batch_to_torch
    from ttscube_tpu_torch.models.wavernn import CubenetVocoder, VocoderConfig
    from ttscube_tpu_torch.train.loop import train
    from ttscube_tpu_torch.train.states import (create_vocoder_state, vocoder_train_step,
                                                vocoder_val_step)
    from ttscube_tpu_torch.utils.checkpoint import save_config, save_params

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = VocoderConfig(num_layers_lr=args.layers_lr, layer_size_lr=args.size_lr,
                        num_layers_hr=args.layers_hr, layer_size_hr=args.size_hr,
                        upsample=args.hop_size,  # hr samples per mel frame
                        upsample_low=args.sample_rate // args.sample_rate_low,
                        output=args.output, lr=args.lr)
    save_config(args.output_base, {
        "sample_rate": args.sample_rate, "sample_rate_low": args.sample_rate_low,
        "hop_size": args.hop_size, "output": args.output,
        "layers_lr": args.layers_lr, "size_lr": args.size_lr,
        "layers_hr": args.layers_hr, "size_hr": args.size_hr})
    data = dict(target_sample_rate=args.sample_rate, lowres_sample_rate=args.sample_rate_low,
                max_segment_size=args.max_segment, hop_size=args.hop_size,
                cache_dir=args.cache_dir, device=device)
    trainset = VocoderDataset(args.train_folder, **data)
    devset = VocoderDataset(args.dev_folder, random_start=False, **data)
    collate = VocoderCollate()
    state = create_vocoder_state(init_random(CubenetVocoder(cfg), 0).to(device))
    best = {"lr": float("inf"), "hr": float("inf")}

    def on_epoch_end(epoch, st):
        losses = [vocoder_val_step(st, batch_to_torch(b, device)) for b in
                  batch_iterator(devset, args.batch_size, collate, shuffle=False)]
        if not losses:
            return
        for k in ("lr", "hr"):
            v = float(np.mean([float(l[k]) for l in losses]))
            if v < best[k]:
                best[k] = v
                save_params(f"{args.output_base}.{k}.best", st.model.get_submodule(k))
                sys.stdout.write(f"\tStored {args.output_base}.{k}.best ({k}={v:.4f})\n")

    return train(state=state, train_step=vocoder_train_step, val_step=vocoder_val_step,
                 trainset=trainset, devset=devset, collate=collate,
                 batch_size=args.batch_size, output_base=args.output_base,
                 selection_metric="loss", device=device, max_epochs=args.max_epochs,
                 max_steps=args.max_steps, resume=args.resume,
                 on_epoch_end=on_epoch_end, epoch_generation=1,
                 cache_batches=args.cache_batches)


if __name__ == "__main__":
    main()
