"""Word-level G2P CLI of the port: counterpart of `scripts/g2p.py`, with the same flags
and the same files (`models/g2p.py`).

    train:      --train-file F --dev-file F --store BASE [--patience N] [--load BASE]
    evaluate:   --test-file F --load BASE            → word accuracy
    transcribe: --transcribe-file F --output-file F --model BASE

    python -m ttscube_tpu_torch.scripts.g2p --train-file lex.train --dev-file lex.dev \
        --store data/g2p [--device cpu]

Training runs Adam (lr 1e-3, optax's `adam`: betas 0.9 / 0.999, eps 1e-8, no weight
decay) on teacher-forced batches in the order of a shuffle per epoch, scores word
accuracy on the dev set after each epoch, writes `{store}.best` when it improves and
`{store}.last` every epoch, and stops after `--patience` epochs without a gain (or at
`--max-epochs`). Everything runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import random
import sys
from argparse import ArgumentParser


def train_g2p(args, device):
    """The training run of the parsed flags; returns the trained G2P."""
    import torch

    from ttscube_tpu_torch.models.g2p import G2P, G2PDataset, seq2seq_loss
    from ttscube_tpu_torch.train.states import SimpleState, apply_step, trainable
    from ttscube_tpu_torch.utils.checkpoint import save_params

    train = G2PDataset(args.train_file)
    dev = G2PDataset(args.dev_file)
    g2p = G2P(device)
    if args.model_path:
        g2p.load(args.model_path, load_last=True)
        best_acc = g2p.evaluate(dev)
        sys.stdout.write(f"Setting baseline accuracy to {best_acc:.4f}\n")
    else:
        g2p.update_encodings(train)
        g2p.initialize_network()
        g2p.save(args.output_path)
        best_acc = 0.0

    state = SimpleState(g2p.model, torch.optim.Adam(trainable(g2p.model), lr=args.lr,
                                                    betas=(0.9, 0.999), eps=1e-8))
    patience_left = args.patience
    epoch = 1
    save_params(args.output_path + ".last", g2p.model)
    while patience_left > 0:
        patience_left -= 1
        sys.stdout.write(f"\n\nStarting epoch {epoch}\n")
        random.shuffle(train.examples)
        losses = []
        for i in range(0, len(train.examples), args.batch_size):
            batch = train.examples[i: i + args.batch_size]
            x = torch.from_numpy(g2p.encode_words([w for w, _ in batch])).to(device)
            y = torch.from_numpy(g2p.encode_labels([t for _, t in batch])).to(device)
            g2p.model.train()
            loss = seq2seq_loss(g2p.model(x, y)[0], y)
            apply_step(state, loss)
            losses.append(loss.detach())
        avg = float(torch.stack(losses).mean()) if losses else 0.0
        sys.stdout.write(f"\tAvg loss: {avg:.6f}\n")
        acc = g2p.evaluate(dev)
        sys.stdout.write(f"\tDevset accuracy: {acc:.4f}\n")
        if acc > best_acc:
            best_acc = acc
            sys.stdout.write(f"\tStoring {args.output_path}.best\n")
            save_params(args.output_path + ".best", g2p.model)
            patience_left = args.patience
        save_params(args.output_path + ".last", g2p.model)
        epoch += 1
        if args.max_epochs != -1 and epoch > args.max_epochs:
            break
    return g2p


def _eval(args, device):
    from ttscube_tpu_torch.models.g2p import G2P, G2PDataset

    g2p = G2P(device)
    g2p.load(args.model_path)
    acc = g2p.evaluate(G2PDataset(args.test_file))
    sys.stdout.write(f"Word accuracy rate is {acc * 100:.2f}%\n")


def _transcribe(args, device):
    from ttscube_tpu_torch.models.g2p import G2P

    g2p = G2P(device)
    g2p.load(args.model_base)
    with open(args.transcribe_file) as f:
        lines = f.readlines()
    with open(args.output_file, "w") as f:
        for i in range(0, len(lines), 128):
            words = [line.split("\t")[0].strip() for line in lines[i: i + 128]]
            for w, t in zip(words, g2p.transcribe(words)):
                f.write(f"{w}\t{' '.join(t)}\n")


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch word-level G2P")
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--train-file", dest="train_file")
    p.add_argument("--dev-file", dest="dev_file")
    p.add_argument("--store", dest="output_path")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--load", dest="model_path")
    p.add_argument("--test-file", dest="test_file")
    p.add_argument("--transcribe-file", dest="transcribe_file")
    p.add_argument("--output-file", dest="output_file")
    p.add_argument("--model", dest="model_base")
    p.add_argument("--max-epochs", dest="max_epochs", type=int, default=-1)
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to run on the CPU (default: the card)")
    return p


def main(argv=None):
    """Train, evaluate or transcribe as the flags say (the mode as in the JAX script);
    returns the trained G2P when training."""
    from ttscube_tpu_torch import resolve_device

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.test_file and args.model_path:
        return _eval(args, device)
    if args.transcribe_file:
        return _transcribe(args, device)
    return train_g2p(args, device)


if __name__ == "__main__":
    main()
