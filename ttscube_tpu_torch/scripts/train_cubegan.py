"""The Cubegan trainer of the port: counterpart of `scripts/train_cubegan.py`, with the
same flags and the same files.

    python -m ttscube_tpu_torch.scripts.train_cubegan --train-folder corpus/train \
        --dev-folder corpus/dev --output-base data/cubegan [--device cpu]

It writes `{base}.yaml` and `{base}.encodings`, trains with one GAN step per batch,
saves `{base}.best`, `{base}.last` and `{base}.opt.last` by the JAX trainer's rules,
synthesizes the devset to `generated_files/free/` every `--epoch-generation` epochs
(0: never), and with `--resume` restores the whole state from `{base}.opt.last`. The
files are the JAX package's: either package resumes the other's run. Training runs on
the card unless `--device cpu`. `--compute-dtype bfloat16` runs the generator's and
the discriminators' convs with bf16 operands (weights, grads and the optimizer state
stay fp32); `--fused-tail-train` is fp32 only (its backward kernel, B2, has no bf16
form), so the two together are refused. Not ported yet: LM conditioning (`--lm`,
A11.2) and a device mesh (`--mesh-data`/`--mesh-model`, A9).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from argparse import ArgumentParser


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch Cubegan trainer")
    p.add_argument("--output-base", dest="output_base", default="data/cubegan")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--train-folder", dest="train_folder", default="data/processed/train")
    p.add_argument("--dev-folder", dest="dev_folder", default="data/processed/dev")
    p.add_argument("--sample-rate", dest="sample_rate", type=int, default=24000)
    p.add_argument("--hop-size", dest="hop_size", type=int, default=240)
    p.add_argument("--lr", dest="lr", type=float, default=2e-4)
    p.add_argument("--epoch-generation", dest="epoch_generation", type=int, default=10,
                   help="synthesize the devset every N epochs (0 = never)")
    p.add_argument("--generation-limit", dest="generation_limit", type=int, default=-1)
    p.add_argument("--lm", dest="lm", default=None,
                   help="conditioning: fasttext:<LANG> or hf:<model> (not ported yet)")
    p.add_argument("--max-epochs", dest="max_epochs", type=int, default=-1)
    p.add_argument("--max-steps", dest="max_steps", type=int, default=-1)
    p.add_argument("--mesh-data", dest="mesh_data", type=int, default=1)
    p.add_argument("--mesh-model", dest="mesh_model", type=int, default=1)
    p.add_argument("--opt-save-every", dest="opt_save_every", type=int, default=1,
                   help="epochs between whole-state .opt.last saves (default 1)")
    p.add_argument("--fused-tail-train", dest="fused_tail_train", action="store_true",
                   help="the generator's last stage through the fused kernels: forward "
                        "B1, backward B2 (fp32)")
    p.add_argument("--compute-dtype", dest="compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the convs' operand type in the generator and the discriminators "
                        "(weights and optimizer state stay fp32)")
    p.add_argument("--no-defer-best-saves", dest="defer_best_saves", action="store_false",
                   default=True, help="write .best on every improving epoch (default: "
                   "keep it on the device until the next --opt-save-every save)")
    p.add_argument("--no-cache-batches", dest="cache_batches", action="store_false",
                   default=True, help="collate every batch at every step instead of "
                   "keeping the collated batches on the device")
    p.add_argument("--resume", dest="resume", action="store_true")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to train on the CPU (default: the card)")
    return p


def parse_args(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.fused_tail_train and args.compute_dtype != "float32":
        p.error(f"--fused-tail-train with --compute-dtype {args.compute_dtype}: the fused "
                "tail's backward kernel (B2) is fp32 only; drop --fused-tail-train for a "
                "bf16 run")
    return args


def _refuse_unported(args) -> None:
    if args.lm:
        raise NotImplementedError(f"--lm {args.lm} is not ported yet (ROADMAP.md A11.2: "
                                  "HF and fastText conditioning)")
    if args.mesh_data * args.mesh_model > 1:
        raise NotImplementedError("--mesh-data/--mesh-model above 1 are not ported yet "
                                  "(ROADMAP.md A9: multi-GPU)")


def main(argv=None):
    """Train as the flags say; returns the final TrainState."""
    args = parse_args(argv)
    _refuse_unported(args)

    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.models.cubegan import (Cubegan, CubeganConfig,
                                                  create_train_state, train_step, val_step)
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.train.loop import train
    from ttscube_tpu_torch.train.runtime import cubegan_synthesize_dataset
    from ttscube_tpu_torch.utils.checkpoint import save_config

    device = resolve_device(args.device)
    save_config(args.output_base, {"sample_rate": args.sample_rate,
                                   "hop_size": args.hop_size, "conditioning": args.lm})
    sys.stdout.write("=================Config=================\n")
    with open(args.output_base + ".yaml") as f:
        sys.stdout.write(f.read())
    sys.stdout.write("========================================\n\n")

    trainset = CubeganDataset(args.train_folder, hop_size=args.hop_size,
                              sample_rate=args.sample_rate)
    devset = CubeganDataset(args.dev_folder, hop_size=args.hop_size,
                            sample_rate=args.sample_rate)
    sys.stdout.write(f"train={len(trainset)} dev={len(devset)} examples\n")

    enc_path = args.output_base + ".encodings"
    if not (os.path.exists(enc_path) and args.resume):
        computed = CubeganEncodings()
        computed.compute(trainset)
        computed.save(enc_path)
    # the config is built from the encodings as the file holds them (max_pitch rounded
    # to an int), so that a fresh run, a resumed run and the served model agree; the
    # JAX trainer takes the unrounded max_pitch on a fresh run only
    encodings = CubeganEncodings(enc_path)

    cfg = CubeganConfig(
        languasito=LanguasitoConfig(
            num_phones=len(encodings.phon2int), num_speakers=len(encodings.speaker2int),
            max_pitch=encodings.max_pitch, max_duration=encodings.max_duration),
        lr=args.lr, sample_rate=args.sample_rate, hop_size=args.hop_size)
    cfg = dataclasses.replace(
        cfg, hifigan=dataclasses.replace(cfg.hifigan, fused_tail_train=args.fused_tail_train,
                                         compute_dtype=args.compute_dtype),
        disc_compute_dtype=args.compute_dtype)
    model = init_random(Cubegan(cfg, train=True), seed=0).to(device)
    state = create_train_state(model, seed=0)
    collate = CubeganCollate(encodings, hop=args.hop_size)

    def on_epoch_end(epoch, st):
        cubegan_synthesize_dataset(st.model, devset, collate, "generated_files/free/",
                                   limit=args.generation_limit)

    return train(state=state, train_step=train_step, val_step=val_step,
                 trainset=trainset, devset=devset, collate=collate,
                 batch_size=args.batch_size, output_base=args.output_base,
                 selection_metric="loss_mel", device=device, max_epochs=args.max_epochs,
                 max_steps=args.max_steps, resume=args.resume,
                 on_epoch_end=on_epoch_end if args.epoch_generation > 0 else None,
                 epoch_generation=max(args.epoch_generation, 1),
                 opt_save_every=args.opt_save_every,
                 defer_best_saves=args.defer_best_saves,
                 cache_batches=args.cache_batches)


if __name__ == "__main__":
    main()
