"""Legacy corpus importer of the port: counterpart of `scripts/import_corpus.py`, with the
same flags and the same files, and no JAX.

    python -m ttscube_tpu_torch.scripts.import_corpus --train-folder raw/train \
        [--dev-folder raw/dev] [--g2p data/g2p] [--device cpu]

Folders of {name}.{txt,wav,phs} triples → {train,dev}-output/{name}.{txt,lab,mgc,f0},
the HTK .phs alignment merged into per-frame labels; the mel (hop 256) runs on the card
unless `--device cpu`. With `--g2p BASE` the .lab transcriptions come from the word G2P
model at BASE (`models/g2p.py`, as `scripts/g2p.py` trains it; on the same device as
the mel) in place of the lower-cased characters.
"""

import os
import shutil
import sys
from argparse import ArgumentParser
from os.path import exists, join

import numpy as np


def _scan(folder, need_phs=True):
    out = []
    if folder is None:
        return out
    for f in sorted(os.listdir(folder)):
        if not os.path.isfile(join(folder, f)):
            continue
        base = f[:-4]
        need = [base + ".txt", base + ".wav"] + ([base + ".phs"] if need_phs else [])
        if all(exists(join(folder, n)) for n in need) and base not in out:
            out.append(base)
    return out


def _process(files, base_folder, out_folder, args, g2p=None, counter_start=0):
    import torch

    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.data.importers import create_lab_file, highpass_filter
    from ttscube_tpu_torch.dsp.mel import MelSpec, feature_mel_config
    from ttscube_tpu_torch.dsp.pitch import rapt_pitch
    from ttscube_tpu_torch.utils.wavio import read_wav

    dev = resolve_device(args.device)
    os.makedirs(out_folder, exist_ok=True)
    mel = MelSpec(feature_mel_config(args.target_sample_rate, args.mgc_order,
                                     hop_length=256))
    total = counter_start
    for i, base in enumerate(files):
        total += 1
        sys.stdout.write(f"\r\tprocessing file {i + 1}/{len(files)}")
        sys.stdout.flush()
        tgt = base if args.prefix is None else f"{args.prefix}_{total:05d}"
        shutil.copyfile(join(base_folder, base + ".txt"), join(out_folder, tgt + ".txt"))
        data, _ = read_wav(join(base_folder, base + ".wav"),
                           target_sr=args.target_sample_rate)
        f0 = rapt_pitch(data, args.target_sample_rate, 256, 30.0, 500.0)
        peak = float(np.max(np.abs(data))) or 1.0
        data = data / peak * 0.999
        data = highpass_filter(data, args.target_sample_rate)
        with torch.no_grad():  # fp64, as data/importers.py `import_audio`
            mgc = mel(torch.from_numpy(np.asarray(data, np.float32)).to(dev),
                      torch.float64).cpu().numpy()
        phs = join(base_folder, base + ".phs")
        if exists(phs):
            if not create_lab_file(join(base_folder, base + ".txt"), phs, mgc.shape[0],
                                   join(out_folder, tgt + ".lab"),
                                   speaker_name=args.speaker, g2p=g2p, lang=args.lang,
                                   emotion=args.emotion):
                continue
        np.save(join(out_folder, tgt + ".mgc"), mgc)
        np.save(join(out_folder, tgt + ".f0"), f0)
    sys.stdout.write("\n")
    return total


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch legacy corpus importer")
    p.add_argument("--train-folder", dest="train_folder", required=True)
    p.add_argument("--dev-folder", dest="dev_folder", default=None)
    p.add_argument("--target-sample-rate", dest="target_sample_rate", type=int,
                   default=16000)
    p.add_argument("--mgc-order", dest="mgc_order", type=int, default=80)
    p.add_argument("--speaker", dest="speaker", default=None)
    p.add_argument("--g2p", dest="g2p", default=None,
                   help="word G2P model base (scripts/g2p.py --store)")
    p.add_argument("--prefix", dest="prefix", default=None)
    p.add_argument("--lang", dest="lang", default="none")
    p.add_argument("--emotion", dest="emotion", default="neutral")
    p.add_argument("--train-output", dest="train_output", default="data/processed/train")
    p.add_argument("--dev-output", dest="dev_output", default="data/processed/dev")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to compute the mel on the CPU (default: the card)")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    g2p = None
    if args.g2p:
        from ttscube_tpu_torch.models.g2p import G2P

        g2p = G2P(args.device)
        g2p.load(args.g2p)
    train_files = _scan(args.train_folder)
    dev_files = _scan(args.dev_folder, need_phs=False)
    sys.stdout.write(f"found {len(train_files)} training / {len(dev_files)} dev files\n")
    n = _process(train_files, args.train_folder, args.train_output, args, g2p)
    _process(dev_files, args.dev_folder, args.dev_output, args, g2p, counter_start=n)


if __name__ == "__main__":
    main()
