"""Blizzard-2023 corpus importer of the port: counterpart of
`scripts/import_blizzard_2023.py`, with the same flags and the same files, and no JAX.

    python -m ttscube_tpu_torch.scripts.import_blizzard_2023 --input-file corpus/align.txt \
        [--speaker spk] [--device cpu]

Input: a '|'-separated alignment file (file|start|end|text|phones|durs) beside the
chapter wavs. Output: {train,dev}-output/{id}.{wav,mgc,pitch,json,png}. The mel runs on
the card unless `--device cpu` (data/importers.py `import_audio`).
"""

import datetime
import os
from argparse import ArgumentParser


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch Blizzard-2023 importer")
    p.add_argument("--input-file", dest="input_file", required=True)
    p.add_argument("--prev-sentences", dest="prev_sentences", type=int, default=5)
    p.add_argument("--next-sentences", dest="next_sentences", type=int, default=5)
    p.add_argument("--dev-ratio", dest="dev_ratio", type=float, default=0.001)
    p.add_argument("--speaker", dest="speaker", default="none")
    p.add_argument("--sample-rate", dest="sample_rate", type=int, default=24000)
    p.add_argument("--hop-size", dest="hop_size", type=int, default=240)
    p.add_argument("--prefix", dest="prefix", default="FILE")
    p.add_argument("--train-output", dest="train_output", default="data/processed/train/")
    p.add_argument("--dev-output", dest="dev_output", default="data/processed/dev/")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to compute the mel on the CPU (default: the card)")
    return p


def main(argv=None) -> dict:
    """Import as the flags say; returns the seconds of audio and of work, by part."""
    from ttscube_tpu_torch.data.importers import (build_context, correct_alignments,
                                                  import_audio, read_alignment_dataset,
                                                  split_train_dev)

    args = parser().parse_args(argv)
    with open(args.input_file) as f:
        lines = correct_alignments(f.readlines())
    dataset, total_time = read_alignment_dataset(lines, speaker=args.speaker)
    dataset = build_context(dataset, args.prev_sentences, args.next_sentences)
    trainset, devset = split_train_dev(dataset, args.dev_ratio)

    print("Found {0} valid sentences, with a total audio time of {1}.".format(
        len(dataset), datetime.timedelta(seconds=total_time / 1000)))
    print("Trainset will contain {0} examples and devset {1} examples".format(
        len(trainset), len(devset)))
    input_folder = os.path.dirname(os.path.abspath(args.input_file))
    times = {}
    for name, part, out in (("trainset", trainset, args.train_output),
                            ("devset", devset, args.dev_output)):
        print(f"Processing {name}")
        t = import_audio(part, out, input_folder, args.sample_rate, args.hop_size,
                         args.prefix, device=args.device)
        times = {k: times.get(k, 0.0) + v for k, v in t.items()}
    return times


if __name__ == "__main__":
    main()
