"""Phonemizer training-data importer of the port: counterpart of
`scripts/import_phonemizer_blizzard.py`, with the same flags and the same files.

    python -m ttscube_tpu_torch.scripts.import_phonemizer_blizzard \
        --input-file corpus/align.txt --output-base data/phonemizer

Writes {output-base}.train and .dev: JSON lists with the hybrid transcriptions.
"""

import datetime
import json
from argparse import ArgumentParser


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch phonemizer-data importer")
    p.add_argument("--input-file", dest="input_file", required=True)
    p.add_argument("--dev-ratio", dest="dev_ratio", type=float, default=0.001)
    p.add_argument("--output-base", dest="output_base", required=True)
    return p


def main(argv=None) -> None:
    from ttscube_tpu_torch.data.importers import (merge_alignment, parse_alignment_line,
                                                  split_train_dev)

    args = parser().parse_args(argv)
    dataset, total_time = [], 0
    with open(args.input_file) as f:
        for line in f:
            d = parse_alignment_line(line)
            if d is None or len(d["text"]) != len(d["phon"]) or \
                    len(d["text"]) != len(d["durs"]):
                continue
            hybrid, words, phon2word, _ = merge_alignment(d["text"], d["phon"], d["durs"])
            total_time += sum(d["durs"])
            dataset.append({"orig_text": d["text"], "hybrid": hybrid, "phones": d["phon"],
                            "words": words, "phon2word": phon2word})
    trainset, devset = split_train_dev(dataset, args.dev_ratio)
    print("Found {0} valid sentences, with a total audio time of {1}.".format(
        len(dataset), datetime.timedelta(seconds=total_time / 1000)))
    print("Trainset will contain {0} examples and devset {1} examples".format(
        len(trainset), len(devset)))
    for ext, part in (("train", trainset), ("dev", devset)):
        with open(f"{args.output_base}.{ext}", "w") as f:
            json.dump(part, f)


if __name__ == "__main__":
    main()
