"""MFA TextGrid corpus importer of the port: counterpart of `scripts/import_textgrid.py`,
with the same flags and the same files, and no JAX.

    python -m ttscube_tpu_torch.scripts.import_textgrid --input-folder aligned/ \
        [--original-text book.txt] [--device cpu]

Input: a folder tree of {name}.TextGrid and {name}.wav pairs (tiers: words, phones, the
utterance's text); optionally the source book's text, for paragraph context. Output:
{train,dev}-output/{id}.{wav,mgc,pitch,json,png}; the mel runs on the card unless
`--device cpu`.
"""

import datetime
import os
from argparse import ArgumentParser


def _get_all_files(folder):
    out = []
    for root, _, files in os.walk(folder):
        for f in files:
            if f.lower().endswith(".textgrid"):
                base = os.path.join(root, f)[: -len(".TextGrid")]
                if os.path.exists(base + ".wav"):
                    out.append(base)
    return sorted(out)


def parser() -> ArgumentParser:
    p = ArgumentParser(description="ttscube_tpu_torch TextGrid importer")
    p.add_argument("--input-folder", dest="input_folder", required=True)
    p.add_argument("--dev-ratio", dest="dev_ratio", type=float, default=0.001)
    p.add_argument("--speaker", dest="speaker", default="none")
    p.add_argument("--sample-rate", dest="sample_rate", type=int, default=24000)
    p.add_argument("--hop-size", dest="hop_size", type=int, default=240)
    p.add_argument("--prefix", dest="prefix", default="FILE")
    p.add_argument("--original-text", dest="original_text", default=None)
    p.add_argument("--train-output", dest="train_output", default="data/processed/train/")
    p.add_argument("--dev-output", dest="dev_output", default="data/processed/dev/")
    p.add_argument("--device", dest="device", default=None,
                   help="cpu to compute the mel on the CPU (default: the card)")
    return p


def main(argv=None) -> None:
    from ttscube_tpu_torch.data.importers import (fetch_context, import_audio,
                                                  merge_textgrid, scrub_uppercase_phones,
                                                  split_train_dev)
    from ttscube_tpu_torch.data.text import SimpleTokenizer
    from ttscube_tpu_torch.data.textgrid import parse_textgrid

    args = parser().parse_args(argv)
    tokenizer = SimpleTokenizer()
    all_files = _get_all_files(args.input_folder)
    print(f"Found {len(all_files)} aligned files")
    dataset, total_time = [], 0
    for base in all_files:
        tiers = parse_textgrid(base + ".TextGrid")
        if len(tiers) < 3 or not tiers[2]:
            continue
        orig_text = " " + tiers[2][0]["text"]
        norm_words = []
        if tiers[0] and tiers[0][0]["text"] not in ("<eps>", ""):
            norm_words.append({"text": " ", "start": 0.0, "stop": 0.0})
        norm_words += tiers[0]
        tok_words = tokenizer(orig_text)
        hybrid, phon2word, frame2phon = merge_textgrid(norm_words, tiers[1], tok_words)
        total_time += len(frame2phon) * 10
        dataset.append({
            "orig_start": 0,
            "orig_end": len(frame2phon) * 10,
            "orig_filename": os.path.basename(base),
            "orig_text": orig_text,
            "phones": hybrid,
            "words": [w.word for w in tok_words],
            "phon2word": phon2word,
            "frame2phon": frame2phon,
            "speaker": args.speaker,
            "left_context": "",
            "right_context": "",
        })

    trainset, devset = split_train_dev(dataset, args.dev_ratio)
    print("Found {0} valid sentences, with a total audio time of {1}.".format(
        len(dataset), datetime.timedelta(seconds=total_time / 1000)))
    print("Trainset will contain {0} examples and devset {1} examples".format(
        len(trainset), len(devset)))
    if args.original_text:
        print("Fetching context")
        fetch_context(trainset, args.original_text)
        fetch_context(devset, args.original_text)
    trainset = [scrub_uppercase_phones(x) for x in trainset]
    devset = [scrub_uppercase_phones(x) for x in devset]

    # TextGrid wavs are per-utterance; segments address the whole file
    for name, part, out in (("trainset", trainset, args.train_output),
                            ("devset", devset, args.dev_output)):
        print(f"Processing {name}")
        import_audio(part, out, args.input_folder, args.sample_rate, args.hop_size,
                     args.prefix, device=args.device)


if __name__ == "__main__":
    main()
