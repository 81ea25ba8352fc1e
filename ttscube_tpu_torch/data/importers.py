"""Corpus import pipeline: counterpart of `ttscube_tpu/data/importers.py`, whole.

Shared logic for the import CLIs (`ttscube_tpu_torch/scripts/import_*.py`): alignment
file parsing, pause redistribution, the char/phone/duration merge into hybrid
transcriptions, ±N-sentence context windows, the train/dev split, the legacy HTK and the
TextGrid paths, and each utterance's files ({id}.{wav,mgc,pitch,json,png}, which the
datasets read). Everything is host numpy but `import_audio`'s mel, which runs on the
card unless the caller asks for the CPU (`dsp/mel.py`). It is computed in fp64 from the
fp32 constants and rounded once: the targets are then the same wherever they are made,
whatever the device's summation order or the process's TF32 settings. (In fp32 the log
amplifies summation noise where the mel energy is small: near the 1e-5 floor the JAX
importer's XLA mel sits up to 2.6e-3 from the fp64 value on the demo corpus,
tests/test_torch_importers.py.)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ttscube_tpu_torch.data.text import SimpleTokenizer

FRAME_UNITS = 10  # alignment duration units per frame (10 ms at ms-granularity)
PAUSE_UNITS = 130  # inter-utterance pause inserted by the aligner


def merge_alignment(text: str, phon: list[str], durs: list[int]):
    """Char/phone/duration merge → (hybrid, words, phon2word, frame2phon).

    Reference ``_merge`` (import_blizzard_2023.py:19-70): non-alpha chars keep
    themselves as 'hybrid phones'; '_' on an alpha char is a deletion and is dropped;
    frame2phon assigns each 10-unit frame to its phone, skipping zero-duration phones.
    """
    tokenizer = SimpleTokenizer()
    words = [w.word for w in tokenizer(text)]
    hybrid, phon2word, dd = [], [], []
    windex = cindex = 0
    for t, p, d in zip(text, phon, durs):
        hybrid.append(p if t.isalpha() else t)
        phon2word.append(windex)
        cindex += 1
        if windex < len(words) and cindex == len(words[windex]):
            cindex = 0
            windex += 1
        dd.append(d)

    nh, nd, np2w = [], [], []
    for t, h, d, p2w in zip(text, hybrid, dd, phon2word):
        if t.isalpha() and t != " " and h == "_":
            continue  # deletion
        nh.append(h)
        nd.append(d)
        np2w.append(p2w)

    total = sum(nd)
    pend = np.cumsum(nd)
    frame2phon = []
    cphon = 0
    for frame in range(total // FRAME_UNITS):
        while cphon < len(pend) and frame * FRAME_UNITS >= pend[cphon]:
            cphon += 1
            while cphon < len(nd) and nd[cphon] == 0:
                cphon += 1
        frame2phon.append(min(cphon, len(nh) - 1))
    return nh, words, np2w, frame2phon


def parse_alignment_line(line: str):
    """'file|start|end|text|phones|durs' → dict or None (skips {tags})."""
    parts = line.strip().split("|")
    if len(parts) < 6:
        return None
    if "{" in parts[3] and "}" in parts[3]:
        return None
    return {
        "orig_fn": parts[0],
        "start": int(parts[1]),
        "end": int(parts[2]),
        "text": parts[3],
        "phon": parts[4].split(" "),
        "durs": [int(x) for x in parts[5].strip().split(" ")],
    }


def correct_alignments(lines: list[str]) -> list[str]:
    """Boundary correction: redistribute the aligner's fixed 130-unit inter-utterance
    pauses to neighboring utterances (reference ``_correct_alignments`` /
    ``_get_real_alignments`` import_blizzard_2023.py:114-174)."""
    dataset = [d for d in (parse_alignment_line(l) for l in lines) if d is not None]
    out = []
    for i, item in enumerate(dataset):
        new_start, new_end = item["start"], item["end"]
        durs = list(item["durs"])
        if i > 0 and dataset[i - 1]["orig_fn"] == item["orig_fn"]:
            prev_end = dataset[i - 1]["end"] - PAUSE_UNITS
            new_start = prev_end
            durs[0] = item["start"] - prev_end + PAUSE_UNITS
        if i + 1 < len(dataset) and dataset[i + 1]["orig_fn"] == item["orig_fn"]:
            next_start = dataset[i + 1]["start"] + PAUSE_UNITS
            new_end = next_start
            # find which phone carries the trailing pause (reference :128-133)
            j = len(durs) - 1
            for j in range(len(durs) - 1, 0, -1):
                if durs[j] == PAUSE_UNITS:
                    break
            durs[j] = next_start - item["end"] + PAUSE_UNITS
        out.append("|".join([item["orig_fn"], str(new_start), str(new_end),
                             item["text"], " ".join(item["phon"]),
                             " ".join(str(x) for x in durs)]))
    return out


def build_context(dataset: list[dict], prev_sentences: int, next_sentences: int):
    """±N-sentence context windows within the same chapter
    (reference import_blizzard_2023.py:219-232)."""
    for i in range(len(dataset)):
        l_start = max(0, i - prev_sentences)
        l_end = min(len(dataset), i + next_sentences + 1)
        for j in range(l_start, i):
            if dataset[i]["orig_filename"] != dataset[j]["orig_filename"]:
                l_start += 1
        for j in range(l_end, i, 1):
            if dataset[i]["orig_filename"] != dataset[j]["orig_filename"]:
                l_end -= 1
        dataset[i]["left_context"] = " ".join(
            item["orig_text"][1:] for item in dataset[l_start:i])
        dataset[i]["right_context"] = " ".join(
            item["orig_text"][1:] for item in dataset[i + 1 : l_end])
    return dataset


def split_train_dev(dataset: list[dict], dev_ratio: float):
    """Every (1/ratio)-th example goes to dev (reference :235-249)."""
    split = int(1.0 / dev_ratio) if dev_ratio > 0 else 0
    if split == 0:
        return dataset, []
    if split == 1:
        return [], dataset
    train, dev = [], []
    for i, item in enumerate(dataset):
        (dev if (i + 1) % split == 0 else train).append(item)
    return train, dev


def import_audio(dataset: list[dict], output_folder: str, input_folder: str,
                 sample_rate: int = 24000, hop_size: int = 240, prefix: str = "FILE",
                 progress: bool = True, device=None) -> dict:
    """Each utterance's files: its wav segment (peak-normalized to 0.98), log10 mel
    (.mgc, in fp64 on `device`: the card unless the caller asks for the CPU), RAPT pitch
    (.pitch), a PNG of the mel and its JSON. `progress` writes a counter to stdout.
    Returns the seconds of audio written and the seconds spent, by part."""
    import torch

    from ttscube_tpu_torch import resolve_device
    from ttscube_tpu_torch.dsp.mel import MelSpec, feature_mel_config
    from ttscube_tpu_torch.dsp.pitch import rapt_pitch
    from ttscube_tpu_torch.train.runtime import render_spectrogram
    from ttscube_tpu_torch.utils.wavio import read_wav, write_wav

    dev = resolve_device(device)
    os.makedirs(output_folder, exist_ok=True)
    mel_fn = MelSpec(feature_mel_config(sample_rate, hop_length=hop_size))
    times = dict(audio_s=0.0, mel_s=0.0, pitch_s=0.0, png_s=0.0, total_s=0.0)
    t_all = time.perf_counter()
    dataset = sorted(dataset, key=lambda x: x["orig_filename"])
    wav, last_file = None, None
    oms = sample_rate / 1000.0
    for i, item in enumerate(dataset):
        if progress:
            sys.stdout.write(f"\r\t{i + 1}/{len(dataset)}")
            sys.stdout.flush()
        uid = f"{prefix}_{i:08d}"
        item["id"] = uid
        if last_file != item["orig_filename"]:
            wav, _ = read_wav(os.path.join(input_folder, item["orig_filename"] + ".wav"),
                              target_sr=sample_rate)
            last_file = item["orig_filename"]
        seg = wav[int(item["orig_start"] * oms) : int(item["orig_end"] * oms)]
        peak = float(np.max(np.abs(seg))) if len(seg) else 1.0
        seg = seg / (peak or 1.0) * 0.98
        times["audio_s"] += len(seg) / sample_rate
        t = time.perf_counter()
        with torch.no_grad():
            mel = mel_fn(torch.from_numpy(np.asarray(seg, np.float32)).to(dev),
                         torch.float64).cpu().numpy()
        times["mel_s"] += time.perf_counter() - t
        base = os.path.join(output_folder, uid)
        t = time.perf_counter()
        render_spectrogram(mel, base + ".png")
        times["png_s"] += time.perf_counter() - t
        write_wav(base + ".wav", seg, sample_rate)
        with open(base + ".mgc", "wb") as f:
            np.save(f, mel)
        with open(base + ".json", "w") as f:
            json.dump(item, f)
        t = time.perf_counter()
        pitch = rapt_pitch(seg, sample_rate, hop_size, 60.0, 400.0)
        times["pitch_s"] += time.perf_counter() - t
        with open(base + ".pitch", "wb") as f:
            np.save(f, pitch)
    if progress and dataset:
        sys.stdout.write("\n")
    times["total_s"] = time.perf_counter() - t_all
    return times


# -- legacy HTK import path (reference scripts/import_corpus.py) -----------------------


def encode_htk(string: str) -> str:
    """HTK octal re-encoding of non-ASCII strings (reference import_corpus.py:132-180)."""
    out = ""
    for b in bytes(string, "utf-8"):
        out += "\\{0}{1}{2}".format((b // 64) % 8, (b // 8) % 8, b % 8)
    return out


def align_htk(phs_lines: list[str], transcription: list[str], num_frames: int,
              frame_ms: int = 16):
    """DP-align a char/phone transcription to HTK .phs lines ('start stop phone', 100 ns
    units) → per-mel-frame phone indices (reference ``_align`` import_corpus.py:64-129)."""
    s1 = transcription
    s2 = [p.split(" ")[2].strip() for p in phs_lines]
    stop = [int(p.split(" ")[1].strip()) for p in phs_lines]
    a = np.zeros((len(s1) + 1, len(s2) + 1))
    a[:, 0] = np.arange(a.shape[0])
    a[0, :] = np.arange(a.shape[1])
    for i in range(1, a.shape[0]):
        for j in range(1, a.shape[1]):
            c_ph, c_htk = s1[i - 1], s2[j - 1]
            cost = 0 if (c_ph == c_htk or encode_htk(c_ph) == c_htk) else 1
            a[i, j] = cost + min(a[i - 1, j], a[i - 1, j - 1], a[i, j - 1])
    i, j = a.shape[0] - 1, a.shape[1] - 1
    phs2t = {j - 1: i - 1}
    while i != 1 or j != 1:
        if i == 1:
            j -= 1
        elif j == 1:
            i -= 1
        elif a[i - 1, j - 1] <= a[i - 1, j] and a[i - 1, j - 1] <= a[i, j - 1]:
            i -= 1
            j -= 1
        elif a[i - 1, j] < a[i - 1, j - 1] and a[i - 1, j] < a[i, j - 1]:
            i -= 1
        else:
            j -= 1
        phs2t[j - 1] = i - 1

    trans2interval = {}
    for iphs in range(len(phs_lines)):
        if iphs in phs2t:
            trans2interval[phs2t[iphs]] = stop[iphs]
    align = np.full(num_frames, -1, np.int64)
    intervals = []
    start = 0
    for tpos in sorted(trans2interval):
        intervals.append((tpos, start, trans2interval[tpos]))
        start = trans2interval[tpos]
    for m in range(num_frames):
        t = m * frame_ms
        for tpos, s, e in intervals:
            if s / 10000 <= t <= e / 10000:
                align[m] = tpos
                break
        if align[m] == -1:
            align[m] = len(transcription) - 1
    return align


def create_lab_file(txt_file: str, phs_file: str, num_frames: int, lab_file: str,
                    speaker_name: str | None = None, g2p=None, lang: str = "none",
                    emotion: str = "neutral") -> bool:
    """Legacy .lab JSON: {speaker, emotion, text, transcription, aligned, lang}
    (reference ``create_lab_file`` import_corpus.py:183-226)."""
    line = open(txt_file, encoding="utf-8").readline().strip().replace("\t", " ")
    while "  " in line:
        line = line.replace("  ", " ")
    obj: dict = {}
    fname = txt_file.replace("\\", "/").split("/")[-1]
    if speaker_name is not None:
        obj["speaker"] = speaker_name
    elif len(fname.split("_")) != 1:
        obj["speaker"] = fname.split("_")[0]
    else:
        obj["speaker"] = "none"
    obj["emotion"] = emotion
    obj["text"] = line
    if g2p is not None:
        trans = ["<START>"]
        for token in g2p(line):
            for ph in token.transcription:
                trans.append(ph)
        trans.append("<STOP>")
        obj["transcription"] = trans
    else:
        obj["transcription"] = ["<START>"] + [c.lower() for c in line] + ["<STOP>"]
    phs_lines = open(phs_file).readlines()
    aligned = align_htk(phs_lines, obj["transcription"], num_frames)
    obj["aligned"] = aligned.tolist()
    obj["lang"] = lang
    json.dump(obj, open(lab_file, "w", encoding="utf-8"))
    return True


def highpass_filter(y: np.ndarray, sr: int, cutoff_hz: float = 100.0) -> np.ndarray:
    """30th-order butterworth high-pass (reference import_corpus.py:229-233)."""
    from scipy import signal

    sos = signal.butter(30, cutoff_hz, "hp", fs=sr, output="sos")
    return signal.sosfilt(sos, y).astype(np.float32)


# -- TextGrid (MFA) import path (reference scripts/import_textgrid.py) -----------------


def _word_cost(tg_word: dict, token) -> float:
    """Levenshtein substitution cost between an aligner word and a tokenizer token
    (reference ``_cost`` import_textgrid.py:22-34)."""
    t1 = tg_word["text"].lower()
    t2 = token.word.lower()
    if t1 == t2:
        return 0.0
    if t1 == "<eps>" and not t2.isalpha():
        return 0.0
    if t1.startswith(t2) or t2.startswith(t1):
        return 0.5
    if t1.endswith(t2) or t2.endswith(t1):
        return 0.5
    return 1.0


def align_words(tg_words: list[dict], tok_words) -> list[int]:
    """DP alignment aligner-words ↔ tokenizer-words → tg→tok index map
    (reference ``_align`` import_textgrid.py:37-68)."""
    a = np.zeros((len(tg_words) + 1, len(tok_words) + 1))
    a[:, 0] = np.arange(a.shape[0])
    a[0, :] = np.arange(a.shape[1])
    for i in range(1, a.shape[0]):
        for j in range(1, a.shape[1]):
            c = _word_cost(tg_words[i - 1], tok_words[j - 1])
            a[i, j] = min(a[i - 1, j - 1], a[i - 1, j], a[i, j - 1]) + c
    i, j = a.shape[0] - 1, a.shape[1] - 1
    tg2tok = [0] * len(tg_words)
    tg2tok[i - 1] = j - 1
    while i > 1 or j > 1:
        if i == 1:
            j -= 1
        elif j == 1:
            i -= 1
        elif a[i - 1, j - 1] <= a[i - 1, j] and a[i - 1, j - 1] <= a[i, j - 1]:
            i -= 1
            j -= 1
        elif a[i - 1, j] <= a[i, j - 1]:
            i -= 1
        else:
            j -= 1
        tg2tok[i - 1] = j - 1
    return tg2tok


def merge_textgrid(norm_words: list[dict], phons: list[dict], tok_words):
    """Word/phone-span merge → (hybrid, phon2word, frame2phon) at 10 ms frames
    (reference ``_merge`` import_textgrid.py:71-138). Times in seconds."""
    tg2tok = align_words(norm_words, tok_words)
    tok2tg = {t: i for i, t in enumerate(tg2tok)}

    linear = []
    c_pos = 0.0
    phone_used = [False] * len(phons)
    for wi, tok in enumerate(tok_words):
        word = tok.word
        if wi not in tok2tg:
            obj = {"word": word,
                   "phones": [{"phon": word, "start": c_pos, "stop": c_pos}]}
        else:
            w = norm_words[tok2tg[wi]]
            phonemes = []
            for pi, ph in enumerate(phons):
                if ph["start"] >= w["start"] and ph["stop"] <= w["stop"] \
                        and not phone_used[pi]:
                    phone_used[pi] = True
                    phonemes.append({"phon": ph["text"], "start": ph["start"],
                                     "stop": ph["stop"]})
            obj = {"word": word, "phones": phonemes}
            c_pos = w["stop"]
        linear.append(obj)

    hybrid, phon2word, spans = [], [], []
    c_pos = 0.0
    for wi, w in enumerate(linear):
        if not w["phones"]:
            w["phones"] = [{"phon": w["word"], "start": c_pos, "stop": c_pos}]
        for ph in w["phones"]:
            hybrid.append(ph["phon"])
            spans.append((ph["start"], ph["stop"]))
            phon2word.append(wi)
        c_pos = spans[-1][1]

    min_pos = min(w["start"] for w in norm_words)
    max_pos = max(w["stop"] for w in norm_words)
    frame2phon = []
    ip = 0
    for frame in range(int((max_pos - min_pos) * 100)):
        c = frame / 100.0
        if ip < len(hybrid):
            while c > spans[ip][1]:
                ip += 1
                if ip >= len(hybrid):
                    break
        frame2phon.append(min(ip, len(hybrid) - 1))
    return hybrid, phon2word, frame2phon


def fetch_context(dataset: list[dict], original_text_path: str):
    """Recover left/right paragraph context from the source book text
    (reference ``_fetch_context`` import_textgrid.py:206-237)."""
    full = open(original_text_path, encoding="utf-8", errors="replace").read()
    while "\n\n\n" in full:
        full = full.replace("\n\n\n", "\n\n")
    while "  " in full:
        full = full.replace("  ", " ")
    paragraphs = full.split("\n\n")
    matched = 0
    for item in dataset:
        text = item["orig_text"].strip()
        for par in paragraphs:
            par = par.replace("\n", " ")
            while "  " in par:
                par = par.replace("  ", " ")
            idx = par.lower().find(text.lower())
            if idx >= 0:
                matched += 1
                item["left_context"] = par[:idx].strip()
                item["right_context"] = par[idx + len(text):].strip()
                break
    return matched


def scrub_uppercase_phones(item: dict):
    """Replace phones containing lowercase alpha chars with ' ' — MFA phone sets are
    uppercase; lowercase means a raw word leaked in (reference ``_fix_item`` :194-203)."""
    for i, ph in enumerate(item["phones"]):
        for ch in ph:
            if ch.isalpha() and ch.upper() != ch:
                item["phones"][i] = " "
                break
    return item


def read_alignment_dataset(lines: list[str], speaker: str = "none"):
    """Alignment lines → per-utterance dicts with merged hybrid transcriptions
    (reference _import_dataset :183-217). Returns (dataset, total_time_units)."""
    dataset, total_time = [], 0
    for line in lines:
        d = parse_alignment_line(line)
        if d is None:
            continue
        if len(d["text"]) != len(d["phon"]) or len(d["text"]) != len(d["durs"]):
            continue  # malformed row (reference drops into a debugger here)
        hybrid, words, phon2word, frame2phon = merge_alignment(
            d["text"], d["phon"], d["durs"])
        total_time += sum(d["durs"])
        dataset.append({
            "orig_start": d["start"],
            "orig_end": d["end"],
            "orig_filename": d["orig_fn"],
            "orig_text": d["text"],
            "phones": hybrid,
            "words": words,
            "phon2word": phon2word,
            "frame2phon": frame2phon,
            "speaker": speaker,
        })
    return dataset, total_time
