"""Deterministic pseudo-speech demo corpus for end-to-end pipeline drives.

Generates formant-synthesized utterances with a character-level alignment file in the
Blizzard-2023 importer format (file|start|end|text|phones|durs — see
ttscube_tpu_torch/scripts/import_blizzard_2023.py and
data/importers.py::parse_alignment_line), so the
FULL production pipeline — import → phonemizer → cubegan → export → TTSCube — can be
driven and quality-tracked without distributing real speech data.

The audio is learnable, not arbitrary noise: each letter maps to a fixed acoustic class
(vowels = additive harmonics under a two-formant envelope with a declining f0 contour;
nasals/approximants = damped low-formant voicing; fricatives = shaped noise; stops =
closure + burst), so loss_mel has real phone→spectrum structure to model and synthesized
devset audio can be inspected against the originals.

The port's copy of `scripts/make_demo_corpus.py`: with the same flags and seed it
writes the same files, through the port's `utils/wavio.py`, so that a machine without
JAX can make a corpus in the Blizzard-2023 format.

Usage:
    python -m ttscube_tpu_torch.scripts.make_demo_corpus --output corpus --sentences 300
"""

import os
from argparse import ArgumentParser

import numpy as np

SR = 24000

VOWELS = {  # (F1, F2) Hz
    "a": (800, 1200), "e": (500, 1900), "i": (300, 2300),
    "o": (500, 900), "u": (320, 800),
}
NASALS = {"m": (250, 1000), "n": (250, 1700)}
APPROX = {"l": (400, 1300), "r": (450, 1350), "w": (350, 800), "y": (300, 2200)}
FRICS = {  # (band_lo, band_hi) Hz
    "s": (4000, 9000), "z": (3500, 8000), "f": (1500, 7000), "v": (1000, 5000),
    "h": (500, 4000), "j": (2000, 6000), "x": (2500, 7000),
}
STOPS = {"p": 1200, "t": 4000, "b": 800, "d": 2500, "k": 1800, "g": 1000,
         "c": 2000, "q": 1500}

WORDS = [
    "ama", "emi", "ilo", "onu", "ukela", "sano", "tivo", "muna", "lori", "wafe",
    "zeki", "dupo", "haze", "rila", "kemo", "vasu", "nide", "yolo", "bapi", "gute",
    "selami", "tokun", "mirade", "fulosa", "nevika", "pastor", "wimelo", "duvane",
    "ralito", "zumeka", "hofani", "besuro", "ka", "no", "si", "tu", "ve", "lo",
    "dime", "zofar",
]


def _voiced(n, f0_start, f0_end, formants, sr=SR, amp=0.45, bw=130.0):
    """Additive harmonics, amplitudes from a sum-of-Gaussians formant envelope."""
    t = np.arange(n) / sr
    f0 = np.linspace(f0_start, f0_end, n)
    phase0 = np.cumsum(2 * np.pi * f0 / sr)
    out = np.zeros(n)
    for k in range(1, int(6000 // max(f0_end, 1.0))):
        fk = k * (f0_start + f0_end) / 2
        if fk > 6000:
            break
        env = sum(np.exp(-0.5 * ((fk - F) / bw) ** 2) for F in formants)
        out += (0.12 + env) / (1 + 0.25 * k) * np.sin(k * phase0)
    # gentle on/offset ramps to avoid clicks
    ramp = min(n // 8, 240)
    w = np.ones(n)
    w[:ramp] = np.linspace(0, 1, ramp)
    w[-ramp:] = np.linspace(1, 0, ramp)
    return (amp * out * w * (0.8 + 0.2 * np.hanning(n))).astype(np.float32)


def _noise(n, lo, hi, rng, amp=0.18, sr=SR):
    x = rng.standard_normal(n)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1 / sr)
    mask = ((freqs >= lo) & (freqs <= hi)).astype(float)
    mask = np.convolve(mask, np.ones(9) / 9, mode="same")  # soft band edges
    y = np.fft.irfft(spec * mask, n)
    peak = np.abs(y).max() or 1.0
    ramp = min(n // 6, 180)
    w = np.ones(n)
    w[:ramp] = np.linspace(0, 1, ramp)
    w[-ramp:] = np.linspace(1, 0, ramp)
    return (amp * y / peak * w).astype(np.float32)


def synth_char(ch, dur_ms, f0_a, f0_b, rng, vt=1.0):
    """vt: vocal-tract scale — multiplies formant/band frequencies (speaker identity)."""
    n = int(dur_ms * SR / 1000)
    if n <= 0:
        return np.zeros(0, np.float32)
    if ch in VOWELS:
        return _voiced(n, f0_a, f0_b, tuple(f * vt for f in VOWELS[ch]))
    if ch in NASALS:
        return _voiced(n, f0_a, f0_b, tuple(f * vt for f in NASALS[ch]), amp=0.25)
    if ch in APPROX:
        return _voiced(n, f0_a, f0_b, tuple(f * vt for f in APPROX[ch]), amp=0.3)
    if ch in FRICS:
        lo, hi = FRICS[ch]
        return _noise(n, lo * vt, min(hi * vt, SR / 2 - 500), rng)
    if ch in STOPS:
        out = np.zeros(n, np.float32)
        burst = min(n // 3, int(0.012 * SR))
        if burst > 8:
            f = STOPS[ch] * vt
            out[-burst:] = _noise(burst, max(f - 800, 200),
                                  min(f + 2000, SR / 2 - 500), rng, amp=0.3)
        return out
    return np.zeros(n, np.float32)  # space / punctuation = silence


def speaker_profile(k: int, n_speakers: int):
    """Deterministic per-speaker acoustics: f0 register + vocal-tract scale, spanning
    a bass→soprano range so the speaker embedding has real signal to learn."""
    u = 0.0 if n_speakers <= 1 else k / (n_speakers - 1)
    return {"f0": 0.75 + 0.85 * u,   # 0.75x .. 1.6x of the base register
            "vt": 0.90 + 0.22 * u}   # formants 0.90x .. 1.12x


def make_sentence(rng, profile=None):
    profile = profile or {"f0": 1.0, "vt": 1.0}
    words = [WORDS[rng.integers(len(WORDS))] for _ in range(rng.integers(4, 9))]
    text = " ".join(words) + "."
    rate = rng.uniform(0.8, 1.3)  # per-sentence speaking rate → duration variance
    chars, durs = [], []
    for ch in text:
        if ch in VOWELS:
            d = rng.integers(90, 180)
        elif ch == " ":
            d = rng.integers(60, 120)
        elif ch == ".":
            d = rng.integers(150, 250)
        elif ch in STOPS:
            d = rng.integers(50, 90)
        else:
            d = rng.integers(50, 110)
        chars.append(ch)
        durs.append(max(int(d * rate), 20))
    total_ms = sum(durs)
    f0_hi, f0_lo = 170.0 * profile["f0"], 95.0 * profile["f0"]
    audio = []
    t_ms = 0
    for ch, d in zip(chars, durs):
        a = f0_hi + (f0_lo - f0_hi) * t_ms / total_ms
        b = f0_hi + (f0_lo - f0_hi) * (t_ms + d) / total_ms
        audio.append(synth_char(ch, d, a, b, rng, vt=profile["vt"]))
        t_ms += d
    return text, durs, np.concatenate(audio)


def main(args):
    from ttscube_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.output, exist_ok=True)
    total_s = 0.0
    align_files = []
    for k in range(args.speakers):
        profile = speaker_profile(k, args.speakers)
        lines = []
        for i in range(args.sentences):
            text, durs, audio = make_sentence(rng, profile)
            # lead-in/out silence so the aligner-pause semantics have something real
            pad = np.zeros(int(0.05 * SR), np.float32)
            audio = np.concatenate([pad, audio, pad])
            fn = f"spk{k}_chap_{i:05d}" if args.speakers > 1 else f"chap_{i:05d}"
            write_wav(os.path.join(args.output, fn + ".wav"), audio, SR)
            start, end = 50, 50 + sum(durs)
            # phone == the character itself for letters; non-alpha positions need a
            # placeholder token (the merge keeps the text char for non-alpha anyway,
            # and the space-separated phone field must stay len(text) long)
            phones = " ".join(ch if ch.isalpha() else "_" for ch in text)
            lines.append("|".join([fn, str(start), str(end), text, phones,
                                   " ".join(str(d) for d in durs)]))
            total_s += (end - start) / 1000.0 + 0.1
        # one alignment file per speaker: import each with its own --speaker flag
        # (the importer's per-file speaker semantics, import_blizzard_2023.py)
        name = f"align_spk{k}.txt" if args.speakers > 1 else "align.txt"
        with open(os.path.join(args.output, name), "w") as f:
            f.write("\n".join(lines) + "\n")
        align_files.append(name)
    print(f"wrote {args.speakers * args.sentences} utterances "
          f"({total_s/60:.1f} min audio, {args.speakers} speakers) to {args.output}/ "
          f"[{', '.join(align_files)}]")


def parser() -> ArgumentParser:
    ap = ArgumentParser()
    ap.add_argument("--output", default="corpus")
    ap.add_argument("--sentences", type=int, default=300)
    ap.add_argument("--speakers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    return ap


if __name__ == "__main__":
    main(parser().parse_args())
