"""The port's corpus import (`ttscube_tpu_torch/data/importers.py`, `dsp/pitch.py`,
`data/textgrid.py`, the import scripts and `make_demo_corpus`) against the JAX package's
on the CPU, on seeded inputs.

Limits: every pure function equal to its JAX counterpart; the files the importers write
equal the JAX scripts' (`.json`, `.wav`, `.pitch`, `.f0`, `.lab`, `.txt` byte-equal)
but the mel and its PNG; the numpy twins of the pitch
tracker equal; the demo corpus byte-equal to the JAX script's. The JAX scripts run in
this process on the same flags, parsed by the port's parsers.

The mel (`.mgc`) is held against an fp64 numpy transform with the JAX module's own fp32
constants, made here from the written `.wav`: the port's within 1e-4 of it everywhere,
and the port's within 1e-4 of the JAX file beyond the JAX file's own distance from it,
element by element. Near the 1e-5 floor (log-mel about -5) the JAX importer's XLA fp32
mel sits up to 2.6e-3 from the fp64 value on the demo corpus, so a flat 1e-4 against the
JAX file does not hold there for any right implementation; the port computes its mel in
fp64 (data/importers.py). The PNG (decoded with PIL, here only) is pixel-equal to the
JAX renderer's picture of the port's mel, and within one grey level of the JAX file's.
"""

import importlib.util
import json
import os
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

from ttscube_tpu.data import importers as jimp
from ttscube_tpu.data import textgrid as jtg
from ttscube_tpu.data.text import SimpleTokenizer as JaxTokenizer
from ttscube_tpu_torch.data import importers as timp
from ttscube_tpu_torch.data import textgrid as ttg
from ttscube_tpu_torch.data.text import SimpleTokenizer
from tests.torch_parity import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.usefixtures("one_cpu_thread")


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def without_device(args: Namespace) -> Namespace:
    return Namespace(**{k: v for k, v in vars(args).items() if k != "device"})


# -- the pure functions -------------------------------------------------------------------

def _alignment_lines(rng, n=6):
    lines = []
    for i in range(n):
        text = "".join(rng.choice(list("abcde ,.")) for _ in range(int(rng.integers(4, 12))))
        phon = [c.upper() if c.isalpha() and rng.random() > 0.2 else "_" for c in text]
        durs = [int(rng.choice([0, 10, 30, 130, 70])) for _ in text]
        start = 1000 * i
        lines.append(f"ch{i // 3}|{start}|{start + sum(durs)}|{text}|{' '.join(phon)}|"
                     f"{' '.join(map(str, durs))}")
    return lines + ["bad line", "ch9|0|10|{tag}|A|10"]


def _dataset(rng):
    return jimp.read_alignment_dataset(_alignment_lines(rng), "spk")[0]


def _tg_words_phones():
    words = [{"text": "hello", "start": 0.0, "stop": 0.4},
             {"text": "world", "start": 0.4, "stop": 0.9}]
    phones = [{"text": p, "start": 0.1 * i, "stop": 0.1 * (i + 1)}
              for i, p in enumerate(["HH", "EH", "L", "OW", "W", "ER", "L", "D", "sil"])]
    return [{"text": " ", "start": 0.0, "stop": 0.0}] + words, phones


def _phs(rng, text):
    t, lines = 0, []
    for c in ["<START>"] + [c.lower() for c in text] + ["<STOP>"]:
        d = int(rng.integers(1, 5)) * 160000
        lines.append(f"{t} {t + d} {c}\n")
        t += d
    return lines


def _case(name, tmp_path):
    """(port function, JAX function, args) of one pure function on seeded inputs."""
    rng = np.random.default_rng(sum(map(ord, name)))
    tok, jtok = SimpleTokenizer(), JaxTokenizer()
    words, phones = _tg_words_phones()
    if name == "merge_alignment":
        text = "ab, cd e."
        phon = ["A", "_", ",", " ", "C", "D", " ", "E", "."]
        durs = [int(d) for d in rng.integers(0, 40, len(text))]
        return timp.merge_alignment, jimp.merge_alignment, (text, phon, durs)
    if name == "correct_alignments":
        return timp.correct_alignments, jimp.correct_alignments, (_alignment_lines(rng),)
    if name == "read_alignment_dataset":
        return (timp.read_alignment_dataset, jimp.read_alignment_dataset,
                (_alignment_lines(rng), "spk"))
    if name == "build_context":
        return timp.build_context, jimp.build_context, (_dataset(rng), 2, 1)
    if name == "split_train_dev":
        return timp.split_train_dev, jimp.split_train_dev, (_dataset(rng), 0.3)
    if name == "merge_textgrid":
        return (lambda *a: timp.merge_textgrid(*a, tok(" hello world")),
                lambda *a: jimp.merge_textgrid(*a, jtok(" hello world")), (words, phones))
    if name == "align_words":
        return (lambda w: timp.align_words(w, tok(" hello big world")),
                lambda w: jimp.align_words(w, jtok(" hello big world")), (words,))
    if name == "scrub_uppercase_phones":
        return (timp.scrub_uppercase_phones, jimp.scrub_uppercase_phones,
                ({"phones": ["HH", "bad", "EH", " ", "x1", "Ok"]},))
    if name == "fetch_context":
        book = tmp_path / "book.txt"
        book.write_text("Intro here.\n\n\nSome  words before hello world and after.\n\nEnd.")
        return (lambda d: (timp.fetch_context(d, str(book)), d),
                lambda d: (jimp.fetch_context(d, str(book)), d),
                ([{"orig_text": " hello world"}, {"orig_text": "absent"}],))
    if name == "encode_htk":
        return timp.encode_htk, jimp.encode_htk, ("ăîș ab",)
    if name == "align_htk":
        text = "a bc"
        trans = ["<START>"] + list(text) + ["<STOP>"]
        return timp.align_htk, jimp.align_htk, (_phs(rng, text), trans, 40)
    if name == "create_lab_file":
        (tmp_path / "spk_1.txt").write_text("Ab  c\td\n", encoding="utf-8")
        (tmp_path / "spk_1.phs").write_text("".join(_phs(rng, "Ab c d")))

        def run(imp, out):
            imp.create_lab_file(str(tmp_path / "spk_1.txt"), str(tmp_path / "spk_1.phs"), 30,
                                str(tmp_path / out), lang="xx")
            return (tmp_path / out).read_bytes()
        return (lambda: run(timp, "t.lab"), lambda: run(jimp, "j.lab"), ())
    if name == "highpass_filter":
        y = rng.standard_normal(4000).astype(np.float32)
        return timp.highpass_filter, jimp.highpass_filter, (y, 16000)
    if name == "parse_textgrid":
        def run(tg, out):
            tg.write_textgrid(str(tmp_path / out), [("words", words[1:]), ("phones", phones),
                                                    ("utt", [{"text": 'say "hi"', "start": 0.0,
                                                              "stop": 0.9}])], 0.9)
            return (tmp_path / out).read_bytes(), tg.parse_textgrid(str(tmp_path / out))
        return (lambda: run(ttg, "t.TextGrid"), lambda: run(jtg, "j.TextGrid"), ())
    raise KeyError(name)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


PURE = ["merge_alignment", "correct_alignments", "read_alignment_dataset", "build_context",
        "split_train_dev", "merge_textgrid", "align_words", "scrub_uppercase_phones",
        "fetch_context", "encode_htk", "align_htk", "create_lab_file", "highpass_filter",
        "parse_textgrid"]


@pytest.mark.parametrize("name", PURE)
def test_pure_function_matches_jax(name, tmp_path):
    import copy

    ours, theirs, args = _case(name, tmp_path)
    got, want = ours(*copy.deepcopy(args)), theirs(*copy.deepcopy(args))
    assert _equal(got, want), (name, got, want)


def test_pitch_twins_match_jax():
    """The native tracker (built from native/pitch.cpp into the port's build folder)
    equals the JAX package's, and the two numpy twins equal each other, on a seeded
    voiced-then-noisy signal."""
    from ttscube_tpu.dsp import pitch as jpitch
    from ttscube_tpu_torch.dsp import pitch as tpitch

    rng = np.random.default_rng(11)
    t = np.arange(12000) / 24000
    x = np.concatenate([0.5 * np.sin(2 * np.pi * (140 + 60 * t) * t),
                        0.1 * rng.standard_normal(6000)]).astype(np.float32)
    native = tpitch.rapt_pitch(x)
    assert np.array_equal(native, jpitch.rapt_pitch(x))
    assert (native > 0).sum() > 20
    twin = tpitch.rapt_pitch(x, use_native=False)
    assert np.array_equal(twin, jpitch.rapt_pitch(x, use_native=False))
    print(f"\nparity rapt_pitch: native equal; numpy twins equal; native vs numpy "
          f"{int((twin != native).sum())} of {len(twin)} frames differ")


# -- the scripts ----------------------------------------------------------------------------

def mel64(y: np.ndarray, sr: int, hop: int) -> np.ndarray:
    """The feature log10-mel of `y` in fp64 numpy, from the JAX module's fp32 DFT
    matrices and filterbank (centre zero padding of n_fft / 2, as both packages)."""
    from ttscube_tpu.dsp import mel as jmel

    c = jmel.feature_mel_config(sr, hop_length=hop)
    cos_m, sin_m = jmel._dft_matrices(c.n_fft, c.win_length, jmel.hann_window(c.win_length))
    fb = jmel.mel_filterbank(sr, c.n_fft, c.n_mels, c.fmin, c.fmax).T.astype(np.float64)
    yp = np.pad(y.astype(np.float64), (c.n_fft // 2, c.n_fft // 2))
    n = 1 + (len(yp) - c.n_fft) // hop
    frames = np.stack([yp[i * hop: i * hop + c.n_fft] for i in range(n)])
    mag = np.sqrt((frames @ cos_m.astype(np.float64)) ** 2
                  + (frames @ sin_m.astype(np.float64)) ** 2)
    return np.log10(np.maximum(mag @ fb, 1e-5))


MEL_READINGS = []


def compare_mel(ours: np.ndarray, theirs: np.ndarray, exact: np.ndarray, name) -> None:
    assert ours.shape == theirs.shape == exact.shape and ours.dtype == theirs.dtype
    port_exact, jax_exact = np.abs(ours - exact), np.abs(theirs - exact)
    assert float(port_exact.max()) <= 1e-4, name
    assert (np.abs(ours - theirs) <= 1e-4 + jax_exact).all(), name
    MEL_READINGS.append((float(np.abs(ours - theirs).max()), float(port_exact.max()),
                         float(jax_exact.max())))


def exact_mel(folder: Path, uid: str, source: Path, legacy: bool) -> np.ndarray:
    """`mel64` of what the importer took the mel of: the segment of the source wav that
    the `.json` names, normalized (Blizzard and TextGrid importers), or the legacy
    importer's normalized, high-passed source at hop 256, found by the `.txt` it
    copied."""
    from ttscube_tpu.data.importers import highpass_filter
    from ttscube_tpu.utils.wavio import read_wav

    if not legacy:
        item = json.loads((folder / (uid + ".json")).read_text())
        wav, sr = read_wav(str(source / (item["orig_filename"] + ".wav")), target_sr=24000)
        seg = wav[int(item["orig_start"] * 24.0): int(item["orig_end"] * 24.0)]
        return mel64(seg / (float(np.max(np.abs(seg))) or 1.0) * 0.98, sr, 240)
    text = (folder / (uid + ".txt")).read_text()
    src = next(p for p in sorted(source.glob("*.txt")) if p.read_text() == text)
    y, sr = read_wav(str(src.with_suffix(".wav")))
    y = highpass_filter(y / (float(np.max(np.abs(y))) or 1.0) * 0.999, sr)
    return mel64(y, sr, 256)


def compare_trees(ours: Path, theirs: Path, source: Path | None = None,
                  legacy: bool = False) -> int:
    """Assert two output folders hold the same files, equal by the module's limits;
    returns the number of files."""
    from PIL import Image

    names = sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    for n in names:
        a, b = ours / n, theirs / n
        if ".mgc" in n.suffixes:
            compare_mel(np.load(a), np.load(b),
                        exact_mel(a.parent, n.name.split(".")[0], source, legacy), n)
        elif n.suffix == ".png":
            # the same picture of the port's own mel as JAX's renderer makes, and within
            # one grey level of the JAX file's (whose mel differs by the JAX file's noise)
            from ttscube_tpu.train.runtime import render_spectrogram

            render_spectrogram(np.load(a.with_suffix(".mgc")), str(a) + ".jax.png")
            ours_px = np.asarray(Image.open(a)).astype(int)
            assert np.array_equal(ours_px, np.asarray(Image.open(str(a) + ".jax.png"))), n
            os.unlink(str(a) + ".jax.png")
            assert np.abs(ours_px - np.asarray(Image.open(b)).astype(int)).max() <= 1, n
        else:
            assert a.read_bytes() == b.read_bytes(), n
    return len(names)


def _demo(tmp_path, sentences=3, speakers=2):
    from ttscube_tpu_torch.scripts import make_demo_corpus

    out = tmp_path / "corpus"
    make_demo_corpus.main(make_demo_corpus.parser().parse_args(
        ["--output", str(out), "--sentences", str(sentences), "--speakers", str(speakers)]))
    return out


def test_demo_corpus_is_byte_equal(tmp_path):
    from ttscube_tpu_torch.scripts import make_demo_corpus

    ours = _demo(tmp_path)
    args = make_demo_corpus.parser().parse_args(
        ["--output", str(tmp_path / "jax"), "--sentences", "3", "--speakers", "2"])
    jax_script("make_demo_corpus").main(args)
    assert compare_trees(ours, tmp_path / "jax") == 2 * 3 + 2


def _legacy_corpus(root: Path):
    from ttscube_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(5)
    for i, text in enumerate(["Ab cd.", "ef g"]):
        (root / f"spk_{i}.txt").write_text(text + "\n", encoding="utf-8")
        (root / f"spk_{i}.phs").write_text("".join(_phs(rng, text)))
        t = np.arange(16000) / 16000
        write_wav(str(root / f"spk_{i}.wav"),
                  (0.4 * np.sin(2 * np.pi * (120 + 40 * i) * t)
                   + 0.05 * rng.standard_normal(len(t))).astype(np.float32), 16000)


def _textgrid_corpus(root: Path):
    from ttscube_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(6)
    words, phones = _tg_words_phones()
    for i in range(3):
        ttg.write_textgrid(str(root / f"utt{i}.TextGrid"),
                           [("words", words[1:]), ("phones", phones),
                            ("utt", [{"text": "Hello world", "start": 0.0, "stop": 0.9}])],
                           0.9)
        write_wav(str(root / f"utt{i}.wav"),
                  (0.3 * rng.standard_normal(24000 * 9 // 10)).astype(np.float32), 24000)
    (root / "book.txt").write_text("Then he said: Hello world, and left.\n\nEnd.")


@pytest.mark.parametrize("script", ["import_blizzard_2023", "import_phonemizer_blizzard",
                                    "import_textgrid", "import_corpus"])
def test_import_script_matches_jax(script, tmp_path):
    """Each import script of the port (mel on the CPU) against the JAX script of its name
    on the same input and flags: every file it writes, by the module's limits."""
    mod = importlib.import_module(f"ttscube_tpu_torch.scripts.{script}")
    if script in ("import_blizzard_2023", "import_phonemizer_blizzard"):
        src = _demo(tmp_path, sentences=4, speakers=1)
        flags = ["--input-file", str(src / "align.txt"), "--dev-ratio", "0.25"]
    elif script == "import_textgrid":
        src = tmp_path / "tg"
        src.mkdir()
        _textgrid_corpus(src)
        flags = ["--input-folder", str(src), "--dev-ratio", "0.34", "--original-text",
                 str(src / "book.txt")]
    else:
        src = tmp_path / "legacy"
        src.mkdir()
        _legacy_corpus(src)
        flags = ["--train-folder", str(src), "--dev-folder", str(src), "--prefix", "P"]
    outs = {}
    for who in ("port", "jax"):
        out = tmp_path / who
        out.mkdir()
        if script == "import_phonemizer_blizzard":
            argv = flags + ["--output-base", str(out / "phon")]
        else:
            argv = flags + ["--train-output", str(out / "train"), "--dev-output",
                            str(out / "dev")]
        if who == "port":
            mod.main(argv + (["--device", "cpu"] if "--device" in
                             mod.parser().format_help() else []))
        else:
            args = without_device(mod.parser().parse_args(argv))
            jmod = jax_script(script)
            for fn in ("_import_dataset", "phase_1_prepare_corpus"):
                if hasattr(jmod, fn):
                    getattr(jmod, fn)(args)
        outs[who] = out
    MEL_READINGS.clear()
    n = compare_trees(outs["port"], outs["jax"], src, legacy=script == "import_corpus")
    if MEL_READINGS:
        worst = np.max(MEL_READINGS, axis=0)
        print(f"\nparity {script} .mgc: port vs JAX {worst[0]:.3e}, port vs fp64 "
              f"{worst[1]:.3e} (tol 1e-4), JAX vs fp64 {worst[2]:.3e}")
    print(f"\nparity {script}: {n} files equal by the limits")
    assert n >= 2
    if script == "import_blizzard_2023":
        meta = json.loads(next((outs["port"] / "train").glob("*.json")).read_text())
        assert {"id", "phones", "frame2phon", "left_context"} <= set(meta)


def test_import_corpus_refuses_g2p(tmp_path):
    """`--g2p` at a base without a G2P model is refused before anything is imported
    (word G2P itself: tests/test_torch_g2p.py)."""
    from ttscube_tpu_torch.scripts import import_corpus

    with pytest.raises(FileNotFoundError, match="model.encodings"):
        import_corpus.main(["--train-folder", str(tmp_path), "--g2p", str(tmp_path / "model"),
                            "--train-output", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_import_audio_reports_its_times(tmp_path):
    src = _demo(tmp_path, sentences=2, speakers=1)
    data, _ = timp.read_alignment_dataset(open(src / "align.txt").readlines(), "spk")
    times = timp.import_audio(data, str(tmp_path / "out"), str(src), progress=False,
                              device="cpu")
    assert set(times) == {"audio_s", "mel_s", "pitch_s", "png_s", "total_s"}
    assert times["audio_s"] > 0.5 and times["total_s"] >= times["mel_s"] > 0
    assert len(os.listdir(tmp_path / "out")) == 2 * 5
