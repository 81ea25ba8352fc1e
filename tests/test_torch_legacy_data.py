"""The legacy generation's data, files and trainers on the CPU against the JAX package:
`TextcoderCollate` and `VocoderCollate`, `VocoderDataset` with its feature cache and
crops, `data/augment.alter`, `data/legacy.py`, `train/runtime.synthesize_devset`, and
the Textcoder and vocoder trainer CLIs (`scripts/train_textcoder.py`,
`scripts/train_vocoder.py`): the files they write load in the JAX package, and
`--resume` restores the state bit-equal.

Limits: arrays and files equal, but the mel, which is held as tests/test_torch_importers.py
holds the importer's (the port's fp64 mel within 1e-4 of an fp64 numpy transform, and of
JAX's beyond JAX's own distance from it); synthesize_devset's forced mel 5e-5 against
JAX's pass at the same PreNet masks (tests/test_torch_textcoder.py draws them).
"""

import numpy as np
import pytest

import jax

from ttscube_tpu.data import augment as jaug
from ttscube_tpu.data import collate as jcol
from ttscube_tpu.data import datasets as jds
from ttscube_tpu.data import legacy as jleg
from ttscube_tpu.models import textcoder as jtc
from ttscube_tpu_torch.convert import init_random, load_jax_params
from ttscube_tpu_torch.data import augment as taug
from ttscube_tpu_torch.data import collate as tcol
from ttscube_tpu_torch.data import datasets as tds
from ttscube_tpu_torch.data import legacy as tleg
from ttscube_tpu_torch.data.encodings import TextcoderEncodings
from ttscube_tpu_torch.models import textcoder as ttc
from ttscube_tpu_torch.models.hifigan import Generator, HifiganConfig
from ttscube_tpu_torch.train.runtime import synthesize_devset
from ttscube_tpu_torch.utils.wavio import read_wav, write_wav
from tests.torch_parity import (SMALL_HIFI, assert_close, one_cpu_thread,  # noqa: F401
                                release_jax_caches, seeded_tree)
from tests.test_torch_importers import MEL_READINGS, compare_mel, mel64
from tests.test_torch_textcoder import jnp_batch, torch_masks, with_masks

pytestmark = pytest.mark.usefixtures("one_cpu_thread", "release_jax_caches")

TOL_MEL = 5e-5
HOP = 240
UP = int(np.prod(SMALL_HIFI["upsample_rates"]))  # the small generator's samples per frame


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's demo corpus (one speaker, 8 sentences) imported by the port's
    `import_blizzard_2023` on the CPU, a quarter for dev."""
    from ttscube_tpu_torch.scripts import import_blizzard_2023, make_demo_corpus

    root = tmp_path_factory.mktemp("legacy")
    make_demo_corpus.main(make_demo_corpus.parser().parse_args(
        ["--output", str(root / "corpus"), "--sentences", "8", "--speakers", "1"]))
    import_blizzard_2023.main(["--input-file", str(root / "corpus" / "align.txt"),
                               "--dev-ratio", "0.25", "--train-output", str(root / "train"),
                               "--dev-output", str(root / "dev"), "--device", "cpu"])
    return root


# -- collates ------------------------------------------------------------------------------


def test_textcoder_and_vocoder_collates_match_jax(corpus):
    tset, jset = tds.CubeganDataset(str(corpus / "train")), jds.CubeganDataset(str(corpus / "train"))
    assert len(tset) == len(jset) >= 4
    enc = TextcoderEncodings()
    enc.compute(tset)
    jenc = jcol.CubeganEncodings()
    jenc.compute(jset)
    assert enc.phon2int == jenc.phon2int and enc.max_duration == jenc.max_duration
    got = tcol.TextcoderCollate(enc)([tset[i] for i in range(3)])
    want = jcol.TextcoderCollate(jenc)([jset[i] for i in range(3)])
    assert got.keys() == want.keys() and "y_audio" not in got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    rng = np.random.default_rng(0)
    ex = [(rng.standard_normal(n * 240).astype(np.float32),
           rng.standard_normal(n * 24).astype(np.float32),
           rng.standard_normal((n + 1, 80)).astype(np.float32)) for n in (5, 3, 7)]
    got, want = tcol.VocoderCollate()(ex), jcol.VocoderCollate()(ex)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["mel"][1, 4, 0] == -5.0 and got["x"][1, -1] == 0.0


# -- VocoderDataset and augment ------------------------------------------------------------


def test_vocoder_dataset_matches_jax(corpus, tmp_path):
    """random_start off: the head of each wav, its low-rate twin and its mel; the
    features come back from the cache the same; a seeded crop is hop-aligned and
    repeats with its seed."""
    kw = dict(max_segment_size=4800, random_start=False)
    ours = tds.VocoderDataset(str(corpus / "train"), cache_dir=str(tmp_path / "t"), **kw)
    theirs = jds.VocoderDataset(str(corpus / "train"), cache_dir=str(tmp_path / "j"), **kw)
    assert len(ours) == len(theirs) >= 4
    MEL_READINGS.clear()
    for i in range(len(ours)):
        (a, al, am), (b, bl, bm) = ours[i], theirs[i]
        assert np.array_equal(a, b) and np.array_equal(al, bl) and len(a) == 4800
        wav = np.load(str(tmp_path / "t" / ours._examples[i].replace("/", "_")) + ".audio.npy")
        compare_mel(am, bm, mel64(wav, 24000, HOP)[: len(am)], i)
        again = ours[i]  # from the cache
        assert all(np.array_equal(x, y) for x, y in zip(again, (a, al, am)))
    worst = np.max(MEL_READINGS, axis=0)
    print(f"\nparity VocoderDataset mel: port vs JAX {worst[0]:.3e}, port vs fp64 {worst[1]:.3e} "
          f"(tol 1e-4), JAX vs fp64 {worst[2]:.3e}")
    crops = [tds.VocoderDataset(str(corpus / "train"), max_segment_size=4800, crop_seed=3,
                                cache_dir=str(tmp_path / "t")) for _ in range(2)]
    for i in range(len(ours)):
        x, xl, m = crops[0][i]
        assert all(np.array_equal(p, q) for p, q in zip((x, xl, m), crops[1][i]))
        wav = np.load(str(tmp_path / "t" / ours._examples[i].replace("/", "_")) + ".audio.npy")
        mel = np.load(str(tmp_path / "t" / ours._examples[i].replace("/", "_")) + ".mgc.npy")
        starts = [s for s in range(0, len(wav) - 4800 + 1, HOP) if np.array_equal(wav[s:s + 4800], x)]
        assert len(x) == 4800 and len(xl) == 480 and starts, i
        assert np.array_equal(m, mel[starts[0] // HOP: starts[0] // HOP + 21])


def test_alter_and_augmented_dataset_match_jax(corpus, tmp_path):
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal(24000)).astype(np.float32)
    noise = tmp_path / "noise"
    noise.mkdir()
    write_wav(str(noise / "n.wav"), (0.2 * rng.standard_normal(30000)).astype(np.float32), 24000)
    files = [str(noise / "n.wav")]
    for seed in range(6):
        got = taug.alter(x, np.random.default_rng(seed), 24000, prob=0.6, noise_files=files)
        want = jaug.alter(x, np.random.default_rng(seed), 24000, prob=0.6, noise_files=files)
        assert np.array_equal(got, want), seed
    kw = dict(max_segment_size=4800, random_start=False, augment_prob=1.0, augment_seed=4,
              noise_dir=str(noise))
    ours = tds.VocoderDataset(str(corpus / "train"), cache_dir=str(tmp_path / "t"), **kw)
    theirs = jds.VocoderDataset(str(corpus / "train"), cache_dir=str(tmp_path / "j"), **kw)
    MEL_READINGS.clear()
    for i in range(2):
        (a, al, am), (b, bl, bm) = ours[i], theirs[i]
        assert np.array_equal(a, b) and np.array_equal(al, bl)
        compare_mel(am, bm, mel64(a, 24000, HOP)[: len(am)], i)


# -- data/legacy.py ------------------------------------------------------------------------


def test_legacy_data_matches_jax(tmp_path):
    pis = [tleg.PhoneInfo(c, ctx, 0, 10) for c, ctx in
           (("a", ["SPEAKER:x", "f1"]), ("b", ["f2", "SPEAKER:y"]), ("a", ["f1"]))]
    jpis = [jleg.PhoneInfo(p.char, p.context, p.start, p.stop) for p in pis]
    ours, theirs = tleg.LegacyEncodings(), jleg.LegacyEncodings()
    for p, q in zip(pis, jpis):
        ours.update(p)
        theirs.update(q)
    ours.store(str(tmp_path / "t.enc"))
    theirs.store(str(tmp_path / "j.enc"))
    assert (tmp_path / "t.enc").read_bytes() == (tmp_path / "j.enc").read_bytes()
    back = tleg.LegacyEncodings()
    back.load(str(tmp_path / "j.enc"))
    assert (back.char2int, back.context2int, back.speaker2int) == (
        theirs.char2int, theirs.context2int, theirs.speaker2int)

    data = np.random.default_rng(2).uniform(-1, 1, 5000).astype(np.float32)
    tio, jio = tleg.DatasetIO(), jleg.DatasetIO()
    assert tio.ulaw_encode(data) == jio.ulaw_encode(data)
    codes = list(range(256))
    assert np.allclose(tio.ulaw_decode(codes), jio.ulaw_decode(codes), atol=1e-7, rtol=0)
    cont = np.linspace(-1, 1, 101).tolist()
    assert tio.ulaw_decode(cont, discreete=False) == jio.ulaw_decode(cont, discreete=False)
    for fn in ("b16_enc", "b16_dec", "b16_to_float"):
        arg = data if fn == "b16_enc" else tio.b16_enc(data)
        assert getattr(tio, fn)(arg) == getattr(jio, fn)(arg), fn

    (tmp_path / "lex.txt").write_text("Hello1 HH AH0 L OW1\nworld\tW ER1 L D\n\n")
    for a, b in zip(tleg.LTSDataset(str(tmp_path / "lex.txt")).entries,
                    jleg.LTSDataset(str(tmp_path / "lex.txt")).entries):
        assert (a.word, a.transcription) == (b.word, b.transcription)
    (tmp_path / "u1.txt").write_text("x")
    (tmp_path / "u1.phs").write_text("0 100 a\n100 250 b\n")
    (tmp_path / "u1.lab").write_text("l1\nl2\n")
    assert tleg.LegacyDataset(str(tmp_path)).files == jleg.LegacyDataset(str(tmp_path)).files
    got = [(p.char, p.start, p.stop, p.duration) for p in tio.read_phs(str(tmp_path / "u1.phs"))]
    assert got == [(p.char, p.start, p.stop, p.duration)
                   for p in jio.read_phs(str(tmp_path / "u1.phs"))]
    assert tio.read_lab(str(tmp_path / "u1.lab")) == jio.read_lab(str(tmp_path / "u1.lab"))
    tio.write_wave(str(tmp_path / "w.wav"), data, 24000)
    assert np.array_equal(tio.read_wave(str(tmp_path / "w.wav"))[0],
                          jio.read_wave(str(tmp_path / "w.wav"))[0])


# -- synthesize_devset --------------------------------------------------------------------


def test_synthesize_devset_forced_and_free(corpus, tmp_path):
    """Forced: the mel against JAX's teacher-forced pass at the same masks (5e-5), a PNG
    and a wav of the utterance's frames; free: a PNG and a wav of max_frames frames."""
    devset = tds.CubeganDataset(str(corpus / "dev"))
    enc = TextcoderEncodings()
    enc.compute(tds.CubeganDataset(str(corpus / "train")))
    cfg = dict(num_phones=len(enc.phon2int), num_speakers=len(enc.speaker2int),
               max_pitch=int(enc.max_pitch), max_duration=int(enc.max_duration), pframes=3)
    collate = tcol.TextcoderCollate(enc)
    b0 = collate([devset[0]])
    jm = jtc.CubenetTextcoder(jtc.TextcoderConfig(**cfg))
    k = jax.random.PRNGKey(0)
    variables = seeded_tree(dict(jax.eval_shape(lambda: jm.init(
        {"params": k, "dropout": k}, jnp_batch(b0)))), 3)
    tm = load_jax_params(ttc.CubenetTextcoder(ttc.TextcoderConfig(**cfg)), variables["params"],
                         batch_stats=variables["batch_stats"])
    gen = init_random(Generator(HifiganConfig(**SMALL_HIFI)), 4).eval()
    n = len(devset)
    forward = jax.jit(with_masks(lambda v, b, r: jm.apply(v, b, train=False, rngs={"dropout": r})))
    wants, masks = [], []
    for i in range(n):
        out, m = forward(variables, jnp_batch(collate([devset[i]])), jax.random.PRNGKey(i))
        wants.append(np.asarray(out[3])[0])
        masks.append(torch_masks(m))
    mels = synthesize_devset(tm, gen, devset, collate, str(tmp_path / "forced"), masks=masks)
    for i, (got, want) in enumerate(zip(mels, wants)):
        assert_close(f"synthesize_devset forced mel {i}", got, want, TOL_MEL)
        uid = devset[i]["meta"]["id"]
        audio, sr = read_wav(str(tmp_path / "forced" / f"{uid}.wav"))
        assert sr == 24000 and len(audio) == len(got) * UP and np.isfinite(audio).all()
        png = (tmp_path / "forced" / f"{uid}.png").read_bytes()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    free = synthesize_devset(tm, gen, devset, collate, str(tmp_path / "free"),
                             forced_synthesis=False, max_frames=60, limit=1)
    assert len(free) == 1 and free[0].shape == (60, 80) and np.isfinite(free[0]).all()
    uid = devset[0]["meta"]["id"]
    assert len(read_wav(str(tmp_path / "free" / f"{uid}.wav"))[0]) == 60 * UP
    assert sorted(p.name for p in (tmp_path / "free").iterdir()) == [f"{uid}.png", f"{uid}.wav"]
