"""The port's `synthesize_from_checkpoint` on the CPU: a Cubegan rebuilt from a trainer's
files (`.yaml`, `.encodings`, `.last` in the JAX package's formats) on one utterance of a
seeded corpus (tests/test_data.py::make_corpus), forced at the fixed v1 width and free
at a narrow width; the same against the JAX function (slow: its jitted v1 generator)."""

import functools
import os

import numpy as np
import pytest
import torch

from ttscube_tpu_torch import convert
from ttscube_tpu_torch.data.collate import CubeganCollate
from ttscube_tpu_torch.data.datasets import CubeganDataset
from ttscube_tpu_torch.data.encodings import CubeganEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.train.runtime import (cubegan_synthesize_dataset,
                                             synthesize_from_checkpoint)
from ttscube_tpu_torch.utils.checkpoint import save_config, save_params
from ttscube_tpu_torch.utils.wavio import read_wav
from tests.test_data import make_corpus
from tests.torch_parity import TINY_HIFI, TRAIN_DISC, one_cpu_thread  # noqa: F401

# PyTorch on one thread: the tier's workers share the machine's cores
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

NARROW = dict(hifigan=HifiganConfig(**TINY_HIFI), **TRAIN_DISC)


def _write_checkpoint(folder, corpus, narrow: bool):
    """A trainer's files at `folder/cubegan` from seeded random weights: the whole
    model's tree {lang, gen, mpd, msd} as `.last`, as the trainer writes it."""
    base = str(folder / "cubegan")
    enc = CubeganEncodings()
    enc.compute(CubeganDataset(str(corpus)))
    enc.save(base + ".encodings")
    enc = CubeganEncodings(base + ".encodings")
    save_config(base, {"sample_rate": 24000, "hop_size": 240, "conditioning": None})
    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=len(enc.phon2int),
                                    num_speakers=len(enc.speaker2int),
                                    max_pitch=enc.max_pitch, max_duration=enc.max_duration),
        **(NARROW if narrow else {}))
    save_params(base + ".last", convert.init_random(tcg.Cubegan(cfg, train=True), seed=3))
    return base, cfg, enc


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), n=2)


@pytest.fixture(scope="module")
def v1_checkpoint(tmp_path_factory, corpus):
    return _write_checkpoint(tmp_path_factory.mktemp("v1"), corpus, narrow=False)


def _wav(folder, utt="utt0"):
    audio, sr = read_wav(os.path.join(folder, f"{utt}.wav"))
    assert sr == 24000
    return np.round(audio * 32768).astype(np.int32)


def test_forced_synthesis_from_the_checkpoint(v1_checkpoint, corpus, tmp_path):
    """The rebuilt model holds the `.last` file's lang and gen bit for bit, and its
    forced wav is `cubegan_synthesize_dataset`'s on that model, trimmed to the
    utterance's frames."""
    base, cfg, enc = v1_checkpoint
    model = synthesize_from_checkpoint(base, str(corpus), str(tmp_path / "out"), limit=1,
                                       free=False, device="cpu")
    assert os.listdir(tmp_path / "out") == ["utt0.wav"]
    tree = convert.read_msgpack(base + ".last")
    assert set(tree) == {"lang", "gen", "mpd", "msd"}
    ref = convert.load_jax_params(tcg.Cubegan(cfg), {"lang": tree["lang"], "gen": tree["gen"]})
    got, want = model.state_dict(), ref.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert not model.config.hifigan.fused_tail  # the plain generator, as in JAX
    ds = CubeganDataset(str(corpus))
    cubegan_synthesize_dataset(ref.eval(), ds, CubeganCollate(enc, hop=240), str(tmp_path / "ref"),
                               limit=1, free=False)
    pcm = _wav(tmp_path / "out")
    np.testing.assert_array_equal(pcm, _wav(tmp_path / "ref"))
    assert len(pcm) == len(ds[0]["meta"]["frame2phon"]) * 240 and np.abs(pcm).max() > 0


def test_free_synthesis_trims_to_the_predicted_frames(corpus, tmp_path, monkeypatch):
    """Free synthesis at a narrow width (the config class narrowed as the trainer test
    does): the wav holds the predicted frames, no more."""
    monkeypatch.setattr(tcg, "CubeganConfig", functools.partial(tcg.CubeganConfig, **NARROW))
    base, cfg, enc = _write_checkpoint(tmp_path, corpus, narrow=True)
    model = synthesize_from_checkpoint(base, str(corpus), str(tmp_path / "out"), limit=1,
                                       device="cpu")
    ds = CubeganDataset(str(corpus))
    batch = tcg.batch_to_torch(CubeganCollate(enc, hop=240)([ds[0]]), "cpu")
    _, aux = model.infer({k: v for k, v in batch.items() if k.startswith("x_")},
                         max_frames=2048)
    frames = int(aux["frame_mask"][0].sum())
    assert 0 < frames < 2048
    assert len(_wav(tmp_path / "out")) == frames * 240


def test_runs_on_the_card_unless_asked(v1_checkpoint, corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesize_from_checkpoint(v1_checkpoint[0], str(corpus), str(tmp_path / "o"), limit=1)


@pytest.mark.slow
def test_forced_synthesis_matches_jax(v1_checkpoint, corpus, tmp_path):
    """The JAX function on the same files (its flax init of the whole v1 model and its
    jitted v1 generator cost about a minute on the CPU): the wav samples within 2 int16
    steps."""
    from ttscube_tpu.train.runtime import synthesize_from_checkpoint as jax_synthesize

    base = v1_checkpoint[0]
    jax_synthesize(base, str(corpus), str(tmp_path / "jax"), limit=1, free=False)
    synthesize_from_checkpoint(base, str(corpus), str(tmp_path / "port"), limit=1, free=False,
                               device="cpu")
    want, got = _wav(tmp_path / "jax"), _wav(tmp_path / "port")
    assert got.shape == want.shape and np.abs(want).max() > 0
    print(f"\nparity synthesize_from_checkpoint forced wav: max_abs_diff="
          f"{int(np.abs(got - want).max())} int16 steps tol=2")
    assert np.abs(got - want).max() <= 2
