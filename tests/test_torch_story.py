"""The port's StoryCube, `download_model` and `TTSCube.load` on the CPU: the story's
assembly over a stub cube and over the small fp32 voice of tests/test_torch_api.py
against the JAX StoryCube; a voice's volumes reassembled from a `file://` base (no test
touches the network); and a named voice loaded from the cache and through a download."""

import os
import tarfile

import numpy as np
import pytest

import ttscube_tpu.story as jstory
from ttscube_tpu.utils.wavio import write_wav
from ttscube_tpu.ops.rnn import unroll_override
from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch import story as tstory
from ttscube_tpu_torch.utils import repository
from tests.test_torch_api import SPEAKER, artifacts  # noqa: F401 (the fixture)
from tests.torch_parity import one_cpu_thread  # noqa: F401 (the fixture)

# PyTorch on one thread: the tier's workers share the machine's cores
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

STORY = "hello world.\n\nspeak to me.\n\nhello again."
VOICE_FILES = ("cubegan.model", "cubegan.yaml", "cubegan.encodings", "phonemizer.model",
               "phonemizer.encodings")


class FakeCube:
    """A cube whose every request is one second at 0.1 of full scale."""

    def __call__(self, text, speaker="none"):
        return (np.ones(24000, np.float32) * 0.1 * 32767).astype(np.int16)


def _music(path, seconds=2.0, seed=0):
    rng = np.random.default_rng(seed)
    n = int(24000 * seconds)
    y = 0.2 * np.sin(np.linspace(0, 800 * np.pi, n)) + 0.05 * rng.standard_normal(n)
    write_wav(str(path), y.astype(np.float32), 24000)
    return str(path)


def _same_story(got, want, steps: int, meta_tol: float = 0.0):
    assert got["audio"].dtype == np.int16 and got["audio"].shape == want["audio"].shape
    assert np.abs(got["audio"].astype(np.int32) - want["audio"]).max() <= steps
    assert [(m["name"], m["text"]) for m in got["meta"]] == \
        [(m["name"], m["text"]) for m in want["meta"]]
    for a, b in zip(got["meta"], want["meta"]):
        assert abs(a["start"] - b["start"]) <= meta_tol and abs(a["end"] - b["end"]) <= meta_tol


def test_storycube_assembly_matches_jax_over_a_stub(monkeypatch, tmp_path):
    """As the JAX test (tests/test_api.py): 5 s intro + 2 × (1 s + 1 s pause) + 5 s outro;
    the seeded music mixed at 0.30; the named voice's default music.wav under HOME; a
    request's own music; and 1 s of silence where the voice has no music."""
    monkeypatch.setattr(jstory.TTSCube, "load", staticmethod(lambda name: FakeCube()))
    monkeypatch.setattr(tstory.TTSCube, "load",
                        staticmethod(lambda name, device=None: FakeCube()))
    monkeypatch.setenv("HOME", str(tmp_path))
    music = _music(tmp_path / "music.wav")
    text = "Paragraph one.\n\nParagraph two."
    want = jstory.StoryCube("whatever", music_path=music)(text, speaker="neb")
    got = tstory.StoryCube("whatever", music_path=music)(text, speaker="neb")
    _same_story(got, want, steps=0)
    assert abs(len(got["audio"]) / 24000 - 14.0) < 0.1
    assert got["meta"][0]["name"] == "intro" and got["meta"][1]["text"] == "Paragraph one."
    # no music anywhere: silence under the voice
    silent = tstory.StoryCube("whatever")(text, speaker="neb")
    _same_story(silent, jstory.StoryCube("whatever")(text, speaker="neb"), steps=0)
    peak = np.float32(int(0.1 * 32767)) / np.float32(32767) * 32700  # the stub's int16 level
    assert int(np.abs(silent["audio"]).max()) == int(peak)
    # the named voice's music.wav in its cache, and a request's own music
    os.makedirs(tmp_path / ".ttscube" / "models" / "whatever")
    _music(tmp_path / ".ttscube" / "models" / "whatever" / "music.wav", 1.5, seed=1)
    other = _music(tmp_path / "other.wav", 0.7, seed=2)
    for kw in ({}, {"background_music_path": other}):
        _same_story(tstory.StoryCube("whatever")(text, "neb", **kw),
                    jstory.StoryCube("whatever")(text, "neb", **kw), steps=1)


def test_storycube_over_local_bases_matches_jax(artifacts, monkeypatch):  # noqa: F811
    """The small fp32 voice served by both StoryCubes from its "cubegan:phonemizer"
    bases: audio within 2 int16 steps, the times within 1e-9 s. The JAX TTSCube's
    template (the tree its `load_params` restores the weight file into) is the file's own
    tree here, in place of an eager flax init of the model (15 s on the CPU); its scans
    are traced unrolled once."""
    from flax import serialization

    tree = serialization.msgpack_restore((artifacts / "cubegan.model").read_bytes())
    monkeypatch.setattr(jstory.TTSCube, "_init_template", lambda self: tree)
    pair = f"{artifacts / 'cubegan'}:{artifacts / 'phonemizer'}"
    with unroll_override(1):
        want = jstory.StoryCube(pair)(STORY, speaker=SPEAKER)
    got = tstory.StoryCube(pair, device="cpu")(STORY, speaker=SPEAKER)
    _same_story(got, want, steps=2, meta_tol=1e-9)
    assert [m["name"] for m in got["meta"]].count("paragraph") == 3


def test_storycube_takes_a_ttscube_and_runs_on_the_card_by_default(artifacts):  # noqa: F811
    cube = tapi.TTSCube(str(artifacts / "cubegan"), str(artifacts / "phonemizer"),
                        device="cpu")
    out = tstory.StoryCube(cube)("hello world.", speaker=SPEAKER)
    assert out["audio"].dtype == np.int16 and len(out["meta"]) == 2
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tstory.StoryCube(f"{artifacts / 'cubegan'}:{artifacts / 'phonemizer'}")


def _pack(src_dir, names, tar_path):
    with tarfile.open(tar_path, "w:gz", compresslevel=1) as tar:
        for n in names:
            tar.add(os.path.join(src_dir, n), arcname=n)


def _volumes(tmp_path, src_dir, names, model, parts):
    """`names` of `src_dir` packed and split into `parts` volumes
    `{root}/{model}/model-NN`; returns the `file://` base to format with the model's
    name, and the volume count."""
    root = tmp_path / "remote"
    os.makedirs(root / model)
    tar_path = tmp_path / f"{model}.tar.gz"
    _pack(src_dir, names, tar_path)
    n = repository.split_volumes(str(tar_path), str(root / model / "model"),
                                 chunk_size=-(-tar_path.stat().st_size // parts))
    return f"file://{root}/{{0}}/model", n


def test_download_model_reassembles_file_volumes(tmp_path):
    src = tmp_path / "export"
    os.makedirs(src / "sub")
    rng = np.random.default_rng(0)
    files = {"a.bin": rng.bytes(5000), "b.txt": b"voice\n", "sub/c.bin": rng.bytes(3001)}
    for n, data in files.items():
        (src / n).write_bytes(data)
    base, n_vol = _volumes(tmp_path, src, list(files), "demo", parts=3)
    assert n_vol == 3
    dest = tmp_path / "cache"
    os.makedirs(dest)
    repository.download_model(str(dest), "demo", download_base=base)
    got = {str(p.relative_to(dest)): p.read_bytes() for p in dest.rglob("*") if p.is_file()}
    assert got == files  # the volumes and the joined archive are gone
    with pytest.raises(RuntimeError, match="no model volumes"):
        repository.download_model(str(dest), "missing", download_base=base)


def test_ttscube_load_from_cache_and_through_a_download(artifacts, monkeypatch,  # noqa: F811
                                                         tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    # in the cache: no download (the base names a directory with no volumes)
    cached = tmp_path / "home" / ".ttscube" / "models" / "cached"
    os.makedirs(cached)
    for n in VOICE_FILES:
        (cached / n).write_bytes((artifacts / n).read_bytes())
    monkeypatch.setattr(repository, "DOWNLOAD_BASE", f"file://{tmp_path}/none/{{0}}/model")
    cube = tapi.TTSCube.load("cached", device="cpu")
    assert cube.device.type == "cpu"
    want = cube("hello world.", SPEAKER)
    assert want.dtype == np.int16 and len(want) > 0
    # not in the cache: fetched from the (file://) download base, then served
    base, n_vol = _volumes(tmp_path, artifacts, VOICE_FILES, "fetched", parts=2)
    assert n_vol == 2
    monkeypatch.setattr(repository, "DOWNLOAD_BASE", base)
    cube = tapi.TTSCube.load("fetched", device="cpu")
    fetched = tmp_path / "home" / ".ttscube" / "models" / "fetched"
    assert sorted(os.listdir(fetched)) == sorted(VOICE_FILES)
    np.testing.assert_array_equal(cube("hello world.", SPEAKER), want)
    with pytest.raises(RuntimeError, match="no model volumes"):
        tapi.TTSCube.load("absent", device="cpu")
