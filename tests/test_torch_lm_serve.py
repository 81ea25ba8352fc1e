"""The LM-conditioned slice end to end on the CPU: the port's TTSCube on a JAX-written
HF voice and a fastText voice against the JAX TTSCube (audio within 5e-5, fp32
serving, as tests/test_torch_api.py), the trainer CLI with `--lm hf:` and `--lm
fasttext:` (its fail-fast messages, two steps, the encoder in the `b` partition,
resume), `export_model` with `cubegan.hf/` and `--wordvec` and the exported voices
served with the tokenizer directory moved away, and an HF step over a (2, 1) gloo mesh
against the step without the mesh."""

import functools
import os
import shutil
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ttscube_tpu.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu.models import lm as jlm
from ttscube_tpu.models.cubegan import Cubegan, CubeganConfig
from ttscube_tpu.models.hifigan import HifiganConfig
from ttscube_tpu.models.languasito import LanguasitoConfig
from ttscube_tpu.models.phonemizer import Phonemizer, PhonemizerConfig
from ttscube_tpu.utils.checkpoint import save_params
from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.parallel import mesh as pm
from tests import torch_mesh_ranks as ranks
from tests.test_torch_api import _jax_synthesize_as
from tests.test_torch_lm_cond import HF_LANG, LM, _b_error, hf_batch
from tests.torch_parity import (GRAD_TOL, SHARE, SMALL_HIFI, TINY_HIFI,  # noqa: F401
                                TRAIN_DISC, assert_close, exact_cpu_convs, grad_error,
                                one_cpu_thread, param_error, random_params, train_pair)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

HOP = 16  # SMALL_HIFI upsamples ×16
DRIVE = Path(__file__).resolve().parent.parent / "artifacts" / "drive_ckpt"
TEXTS = ("selami tokun ka.", "hello world.")
VEC_WORDS = ("selami", "tokun", "ka", "hello")
TIMEOUT = 240


def _vec(path: Path, dim: int = 300) -> str:
    rng = np.random.default_rng(5)
    path.write_text(f"{len(VEC_WORDS)} {dim}\n" + "".join(
        w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(dim)) + "\n"
        for w in VEC_WORDS))
    return str(path)


def _voice(base: Path, kind: str, lm_dir: str) -> str:
    """A `kind` ("hf" or "fasttext") voice written by the JAX package's code: the model
    yaml, encodings, `.model` (and the JAX `.last` layout for export: {lang, gen, hf})."""
    enc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    enc.save(str(base / f"{kind}.encodings"))
    hifi = dict(SMALL_HIFI, storage_dtype="float32")
    conf = {"sample_rate": 24000, "hop_size": HOP,
            "hifigan": {k: list(v) if isinstance(v, tuple) else v for k, v in hifi.items()}}
    lm_config = None
    if kind == "hf":
        lm_config = jlm.LMConfig.from_local_dir(lm_dir)
        conf.update(conditioning=f"hf:{lm_dir}", lm_config=lm_config.to_dict())
    else:
        conf.update(conditioning=f"fasttext:{_vec(base / 'words.vec')}")
    yaml.dump(conf, open(base / f"{kind}.yaml", "w"))
    model = Cubegan(CubeganConfig(
        languasito=LanguasitoConfig(
            num_phones=len(enc.phon2int), num_speakers=len(enc.speaker2int),
            max_pitch=enc.max_pitch, max_duration=enc.max_duration, cond_type=kind,
            lm_dim=None if lm_config is None else lm_config.hidden_size),
        hifigan=HifiganConfig(**hifi), hop_size=HOP), train=False)
    dim = model.config.languasito.lm_input_dim
    lang = random_params(model.languasito, {
        "x_char": jnp.zeros((1, 8), jnp.int32), "x_speaker": jnp.zeros((1, 1), jnp.int32),
        "y_frame2phone": jnp.zeros((1, 16), jnp.int32),
        "y_pitch": jnp.zeros((1, 16), jnp.float32),
        "x_words": jnp.zeros((1, 4, dim), jnp.float32),
        "x_phon2word": jnp.zeros((1, 8), jnp.int32)}, seed=11)
    tree = {"lang": lang, "gen": random_params(model.generator, jnp.zeros((1, 4, 80)), seed=12)}
    if lm_config is not None:
        tree["hf"] = random_params(jlm.TransformerEncoder(lm_config),
                                   jnp.zeros((1, 8), jnp.int32), seed=13)
    save_params(str(base / f"{kind}.model"), tree)
    save_params(str(base / f"{kind}.last"), tree)
    if kind == "fasttext":
        from ttscube_tpu.utils.wordvec import WordVectors

        WordVectors.load_vec(str(base / "words.vec")).save_npz(str(base / f"{kind}.wordvec.npz"))
    return str(base / kind)


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    from ttscube_tpu_torch.scripts import make_demo_lm

    base = tmp_path_factory.mktemp("lm_voices")
    penc = PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    penc.save(str(base / "phonemizer.encodings"))
    pm_ = Phonemizer(PhonemizerConfig(num_graphemes=len(penc.graphemes),
                                      num_phonemes=len(penc.phonemes)))
    save_params(str(base / "phonemizer.model"), random_params(
        pm_, {"x_char": jnp.zeros((1, 8), jnp.int32),
              "x_case": jnp.zeros((1, 8), jnp.int32)}, seed=0))
    shutil.copy(base / "phonemizer.model", base / "phonemizer.sacc.best")
    lm_dir = make_demo_lm.main(["--output", str(base / "lm"), "--hidden", "32", "--layers",
                                "2", "--heads", "4", "--pad-vocab", "128", "--seed", "3"])
    return base, {k: _voice(base, k, lm_dir) for k in ("hf", "fasttext")}, lm_dir


@pytest.mark.parametrize("kind", ["hf", "fasttext"])
def test_ttscube_matches_jax(voices, kind):
    """The same model inputs (every `x_` array), durations and audio (5e-5)."""
    from ttscube_tpu.api import TTSCube as JaxTTSCube

    base, paths, _ = voices
    jc = JaxTTSCube(paths[kind], str(base / "phonemizer"))
    tc = tapi.TTSCube(paths[kind], str(base / "phonemizer"), device="cpu")
    speaker = next(iter(tc.encodings.speaker2int))
    assert hasattr(tc.model, "hf") == (kind == "hf")
    for text in TEXTS:
        Xj, Xt = jc._prepare(text, speaker), tc._prepare(text, speaker)
        assert set(Xj) == set(Xt) and ("x_tok_ids" in Xt) == (kind == "hf") \
            and ("x_words" in Xt) == (kind == "fasttext")
        for k, v in Xt.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(Xj[k]), err_msg=k)
        want, total = _jax_synthesize_as(jc, text, speaker)
        got, t_total = tc.synthesize(text, speaker)
        assert t_total == total and np.abs(want).max() > 1e-3
        assert_close(f"TTSCube {kind} voice audio fp32", got, want, 5e-5)
    tc.warmup(frame_buckets=(256,), char_lens=(16,), speaker=speaker)


def _cli_args(tmp_path, corpus, name, lm):
    return ["--train-folder", str(corpus), "--dev-folder", str(corpus), "--output-base",
            str(tmp_path / name / "cubegan"), "--batch-size", "2", "--max-steps", "2",
            "--epoch-generation", "1", "--device", "cpu", "--lm", lm]


def test_trainer_cli_fails_fast_on_bad_lm_specs(tmp_path, voices):
    """As the JAX trainer (tests/test_hf_integration.py): no directory, an unreadable
    tokenizer or config.json, an unknown spec; each stops before a file is written. A
    directory without weights warns and starts the encoder from random weights."""
    from ttscube_tpu_torch.scripts import train_cubegan as cli

    _, _, lm_dir = voices
    no_tok = tmp_path / "no_tok"
    no_tok.mkdir()
    bad_cfg = tmp_path / "bad_cfg"
    bad_cfg.mkdir()
    shutil.copy(os.path.join(lm_dir, "tokenizer.json"), bad_cfg)
    (bad_cfg / "config.json").write_text("{not json")
    for spec, match in ((f"hf:{tmp_path / 'missing'}", "local model directory"),
                        (f"hf:{no_tok}", "could not load a tokenizer"),
                        (f"hf:{bad_cfg}", "could not read"),
                        ("bogus:whatever", "unknown --lm spec")):
        with pytest.raises(SystemExit, match=match):
            cli.main(_cli_args(tmp_path, tmp_path, "out", spec))
    assert not (tmp_path / "out").exists()
    no_weights = tmp_path / "no_weights"
    shutil.copytree(lm_dir, no_weights, ignore=shutil.ignore_patterns("*.bin"))
    cond, cfg, state, tok = cli.lm_setup(f"hf:{no_weights}")
    assert cond == "hf" and state is None and cfg.hidden_size == 32 and tok is not None


@pytest.mark.usefixtures("exact_cpu_convs")
def test_trainer_cli_trains_conditioned_voices(tmp_path, voices, monkeypatch, capsys):
    """`--lm hf:<dir>` and `--lm fasttext:<vec>` on the tiny config (narrowed as
    tests/test_torch_trainer.py narrows it): two steps each, the yaml's spec and
    `lm_config`, the imported encoder moved by the b partition's Adam (0 < |Δ| < 1e-4),
    devset synthesis, and --resume bit-equal."""
    from tests.test_data import make_corpus
    from ttscube_tpu_torch.models.hifigan import HifiganConfig as THifi
    from ttscube_tpu_torch.models.lm import load_local_lm
    from ttscube_tpu_torch.scripts import train_cubegan as cli
    from ttscube_tpu_torch.utils import checkpoint as ckpt

    base, _, lm_dir = voices
    make_corpus(tmp_path / "corpus", n=4)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcg, "CubeganConfig", functools.partial(
        tcg.CubeganConfig, hifigan=THifi(**TINY_HIFI), **TRAIN_DISC))
    for name, spec in (("hf", f"hf:{lm_dir}"), ("ft", f"fasttext:{base / 'words.vec'}")):
        args = _cli_args(tmp_path, tmp_path / "corpus", name, spec)
        state = cli.train_on(cli.parse_args(args), torch.device("cpu"))
        assert state.step == 2
        conf = ckpt.load_config(str(tmp_path / name / "cubegan"))
        assert conf["conditioning"] == spec
        assert sorted(os.listdir(tmp_path / "generated_files" / "free")) == \
            [f"utt{i}.wav" for i in range(4)]
        resumed = cli.train_on(cli.parse_args(args + ["--resume", "--max-epochs", "0"]),
                               torch.device("cpu"))
        sa, sb = state.model.state_dict(), resumed.model.state_dict()
        assert resumed.step == 2 and all(torch.equal(v, sb[k]) for k, v in sa.items())
        if name == "hf":
            assert conf["lm_config"] == load_local_lm(lm_dir)[0].to_dict()
            _, imported = load_local_lm(lm_dir)
            moved = max(float((v - state.model.hf.state_dict()[k]).abs().max())
                        for k, v in imported.items())
            print(f"\nparity trainer CLI --lm hf: the imported encoder moved by {moved:.3e} "
                  "in 2 steps (Adam at 1e-6)")
            assert 0 < moved < 1e-4 and "b" in state.optimizers
        else:
            assert not hasattr(state.model, "hf") and "b" not in state.optimizers
            assert state.model.lang.tower_t.lm.input_size == 300


def test_export_packs_and_serves_conditioned_voices(tmp_path, voices):
    """export_model packs `--wordvec` (a .vec, written as .wordvec.npz) and the HF
    tokenizer's files as `cubegan.hf/` (no weight file: the encoder is in cubegan.model);
    TTSCube serves each export, the HF one with the tokenizer directory moved away,
    as it serves the voice's own files."""
    from ttscube_tpu_torch.scripts import export_model

    base, paths, lm_dir = voices
    speaker = "spk1"
    want = {}
    for kind in ("hf", "fasttext"):
        cube = tapi.TTSCube(paths[kind], str(base / "phonemizer"), device="cpu")
        speaker = next(iter(cube.encodings.speaker2int))
        want[kind] = cube.synthesize(TEXTS[0], speaker)[0]
    moved = tmp_path / "lm_moved"
    for kind in ("hf", "fasttext"):
        extra = ["--wordvec", str(base / "words.vec")] if kind == "fasttext" else []
        out = tmp_path / f"dist_{kind}"
        out.mkdir()
        n = export_model.main(["--input-model", paths[kind], "--input-phonemizer",
                               str(base / "phonemizer"), "--output-model",
                               str(out / "voice")] + extra)
        pkg = out / "pkg"
        pkg.mkdir()
        with open(pkg / "v.tar.gz", "wb") as f:
            for i in range(n):
                f.write((out / f"voice-{i:02d}").read_bytes())
        with tarfile.open(pkg / "v.tar.gz", "r:gz") as tar:
            names = sorted(tar.getnames())
            tar.extractall(pkg)
        if kind == "hf":
            assert {"cubegan.hf/tokenizer.json", "cubegan.hf/config.json",
                    "cubegan.hf/tokenizer_config.json"} <= set(names)
            assert not any(nm.endswith(".bin") for nm in names)
            shutil.move(lm_dir, moved)  # only cubegan.hf/ can serve it now
        else:
            assert "cubegan.wordvec.npz" in names
        try:
            got = tapi.TTSCube(str(pkg / "cubegan"), str(pkg / "phonemizer"),
                               device="cpu").synthesize(TEXTS[0], speaker)[0]
        finally:
            if moved.exists():
                shutil.move(moved, lm_dir)
        assert_close(f"exported {kind} voice vs its own files", got, want[kind], 0.0)
    # a fastText voice without its word vectors is refused
    with pytest.raises(SystemExit, match="--wordvec"):
        export_model.main(["--input-model", paths["fasttext"], "--input-phonemizer",
                           str(base / "phonemizer"), "--output-model",
                           str(tmp_path / "refused")])


@pytest.mark.usefixtures("exact_cpu_convs")
def test_hf_step_over_a_mesh_matches_one_process():
    """One HF train step over a (2, 1) gloo mesh (the encoder sharded by FSDP2 as a unit
    of its own) against the same step in one process: losses 2e-4 relative, grads
    within GRAD_TOL of each module's largest, parameters as tests/test_torch_lm_cond.py
    holds them."""
    from ttscube_tpu_torch.convert import spectral_to_jax, state_dict_to_jax

    batch = hf_batch(seed=2)
    _, _, tm = train_pair(TINY_HIFI, batch, seed=2, lang=HF_LANG, lm=LM)
    starts = np.array([3, 1])
    params, spectral = state_dict_to_jax(tm), spectral_to_jax(tm)["msd"]
    metrics, grads, after, _ = pm.spawn(
        ranks.step_rank, 2, "cpu", timeout=TIMEOUT,
        args=((2, 1), (HF_LANG, TINY_HIFI, TRAIN_DISC), params, spectral, batch, starts, 1,
              LM))
    state = tcg.create_train_state(tm)
    _, met = tcg.train_step(state, tcg.batch_to_torch(batch, "cpu"),
                            starts=torch.from_numpy(starts))
    for k, v in met.items():
        rel = abs(metrics[0][k] - float(v)) / abs(float(v))
        assert rel <= 2e-4, (k, rel)
    got_g = {n: torch.from_numpy(g) for n, g in grads[0].items()}
    want_g = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
    assert any(n.startswith("hf.") for n in got_g)
    err = grad_error(got_g, want_g)
    gdt = [n for n in want_g if not n.startswith("hf.")]
    worst, share, within = param_error({n: torch.from_numpy(after[0][n]) for n in gdt},
                                       {n: tm.state_dict()[n] for n in gdt}, tm.config.lr)
    b_worst, b_share, b_within, _ = _b_error(
        {n: torch.from_numpy(after[0][n]) for n in want_g if n.startswith("hf.")},
        tm.state_dict())
    print(f"\nparity hf step over a (2, 1) mesh vs one process: grads {err:.3e} of a "
          f"module's largest (tol {GRAD_TOL:.0e}); params g/d/t max {worst:.3f} lr, b max "
          f"{b_worst:.3f} lr (1e-6), beyond 0.01 lr {share:.2e} / {b_share:.2e}")
    assert err <= GRAD_TOL and within and share <= SHARE and b_within and b_share <= SHARE
