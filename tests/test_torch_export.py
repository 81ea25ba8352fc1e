"""The port's model packaging (`ttscube_tpu_torch/scripts/export_model.py`) against
`scripts/export_model.py`, run in a subprocess on the CPU, on one seeded training state:
the same `.model` bytes, the same number of volumes, the same descriptor keys; the
packaged files serve in both packages' TTSCube with audio within 5e-5 (fp32 serving, as
tests/test_torch_api.py), and a fastText model without its word vectors is refused."""

import os
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import yaml

from ttscube_tpu_torch.api import TTSCube, phonemizer_config
from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.models.phonemizer import Phonemizer
from ttscube_tpu_torch.scripts import export_model
from ttscube_tpu_torch.utils import config_io
from ttscube_tpu_torch.utils.checkpoint import save_params
from tests.torch_parity import (SMALL_HIFI, TRAIN_DISC, assert_close,  # noqa: F401
                                one_cpu_thread)

# PyTorch on one thread: beside the tier's other workers its spinning pool threads
# slow these tests tenfold (tests/torch_parity.py `one_cpu_thread`)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

ROOT = Path(__file__).resolve().parent.parent
DRIVE = ROOT / "artifacts" / "drive_ckpt"
HIFI = dict(SMALL_HIFI, storage_dtype="float32")


def _run(folder: Path, conditioning=None):
    """A trained run's files in `folder`: cubegan.{last,yaml,encodings} (seeded weights of
    the whole Cubegan, discriminators included) and phonemizer.{sacc.best,encodings}."""
    folder.mkdir()
    enc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    enc.save(str(folder / "cubegan.encodings"))
    penc = PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    penc.save(str(folder / "phonemizer.encodings"))
    cfg = tcg.CubeganConfig(
        languasito=LanguasitoConfig(num_phones=len(enc.phon2int),
                                    num_speakers=len(enc.speaker2int),
                                    max_pitch=enc.max_pitch, max_duration=enc.max_duration),
        hifigan=HifiganConfig(**HIFI), hop_size=16, **TRAIN_DISC)
    save_params(str(folder / "cubegan.last"), init_random(tcg.Cubegan(cfg, train=True), 3))
    save_params(str(folder / "phonemizer.sacc.best"),
                init_random(Phonemizer(phonemizer_config(penc)), 4))
    config_io.dump({"sample_rate": 24000, "hop_size": 16, "conditioning": conditioning,
                    "hifigan": {k: [list(x) if isinstance(x, tuple) else x for x in v]
                                if isinstance(v, tuple) else v for k, v in HIFI.items()}},
                   str(folder / "cubegan.yaml"))


def _unpack(out_base: Path, n: int, dest: Path):
    dest.mkdir()
    with open(dest / "model.tar.gz", "wb") as f:
        for i in range(n):
            f.write(Path(f"{out_base}-{i:02d}").read_bytes())
    with tarfile.open(dest / "model.tar.gz", "r:gz") as tar:
        tar.extractall(dest)
    return dest


def test_export_matches_jax_and_serves_in_both(tmp_path):
    from ttscube_tpu.api import TTSCube as JaxTTSCube
    from tests.test_torch_api import _jax_synthesize_as

    _run(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    flags = lambda who: ["--input-model", str(tmp_path / who / "cubegan"),
                         "--input-phonemizer", str(tmp_path / who / "phonemizer"),
                         "--output-model", str(tmp_path / who / "dist")]
    n = export_model.main(flags("port"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "scripts/export_model.py", *flags("jax")],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]

    ours, theirs = (tmp_path / w / "cubegan.model" for w in ("port", "jax"))
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.stat().st_size < (tmp_path / "port" / "cubegan.last").stat().st_size
    n_jax = len(list((tmp_path / "jax").glob("dist-*")))
    assert n == n_jax >= 1
    desc = [yaml.safe_load(open(tmp_path / w / "dist.yaml")) for w in ("port", "jax")]
    assert desc[0] == desc[1] and set(desc[0]) == {"version", "phonemizer", "synthesis",
                                                    "language", "description"}

    pkg = _unpack(tmp_path / "port" / "dist", n, tmp_path / "pkg")
    assert sorted(p.name for p in pkg.iterdir() if p.name != "model.tar.gz") == [
        "cubegan.encodings", "cubegan.model", "cubegan.yaml", "phonemizer.encodings",
        "phonemizer.model"]
    jc = JaxTTSCube(str(pkg / "cubegan"), str(pkg / "phonemizer"))
    tc = TTSCube(str(pkg / "cubegan"), str(pkg / "phonemizer"), device="cpu")
    speaker = next(iter(tc.encodings.speaker2int))
    for text in ("hello world.", "speak to me."):
        want, total = _jax_synthesize_as(jc, text, speaker)
        got, t_total = tc.synthesize(text, speaker)
        assert t_total == total and np.abs(want).max() > 1e-4
        assert_close("exported model, TTSCube audio", got, want, 5e-5)


def test_export_refuses_conditioned_models(tmp_path):
    """A fastText-conditioned model without its word vectors (`--wordvec`) is refused,
    as the JAX exporter refuses it; conditioned models that have what they need export
    (tests/test_torch_lm_serve.py)."""
    _run(tmp_path / "run", conditioning="fasttext:en")
    with pytest.raises(SystemExit, match="--wordvec"):
        export_model.main(["--input-model", str(tmp_path / "run" / "cubegan"),
                           "--input-phonemizer", str(tmp_path / "run" / "phonemizer"),
                           "--output-model", str(tmp_path / "dist")])
