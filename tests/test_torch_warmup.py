"""`TTSCube.warmup` drives what a request drives (fault C7). After warmup, a request
whose text has a warmed length meets only inputs that warmup met: the phonemizer's input
shape, the model's input shapes after the collate's buckets, the frame bucket of
synthesis, and the audio's copy to the host and int16 conversion, which warmup also
runs. The phonemizer runs on the exact character count, as in the JAX API, and warmup
also runs it alone at each power of two characters up to 512, so that on the card the
modules of its kernels for each range of lengths are loaded (C7).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.phonemizer import Phonemizer
from tests.torch_parity import SMALL_HIFI, one_cpu_thread  # noqa: F401

# PyTorch on one thread: beside the tier's other workers its spinning pool threads
# slow these tests tenfold (tests/torch_parity.py `one_cpu_thread`)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

DRIVE = Path(__file__).resolve().parent.parent / "artifacts" / "drive_ckpt"


def _recording_cube():
    enc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    penc = PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    hifi = {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFI.items()}
    cfg = tapi.config_from_yaml({"hop_size": 16, "hifigan": hifi}, enc)
    state = init_random(tcg.Cubegan(cfg), 0).state_dict()
    pstate = init_random(Phonemizer(tapi.phonemizer_config(penc)), 1).state_dict()
    cube = tapi.TTSCube.from_state_dicts(cfg, enc, penc, state, pstate, device="cpu")
    seen = []
    phon = cube.text2feat.phonemizer
    phon_forward = phon.forward
    phon.forward = lambda X: seen.append(("phonemizer", tuple(X["x_char"].shape))) or \
        phon_forward(X)
    infer = cube.model.infer
    cube.model.infer = lambda X, max_frames, **kw: seen.append(
        ("infer", tuple(sorted((k, tuple(v.shape)) for k, v in X.items())), max_frames)) \
        or infer(X, max_frames, **kw)
    to_host, int16 = cube._to_host, cube._int16
    cube._to_host = lambda audio, total: seen.append(("to_host", tuple(audio.shape))) or \
        to_host(audio, total)
    cube._int16 = lambda audio: seen.append(("int16",)) or int16(audio)
    return cube, next(iter(enc.speaker2int)), seen


def test_warmup_drives_what_a_request_drives():
    cube, speaker, seen = _recording_cube()
    # the length of warmup's text for CHAR_BUCKET characters (29)
    n = len(" ".join("ab" for _ in range(tapi.CHAR_BUCKET // 3))[: tapi.CHAR_BUCKET - 1])
    text = ("ba " * n)[:n - 1] + "."
    frames = cube.frames(text, speaker=speaker)  # the request's frame bucket, warmed below
    bucket = -(-frames // tapi.FRAME_BUCKET) * tapi.FRAME_BUCKET
    seen.clear()
    with torch.inference_mode():
        cube.warmup(frame_buckets=(bucket,), char_lens=(tapi.CHAR_BUCKET,))
    warmed = set(seen)
    assert {kind[0] for kind in warmed} == {"phonemizer", "infer", "to_host", "int16"}
    assert ("phonemizer", (1, n + 2)) in warmed  # the text and two '§'
    # and the phonemizer alone at each power of two characters up to 512
    assert {("phonemizer", (1, 2 ** k + 2)) for k in range(1, 10)} <= warmed
    seen.clear()
    pcm = cube(text, speaker=speaker)
    assert pcm.dtype == np.int16 and len(pcm) > 0
    assert set(seen) <= warmed, set(seen) - warmed
