"""The port's program spans and counters (`utils/profiling.py`) on the CPU: no profiler
range opens while no profiler records; under `trace()` the spans of `Cubegan.infer`,
`train_step` and a `TTSCube` request are exported, nested as the layers nest; the
counters add up, and `shapes.new.*` rise only at a shape that no earlier call met."""

import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.data.encodings import CubeganEncodings, PhonemizerEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.models.phonemizer import Phonemizer
from ttscube_tpu_torch.utils import profiling
from ttscube_tpu_torch.utils.profiling import count, counters, span, trace
from tests.torch_parity import (LANG, SMALL_HIFI, TINY_HIFI, TRAIN_DISC, TRAIN_LANG,  # noqa: F401
                                one_cpu_thread, text_batch, toy_train_batch)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

DRIVE = Path(__file__).resolve().parent.parent / "artifacts" / "drive_ckpt"
# 96 frames in windows of 16 kept frames and 32-frame halos: 6 windows of 80 frames
FRAMES, CHUNK = 96, 16


@pytest.fixture(scope="module")
def model():
    cfg = tcg.CubeganConfig(languasito=LanguasitoConfig(**LANG),
                            hifigan=HifiganConfig(**TINY_HIFI, fused_tail=True))
    return init_random(tcg.Cubegan(cfg), 0).eval()


def _infer(model):
    X = {k: torch.as_tensor(v).long() for k, v in text_batch().items()}
    return model.infer(X, FRAMES, chunk_frames=CHUNK)


def _spans(log_dir) -> list:
    """The exported `tts.*` spans as (name, start, end, thread), by start."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("tts.")), key=lambda s: (s[1], -s[2]))


def _parent(s, spans):
    """The name, up to '#', of the innermost other span around `s` on its thread."""
    around = [p for p in spans if p is not s and p[3] == s[3] and p[1] <= s[1]
              and s[2] <= p[2]]
    return max(around, key=lambda p: (p[1], -p[2]))[0].split("#")[0] if around else None


def _tree(spans) -> dict:
    """{span name up to '#': the set of its parents' names}."""
    tree = {}
    for s in spans:
        tree.setdefault(s[0].split("#")[0], set()).add(_parent(s, spans))
    return tree


def test_no_profiler_range_opens_while_none_records(model, monkeypatch):
    def refuse(self):
        raise AssertionError(f"record_function {self.name!r} opened with no profiler on")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    with span("tts.test"):
        pass
    assert span("tts.test") is span("tts.test", 3)  # the name's one shared null context
    audio, _ = _infer(model)
    assert audio.shape == (2, FRAMES * 240)


def test_infer_exports_its_spans_nested(model, tmp_path):
    before = counters()
    with trace(str(tmp_path), device="cpu"):
        _infer(model)
    after = counters()
    rise = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("infer.batches", "infer.frames", "gen.windows")}
    assert rise == {"infer.batches": 1, "infer.frames": 2 * FRAMES,
                    "gen.windows": -(-FRAMES // CHUNK)}
    spans = _spans(tmp_path)
    assert [s[0] for s in spans if s[0].startswith("tts.infer")] == \
        [f"tts.infer#{after['infer.batches']}"]
    stages = {f"tts.gen.stage{i}": {"tts.gen.window"} for i in range(4)}
    assert _tree(spans) == {
        "tts.infer": {None}, "tts.text": {"tts.infer"}, "tts.text.tower_t": {"tts.text"},
        "tts.text.durations": {"tts.text"}, "tts.text.pitch": {"tts.text"},
        "tts.text.cond": {"tts.text"}, "tts.gen": {"tts.infer"},
        "tts.gen.window": {"tts.gen"}, "tts.gen.pre": {"tts.gen.window"}, **stages}
    names = [s[0] for s in spans]
    assert names.count("tts.gen.window") == rise["gen.windows"]
    assert all(names.count(n) == rise["gen.windows"] for n in ("tts.gen.pre", *stages))


def test_train_step_exports_its_phases(tmp_path):
    cfg = tcg.CubeganConfig(languasito=LanguasitoConfig(**TRAIN_LANG),
                            hifigan=HifiganConfig(**TINY_HIFI), **TRAIN_DISC)
    state = tcg.create_train_state(init_random(tcg.Cubegan(cfg, train=True), 0), seed=1)
    state.step = 7
    batch = tcg.batch_to_torch(toy_train_batch(), "cpu")
    before = counters().get("train.steps", 0)
    with trace(str(tmp_path), device="cpu"):
        tcg.train_step(state, batch)
    assert counters()["train.steps"] == before + 1 and state.step == 8
    tree = _tree(_spans(tmp_path))
    phases = ("forward", "d_loss", "d_backward", "d_opt", "gt_loss", "gt_backward", "gt_opt")
    assert names_of(_spans(tmp_path), "tts.train.step") == ["tts.train.step#7"]
    assert {p: tree[f"tts.train.{p}"] for p in phases} == {p: {"tts.train.step"}
                                                          for p in phases}
    assert tree["tts.text"] == tree["tts.gen"] == {"tts.train.forward"}
    assert tree["tts.gen.pre"] == tree["tts.gen.stage3"] == {"tts.gen"}
    # the discriminators' spans open wherever they run: the D loss, then the G/T loss
    assert tree["tts.disc.mpd"] == tree["tts.disc.msd"] == {"tts.train.d_loss",
                                                            "tts.train.gt_loss"}


def names_of(spans, prefix: str) -> list:
    return [s[0] for s in spans if s[0].split("#")[0] == prefix]


def _cube(duration: int):
    """A TTSCube of seeded weights whose duration head predicts `duration` frames for
    every phone, so that a text's frame bucket follows from its length."""
    enc = CubeganEncodings(str(DRIVE / "cubegan.encodings"))
    penc = PhonemizerEncodings(str(DRIVE / "phonemizer.encodings"))
    hifi = {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_HIFI.items()}
    cfg = tapi.config_from_yaml({"hop_size": 16, "hifigan": hifi}, enc)
    state = init_random(tcg.Cubegan(cfg), 0).state_dict()
    state["lang.dur_output.weight"].zero_()
    state["lang.dur_output.bias"].fill_(-1.0)[duration] = 1.0
    pstate = init_random(Phonemizer(tapi.phonemizer_config(penc)), 1).state_dict()
    cube = tapi.TTSCube.from_state_dicts(cfg, enc, penc, state, pstate, device="cpu")
    return cube, next(iter(enc.speaker2int))


def test_request_spans_and_new_shapes(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_shapes", set())  # as in a fresh process
    cube, speaker = _cube(duration=16)
    short, long = "ab ba ab.", "ab ba ab ba ab ba ab ba ab ba."  # both in one phone bucket
    assert (cube.frames(short, speaker) <= tapi.FRAME_BUCKET
            < cube.frames(long, speaker) <= 2 * tapi.FRAME_BUCKET)
    cube.warmup(frame_buckets=(tapi.FRAME_BUCKET,), char_lens=(tapi.CHAR_BUCKET,),
                speaker=speaker)

    def new_shapes():
        return {k: v for k, v in counters().items() if k.startswith("shapes.new.")}

    warmed, requests = new_shapes(), counters().get("api.requests", 0)
    with trace(str(tmp_path), device="cpu"):
        pcm = cube(short, speaker=speaker)
    assert pcm.dtype == np.int16 and len(pcm) == cube.frames(short, speaker) * 16
    assert new_shapes() == warmed  # the warmed frame bucket
    assert counters()["api.requests"] == requests + 1
    spans = _spans(tmp_path)
    tree = _tree(spans)
    assert names_of(spans, "tts.api.request") == [f"tts.api.request#{requests + 1}"]
    assert {n: tree[n] for n in ("tts.api.phonemize", "tts.api.collate", "tts.api.durations",
                                 "tts.infer", "tts.api.to_host")} == {
        n: {"tts.api.request"} for n in ("tts.api.phonemize", "tts.api.collate",
                                         "tts.api.durations", "tts.infer", "tts.api.to_host")}
    cube(long, speaker=speaker)  # the next frame bucket, which warmup did not run
    got = new_shapes()
    assert (got["shapes.new.text"], got["shapes.new.gen"]) == (
        warmed["shapes.new.text"] + 1, warmed["shapes.new.gen"] + 1)


def test_counts_from_many_threads_add_up():
    """Kernel wrappers count from autograd's thread too: no add may be lost."""
    n, each = 16, 2000
    before = counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count("test.threads") for _ in range(each)])
                   for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counters()["test.threads"] == before + n * each
