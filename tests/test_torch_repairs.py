"""Faults of the port found against the JAX package and repaired: the crop offsets of
training and validation (each from its own generator, as JAX derives its keys), and
checkpoint yaml keys of the JAX HifiganConfig that the port accepts and ignores."""

import numpy as np
import pytest
import torch
import yaml

from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch.convert import init_random
from ttscube_tpu_torch.data.encodings import CubeganEncodings
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.models import languasito as tla
from tests.torch_parity import (TINY_HIFI, TRAIN_DISC, TRAIN_LANG, one_cpu_thread,  # noqa: F401
                                toy_train_batch)

# PyTorch on one thread beside the tier's other workers (tests/torch_parity.py)
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# 70 phones give 227-245 frames: both the 50-frame train windows and the 200-frame
# validation windows have starts to draw
BATCH = toy_train_batch(B=2, N=70, F=260, seed=3)


@pytest.fixture
def model():
    cfg = tcg.CubeganConfig(languasito=tla.LanguasitoConfig(**TRAIN_LANG),
                            hifigan=thg.HifiganConfig(**TINY_HIFI), **TRAIN_DISC)
    return init_random(tcg.Cubegan(cfg, train=True), 0)


@pytest.fixture
def drawn(monkeypatch):
    """Every crop offset drawn, as (window, starts), in order."""
    seen, crop_starts = [], tcg.Cubegan.crop_starts

    def record(self, n_frames, window, generator):
        starts = crop_starts(self, n_frames, window, generator)
        seen.append((window, starts.tolist()))
        return starts

    monkeypatch.setattr(tcg.Cubegan, "crop_starts", record)
    return seen


def test_validation_leaves_the_training_crops_alone(model, drawn):
    """A val_step between two train steps changes neither the second step's crops nor
    its losses (JAX draws train crops from fold_in(key, step), validation from its own
    fixed key)."""
    import copy

    batch = tcg.batch_to_torch(BATCH, "cpu")
    runs = []
    for validate in (False, True):
        state = tcg.create_train_state(copy.deepcopy(model), seed=7)
        drawn.clear()
        tcg.train_step(state, batch)
        if validate:
            tcg.val_step(state, batch)
        _, metrics = tcg.train_step(state, batch)
        runs.append(([d for d in drawn if d[0] == tcg.TRAIN_FRAMES], metrics))
    (crops, metrics), (crops_v, metrics_v) = runs
    assert len(crops) == len(crops_v) == 2
    assert crops[0][1] != crops[1][1]  # each step draws anew
    assert crops == crops_v
    assert all(torch.equal(metrics[k], metrics_v[k]) for k in metrics)


def test_validation_windows_repeat(model, drawn):
    """Two val_step calls on one state, with a train step between them, see the same
    windows and, without the step, give equal metrics."""
    batch = tcg.batch_to_torch(BATCH, "cpu")
    state = tcg.create_train_state(model, seed=7)
    first = tcg.val_step(state, batch)
    second = tcg.val_step(state, batch)
    tcg.train_step(state, batch)
    tcg.val_step(state, batch)
    windows = [d[1] for d in drawn if d[0] == tcg.VAL_FRAMES]
    assert len(windows) == 3 and windows[0] == windows[1] == windows[2]
    assert max(windows[0]) > 0  # there were starts to draw
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_crop_generators_depend_on_seed_and_step():
    draw = lambda g: torch.rand(4, generator=g)
    assert torch.equal(draw(tcg.crop_generator(1, 5)), draw(tcg.crop_generator(1, 5)))
    assert not torch.equal(draw(tcg.crop_generator(1, 5)), draw(tcg.crop_generator(1, 6)))
    assert not torch.equal(draw(tcg.crop_generator(1, 5)), draw(tcg.crop_generator(2, 5)))
    assert not torch.equal(draw(tcg.crop_generator(1)), draw(tcg.crop_generator(1, 0)))


@pytest.mark.parametrize("key,value", [
    ("fused_train_max_batch", 8), ("fold_narrow", True), ("polyphase_channels", [32, 64])])
def test_yaml_with_jax_only_hifigan_keys_builds_the_same_model(key, value):
    """A checkpoint yaml may hold fields of the JAX HifiganConfig that change no value
    in the port: it loads, and gives the config and the model it gives without them."""
    from pathlib import Path

    enc = CubeganEncodings(str(Path(__file__).resolve().parent.parent / "artifacts"
                               / "drive_ckpt" / "cubegan.encodings"))
    base = {"sample_rate": 24000, "hop_size": 240,
            "hifigan": {"upsample_initial_channel": 64, "storage_dtype": "float32"}}
    with_key = yaml.safe_load(yaml.dump(dict(base, hifigan=dict(base["hifigan"], **{key: value}))))
    cfg, cfg_key = tapi.config_from_yaml(base, enc), tapi.config_from_yaml(with_key, enc)
    assert cfg_key == cfg
    sd, sd_key = (init_random(tcg.Cubegan(c), 0).state_dict() for c in (cfg, cfg_key))
    assert sd.keys() == sd_key.keys()
    assert all(torch.equal(sd[k], sd_key[k]) for k in sd)
    assert np.all([v.shape == sd_key[k].shape for k, v in sd.items()])
