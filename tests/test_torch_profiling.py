"""The port's profiling utilities (`utils/profiling.py`) on the CPU, and the profiling
hook of the fused generator, `generator_apply_fused(..., max_stages=k)`, against the JAX
function's prefixes."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttscube_tpu.models.hifigan_fused import generator_apply_fused as jax_apply_fused
from ttscube_tpu_torch.models.hifigan_fused import generator_apply_fused
from ttscube_tpu_torch.utils.profiling import device_timer, trace
from tests.torch_parity import TINY_HIFI, assert_close, gen_pair, one_cpu_thread, t  # noqa: F401

# PyTorch on one thread: the tier's workers share the machine's cores
pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# four stages, the last 32 wide with kernel == stride == 4: the port fuses it (B1)
HIFI = dict(TINY_HIFI, upsample_initial_channel=512)
FRAMES = 6


def test_device_timer_on_cpu_tensors():
    x = torch.ones(64, 64)
    per_call = device_timer(lambda a: a @ a, x, reps=3)
    assert per_call > 0.0
    pair = device_timer(lambda a: a @ a, x, reps=3, return_compile_time=True)
    assert isinstance(pair, tuple) and len(pair) == 2 and pair[0] > 0.0 and pair[1] > 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(32, 32)
    with trace(str(tmp_path / "tr"), device="cpu") as log_dir:
        (x @ x).sum()
    assert log_dir == str(tmp_path / "tr")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: trace() runs on the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path / "tr")):
            pass


@pytest.fixture(scope="module")
def gen_and_mel():
    jcfg, _, params, tg = gen_pair(HIFI, seed=5)
    mel = np.random.default_rng(6).standard_normal((2, FRAMES, 80)).astype(np.float32)
    return jcfg, params, tg, mel


def test_max_stages_prefixes_match_jax(gen_and_mel):
    """k = 0 … 4 against the JAX prefixes, both packages' plain stages (JAX fuses
    nothing off the TPU); with the port's fused last stage, prefixes 0 … 3 equal the
    plain ones and prefix 4 is the audio, as the JAX function's fused tail returns it."""
    jcfg, params, tg, mel = gen_and_mel
    full = np.asarray(jax_apply_fused(params, jnp.asarray(mel), jcfg))
    with torch.no_grad():
        for k in range(5):
            want = np.asarray(jax_apply_fused(params, jnp.asarray(mel), jcfg, max_stages=k))
            plain = generator_apply_fused(tg, t(mel), tg.config, fuse_channels=(),
                                          max_stages=k)
            assert_close(f"max_stages={k} (plain)", plain, want, 1e-5)
            fused = generator_apply_fused(tg, t(mel), tg.config, max_stages=k)
            assert_close(f"max_stages={k} (fused tail)", fused, full if k == 4 else want, 1e-5)
        # before conv_post and untrimmed: 6 frames → 31 → 94 → 376 → 1504 rows
        assert plain.shape == (2, 1504, 32)


def test_max_stages_none_is_unchanged(gen_and_mel):
    jcfg, params, tg, mel = gen_and_mel
    with torch.no_grad():
        a = generator_apply_fused(tg, t(mel), tg.config)
        b = generator_apply_fused(tg, t(mel), tg.config, max_stages=None)
    assert torch.equal(a, b) and a.shape == (2, FRAMES * 240)
    assert_close("max_stages=None", a, jax_apply_fused(params, jnp.asarray(mel), jcfg), 1e-5)
