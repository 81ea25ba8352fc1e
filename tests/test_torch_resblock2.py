"""ResBlock2 (`resblock="2"`, HiFi-GAN v3's residual block: one conv per dilation) in the
port's `Generator` against the JAX package's on the CPU, its parameters across
`convert.py` both ways, the fused generator functions refusing it, and the checkpoint
yaml carrying `resblock` and `compute_dtype`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import yaml

from ttscube_tpu.models import hifigan as jhg
from ttscube_tpu_torch import api as tapi
from ttscube_tpu_torch import convert
from ttscube_tpu_torch.data.encodings import CubeganEncodings
from ttscube_tpu_torch.models import hifigan as thg
from ttscube_tpu_torch.models import hifigan_fused as thf
from ttscube_tpu_torch.utils import config_io
from tests.torch_parity import SMALL_HIFI, assert_close, gen_pair, one_cpu_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# SMALL_HIFI's stages with v3's residual blocks (the public HiFi-GAN v3 config's kernels
# and dilations)
V3_BLOCKS = dict(resblock="2", resblock_kernel_sizes=(3, 5, 7),
                 resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
HIFI2 = dict(SMALL_HIFI, **V3_BLOCKS)


@pytest.fixture(scope="module")
def pair():
    return gen_pair(HIFI2, seed=21)


def test_resblock2_generator_matches_jax(pair):
    """Generator.forward against JAX's Generator.apply, fp32, 5e-5."""
    jcfg, jg, params, tg = pair
    assert isinstance(tg.res_0_0, thg.ResBlock2)
    mel = np.random.default_rng(21).standard_normal((2, 23, 80)).astype(np.float32)
    want = np.asarray(jg.apply({"params": params}, mel))
    with torch.no_grad():
        got = tg(t(mel)).numpy()
    assert want.shape == (2, 23 * jcfg.total_upsample) and np.abs(want).max() > 1e-2
    assert_close("ResBlock2 Generator fp32", got, want, 5e-5)


def test_resblock2_parameters_cross_both_ways(pair):
    """One conv per dilation, named WNConv1d_0..len(d)-1 as in the JAX tree; JAX →
    port → JAX and port → JAX → port are bit-exact."""
    _, _, params, tg = pair
    assert sorted(params["res_1_2"]) == ["WNConv1d_0", "WNConv1d_1"]
    assert [n for n, _ in tg.res_1_2.named_children()] == ["WNConv1d_0", "WNConv1d_1"]
    back = convert.state_dict_to_jax(tg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))
    sd = tg.state_dict()
    again = convert.jax_to_state_dict(thg.Generator(thg.HifiganConfig(**HIFI2)), back)
    assert sd.keys() == again.keys()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_fused_functions_refuse_resblock2(pair):
    """The JAX functions read 2·len(d) convs per block and fail with a KeyError on a
    ResBlock2 generator; the port's raise a ValueError that names the resblock kind."""
    _, _, _, tg = pair
    mel = torch.zeros(1, 4, 80)
    with pytest.raises(ValueError, match="resblock '2'"):
        thf.generator_apply_fused(tg, mel, tg.config)
    with pytest.raises(ValueError, match="resblock '2'"):
        thf.generator_apply_fused_train(tg, mel, tg.config)
    with pytest.raises(ValueError, match="resblock"):
        thg.Generator(thg.HifiganConfig(resblock="3"))


def test_checkpoint_yaml_carries_resblock_and_compute_dtype(tmp_path):
    """A checkpoint yaml written by the port's writer reads back equal with its reader
    and with yaml, and `config_from_yaml` builds the HifiganConfig it names."""
    hifi = {"resblock": "2", "compute_dtype": "bfloat16", "fused_tail": False,
            "resblock_kernel_sizes": [3, 5, 7],
            "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
    conf = {"sample_rate": 24000, "hop_size": 240, "conditioning": None, "hifigan": hifi}
    path = str(tmp_path / "cubegan.yaml")
    config_io.dump(conf, path)
    assert config_io.load(path) == conf == yaml.safe_load(open(path))
    enc = CubeganEncodings()
    enc.phon2int, enc.speaker2int = {"<PAD>": 0, "a": 1}, {"none": 0}
    enc.max_pitch, enc.max_duration = 400, 100
    h = tapi.config_from_yaml(config_io.load(path), enc).hifigan
    assert (h.resblock, h.compute_dtype, h.fused_tail) == ("2", "bfloat16", False)
    assert h.resblock_dilation_sizes == ((1, 2), (2, 6), (3, 12))
    assert isinstance(thg.Generator(h).res_2_1, thg.ResBlock2)
