"""The Textcoder and vocoder trainer CLIs of the port (`scripts/train_textcoder.py`,
`scripts/train_vocoder.py`) on the CPU: a few steps on the port's demo corpus write the
JAX CLIs' files (`.yaml`, `.encodings`, `.best`, `.last`, `.opt.last`, and the
vocoder's `.lr.best` and `.hr.best`), which the JAX package loads and runs;
`--resume --max-epochs 0` restores the step, parameters, running averages and AdamW
moments bit-equal, and `--resume` goes on from there. Textcoder runs at its full
widths; the vocoder at its CLI's widths narrowed by its own flags."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ttscube_tpu.data.collate import TextcoderCollate as JaxCollate
from ttscube_tpu.data.encodings import TextcoderEncodings as JaxEncodings
from ttscube_tpu.models import textcoder as jtc
from ttscube_tpu.models import wavernn as jw
from ttscube_tpu.train import states as js
from ttscube_tpu.utils import checkpoint as jckpt
from ttscube_tpu_torch.convert import batch_stats_to_jax, state_dict_to_jax
from ttscube_tpu_torch.data.datasets import CubeganDataset
from ttscube_tpu.ops.rnn import unroll_override
from tests.torch_parity import one_cpu_thread  # noqa: F401
from tests.test_torch_legacy_data import corpus  # noqa: F401  (the module fixture)


def same_state(a, b) -> bool:
    """Bit-equal step, parameters, buffers, and every AdamW moment and count."""
    sb = b.model.state_dict()
    if a.step != b.step or any(not torch.equal(v, sb[k]) for k, v in
                               a.model.state_dict().items()):
        return False
    for p, q in zip(a.optimizer.param_groups[0]["params"], b.optimizer.param_groups[0]["params"]):
        sa, sq = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if sa.keys() != sq.keys() or any(not torch.equal(sa[k], sq[k]) for k in sa):
            return False
    return True


@pytest.mark.usefixtures("one_cpu_thread")
def test_textcoder_cli_writes_the_jax_files_and_resumes(corpus, tmp_path):
    from ttscube_tpu_torch.scripts import train_textcoder

    base = str(tmp_path / "tc")
    argv = ["--train-folder", str(corpus / "train"), "--dev-folder", str(corpus / "dev"),
            "--output-base", base, "--batch-size", "2", "--device", "cpu"]
    state = train_textcoder.main(argv + ["--max-steps", "3"])
    assert state.step == 3
    for ext in ("yaml", "encodings", "best", "last", "opt.last"):
        assert (tmp_path / f"tc.{ext}").stat().st_size > 0, ext
    assert jckpt.load_config(base) == {"sample_rate": 24000, "hop_size": 240, "pframes": 3}
    jenc = JaxEncodings(base + ".encodings")
    cfg = jtc.TextcoderConfig(num_phones=len(jenc.phon2int),
                              num_speakers=len(jenc.speaker2int),
                              max_pitch=int(jenc.max_pitch), max_duration=int(jenc.max_duration))
    params = jckpt.load_params(base + ".best", state_dict_to_jax(state.model))
    tx = js.optax.adamw(js._inverse_decay(2e-4, 1e-5), weight_decay=0.01)
    template = js.SimpleState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32),
                              extra=batch_stats_to_jax(state.model))
    jres = jckpt.load_train_state(base + ".opt.last", template)
    assert int(jres.step) == 3
    batch = JaxCollate(jenc)([CubeganDataset(str(corpus / "dev"))[0]])
    with unroll_override(1):  # the same math, a fraction of the compile
        out = jax.jit(jtc.CubenetTextcoder(cfg).apply)(
            {"params": jres.params, "batch_stats": jres.extra},
            {k: jnp.asarray(v) for k, v in batch.items()}, rngs={"dropout": jax.random.PRNGKey(0)})
    assert all(np.isfinite(np.asarray(o)).all() for o in out)
    sd = state.model.state_dict()
    assert np.array_equal(np.asarray(jres.extra["postnet"]["bn_0"]["var"]),
                          sd["postnet.bn_0.running_var"].numpy())
    assert not np.array_equal(sd["postnet.bn_0.running_var"].numpy(), np.ones(512, np.float32))

    restored = train_textcoder.main(argv + ["--resume", "--max-epochs", "0"])
    assert same_state(restored, state)
    assert train_textcoder.main(argv + ["--resume", "--max-steps", "4"]).step == 4
    shutil.rmtree(tmp_path)  # ~600 MB of full-width files


@pytest.mark.usefixtures("one_cpu_thread")
def test_vocoder_cli_writes_the_jax_files_and_resumes(corpus, tmp_path):
    from ttscube_tpu_torch.scripts import train_vocoder

    base = str(tmp_path / "voc")
    argv = ["--train-folder", str(corpus / "train"), "--dev-folder", str(corpus / "dev"),
            "--output-base", base, "--batch-size", "2", "--max-segment", "2400",
            "--layers-lr", "1", "--size-lr", "16", "--layers-hr", "2", "--size-hr", "24",
            "--cache-dir", str(tmp_path / "cache"), "--device", "cpu"]
    state = train_vocoder.main(argv + ["--max-steps", "3"])
    assert state.step == 3
    for ext in ("yaml", "best", "last", "opt.last", "lr.best", "hr.best"):
        assert (tmp_path / f"voc.{ext}").stat().st_size > 0, ext
    conf = jckpt.load_config(base)
    assert conf["size_hr"] == 24 and conf["output"] == "mol" and conf["sample_rate_low"] == 2400
    jv = jw.CubenetVocoder(jw.VocoderConfig(num_layers_lr=1, layer_size_lr=16, num_layers_hr=2,
                                            layer_size_hr=24))
    tree = state_dict_to_jax(state.model)
    for net in ("lr", "hr"):
        jckpt.load_params(f"{base}.{net}.best", tree[net])
    template = js.SimpleState(params=tree, opt_state=js._vocoder_tx(jv.config).init(tree),
                              step=jnp.zeros((), jnp.int32))
    jres = jckpt.load_train_state(base + ".opt.last", template)
    assert int(jres.step) == 3
    rng = np.random.default_rng(0)
    batch = {"mel": rng.standard_normal((1, 11, 80)).astype(np.float32),
             "x": rng.uniform(-0.5, 0.5, (1, 2400)).astype(np.float32),
             "x_low": rng.uniform(-0.5, 0.5, (1, 240)).astype(np.float32)}
    with unroll_override(1):
        assert np.isfinite(float(jax.jit(jv.losses)(jres.params, batch)["loss"]))
    restored = train_vocoder.main(argv + ["--resume", "--max-epochs", "0"])
    assert same_state(restored, state)
    assert train_vocoder.main(argv + ["--resume", "--max-steps", "4"]).step == 4
