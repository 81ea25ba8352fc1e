"""The port's mesh (`ttscube_tpu_torch.parallel.mesh`) in gloo processes on the CPU:
synthesis over the mesh against `Cubegan.infer` and JAX's `make_parallel_synthesis`
(5e-5), and the trainer loop and the trainer CLI over a mesh, saving and resuming (the
twin of tests/test_parallel.py:127-166). Each spawn of ranks waits under a timeout of
its own (`TIMEOUT`)."""

import numpy as np
import pytest
import torch

import jax

from ttscube_tpu.models import cubegan as jcg
from ttscube_tpu.parallel import mesh as jmesh
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.parallel import mesh as pm
from tests import torch_mesh_ranks as ranks
from tests.torch_parity import (TINY_HIFI, TRAIN_DISC, TRAIN_LANG,  # noqa: F401
                                assert_close, exact_cpu_convs, one_cpu_thread,
                                toy_train_batch, train_pair)

pytestmark = pytest.mark.usefixtures("exact_cpu_convs", "one_cpu_thread")

TIMEOUT = 240  # seconds for one spawn of ranks


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_parallel_synthesis_across_mesh():
    """Synthesis of 4 utterances over a (2, 1) mesh (the port with the fused generator
    path, `Generator.fused`) against `Cubegan.infer` in one process and JAX's
    `make_parallel_synthesis` on 2 devices, on the same weights (5e-5)."""
    batch = toy_train_batch(B=4, seed=5)
    _, jstate, tm = train_pair(TINY_HIFI, batch, seed=5)
    params = {"lang": _numpy(jstate.params["lang"]), "gen": _numpy(jstate.params["gen"])}
    X = {k: v for k, v in batch.items() if k.startswith("x_")}
    hifi = dict(TINY_HIFI, fused_tail=True)
    got = pm.spawn(ranks.synthesis_rank, 2, "cpu", timeout=TIMEOUT,
                   args=((2, 1), (TRAIN_LANG, hifi, TRAIN_DISC), params, X, 64))
    single = tcg.Cubegan(ranks.config(TRAIN_LANG, hifi, TRAIN_DISC))
    single.load_state_dict({k: v for k, v in tm.state_dict().items()
                            if k.split(".")[0] in ("lang", "gen")}, strict=False)
    want, _ = single.infer({k: torch.from_numpy(v).long() for k, v in X.items()},
                           max_frames=64)
    assert got.shape == (4, 64 * 240)
    assert_close("mesh synthesis (2, 1) vs Cubegan.infer", got, want, 5e-5)
    jm = jcg.Cubegan(_jcfg(), train=False)
    run = jmesh.make_parallel_synthesis(jm, jmesh.make_mesh(data=2, model=1,
                                                            devices=jax.devices()[:2]), 64)
    assert_close("mesh synthesis (2, 1) vs JAX make_parallel_synthesis", got,
                 np.asarray(run(params, X)), 5e-5)


def _jcfg():
    from ttscube_tpu.models import hifigan as jhg
    from ttscube_tpu.models import languasito as jla

    return jcg.CubeganConfig(languasito=jla.LanguasitoConfig(**TRAIN_LANG),
                             hifigan=jhg.HifiganConfig(**TINY_HIFI), **TRAIN_DISC)


def test_mesh_through_trainer_loop_with_resume(tmp_path):
    """The trainer loop (`train/loop.py`) over a (2, 2) mesh: 2 epochs of one batch of
    4, then resumed from the files for 3 more epochs: step counts 2, then 5 (the twin of
    tests/test_parallel.py:127-166). Rank 0 wrote the files; JAX's `load_train_state`
    reads the saved `.opt.last` bit-equal to the ranks' state."""
    import os

    from tests.test_cubegan import tiny_model, toy_batch
    from tests.test_data import make_corpus
    from ttscube_tpu.utils.checkpoint import load_train_state

    make_corpus(tmp_path / "corpus", n=4)
    base = str(tmp_path / "model" / "cubegan")
    counts, tree = pm.spawn(ranks.loop_rank, 4, "cpu", timeout=TIMEOUT,
                            args=((2, 2), (TRAIN_LANG, TINY_HIFI, TRAIN_DISC),
                                  str(tmp_path / "corpus"), base, 3))
    assert counts == [2, 5]
    for ext in (".best", ".last", ".opt.last"):
        assert os.path.exists(base + ext), ext
    # the template's shapes only: an eager flax init of the tiny Cubegan takes ~1 min
    template = jax.eval_shape(lambda: jcg.create_train_state(
        tiny_model(), jax.random.PRNGKey(0), toy_batch(B=4)))
    loaded = load_train_state(base + ".opt.last", template)
    assert int(loaded.step) == 5
    got = jax.tree_util.tree_leaves(_numpy(loaded.params))
    want = jax.tree_util.tree_leaves(tree["params"])
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_cli_trains_and_resumes_on_a_mesh(tmp_path, monkeypatch):
    """`python -m ttscube_tpu_torch.scripts.train_cubegan --mesh-data D --mesh-model M
    --device cpu` on the tiny config (narrowed as tests/test_torch_trainer.py narrows
    it): a (1, 1) mesh runs in this process, a (2, 2) mesh in four gloo processes (the
    CLI's rank body, with the narrowed config); each trains 2 steps, saves, and resumes
    from its files. A batch that does not divide over the data axis is refused."""
    import functools
    import os

    from tests.test_data import make_corpus
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.scripts import train_cubegan as cli

    make_corpus(tmp_path / "corpus", n=4)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcg, "CubeganConfig", functools.partial(
        tcg.CubeganConfig, hifigan=HifiganConfig(**TINY_HIFI), **TRAIN_DISC))

    def argv(name, shape):
        return ["--train-folder", str(tmp_path / "corpus"), "--dev-folder",
                str(tmp_path / "corpus"), "--output-base", str(tmp_path / name / "cubegan"),
                "--batch-size", "2", "--max-steps", "2", "--epoch-generation", "0",
                "--device", "cpu", "--mesh-data", str(shape[0]), "--mesh-model",
                str(shape[1])]

    one = argv("one", (1, 1))
    assert cli.main(one) == 2
    assert cli.main(one + ["--resume", "--max-epochs", "0"]) == 2
    four = argv("four", (2, 2))
    assert pm.spawn(ranks.cli_rank, 4, "cpu", timeout=TIMEOUT,
                    args=(four, TINY_HIFI, TRAIN_DISC)) == 2
    assert pm.spawn(ranks.cli_rank, 4, "cpu", timeout=TIMEOUT,
                    args=(four + ["--resume", "--max-epochs", "1", "--max-steps", "4"], TINY_HIFI,
                          TRAIN_DISC)) == 4
    for name in ("one", "four"):
        for ext in (".yaml", ".encodings", ".best", ".last", ".opt.last"):
            assert os.path.exists(tmp_path / name / ("cubegan" + ext)), (name, ext)
    with pytest.raises(SystemExit):
        cli.parse_args(argv("odd", (2, 1))[:-4] + ["--batch-size", "3", "--mesh-data", "2"])
