"""What each rank runs in tests/test_torch_parallel.py and tests/test_torch_mesh.py: the
port's mesh code in gloo processes on the CPU (`ttscube_tpu_torch.parallel.mesh.spawn`).

A spawned process imports this module by name, so it imports torch and the port only
(no JAX: the parent process holds the JAX side of every comparison). Configurations and
batches come in as arguments, made by the parent from tests/torch_parity.py."""

import torch
from torch.distributed.tensor import DTensor

from ttscube_tpu_torch.convert import load_jax_params, train_state_to_jax
from ttscube_tpu_torch.models import cubegan as tcg
from ttscube_tpu_torch.models.hifigan import HifiganConfig
from ttscube_tpu_torch.models.languasito import LanguasitoConfig
from ttscube_tpu_torch.parallel import mesh as pm

# every rank runs the CPU convs without oneDNN, as the single-process comparisons do
# (tests/torch_parity.py `exact_cpu_convs`)
EXACT = torch.backends.mkldnn.flags(enabled=False)


def config(lang: dict, hifi: dict, disc: dict) -> tcg.CubeganConfig:
    return tcg.CubeganConfig(languasito=LanguasitoConfig(**lang),
                             hifigan=HifiganConfig(**hifi), **disc)


def _full(t):
    """A copy of the whole tensor (on a 'model' axis of 1, `full_tensor` may return the
    local shard itself, which the next step changes in place)."""
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu().numpy().copy()


def step_rank(rank, world, device, shape, cfg, params, spectral, batch, starts, steps):
    """`steps` mesh train steps of a Cubegan holding the JAX trees `params` and
    `spectral`, on the global `batch` with the global crop offsets `starts` (None: drawn
    by the step). Returns, for each step, its metrics, the grads it reduced (whole, by
    name) and the parameters after it (whole, by name); and each parameter's placement
    and its AdamW moments' placements."""
    with EXACT:
        mesh = pm.make_mesh(*shape, device=device)
        model = load_jax_params(tcg.Cubegan(config(*cfg), train=True), params,
                                {"msd": spectral})
        step = pm.make_parallel_train_step(model, mesh, tcg.train_step)
        state = tcg.create_train_state(model)
        b = tcg.batch_to_torch(batch, device)
        metrics, grads, after = [], [], []
        for _ in range(steps):
            state, m = step(state, b, None if starts is None else torch.as_tensor(starts))
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({n: _full(p.grad) for n, p in model.named_parameters()
                          if p.grad is not None})
            after.append({n: _full(p) for n, p in model.named_parameters()})
        placements = {}
        for part, opt in state.optimizers.items():
            for p in opt.param_groups[0]["params"]:
                st = opt.state.get(p, {})
                placements[id(p)] = (str(p.placements), tuple(
                    str(st[k].placements) for k in ("exp_avg", "exp_avg_sq") if k in st))
        named = {n: placements.get(id(p)) for n, p in model.named_parameters()}
        return metrics, grads, after, named


def synthesis_rank(rank, world, device, shape, cfg, params, X, max_frames):
    """Mesh synthesis of the global inputs `X` by a Cubegan holding the JAX tree
    `params` ({lang, gen}); the audio as every rank gathers it."""
    with EXACT:
        mesh = pm.make_mesh(*shape, device=device)
        model = load_jax_params(tcg.Cubegan(config(*cfg)), params)
        run = pm.make_parallel_synthesis(model, mesh, max_frames)
        audio = run({k: torch.as_tensor(v, device=device).long() for k, v in X.items()})
        return audio.cpu().numpy()


def loop_rank(rank, world, device, shape, cfg, corpus, base, resume_epochs):
    """The trainer loop over the mesh on a corpus, twice: 2 epochs (1 batch of 4 each),
    then resumed from the files for `resume_epochs` more. Returns the two step counts
    and the train state tree after the second."""
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.data.collate import CubeganCollate
    from ttscube_tpu_torch.data.datasets import CubeganDataset
    from ttscube_tpu_torch.data.encodings import CubeganEncodings
    from ttscube_tpu_torch.train.loop import train

    ds = CubeganDataset(corpus)
    enc = CubeganEncodings()
    enc.compute(ds)
    collate = CubeganCollate(enc, min_frames=60, bucket_frames=60, bucket_phones=16)
    counts = []
    with EXACT:
        for epochs, resume in ((2, False), (resume_epochs, True)):
            mesh = pm.make_mesh(*shape, device=device)
            model = init_random(tcg.Cubegan(config(*cfg), train=True), 0)
            step = pm.make_parallel_train_step(model, mesh, tcg.train_step)
            vstep = pm.make_parallel_val_step(model, mesh, tcg.val_step)
            state = train(state=tcg.create_train_state(model), train_step=step,
                          val_step=vstep, trainset=ds, devset=ds, collate=collate,
                          batch_size=4, output_base=base, selection_metric="loss_mel",
                          max_epochs=epochs, log_every=1, resume=resume)
            counts.append(int(state.step))
        tree = train_state_to_jax(state)
    return counts, tree


def cli_rank(rank, world, device, argv, hifi, disc):
    """The trainer CLI's rank body (`train_cubegan.train_on` over the mesh of its flags),
    with the config narrowed to `hifi` and `disc` as tests/test_torch_trainer.py narrows
    it. Returns the final step."""
    import functools

    from ttscube_tpu_torch.scripts import train_cubegan as cli

    tcg.CubeganConfig = functools.partial(tcg.CubeganConfig, hifigan=HifiganConfig(**hifi),
                                          **disc)
    args = cli.parse_args(argv)
    with EXACT:
        return cli._rank(rank, world, device, args)
