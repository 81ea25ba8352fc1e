"""Entry points of the port: twins of `__graft_entry__.py`'s `entry` and
`dryrun_multichip`.

    fn, (model, X) = entry()        # fn(model, X) → audio (B, 64·240)
    dryrun_multichip(4, device="cpu")  # one Cubegan GAN step, save, resume, synthesis

`entry()` is the flagship forward (Cubegan free synthesis) on tiny shapes, with seeded
random weights. `dryrun_multichip(n)` runs one full Cubegan training step over an n-rank
('data', 'model') mesh (model 2 where n is even and at least 4, as the JAX function
picks), a second step, a save of the sharded state, a restore into a fresh model, a
third step, and synthesis over the mesh, asserting what the JAX function asserts. On the
card it needs n cards and raises where there are fewer (the JAX function hosts a mesh of
virtual CPU devices instead; the port never carries on on the CPU unless asked); with
`device="cpu"` its ranks are n gloo processes.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ttscube_tpu_torch import resolve_device
from ttscube_tpu_torch.ops.length_regulator import durations_to_frame2phone_np


def _example_batch(B=2, N=16, F=60) -> dict:
    """`__graft_entry__._example_batch`, as numpy arrays (the same seeded values)."""
    rng = np.random.default_rng(0)
    durs = rng.integers(2, 6, (B, N)).astype(np.int32)
    f2p, fmask = durations_to_frame2phone_np(durs, np.full((B,), N, np.int32), F)
    return {
        "x_char": rng.integers(1, 30, (B, N)).astype(np.int32),
        "x_speaker": rng.integers(1, 3, (B, 1)).astype(np.int32),
        "y_frame2phone": f2p,
        "y_frame_mask": fmask,
        "y_pitch": (rng.uniform(80, 300, (B, F)) * fmask).astype(np.float32),
        "y_dur": durs,
        "y_audio": (0.1 * rng.standard_normal((B, F * 240))).astype(np.float32),
        "n_frames": fmask.sum(axis=1).astype(np.int32),
    }


def _tiny_config():
    """`__graft_entry__._tiny_config` in the port."""
    from ttscube_tpu_torch.models.cubegan import CubeganConfig
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig

    return CubeganConfig(
        languasito=LanguasitoConfig(num_phones=30, num_speakers=3, max_pitch=400,
                                    max_duration=100),
        hifigan=HifiganConfig(upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3),)),
        mpd_channels=(8, 16), msd_width=8)


def entry(device=None):
    """(fn, (model, X)): fn(model, X) is free synthesis of the inputs X at 64 frames,
    audio (B, 64·240); the model holds seeded random weights (load others with
    `convert.load_jax_params`)."""
    from ttscube_tpu_torch.convert import init_random
    from ttscube_tpu_torch.models.cubegan import Cubegan

    dev = resolve_device(device)
    model = init_random(Cubegan(_tiny_config()), seed=0).to(dev).eval()
    X = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
         for k, v in _example_batch().items() if k.startswith("x_")}

    def fn(model, X):
        audio, _ = model.infer(X, max_frames=64)
        return audio

    return fn, (model, X)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full Cubegan GAN step over an n-rank mesh, then the second step, the
    save/restore cycle, the third step and mesh synthesis (see the module docstring).
    Returns rank 0's metrics of the three steps."""
    from ttscube_tpu_torch.parallel.mesh import run_ranks

    return run_ranks(dryrun_rank, n_devices, device, timeout=1800,
                     threads=max(1, torch.get_num_threads() // n_devices))


def _finite(metrics: dict, when: str) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    for k, v in out.items():
        assert np.isfinite(v), f"non-finite {k} {when}"
    return out


def dryrun_rank(rank: int, world: int, device) -> dict:
    """`dryrun_multichip`'s body on one rank of the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ttscube_tpu_torch.convert import init_random, load_jax_params, state_dict_to_jax
    from ttscube_tpu_torch.models.cubegan import (Cubegan, batch_to_torch,
                                                  create_train_state, train_step)
    from ttscube_tpu_torch.parallel.mesh import (make_mesh, make_parallel_synthesis,
                                                 make_parallel_train_step)
    from ttscube_tpu_torch.utils.checkpoint import load_train_state, save_train_state
    from ttscube_tpu_torch.utils.ranks import barrier

    model_axis = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(world // model_axis, model_axis, device=device)
    batch = batch_to_torch(_example_batch(B=world), device)  # divides over 'data'

    def fresh(seed):
        model = init_random(Cubegan(_tiny_config(), train=True), seed).to(device)
        step = make_parallel_train_step(model, mesh, train_step)
        return create_train_state(model), step

    state, step = fresh(0)
    state, m1 = step(state, batch)
    out = {"step1": _finite(m1, "at step 1")}
    assert state.step == 1
    state, m2 = step(state, batch)
    out["step2"] = _finite(m2, "at step 2")
    assert state.step == 2

    # the sharded state's checkpoint cycle: every rank gathers, rank 0 writes, every
    # rank restores into a fresh model with other weights, and training goes on
    full = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu()
    before = {n: full(p) for n, p in state.model.named_parameters()}
    tmp = [tempfile.mkdtemp(prefix="dryrun_") if rank == 0 else None]
    dist.broadcast_object_list(tmp, src=0)
    ckpt = os.path.join(tmp[0], "dryrun.opt.last")
    save_train_state(ckpt, state)
    barrier()
    restored, step_r = fresh(1)
    load_train_state(ckpt, restored)
    barrier()
    if rank == 0:
        os.unlink(ckpt)
        os.rmdir(tmp[0])
    assert restored.step == 2
    for n, p in restored.model.named_parameters():
        assert torch.equal(full(p), before[n]), f"{n} differs after the restore"
    restored, m3 = step_r(restored, batch)
    out["step3"] = _finite(m3, "after the sharded resume")
    assert restored.step == 3

    # mesh synthesis: utterances over 'data', the resumed weights
    params = state_dict_to_jax(restored.model)
    infer_model = load_jax_params(Cubegan(_tiny_config()).to(device),
                                  {"lang": params["lang"], "gen": params["gen"]})
    X = {k: v for k, v in batch.items() if k.startswith("x_")}
    audio = make_parallel_synthesis(infer_model, mesh, max_frames=64)(X)
    assert tuple(audio.shape) == (world, 64 * 240), tuple(audio.shape)
    assert bool(torch.isfinite(audio).all()), "non-finite mesh synthesis audio"
    return out
