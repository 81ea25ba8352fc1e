"""Device mesh and sharding over torch.distributed: counterpart of
`ttscube_tpu/parallel/mesh.py`, with the same names.

The JAX module lays a ('data', 'model') mesh over the devices, shards the batch over
'data' and every large weight over 'model', and lets XLA insert the collectives. The
port does the same with FSDP2 (`torch.distributed.fsdp.fully_shard`) on a 2-D
`DeviceMesh` named ('data', 'model'): it replicates over dim 0 and shards over dim 1
(HSDP), so

  * each parameter is stored sharded over 'model' on the axis that the JAX rule picks
    (`partition_params`, mapped through `convert.leaf_layout`), and gathered whole for
    each module's forward and backward;
  * the AdamW moments of a sharded parameter are DTensors with its placement (the JAX
    `partition_opt_state`), and the counts and the lr schedule are plain numbers;
  * each rank takes its 'data' rows of the global batch (`shard_batch`), and the grads
    are averaged over the ranks. Ranks that differ only on 'model' hold the same rows.

Departures from the JAX module, each deliberate:

  * the parameters that the JAX rule replicates are sharded on their axis 0 by FSDP2's
    default placement: that changes memory, not the arithmetic;
  * the 'model' axis shards storage only: every rank computes its rows with whole
    weights (the JAX mesh may also split the matmuls), so the result is the same;
  * a mesh is a set of processes, one per rank (`spawn`), not one controller.

Every function here that touches the model is a collective: every rank of the mesh
calls it, in the same order. Processes join with a `file://` rendezvous; on the card
each rank takes the card of its number and NCCL, on the CPU gloo.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import FSDPModule, fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import Shard

from ttscube_tpu_torch import resolve_device
from ttscube_tpu_torch.convert import leaf_layout, _LEAVES

# -- processes ---------------------------------------------------------------------------


def init_process(rank: int, world_size: int, init_file: str, device) -> torch.device:
    """Join the process group of `world_size` ranks that rendezvous at `init_file`: NCCL
    on card `rank` (raises where there are fewer cards), gloo on the CPU. Returns this
    rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} of {world_size} needs card {rank}; this "
                               f"machine has {torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size)
    return dev


def _rank_main(rank, fn, world_size, init_file, device, threads, out_file, args):
    torch.set_num_threads(threads)
    if rank:
        sys.stdout = open(os.devnull, "w")
    dev = init_process(rank, world_size, init_file, device)
    try:
        result = fn(rank, world_size, dev, *args)
        if rank == 0:
            with open(out_file, "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, device=None, args=(), threads: int = 1,
              timeout: float | None = None):
    """Run `fn(rank, world_size, device, *args)` on each rank of a new process group
    and return rank 0's result: one rank in this process, more in processes of their
    own (`spawn`)."""
    if world_size > 1:
        return spawn(fn, world_size, device, args, threads, timeout)
    with tempfile.TemporaryDirectory() as tmp:
        dev = init_process(0, 1, os.path.join(tmp, "rendezvous"), device)
        try:
            return fn(0, 1, dev, *args)
        finally:
            dist.destroy_process_group()


def spawn(fn, world_size: int, device=None, args=(), threads: int = 1,
          timeout: float | None = None):
    """Run `fn(rank, world_size, device, *args)` in `world_size` new processes joined
    in one process group, and return rank 0's result. `fn` is a module-level function
    (it is imported by name in each process); ranks above 0 write nothing to stdout. A
    rank that fails, or a run longer than `timeout` seconds, stops every rank and
    raises."""
    if world_size > 1 and resolve_device(device).type == "cuda" and \
            torch.cuda.device_count() < world_size:
        raise RuntimeError(f"a mesh of {world_size} ranks on the card needs {world_size} "
                           f"cards; this machine has {torch.cuda.device_count()} (pass "
                           "device='cpu' for gloo processes)")
    with tempfile.TemporaryDirectory() as tmp:
        init_file, out_file = os.path.join(tmp, "rendezvous"), os.path.join(tmp, "result")
        ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False,
                                 start_method="spawn",
                                 args=(fn, world_size, init_file, device, threads,
                                       out_file, tuple(args)))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} ran past "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(out_file, "rb") as f:
            return pickle.load(f)


# -- the mesh ----------------------------------------------------------------------------


def make_mesh(data: int | None = None, model: int = 1, device=None) -> DeviceMesh:
    """The ('data', 'model') mesh over this process group's ranks (rank = data index ·
    model + model index), on the card unless `device` is the CPU. `data` defaults to
    the world size over `model`."""
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) does not cover the {world} ranks")
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def _model_size(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh["model"].size()


def partition_params(module: torch.nn.Module, mesh, min_size: int = 2**14) -> dict:
    """Each parameter's torch axis that the JAX rule shards on 'model', or None: a
    parameter of at least `min_size` elements is sharded on the last axis of its JAX
    layout (the output features), else on its largest, whichever first divides by the
    model size. The JAX axis is mapped to torch's through `convert.leaf_layout`, so a
    Conv1d kernel (flax (K, I, O), torch (O, I, K)) shards on torch's axis 0. `mesh` is a
    `DeviceMesh` or the size of its 'model' axis."""
    size = _model_size(mesh)
    out = {}
    for prefix, mod in module.named_modules():
        if not isinstance(mod, _LEAVES):
            continue
        layout = leaf_layout(mod)
        for name, p in mod.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            out[key] = None
            if name not in layout or size <= 1 or p.numel() < min_size:
                continue
            axes = layout[name][1] or tuple(range(p.ndim))
            jshape = [p.shape[axes.index(a)] for a in range(p.ndim)]
            order = sorted(range(p.ndim), key=lambda a: (a != p.ndim - 1, -jshape[a]))
            for a in order:
                if jshape[a] % size == 0 and jshape[a] >= size:
                    out[key] = axes.index(a)
                    break
    return out


# the methods that read a module's weights outside its `forward`: FSDP2 gathers a
# module's parameters in its forward hooks, so these go through the same hooks
_FORWARD_METHODS = {"": ("gan_forward", "d_loss", "gt_losses", "losses", "infer"),
                    "lang": ("infer", "durations"), "gen": ("fused", "fused_train")}


def _keep_rnn_weights() -> None:
    """`flatten_parameters` of a sharded model's LSTMs. On the card nn.LSTM's own moves
    each weight into one cuDNN buffer (`set_`) whenever it sees new weight tensors, as
    FSDP2's gathered weights are at their first forward: the weight would then no longer
    be the buffer that FSDP2's next all-gather fills, and every later step would run the
    LSTM on the first step's weights. Without it cuDNN packs the weights at each call."""


def shard_model(model: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Shard a Cubegan over `mesh` in place (FSDP2): `lang`, `gen`, `mpd` and `msd` (those
    it has) each as one unit, then the root; each parameter on its `partition_params`
    axis over 'model' and replicated over 'data'. The buffers (the MSD's spectral u,
    the mel filters) stay whole on every rank. A model sharded already is left as it
    is. The LSTMs keep their weights where FSDP2 puts them (`_keep_rnn_weights`).
    Returns the model."""
    if isinstance(model, FSDPModule):
        return model
    # the port's modules return slices of their outputs, which no caller changes in
    # place; FSDP2 warns about every such view
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view")
    axis_of = partition_params(model, mesh)
    by_param = {id(p): axis_of.get(n) for n, p in model.named_parameters()}

    def placement(p):
        axis = by_param.get(id(p))
        return None if axis is None else Shard(axis)

    for mod in model.modules():
        if isinstance(mod, torch.nn.RNNBase):
            mod.flatten_parameters = _keep_rnn_weights
    for name in ("lang", "gen", "mpd", "msd"):
        if hasattr(model, name):
            fully_shard(getattr(model, name), mesh=mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    for name, methods in _FORWARD_METHODS.items():
        mod = getattr(model, name) if name else model
        for m in methods:
            register_fsdp_forward_method(mod, m)
    return model


def _rows(mesh: DeviceMesh, n: int) -> slice:
    data = mesh["data"].size()
    if n % data:
        raise ValueError(f"a batch of {n} does not divide over the {data} data ranks")
    i = mesh["data"].get_local_rank()
    return slice(i * n // data, (i + 1) * n // data)


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's 'data' rows of the global batch: every rank collates the same global
    batch in the same order, so padding and buckets agree, and ranks that differ only
    on 'model' take the same rows."""
    return {k: v[_rows(mesh, v.shape[0])] if getattr(v, "ndim", 0) >= 1 else v
            for k, v in batch.items()}


def mean_over_ranks(metrics: dict) -> dict:
    """Each scalar averaged over every rank of the process group (gloo has no AVG)."""
    keys = sorted(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(v)
    v = v / dist.get_world_size()
    return dict(zip(keys, v.unbind()))


def make_parallel_synthesis(model, mesh: DeviceMesh, max_frames: int):
    """Batched synthesis over the mesh: fn(X) → audio (B, max_frames·hop) on every rank,
    where X is the global batch of inputs (x_*) and B divides over 'data'. Each rank
    runs `Cubegan.infer` on its rows and the audio is gathered over 'data'. `model` is
    sharded by `shard_model` (here, if it is not already)."""
    shard_model(model, mesh)
    group = mesh["data"].get_group()

    def run(X):
        audio, _ = model.infer(shard_batch(X, mesh), max_frames=max_frames)
        parts = [torch.empty_like(audio) for _ in range(mesh["data"].size())]
        dist.all_gather(parts, audio.contiguous(), group=group)
        return torch.cat(parts)

    return run


def make_parallel_train_step(model, mesh: DeviceMesh, train_step_fn):
    """One `train_step_fn(state, batch, starts=...)` over the mesh: fn(state, batch,
    starts=None) → (state, metrics), where `batch` is the global batch on the device,
    the same on every rank. As in the single-device step:

      * the crop offsets of the global batch (`starts`, or drawn from
        `crop_generator(seed, step)`) are the same on every rank, which takes its rows;
      * the text losses divide by the global counts of valid phones and frames
        (`dur_denom`, `frame_denom` in the rank's batch, over the data size, so that
        the mean over the ranks is the global mean); every other loss is a mean over
        windows of one size, whose mean over the ranks is the global mean;
      * the metrics are those means, the same on every rank.

    `model` is sharded by `shard_model` (here, if it is not already); build the
    optimizers after it (`create_train_state`), so that they hold the sharded
    parameters."""
    from ttscube_tpu_torch.models.cubegan import TRAIN_FRAMES, crop_generator

    shard_model(model, mesh)
    data = mesh["data"].size()

    def run(state, batch, starts=None):
        if starts is None:
            window = min(TRAIN_FRAMES, batch["y_frame2phone"].shape[1])
            starts = model.crop_starts(batch["n_frames"], window,
                                       crop_generator(state.seed, state.step))
        local = dict(shard_batch(batch, mesh), **global_denominators(batch, data))
        state, metrics = train_step_fn(state, local, starts=starts[_rows(mesh, len(starts))])
        return state, mean_over_ranks(metrics)

    return run


def global_denominators(batch: dict, data: int) -> dict:
    """The counts the text losses of a global batch divide by, over the data size: the
    valid phones (`x_char` != 0) and the valid frames (`y_frame_mask`), each at least 1
    (models/languasito.py `languasito_losses`)."""
    out = {"dur_denom": (batch["x_char"] != 0).sum().clamp(min=1).float() / data}
    if "y_frame_mask" in batch:
        out["frame_denom"] = batch["y_frame_mask"].float().sum().clamp(min=1.0) / data
    return out


def make_parallel_val_step(model, mesh: DeviceMesh, val_step_fn):
    """Validation over the mesh: every rank runs `val_step_fn(state, batch)` on the whole
    global batch, as the JAX trainer's plain jitted val step does, and the metrics are
    averaged over the ranks, so that every rank sees the same numbers (the checkpoint
    keeper decides on them, and its saves are collectives)."""
    shard_model(model, mesh)

    def run(state, batch):
        return mean_over_ranks(val_step_fn(state, batch))

    return run

