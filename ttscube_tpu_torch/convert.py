"""Parameters between the JAX package's trees and the port's modules.

A JAX tree is a nested dict of numpy arrays, as flax keeps it ({"lang": ..., "gen":
...} for Cubegan). The port's modules are named as the tree is, so the walk below
pairs each leaf module with its subtree and applies the layout rules:

  * Conv1d kernel, SNConv1d kernel, WNConv1d v: (k, in, out) ↔ (out, in, k)
  * WNConv2d v: (kh, kw, in, out) ↔ (out, in, kh, kw)
  * SNConv1d u: the JAX "spectral" collection ↔ the module's buffer `u`
  * WNConvTranspose1d v: (k, out, in) ↔ (in, out, k); its g is per input channel
  * Dense kernel: (in, out) ↔ Linear weight (out, in)
  * LayerNorm, BatchNorm: flax {scale, bias} ↔ torch {weight, bias}; a BatchNorm's
    running_mean/running_var ↔ the JAX "batch_stats" collection's mean/var
  * LSTM, LSTMCell: wi/wh (D, 4H) ↔ weight_ih/weight_hh (4H, D); the single bias b
    goes to bias_ih with bias_hh = 0, and comes back as bias_ih + bias_hh
  * GRU, GRUCell: wi/wh (D, 3H) ↔ weight_ih/weight_hh (3H, D); bi ↔ bias_ih, bh ↔
    bias_hh
  * g, bias, embeddings, and a parameter a non-leaf module holds itself (the
    attention's v): unchanged

`read_msgpack` reads the JAX package's `.model` / `.last` files (flax msgpack) with the
port's own reader (`utils/serialization.py`), never flax or msgpack.
`train_state_to_jax` and `load_jax_train_state` move a whole training state (weights,
optimizer moments and counts, spectral u, step) between the port and the JAX
package's `TrainState` tree; `simple_state_to_jax` and `load_jax_simple_state` do the
same for the JAX `SimpleState` of the phonemizer, textcoder and vocoder trainers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ttscube_tpu_torch.models.languasito import MaskedEmbed
from ttscube_tpu_torch.ops.conv import (Conv1d, SNConv1d, WNConv1d, WNConv2d,
                                        WNConvTranspose1d)
from ttscube_tpu_torch.ops.linear import BatchNorm, Dense, Embed, LayerNorm
from ttscube_tpu_torch.ops.rnn import GRU, LSTM, GRUCell, LSTMCell
from ttscube_tpu_torch.utils.serialization import msgpack_restore

_T3 = (2, 1, 0)  # (k, a, b) ↔ (b, a, k)
_T4 = (3, 2, 0, 1)  # (kh, kw, in, out) → (out, in, kh, kw)


def leaf_layout(mod: nn.Module) -> dict:
    """Each parameter of a leaf module that has a JAX counterpart: torch name → (JAX
    name, axes), where the torch tensor is `np.transpose(jax_array, axes)` (axes None:
    unchanged). An LSTM's `bias_hh` has none (it is kept at zero; see `_leaf_to_torch`)."""
    if isinstance(mod, (Conv1d, SNConv1d)):
        out = {"kernel": ("kernel", _T3)}
    elif isinstance(mod, (WNConv1d, WNConvTranspose1d)):
        out = {"v": ("v", _T3), "g": ("g", None)}
    elif isinstance(mod, WNConv2d):
        out = {"v": ("v", _T4), "g": ("g", None)}
    elif isinstance(mod, Dense):
        out = {"weight": ("kernel", (1, 0))}
    elif isinstance(mod, Embed):
        return {"weight": ("embedding", None)}
    elif isinstance(mod, (LayerNorm, BatchNorm)):
        return {"weight": ("scale", None), "bias": ("bias", None)}
    elif isinstance(mod, MaskedEmbed):
        return {"embedding": ("embedding", None)}
    elif isinstance(mod, LSTM):
        out = {}
        for layer in range(mod.num_layers):
            for tsfx, jsfx in (("", ""), ("_reverse", "_rev"))[: 1 + mod.bidirectional]:
                out[f"weight_ih_l{layer}{tsfx}"] = (f"wi_l{layer}{jsfx}", (1, 0))
                out[f"weight_hh_l{layer}{tsfx}"] = (f"wh_l{layer}{jsfx}", (1, 0))
                out[f"bias_ih_l{layer}{tsfx}"] = (f"b_l{layer}{jsfx}", None)
        return out
    elif isinstance(mod, LSTMCell):
        return {"weight_ih": ("wi", (1, 0)), "weight_hh": ("wh", (1, 0)),
                "bias_ih": ("b", None)}
    elif isinstance(mod, (GRU, GRUCell)):
        sfx = [f"_l{n}" for n in range(mod.num_layers)] if isinstance(mod, GRU) else [""]
        return {f"{t}{s}": (f"{j}{s}", axes) for s in sfx for t, j, axes in (
            ("weight_ih", "wi", (1, 0)), ("weight_hh", "wh", (1, 0)),
            ("bias_ih", "bi", None), ("bias_hh", "bh", None))}
    else:
        raise TypeError(f"no JAX layout rule for {type(mod).__name__}")
    if getattr(mod, "bias", None) is not None:
        out["bias"] = ("bias", None)
    return out


def _leaf_to_torch(mod: nn.Module, p: dict) -> dict:
    out = {name: torch.from_numpy(np.array(np.transpose(p[jname], axes) if axes else
                                           p[jname], dtype=np.float32))
           for name, (jname, axes) in leaf_layout(mod).items()}
    if isinstance(mod, (LSTM, LSTMCell)):
        for name in list(out):
            if name.startswith("bias_ih"):
                out[name.replace("bias_ih", "bias_hh")] = torch.zeros(4 * mod.hidden_size)
    return out


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor as an fp32 numpy array; a sharded one (a DTensor, parallel/mesh.py) is
    gathered first, which every rank of its mesh must call."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().float().numpy()


def _leaf_to_jax(mod: nn.Module, sd: dict) -> dict:
    out = {}
    for name, (jname, axes) in leaf_layout(mod).items():
        a = host(sd[name])
        if isinstance(mod, (LSTM, LSTMCell)) and name.startswith("bias_ih"):
            a = a + host(sd[name.replace("bias_ih", "bias_hh")])
        out[jname] = np.ascontiguousarray(np.transpose(a, np.argsort(axes))) if axes else a
    return out


_LEAVES = (Conv1d, SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d, Dense, Embed,
           LayerNorm, BatchNorm, MaskedEmbed, LSTM, LSTMCell, GRU, GRUCell)
# the buffers a leaf keeps beside its parameters, and their names in the JAX tree that
# holds them ("spectral" for u, "batch_stats" for a BatchNorm's running averages)
_BUFFERS = {SNConv1d: {"u": "u"}, BatchNorm: {"running_mean": "mean", "running_var": "var"}}


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_to_state_dict(module: nn.Module, tree: dict, spectral: dict | None = None,
                      batch_stats: dict | None = None) -> dict:
    """The state dict of `module` holding the JAX parameter tree `tree` and the buffers
    of the JAX trees laid out as `tree`: `spectral` (each spectral-normalized conv's
    `u`) and `batch_stats` (each BatchNorm's running mean and var). Without a tree its
    leaves keep the buffers they hold."""
    out = {}

    def walk(mod, sub, bufs, prefix):
        if isinstance(mod, _LEAVES):
            out.update({prefix + k: v for k, v in _leaf_to_torch(mod, sub).items()})
            for name, jname in _BUFFERS.get(type(mod), {}).items():
                out[prefix + name] = getattr(mod, name).detach().cpu() if bufs is None \
                    else _f32(bufs[jname])
            return
        for name, _ in mod.named_parameters(recurse=False):
            out[prefix + name] = _f32(sub[name])
        for name, child in mod.named_children():
            walk(child, sub[name], None if bufs is None else bufs.get(name),
                 prefix + name + ".")

    if spectral is not None and batch_stats is not None:
        raise ValueError("no port module holds both spectral u and batch statistics")
    walk(module, tree, spectral if spectral is not None else batch_stats, "")
    return out


def state_dict_to_jax(module: nn.Module, state_dict: dict | None = None) -> dict:
    """The JAX parameter tree (nested dict of numpy arrays) of `module`'s weights."""
    sd = module.state_dict() if state_dict is None else state_dict

    def walk(mod, prefix):
        if isinstance(mod, _LEAVES):
            local = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
                     and "." not in k[len(prefix):]}
            return _leaf_to_jax(mod, local)
        own = {name: host(sd[prefix + name]) for name, _ in mod.named_parameters(recurse=False)}
        return dict(own, **{name: walk(child, prefix + name + ".")
                            for name, child in mod.named_children()})

    return walk(module, "")


def _buffers_to_jax(module: nn.Module, kind) -> dict:
    """The JAX tree of the buffers of `module`'s leaves of type `kind`, nested as the
    parameters are, subtrees without one left out."""

    def walk(mod):
        if isinstance(mod, kind):
            return {jname: host(getattr(mod, name)) for name, jname in _BUFFERS[kind].items()}
        sub = {name: walk(child) for name, child in mod.named_children()}
        return {k: v for k, v in sub.items() if v}

    return walk(module)


def spectral_to_jax(module: nn.Module) -> dict:
    """The JAX "spectral" tree of `module`: the `u` of each spectral-normalized conv."""
    return _buffers_to_jax(module, SNConv1d)


def batch_stats_to_jax(module: nn.Module) -> dict:
    """The JAX "batch_stats" tree of `module`: each BatchNorm's {mean, var}."""
    return _buffers_to_jax(module, BatchNorm)


def like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`full` on `ref`'s device and type, and sharded as `ref` where that is a DTensor
    (each rank keeps its own shard of its own copy of `full`; no communication)."""
    if isinstance(ref, DTensor):
        return distribute_tensor(full.to(ref.device, ref.dtype), ref.device_mesh,
                                 ref.placements, src_data_rank=None)
    return full.to(ref.device, ref.dtype)


def load_state_dict(module: nn.Module, sd: dict) -> None:
    """`module.load_state_dict(sd, strict=True)` for whole tensors, also where the
    module's parameters are sharded (parallel/mesh.py)."""
    own = module.state_dict()
    module.load_state_dict({k: like(v, own[k]) if isinstance(own.get(k), DTensor) else v
                            for k, v in sd.items()}, strict=True)


def load_jax_params(module: nn.Module, tree: dict, spectral: dict | None = None,
                    batch_stats: dict | None = None) -> nn.Module:
    """Copy a JAX parameter tree (and spectral or batch_stats tree) onto `module`
    (strict: every weight must be there)."""
    load_state_dict(module, jax_to_state_dict(module, tree, spectral, batch_stats))
    return module


def init_random(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights (each module's `init_weights`)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    return module


def read_msgpack(path: str) -> dict:
    """A flax msgpack checkpoint (`.model`, `.last`) as a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"'{path}' does not hold a parameter tree")
    return tree


# -- the training state ------------------------------------------------------------------
#
# The JAX package keeps a Cubegan run as one pytree, `TrainState` {params, opt_state,
# spectral, step} (ttscube_tpu/models/cubegan.py), whose opt_state holds two optax
# `multi_transform` states: "d" (AdamW on the discriminators, every other partition set
# to zero) and "gtb" (AdamW on g and t, Adam at 1e-6 on b, d set to zero). Each has
# inner_states → partition → inner_state, which for an AdamW partition is the chain
# {"0": {count, mu, nu}, "1": {} (the decay), "2": {count} (the schedule)}, for Adam
# {"0": {count, mu, nu}, "1": {}}, and {} for a partition set to zero. mu and nu are
# trees shaped as params whose leaves outside the partition are {} (optax's MaskedNode).
# The port keeps one torch optimizer per partition (`make_optimizer`), whose per-
# parameter `step` is optax's count; its learning rate follows the train state's step,
# as optax's schedule follows its count.

# each multi_transform's partitions, in the order the JAX package builds them, and
# those it updates
_TXS = {"d": (("d", "g", "t", "b"), ("d",)), "gtb": (("g", "t", "b", "d"), ("g", "t", "b"))}


def jax_partition(path: tuple) -> str:
    """The optimizer partition of a JAX parameter by its path of keys: `gen`, and
    `tower_g`/`cond_rnn`/`cond_output` of `lang` → g; the rest of `lang` → t;
    `mpd`/`msd` → d; anything else → b (ttscube_tpu/models/cubegan.py
    `partition_labels`)."""
    top = path[0]
    if top == "gen":
        return "g"
    if top in ("mpd", "msd"):
        return "d"
    if top == "lang":
        return "g" if len(path) > 1 and path[1] in ("tower_g", "cond_rnn",
                                                    "cond_output") else "t"
    return "b"


def _masked(tree: dict, part: str, path=()) -> dict:
    """`tree` with every array outside partition `part` replaced by {}."""
    return {k: _masked(v, part, path + (k,)) if isinstance(v, dict)
            else (v if jax_partition(path + (k,)) == part else {})
            for k, v in tree.items()}


def _filled(moments: dict, params: dict) -> dict:
    """A moment tree with its {} leaves (outside the partition) filled with zeros of
    the parameter's shape."""
    return {k: _filled(moments[k], v) if isinstance(v, dict)
            else (np.zeros_like(v) if isinstance(moments[k], dict) else moments[k])
            for k, v in params.items()}


def _optimizer_of(state) -> dict:
    """Each parameter's (partition, optimizer), by the parameter's identity."""
    return {id(p): (part, opt) for part, opt in state.optimizers.items()
            for group in opt.param_groups for p in group["params"]}


def _moment_trees(model: nn.Module, owner: dict):
    """The Adam moments of `model`'s parameters as JAX trees {"exp_avg": ...,
    "exp_avg_sq": ...} (zeros where a parameter has none), and each optimizer's count
    by its key; `owner` maps id(parameter) → (key, optimizer)."""
    counts, moments = {}, {}
    for key in ("exp_avg", "exp_avg_sq"):
        sd = {}
        for name, t in model.state_dict(keep_vars=True).items():
            part_opt = owner.get(id(t))
            st = part_opt[1].state.get(t, {}) if part_opt else {}
            sd[name] = st[key] if key in st else torch.zeros_like(t)
            if part_opt and "step" in st:
                counts[part_opt[0]] = int(st["step"])
        moments[key] = state_dict_to_jax(model, sd)
    return counts, moments


def _adam_updates(model: nn.Module, opt, adam: dict, params: dict) -> list:
    """(optimizer, parameter, its new torch state) for each parameter of `opt`, from an
    optax ScaleByAdamState tree `adam` {count, mu, nu} (moments outside the partition
    may be {}); an empty state where the count is 0."""
    count = int(adam["count"])
    mu, nu = (jax_to_state_dict(model, _filled(adam[k], params)) for k in ("mu", "nu"))
    named = {id(p): n for n, p in model.named_parameters()}
    return [(opt, p, {} if count == 0 else {
        "step": torch.tensor(float(count)),
        "exp_avg": like(mu[named[id(p)]], p), "exp_avg_sq": like(nu[named[id(p)]], p)})
        for group in opt.param_groups for p in group["params"]]


def _load_checked(model: nn.Module, sd: dict, updates: list, where: str) -> None:
    """Load the state dict `sd` (which must fit `model` exactly) and the optimizer
    states `updates`; nothing is changed if `sd` does not fit."""
    own = model.state_dict()
    wrong = [k for k, v in sd.items() if k not in own or own[k].shape != v.shape]
    if wrong or len(sd) != len(own):
        raise ValueError(f"'{where}' does not fit this model: {wrong[:3] or 'missing weights'}")
    load_state_dict(model, sd)
    for opt, p, st in updates:
        opt.state.pop(p, None)
        if st:
            opt.state[p] = st


def train_state_to_jax(state) -> dict:
    """The JAX package's TrainState tree {params, opt_state, spectral, step} of a port
    TrainState (models/cubegan.py), as numpy arrays."""
    model = state.model
    step = np.asarray(state.step, np.int32)
    counts, moments = _moment_trees(model, _optimizer_of(state))
    opt_state = {}
    for tx, (parts, active) in _TXS.items():
        inner = {}
        for part in parts:
            if part not in active:
                inner[part] = {"inner_state": {}}
                continue
            count = np.asarray(counts.get(part, state.step), np.int32)
            adam = {"count": count, "mu": _masked(moments["exp_avg"], part),
                    "nu": _masked(moments["exp_avg_sq"], part)}
            chain = {"0": adam, "1": {}}
            if part != "b":
                chain["2"] = {"count": step}
            inner[part] = {"inner_state": chain}
        opt_state[tx] = {"inner_states": inner}
    return {"params": state_dict_to_jax(model), "opt_state": opt_state,
            "spectral": spectral_to_jax(model).get("msd", {}), "step": step}


def check_train_state_tree(tree, where: str) -> None:
    """Raise ValueError unless `tree` is a TrainState tree with the two optimizer
    states {"d", "gtb"}; the single multi_transform state of the JAX package's first
    round is named as such."""
    if not isinstance(tree, dict) or not {"params", "opt_state", "step"} <= set(tree):
        raise ValueError(f"'{where}' holds no train state {{params, opt_state, spectral, "
                         "step}")
    opt = tree["opt_state"]
    if not isinstance(opt, dict) or not {"d", "gtb"} <= set(opt):
        raise ValueError(
            f"'{where}' is a legacy (round-1) optimizer checkpoint with a single "
            "multi_transform state; the current format keeps two states {'d','gtb'}. "
            "Resume weights only (the trainer does this when .opt.last fails to load: "
            "load_params on '.last'); the optimizer restarts from step 0.")


def load_jax_train_state(state, tree: dict, where: str = "<tree>"):
    """Copy a JAX TrainState tree onto a port TrainState in place: parameters, the
    spectral u, the step, and each partition's moments and count. Returns the state.
    Raises ValueError, with nothing restored, when the tree does not fit the state (as
    flax's `from_bytes` does for a template it does not match)."""
    check_train_state_tree(tree, where)
    try:
        return _load_train_state(state, tree, where)
    except KeyError as e:
        raise ValueError(f"'{where}' does not fit this model: it lacks {e}") from e


def _load_train_state(state, tree: dict, where: str):
    model, step = state.model, int(tree["step"])
    updates = []  # (optimizer, parameter, its new state), applied once all are read
    for part, opt in state.optimizers.items():
        tx = "d" if part == "d" else "gtb"
        chain = tree["opt_state"][tx]["inner_states"][part]["inner_state"]
        if part != "b" and int(chain["2"]["count"]) != step:
            raise ValueError(f"'{where}': partition {part}'s schedule count "
                             f"{int(chain['2']['count'])} differs from the step {step}; the "
                             "port's learning rate follows the step")
        updates += _adam_updates(model, opt, chain["0"], tree["params"])
    spectral = tree.get("spectral")
    sd = jax_to_state_dict(model, tree["params"], {"msd": spectral} if spectral else None)
    _load_checked(model, sd, updates, where)
    state.step = step
    return state


# -- the SimpleState of the phonemizer, textcoder and vocoder trainers -------------------
#
# The JAX `SimpleState` (ttscube_tpu/train/states.py) is {params, opt_state, step, extra}.
# Its opt_state is optax adamw's chain: ScaleByAdamState {count, mu, nu}, the decay's
# empty state, then the learning rate's: {} for a constant rate (the phonemizer), {count}
# for a schedule (textcoder and vocoder: {"0": ..., "1": {}, "2": {count}}). The vocoder
# clips the global norm first: {"0": {} (the clip), "1": <the adamw chain>}. `extra`
# holds Textcoder's batch_stats, else None. The port's (train/states.py) holds the model,
# one torch AdamW, the step, and `lr_decay` / `clip_norm` where the JAX optimizer has a
# schedule or a clip.


def simple_state_to_jax(state) -> dict:
    """The JAX SimpleState tree of a port SimpleState, as numpy arrays."""
    step = np.asarray(state.step, np.int32)
    counts, moments = _moment_trees(state.model, {
        id(p): ("all", state.optimizer) for group in state.optimizer.param_groups
        for p in group["params"]})
    adam = {"count": np.asarray(counts.get("all", 0), np.int32),
            "mu": moments["exp_avg"], "nu": moments["exp_avg_sq"]}
    opt = {"0": adam, "1": {}, "2": {} if state.lr_decay is None else {"count": step}}
    if state.clip_norm is not None:
        opt = {"0": {}, "1": opt}
    return {"params": state_dict_to_jax(state.model), "opt_state": opt, "step": step,
            "extra": batch_stats_to_jax(state.model) or None}


def load_jax_simple_state(state, tree: dict, where: str = "<tree>"):
    """Copy a JAX SimpleState tree onto a port SimpleState in place (parameters, the
    moments and count, the step, Textcoder's batch statistics); returns it. Raises
    ValueError, with nothing restored, when the tree is no SimpleState of this model
    and this optimizer."""
    opt = tree.get("opt_state") if isinstance(tree, dict) else None
    if state.clip_norm is not None and isinstance(opt, dict):
        opt = opt.get("1")  # the chain after the clip's empty state
    if not isinstance(tree, dict) or not {"params", "opt_state", "step"} <= set(tree) \
            or not isinstance(opt, dict) \
            or not {"count", "mu", "nu"} <= set(opt.get("0") or {}):
        raise ValueError(f"'{where}' holds no SimpleState {{params, opt_state ("
                         f"{'clip, ' if state.clip_norm is not None else ''}adamw), step}}")
    step = int(tree["step"])
    if state.lr_decay is not None and int((opt.get("2") or {}).get("count", -1)) != step:
        raise ValueError(f"'{where}': the learning-rate schedule's count differs from the "
                         f"step {step}; the port's learning rate follows the step")
    stats = tree.get("extra") or None
    has_stats = bool(batch_stats_to_jax(state.model))
    if has_stats != (stats is not None):
        raise ValueError(f"'{where}' does not fit this model: batch statistics "
                         f"{'missing' if has_stats else 'present'}")
    try:
        updates = _adam_updates(state.model, state.optimizer, opt["0"], tree["params"])
        sd = jax_to_state_dict(state.model, tree["params"], batch_stats=stats)
    except KeyError as e:
        raise ValueError(f"'{where}' does not fit this model: it lacks {e}") from e
    _load_checked(state.model, sd, updates, where)
    state.step = step
    return state
