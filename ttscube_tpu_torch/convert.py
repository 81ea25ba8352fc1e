"""Parameters between the JAX package's trees and the port's modules.

A JAX tree is a nested dict of numpy arrays, as flax keeps it ({"lang": ..., "gen":
...} for Cubegan). The port's modules are named as the tree is, so the walk below
pairs each leaf module with its subtree and applies the layout rules:

  * Conv1d kernel, SNConv1d kernel, WNConv1d v: (k, in, out) ↔ (out, in, k)
  * WNConv2d v: (kh, kw, in, out) ↔ (out, in, kh, kw)
  * SNConv1d u: the JAX "spectral" collection ↔ the module's buffer `u`
  * WNConvTranspose1d v: (k, out, in) ↔ (in, out, k); its g is per input channel
  * Dense kernel: (in, out) ↔ Linear weight (out, in)
  * LSTM: wi/wh (D, 4H) ↔ weight_ih/weight_hh (4H, D); the single bias b goes to
    bias_ih with bias_hh = 0, and comes back as bias_ih + bias_hh
  * g, bias, embeddings: unchanged

`read_msgpack` reads the JAX package's `.model` / `.last` files (flax msgpack) with the
port's own reader (`utils/serialization.py`), never flax or msgpack.
`train_state_to_jax` and `load_jax_train_state` move a whole training state (weights,
optimizer moments and counts, spectral u, step) between the port and the JAX
package's `TrainState` tree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ttscube_tpu_torch.models.languasito import MaskedEmbed
from ttscube_tpu_torch.ops.conv import (Conv1d, SNConv1d, WNConv1d, WNConv2d,
                                        WNConvTranspose1d)
from ttscube_tpu_torch.ops.linear import Dense, Embed
from ttscube_tpu_torch.ops.rnn import LSTM
from ttscube_tpu_torch.utils.serialization import msgpack_restore

_T3 = (2, 1, 0)  # (k, a, b) ↔ (b, a, k)
_T4 = (3, 2, 0, 1)  # (kh, kw, in, out) → (out, in, kh, kw)
_T4_BACK = (2, 3, 1, 0)


def _leaf_to_torch(mod: nn.Module, p: dict) -> dict:
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    if isinstance(mod, (Conv1d, SNConv1d)):
        out = {"kernel": a(np.transpose(p["kernel"], _T3))}
    elif isinstance(mod, (WNConv1d, WNConvTranspose1d)):
        out = {"v": a(np.transpose(p["v"], _T3)), "g": a(p["g"])}
    elif isinstance(mod, WNConv2d):
        out = {"v": a(np.transpose(p["v"], _T4)), "g": a(p["g"])}
    elif isinstance(mod, Dense):
        out = {"weight": a(np.asarray(p["kernel"]).T)}
    elif isinstance(mod, Embed):
        return {"weight": a(p["embedding"])}
    elif isinstance(mod, MaskedEmbed):
        return {"embedding": a(p["embedding"])}
    elif isinstance(mod, LSTM):
        out = {}
        for layer in range(mod.num_layers):
            for tsfx, jsfx in (("", ""), ("_reverse", "_rev"))[: 1 + mod.bidirectional]:
                out[f"weight_ih_l{layer}{tsfx}"] = a(np.asarray(p[f"wi_l{layer}{jsfx}"]).T)
                out[f"weight_hh_l{layer}{tsfx}"] = a(np.asarray(p[f"wh_l{layer}{jsfx}"]).T)
                out[f"bias_ih_l{layer}{tsfx}"] = a(p[f"b_l{layer}{jsfx}"])
                out[f"bias_hh_l{layer}{tsfx}"] = torch.zeros(4 * mod.hidden_size)
        return out
    else:
        raise TypeError(f"no JAX layout rule for {type(mod).__name__}")
    if getattr(mod, "bias", None) is not None:
        out["bias"] = a(p["bias"])
    return out


def _leaf_to_jax(mod: nn.Module, sd: dict) -> dict:
    n = lambda name: sd[name].detach().cpu().float().numpy()
    if isinstance(mod, (Conv1d, SNConv1d)):
        out = {"kernel": np.ascontiguousarray(np.transpose(n("kernel"), _T3))}
    elif isinstance(mod, (WNConv1d, WNConvTranspose1d)):
        out = {"v": np.ascontiguousarray(np.transpose(n("v"), _T3)), "g": n("g")}
    elif isinstance(mod, WNConv2d):
        out = {"v": np.ascontiguousarray(np.transpose(n("v"), _T4_BACK)), "g": n("g")}
    elif isinstance(mod, Dense):
        out = {"kernel": np.ascontiguousarray(n("weight").T)}
    elif isinstance(mod, Embed):
        return {"embedding": n("weight")}
    elif isinstance(mod, MaskedEmbed):
        return {"embedding": n("embedding")}
    elif isinstance(mod, LSTM):
        out = {}
        for layer in range(mod.num_layers):
            for tsfx, jsfx in (("", ""), ("_reverse", "_rev"))[: 1 + mod.bidirectional]:
                out[f"wi_l{layer}{jsfx}"] = np.ascontiguousarray(n(f"weight_ih_l{layer}{tsfx}").T)
                out[f"wh_l{layer}{jsfx}"] = np.ascontiguousarray(n(f"weight_hh_l{layer}{tsfx}").T)
                out[f"b_l{layer}{jsfx}"] = (n(f"bias_ih_l{layer}{tsfx}")
                                            + n(f"bias_hh_l{layer}{tsfx}"))
        return out
    else:
        raise TypeError(f"no JAX layout rule for {type(mod).__name__}")
    if getattr(mod, "bias", None) is not None:
        out["bias"] = n("bias")
    return out


_LEAVES = (Conv1d, SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d, Dense, Embed,
           MaskedEmbed, LSTM)


def jax_to_state_dict(module: nn.Module, tree: dict, spectral: dict | None = None) -> dict:
    """The state dict of `module` holding the JAX parameter tree `tree` and, for its
    spectral-normalized convs, the `u` vectors of the JAX "spectral" tree `spectral`
    (laid out as `tree`; without it each keeps the `u` it holds)."""
    out = {}

    def walk(mod, sub, spec, prefix):
        if isinstance(mod, _LEAVES):
            out.update({prefix + k: v for k, v in _leaf_to_torch(mod, sub).items()})
            if isinstance(mod, SNConv1d):
                u = mod.u.detach().cpu() if spec is None else \
                    torch.from_numpy(np.array(spec["u"], dtype=np.float32))
                out[prefix + "u"] = u
            return
        for name, child in mod.named_children():
            walk(child, sub[name], None if spec is None else spec.get(name),
                 prefix + name + ".")

    walk(module, tree, spectral, "")
    return out


def state_dict_to_jax(module: nn.Module, state_dict: dict | None = None) -> dict:
    """The JAX parameter tree (nested dict of numpy arrays) of `module`'s weights."""
    sd = module.state_dict() if state_dict is None else state_dict

    def walk(mod, prefix):
        if isinstance(mod, _LEAVES):
            local = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
                     and "." not in k[len(prefix):]}
            return _leaf_to_jax(mod, local)
        return {name: walk(child, prefix + name + ".")
                for name, child in mod.named_children()}

    return walk(module, "")


def spectral_to_jax(module: nn.Module) -> dict:
    """The JAX "spectral" tree of `module`: the `u` of each spectral-normalized conv,
    nested as the parameters are, subtrees without one left out."""

    def walk(mod):
        if isinstance(mod, SNConv1d):
            return {"u": mod.u.detach().cpu().float().numpy()}
        sub = {name: walk(child) for name, child in mod.named_children()}
        return {k: v for k, v in sub.items() if v}

    return walk(module)


def load_jax_params(module: nn.Module, tree: dict, spectral: dict | None = None) -> nn.Module:
    """Copy a JAX parameter tree (and spectral tree) onto `module` (strict: every
    weight must be there)."""
    module.load_state_dict(jax_to_state_dict(module, tree, spectral), strict=True)
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


def train_state_to_jax(state) -> dict:
    """The JAX package's TrainState tree {params, opt_state, spectral, step} of a port
    TrainState (models/cubegan.py), as numpy arrays."""
    model = state.model
    step = np.asarray(state.step, np.int32)
    owner = _optimizer_of(state)
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
        count = int(chain["0"]["count"])
        if part != "b" and int(chain["2"]["count"]) != step:
            raise ValueError(f"'{where}': partition {part}'s schedule count "
                             f"{int(chain['2']['count'])} differs from the step {step}; the "
                             "port's learning rate follows the step")
        mu, nu = (jax_to_state_dict(model, _filled(chain["0"][k], tree["params"]))
                  for k in ("mu", "nu"))
        named = {id(p): n for n, p in model.named_parameters()}
        for group in opt.param_groups:
            for p in group["params"]:
                n = named[id(p)]
                updates.append((opt, p, {} if count == 0 else {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[n].to(p.device, p.dtype),
                    "exp_avg_sq": nu[n].to(p.device, p.dtype)}))
    spectral = tree.get("spectral")
    sd = jax_to_state_dict(model, tree["params"], {"msd": spectral} if spectral else None)
    own = model.state_dict()
    wrong = [k for k, v in sd.items() if k not in own or own[k].shape != v.shape]
    if wrong or len(sd) != len(own):
        raise ValueError(f"'{where}' does not fit this model: {wrong[:3] or 'missing weights'}")
    model.load_state_dict(sd, strict=True)
    for opt, p, st in updates:
        opt.state.pop(p, None)
        if st:
            opt.state[p] = st
    state.step = step
    return state
