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

`read_msgpack` reads the JAX package's `.model` / `.last` files (flax msgpack) without
flax; it imports `msgpack` when called, never at import.
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
    import msgpack  # file-loading path only; the card's serving path never calls this

    def ndarray(data):
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    def ext_hook(code, data):
        if code in (1, 3):  # flax's ndarray and numpy-scalar extension types
            arr = ndarray(data)
            return arr if code == 1 else arr[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False,
                               strict_map_key=False)
    if not isinstance(tree, dict):
        raise ValueError(f"'{path}' does not hold a parameter tree")
    return tree
