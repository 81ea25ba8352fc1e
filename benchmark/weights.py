"""Seeded weights, made on the device in the type they are served in: two large draws
from a `torch.Generator` on the card (one normal, one uniform), cut into leaves and
scaled by each leaf's rule. The same seed and the same shapes give the same weights,
which the program and the reference both receive.

The rules follow the model's own initialisers by the leaf's name: weight-normalised
convs v ~ N(0, 0.01²) with g = 1 (unit-norm kernel rows); LSTM weights and input bias
~ U(±1/√H), the second bias 0; dense and char-CNN kernels Xavier-uniform (tanh gain
for the char CNN); the spectral-normalised convs U(±1/√fan-in) with u ~ N(0, 1);
phone and speaker tables N(0, 1); BERT's tables and dense weights N(0, 0.02²), its
layer norms 1 and 0; other biases 0."""

from __future__ import annotations

import math

import torch


def rule(name: str, shape: tuple):
    """("normal" | "uniform" | "const", scale or value) for one leaf."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("hf."):
        if name.endswith("_ln.weight"):
            return "const", 1.0
        if leaf == "bias":
            return "const", 0.0
        return "normal", 0.02
    if leaf == "v":
        return "normal", 0.01
    if leaf == "g":
        return "const", 1.0
    if leaf == "u":
        return "normal", 1.0
    if leaf.startswith("bias_hh"):
        return "const", 0.0
    if leaf.startswith(("weight_ih", "weight_hh", "bias_ih")):
        hidden = shape[0] // 4
        return "uniform", 1.0 / math.sqrt(hidden)
    if leaf == "embedding":
        return "normal", 1.0
    if leaf == "kernel" and ".char_cnn_" in name:
        fout, fin, k = shape
        return "uniform", (5.0 / 3) * math.sqrt(6.0 / (k * fin + k * fout))
    if leaf == "kernel":
        fout, fin, k = shape
        return "uniform", 1.0 / math.sqrt(fin * k)
    if leaf == "weight" and len(shape) == 2:
        fout, fin = shape
        return "uniform", math.sqrt(6.0 / (fin + fout))
    if leaf == "bias":
        return "const", 0.0
    raise ValueError(f"no initialisation rule for {name} {shape}")


def make(shapes: dict, seed: int, device) -> dict:
    """{name: fp32 tensor on `device`} for {name: shape}, from `seed`."""
    rules = {n: rule(n, tuple(s)) for n, s in shapes.items()}
    sizes = {kind: sum(math.prod(shapes[n]) for n, r in rules.items() if r[0] == kind)
             for kind in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device)}
    offset = {"normal": 0, "uniform": 0}
    out = {}
    for n, (kind, scale) in rules.items():
        numel = math.prod(shapes[n])
        if kind == "const":
            out[n] = torch.full(tuple(shapes[n]), scale, device=device)
            continue
        flat = pools[kind][offset[kind]: offset[kind] + numel]
        offset[kind] += numel
        out[n] = (flat * scale if kind == "normal" else (2 * flat - 1) * scale).view(shapes[n])
    return out


def shapes_of(module) -> dict:
    """{name: shape} of a module's parameters and buffers, as its state dict names them."""
    return {n: tuple(t.shape) for n, t in module.state_dict().items()}
