"""The transformer encoder of HF conditioning: counterpart of `ttscube_tpu/models/lm.py`.

A BERT-architecture encoder (post-LN, erf GELU, absolute positions from 0, token type 0
everywhere) whose last hidden state Cubegan gathers per word (`Cubegan.lm_condition`).
Its parameters sit under `hf` in the Cubegan, as under `params["hf"]` in the JAX tree,
and train in the `b` partition (Adam at 1e-6). As in the JAX package the encoder never
drops out, in training too (the JAX `lm_condition` applies it with its default
`deterministic=True`); `LMConfig.dropout` is read from config.json and kept, not used.
The attention is plain PyTorch: two matmuls and a softmax, with padded keys masked by
adding `torch.finfo(float32).min`, so that a row whose tokens are all masked gets a
uniform softmax rather than NaNs, as in JAX.

`load_local_lm(model_dir)` reads a local HF-format directory: `config.json`, and the
weights of `pytorch_model.bin` (`torch.load(weights_only=True)`) or of
`model.safetensors` (read here, without the `safetensors` package), named as HF's
`BertModel` names them (`load_bert_state_dict`); `bert_state_dict` writes those names.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ttscube_tpu_torch.ops.linear import Dense, Embed, LayerNorm

BERT_INIT_STD = 0.02  # BertConfig.initializer_range


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    pad_token_id: int = 0

    @classmethod
    def from_local_dir(cls, model_dir: str) -> "LMConfig":
        """From an HF-style config.json in a local model directory."""
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = json.load(f)
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg.get("hidden_size", 768),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            intermediate_size=cfg.get("intermediate_size", 3072),
            max_position=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            dropout=cfg.get("hidden_dropout_prob", 0.1),
            pad_token_id=cfg.get("pad_token_id", 0),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Dense(Dense):
    """A dense layer with BERT's initialisation: normal(0, 0.02) weights, zero bias."""

    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, BERT_INIT_STD, generator=gen)
            self.bias.zero_()


class _Embed(Embed):
    def init_weights(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, BERT_INIT_STD, generator=gen)


class _SelfAttention(nn.Module):
    def __init__(self, c: LMConfig):
        super().__init__()
        self.heads = c.num_heads
        for name in ("query", "key", "value", "output"):
            self.add_module(name, _Dense(c.hidden_size, c.hidden_size))

    def forward(self, h, bias):
        B, T, H = h.shape
        hd = H // self.heads
        q = self.query(h).view(B, T, self.heads, hd)
        k = self.key(h).view(B, T, self.heads, hd)
        v = self.value(h).view(B, T, self.heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H)
        return self.output(ctx)


class _EncoderLayer(nn.Module):
    def __init__(self, c: LMConfig):
        super().__init__()
        self.attn = _SelfAttention(c)
        self.attn_ln = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.ff_in = _Dense(c.hidden_size, c.intermediate_size)
        self.ff_out = _Dense(c.intermediate_size, c.hidden_size)
        self.ff_ln = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, h, bias):
        h = self.attn_ln(h + self.attn(h, bias))
        f = self.ff_out(F.gelu(self.ff_in(h)))  # BERT's erf GELU
        return self.ff_ln(h + f)


class TransformerEncoder(nn.Module):
    """(B, T) token ids [and a (B, T) bool mask, default ids != pad] → the last hidden
    state (B, T, hidden). Submodules are named as the flax tree: word_emb, pos_emb,
    type_emb, emb_ln, layer_{i}.{attn.{query,key,value,output}, attn_ln, ff_in,
    ff_out, ff_ln}."""

    def __init__(self, config: LMConfig):
        super().__init__()
        c = self.config = config
        self.word_emb = _Embed(c.vocab_size, c.hidden_size)
        self.pos_emb = _Embed(c.max_position, c.hidden_size)
        self.type_emb = _Embed(c.type_vocab_size, c.hidden_size)
        self.emb_ln = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", _EncoderLayer(c))

    def forward(self, tok_ids, attn_mask=None):
        c = self.config
        if attn_mask is None:
            attn_mask = tok_ids != c.pad_token_id
        T = tok_ids.shape[1]
        h = self.word_emb(tok_ids) + self.pos_emb.weight[:T][None]
        h = self.emb_ln(h + self.type_emb.weight[0])  # token types are all 0
        bias = torch.where(attn_mask[:, None, None, :].bool(), 0.0,
                           torch.finfo(torch.float32).min)
        for i in range(c.num_layers):
            h = getattr(self, f"layer_{i}")(h, bias)
        return h


# -- HF BertModel names ------------------------------------------------------------------

_LAYER_NAMES = (("attn.query", "attention.self.query"), ("attn.key", "attention.self.key"),
                ("attn.value", "attention.self.value"),
                ("attn.output", "attention.output.dense"),
                ("attn_ln", "attention.output.LayerNorm"), ("ff_in", "intermediate.dense"),
                ("ff_out", "output.dense"), ("ff_ln", "output.LayerNorm"))


def bert_names(config: LMConfig) -> dict:
    """Each TransformerEncoder state-dict key → its HF `BertModel` name."""
    out = {"word_emb.weight": "embeddings.word_embeddings.weight",
           "pos_emb.weight": "embeddings.position_embeddings.weight",
           "type_emb.weight": "embeddings.token_type_embeddings.weight",
           "emb_ln.weight": "embeddings.LayerNorm.weight",
           "emb_ln.bias": "embeddings.LayerNorm.bias"}
    for i in range(config.num_layers):
        for port, hf in _LAYER_NAMES:
            for s in ("weight", "bias"):
                out[f"layer_{i}.{port}.{s}"] = f"encoder.layer.{i}.{hf}.{s}"
    return out


def load_bert_state_dict(state_dict: dict, config: LMConfig) -> dict:
    """A TransformerEncoder state dict (fp32 tensors) from an HF `BertModel` state
    dict, its names with or without a 'bert.' prefix; the pooler and a `position_ids`
    buffer are ignored. The counterpart of the JAX `params_from_torch_bert`."""
    sd = {(k[5:] if k.startswith("bert.") else k): v for k, v in state_dict.items()}
    missing = [hf for hf in bert_names(config).values() if hf not in sd]
    if missing:
        raise KeyError(f"BERT weights lack {missing[:3]} ({len(missing)} names)")
    f32 = lambda v: (v.detach().cpu().float() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v, np.float32)))
    return {port: f32(sd[hf]) for port, hf in bert_names(config).items()}


def bert_state_dict(encoder: TransformerEncoder) -> dict:
    """The encoder's weights under HF `BertModel` names (CPU tensors)."""
    sd = encoder.state_dict()
    return {hf: sd[port].detach().cpu().clone()
            for port, hf in bert_names(encoder.config).items()}


# -- safetensors, without the package -------------------------------------------------------

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> dict:
    """A `.safetensors` file as {name: numpy array}: an 8-byte little-endian header
    length, a JSON header {name: {dtype, shape, data_offsets}} (and `__metadata__`),
    then the raw little-endian data. BF16 arrays come back as fp32 (exactly)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        buf, dtype = data[start:end], info["dtype"]
        if dtype == "BF16":
            a = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif dtype in _ST_DTYPES:
            a = np.frombuffer(buf, _ST_DTYPES[dtype])
        else:
            raise NotImplementedError(f"safetensors dtype {dtype} ('{name}') is not read")
        out[name] = a.reshape(info["shape"]).copy()
    return out


def load_local_lm(model_dir: str):
    """(LMConfig, TransformerEncoder state dict or None) from a local HF-style model
    directory: config.json, and pytorch_model.bin or model.safetensors where there is
    one (None otherwise: the caller decides whether a random encoder will do)."""
    config = LMConfig.from_local_dir(model_dir)
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(bin_path):
        return config, load_bert_state_dict(
            torch.load(bin_path, map_location="cpu", weights_only=True), config)
    if os.path.exists(st_path):
        return config, load_bert_state_dict(read_safetensors(st_path), config)
    return config, None
