"""What the runners share: the program's configuration objects built from a
configuration file, its model with the benchmark's seeded weights, and the spans the
traced slice opens around the program's calls."""

from __future__ import annotations

import functools

import torch

from benchmark import weights


def port_configs(c: dict, train: bool):
    """(CubeganConfig, LMConfig or None) of the program for configuration file `c`:
    serving at `serving`'s types, training at `train_precision`'s."""
    from ttscube_tpu_torch.models.cubegan import CubeganConfig
    from ttscube_tpu_torch.models.hifigan import HifiganConfig
    from ttscube_tpu_torch.models.languasito import LanguasitoConfig
    from ttscube_tpu_torch.models.lm import LMConfig

    lc, h, t = c["languasito"], c["hifigan"], c["training"]
    lm = None
    if lc.get("cond_type") == "hf":
        m = c["lm"]
        lm = LMConfig(vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
                      num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
                      intermediate_size=m["intermediate_size"],
                      max_position=m["max_position_embeddings"],
                      type_vocab_size=m["type_vocab_size"], layer_norm_eps=m["layer_norm_eps"],
                      pad_token_id=m["pad_token_id"])
    gen = dict(resblock=h["resblock"], upsample_rates=tuple(h["upsample_rates"]),
               upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
               upsample_initial_channel=h["upsample_initial_channel"],
               resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
               resblock_dilation_sizes=tuple(tuple(d) for d in h["resblock_dilation_sizes"]),
               num_mels=h["num_mels"], sampling_rate=h["sampling_rate"])
    if train:
        p = c["train_precision"]
        gen.update(compute_dtype=p["compute_dtype"], fused_tail_train=p["fused_tail_train"])
        disc = p["disc_compute_dtype"]
    else:
        s = c["serving"]
        gen.update(fused_tail=s["fused_tail"], storage_dtype=s["storage_dtype"],
                   compute_dtype=s["compute_dtype"], fuse_channels=tuple(s["fuse_channels"]))
        disc = "float32"
    d = c["discriminators"]
    if tuple(d["mpd_periods"]) != (2, 3, 5, 7, 11):
        raise ValueError("the program's MPD has the periods 2, 3, 5, 7, 11")
    cfg = CubeganConfig(
        languasito=LanguasitoConfig(num_phones=lc["num_phones"], num_speakers=lc["num_speakers"],
                                    max_pitch=lc["max_pitch"], max_duration=lc["max_duration"],
                                    cond_type=lc.get("cond_type"),
                                    lm_dim=lm.hidden_size if lm is not None else None),
        hifigan=HifiganConfig(**gen), lr=t["lr"], lr_decay=t["lr_decay"],
        sample_rate=c["sample_rate"], hop_size=c["hop_size"], mel_weight=t["mel_weight"],
        mpd_channels=tuple(d["mpd_channels"]), msd_width=d["msd_width"],
        disc_compute_dtype=disc)
    return cfg, lm


def set_tf32(c: dict, train: bool) -> None:
    """torch's TF32 switches as the configuration states them for serving or training."""
    p = c["train_precision" if train else "serving"]
    torch.backends.cudnn.allow_tf32 = p["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = p["matmul_tf32"]


def build(c: dict, seed: int, device, train: bool):
    """The program's Cubegan on `device` with the seeded weights; returns (model, the
    shapes the weights were made for, the weights)."""
    from ttscube_tpu_torch.models.cubegan import Cubegan

    cfg, lm = port_configs(c, train)
    set_tf32(c, train)
    with torch.device(device):
        model = Cubegan(cfg, train=train, lm_config=lm)
    shapes = weights.shapes_of(model)
    with torch.no_grad():
        W = weights.make(shapes, seed, device)
        model.load_state_dict(W)
    return model, shapes, W


def resolve(root, path: str) -> list:
    """(owner, attribute) pairs that a dotted path names under `root`; a `*` segment
    runs over a dict's values; a missing attribute names nothing."""
    *heads, last = path.split(".")
    owners = [root]
    for part in heads:
        nxt = []
        for o in owners:
            if part == "*":
                nxt += list(o.values()) if isinstance(o, dict) else []
            elif hasattr(o, part):
                nxt.append(getattr(o, part))
        owners = nxt
    return [(o, last) for o in owners if hasattr(o, last)]


def open_spans(root, spans: dict) -> list:
    """Wrap each callable that `spans` ({span name: dotted path or list of them}) names
    in a `record_function` range of that name; returns what `close_spans` undoes."""
    from torch.profiler import record_function

    undo = []
    for name, paths in spans.items():
        targets = [t for p in ([paths] if isinstance(paths, str) else paths)
                   for t in resolve(root, p)]
        for owner, attr in targets:
            fn = getattr(owner, attr)

            @functools.wraps(fn)
            def wrapped(*a, _fn=fn, _name=name, **kw):
                with record_function(_name):
                    return _fn(*a, **kw)

            had = attr in vars(owner)
            setattr(owner, attr, wrapped)
            undo.append((owner, attr, fn if had else None))
    return undo


def close_spans(undo: list) -> None:
    for owner, attr, fn in reversed(undo):
        if fn is None:
            delattr(owner, attr)
        else:
            setattr(owner, attr, fn)


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
