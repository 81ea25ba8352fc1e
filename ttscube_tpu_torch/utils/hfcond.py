"""The front end of an HF-conditioned voice in TTSCube: counterpart of
`ttscube_tpu/utils/hfcond.py`.

The tokenizer comes from a local directory: the `<model>.hf/` directory that
`export_model` packs beside the model where there is one, else the directory named in
the model yaml's conditioning spec (`hf:<dir>`, read with `utils/config_io.py`). Each
request's words get their token ids and word→token map (`words_hf`), with empty left
and right context windows.
"""

from __future__ import annotations

import os

from ttscube_tpu_torch.utils import config_io
from ttscube_tpu_torch.utils.hf import HFTokenizer


class HFCondFrontend:
    def __init__(self, model_dir: str):
        self.tokenizer = HFTokenizer(model_dir)

    @classmethod
    def from_packaged(cls, model_path: str) -> "HFCondFrontend":
        packaged = model_path + ".hf"
        if os.path.isdir(packaged):
            return cls(packaged)
        conf = config_io.load(model_path + ".yaml") or {}
        spec = conf.get("conditioning") or ""
        if ":" not in spec:
            raise ValueError(f"'{model_path}.yaml' conditioning spec '{spec}' names no "
                             "tokenizer directory")
        model_dir = spec.split(":", 1)[1]
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(
                f"hf-conditioned model: tokenizer directory '{model_dir}' (from the "
                f"packaged conditioning spec) not found locally — place the HF "
                "tokenizer files there or retrain with a portable path")
        return cls(model_dir)

    def __call__(self, meta: dict) -> dict:
        """`meta` (a Text2Feat result) with `words_hf` and empty context windows."""
        meta["words_hf"] = self.tokenizer(meta["words"])
        meta["words_left_hf"] = {"tok_ids": [], "word2tok": {}}
        meta["words_right_hf"] = {"tok_ids": [], "word2tok": {}}
        return meta
