"""A small copy of the benchmark for tests on the CPU: the same files under a temporary
root, each cell cut to a few items of a few frames (training: two utterances of 70-90
frames, the GAN crop kept at its 50 frames, the followed step among the window's first
two), BERT cut to 2 layers of 64, and each cell's limits as committed."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_params(cell: dict) -> dict:
    p = dict(cell["params"])
    if cell["kind"] == "synth_batch":
        p.update(batch=3, phones=[5, 9], max_frames=24, check_share=0.5, check_rows=2)
        if p.get("chunk_frames"):
            p.update(max_frames=48, chunk_frames=8, halo_frames=4)
    else:
        p.update(batch=2, pool=3, frames=[70, 90], watch_within=2)
        if "context_extra" in p:
            p.update(context_extra=0, tokens_per_word=[1, 2])
    return p


def make_root(dest: Path) -> Path:
    """A tiny benchmark under `dest`; returns `dest`."""
    dest = Path(dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for f in (dest / "benchmark" / "workloads").glob("*.json"):
        cell = json.loads(f.read_text())
        cell["params"] = tiny_params(cell)
        cell["trace_units"] = 1
        f.write_text(json.dumps(cell))
    bert = dest / "benchmark" / "configs" / "cubegan-v1-bert-base.json"
    c = json.loads(bert.read_text())
    c["lm"].update(vocab_size=2000, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=128, max_position_embeddings=128)
    bert.write_text(json.dumps(c))
    return dest


def run_cpu(root: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.5):
    """One run of the harness on the CPU: its look for a card gives the host instead,
    and the card's name and memory peak read as "cpu" and 0."""
    import time
    from unittest import mock

    import torch

    from benchmark import harness

    with mock.patch.object(harness, "card", lambda chips, log: torch.device("cpu")), \
            mock.patch.multiple(torch.cuda, max_memory_allocated=lambda device: 0,
                                get_device_name=lambda device: "cpu"):
        return harness.run(root, workload, seed, seconds, False, time.perf_counter())
