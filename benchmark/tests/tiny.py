"""A small copy of the benchmark for tests on the CPU: the same files under a temporary
root, each cell and each configuration cut by a file of its own, found by name, and each
cell's limits as committed.

- `benchmark/tests/tiny/cells/<cell>.json`: `params`, merged over the cell's parameters
  (synthesis: a few items of a few frames; training: two utterances of 70-90 frames, the
  GAN crop kept at its 50 frames, the followed step among the window's first two);
  `trace_units`; `sound_run`, whether the CPU tests run the cell as it is and require it
  correct; `faults`, the faults of `benchmark/faults.py` its CPU run must catch;
- `benchmark/tests/tiny/configs/<config>.json`: groups merged over the configuration's
  own (BERT cut to 2 layers of 64), or `{}`."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.calibrate import with_overrides
from benchmark.harness import Bench

REPO = Path(__file__).resolve().parents[2]
CUTS = Path("benchmark") / "tests" / "tiny"


def cut_file(root: Path, kind: str, name: str) -> Path:
    """The file that cuts `name`, a cell (`kind` "cells") or a configuration ("configs"),
    in the benchmark under `root`."""
    return Path(root) / CUTS / kind / f"{name}.json"


def read_cut(root: Path, kind: str, name: str) -> dict:
    path = cut_file(root, kind, name)
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: the CPU copy cuts every {kind[:-1]} "
                                "by a file of its own")
    return json.loads(path.read_text())


def tiny_cell(name: str, root: Path = REPO) -> dict:
    """Cell `name` of the benchmark under `root`, as the CPU copy runs it."""
    cell = Bench(root).cell(name)
    cut = read_cut(root, "cells", name)
    return dict(cell, params={**cell["params"], **cut["params"]}, trace_units=cut["trace_units"])


def copy_benchmark(src: Path, dest: Path, *leave_out: str) -> Path:
    """`BENCHMARK.json` and the benchmark's folder of `src` under `dest`, without caches
    and what `leave_out` names; returns `dest`."""
    dest = Path(dest)
    shutil.copytree(Path(src) / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", *leave_out))
    shutil.copy(Path(src) / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def make_root(dest: Path, src: Path = REPO) -> Path:
    """A tiny copy under `dest` of the benchmark under `src`, each cell and configuration
    cut by its file under `src`; returns `dest`."""
    dest = copy_benchmark(src, dest, "tests")
    bench = Bench(dest)
    for w in bench.manifest["workloads"]:
        (bench.dir / "workloads" / f"{w['name']}.json").write_text(
            json.dumps(tiny_cell(w["name"], src)))
    for c in bench.manifest["configs"]:
        cut = read_cut(src, "configs", c["name"])
        (dest / c["file"]).write_text(json.dumps(with_overrides(bench.config(c["name"]), cut)))
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
