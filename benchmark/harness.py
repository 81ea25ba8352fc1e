"""One run of one cell: set-up, a measured window, a traced slice where asked, the check
against the reference, and the result line.

Everything is found by name, so that a new cell, configuration, traffic kind or metric is
new files alone:
- `BENCHMARK.json` (the repository's root): the cells, and which metrics each reports;
- `benchmark/workloads/<cell>.json`: the cell's runner, traffic kind and parameters, the
  span of its traced slice, and the limit of each number its check compares;
- `benchmark/configs/...`: the configuration file `BENCHMARK.json` names;
- `benchmark/traffic/<kind>.py`: a `Traffic(params, config, seed)` class;
- `benchmark/runners/<runner>.py`: a `Runner(cell, config, traffic, seed, device)` class
  with `setup`, `unit(i)`, `sync`, `failed(records)`, `free`, `check`, `first_unit` and,
  where its check reads a unit of the window, `min_units`;
- `benchmark/metrics/<metric>.py`: `read(run)` returning the metric's value or None,
  and, where it reads a span, `SPANS` ({span: dotted path under the runner to wrap})."""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BANNED = ("jax", "jaxlib", "flax", "ttscube_tpu")


class RunError(Exception):
    """A run that cannot give a result (no card, a missing file, a module of the JAX
    package loaded): it prints none and exits with another code than 0."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's files under `root` (a checkout)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.manifest = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "benchmark"

    def entry(self, workload: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == workload:
                return w
        raise RunError(f"BENCHMARK.json has no workload {workload!r}")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise RunError(f"BENCHMARK.json has no config {name!r}")

    def cell(self, workload: str) -> dict:
        cell = load_json(self.dir / "workloads" / f"{workload}.json")
        e = self.entry(workload)
        if (cell["config"], cell["traffic"]) != (e["config"], e["traffic"]):
            raise RunError(f"{workload}: its file names {cell['config']}/{cell['traffic']}, "
                           f"BENCHMARK.json {e['config']}/{e['traffic']}")
        return cell

    def metrics(self, workload: str, kind: str) -> list:
        """The `end_to_end` or `per_layer` entries that the cell reports."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def metric_module(self, name: str):
        return load_module(self.dir / "metrics" / f"{name}.py", f"bench_metric_{name}")

    def traffic(self, kind: str):
        return load_module(self.dir / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")

    def runner(self, name: str):
        return load_module(self.dir / "runners" / f"{name}.py", f"bench_runner_{name}")


class Run:
    """What a metric reads: the set-up time, the window's units (each with its shape,
    work and host ms), the window's length, the traced slice's units and trace, the
    configuration and the cell."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def window(runner, seconds: float, first: int) -> tuple:
    """Units back to back from index `first` until `seconds` have passed, and at least
    the runner's `min_units` (the units its check reads; fewer than a full window holds);
    returns (the units' records, the seconds from the first's start to the last's end)."""
    records = []
    least = getattr(runner, "min_units", 1)
    t_start = time.perf_counter()
    i = first
    while time.perf_counter() - t_start < seconds or len(records) < least:
        t0 = time.perf_counter()
        rec = runner.unit(i)
        rec["host_ms"] = (time.perf_counter() - t0) * 1e3
        records.append(rec)
        i += 1
    runner.sync()
    return records, time.perf_counter() - t_start


def decide(numbers: dict, limits: dict, failed: int) -> bool:
    return (failed == 0 and set(numbers) <= set(limits)
            and all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items()))


def card(chips: int, log):
    """The card a run measures on: the first of the `chips` it needs; a machine with
    fewer gives no result, and the run never falls back to the host."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card and never falls back")
    if torch.cuda.device_count() < chips:
        raise RunError(f"{chips} card(s) needed, {torch.cuda.device_count()} found")
    print(f"card: {card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}",
          file=log, flush=True)
    return torch.device("cuda", 0)


def run(root, workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        log=sys.stderr) -> dict:
    """One run; returns the result (the last line's object, with `checks` last)."""
    import torch

    bench = Bench(root)
    entry = bench.entry(workload)
    cell = bench.cell(workload)
    device = card(entry["chips"], log)
    config = bench.config(entry["config"])
    traffic = bench.traffic(cell["kind"]).Traffic(cell["params"], config, seed)
    runner = bench.runner(cell["runner"]).Runner(cell, config, traffic, seed, device)
    before = time.perf_counter() - t_process

    runner.setup()
    runner.sync()
    setup_s = time.perf_counter() - t_process
    phases = {"process start, imports, card": before, **getattr(runner, "phases", {})}
    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), file=log,
          flush=True)
    records, elapsed = window(runner, seconds, runner.first_unit)
    failed = runner.failed(records)
    peak = torch.cuda.max_memory_allocated(device)

    per_layer = bench.metrics(workload, "per_layer")
    traced, sliced = None, []
    if trace:
        from benchmark.runners.common import close_spans, open_spans
        from benchmark.trace import profiled

        spans = {}
        for m in per_layer:
            spans.update(getattr(bench.metric_module(m["name"]), "SPANS", {}))
        undo = open_spans(runner, spans)
        try:
            with profiled() as holder:
                first = runner.first_unit + len(records)
                sliced = [runner.unit(first + j) for j in range(cell["trace_units"])]
        finally:
            close_spans(undo)
        traced = holder.trace

    runner.free()
    numbers = runner.check()
    limits = cell["limits"]
    correct = decide(numbers, limits, failed)

    ctx = Run(setup_s=setup_s, units=records, elapsed_s=elapsed, sliced=sliced,
              trace=traced, config=config, cell=cell, workload=workload)
    metrics = {}
    for m in (per_layer if trace else bench.metrics(workload, "end_to_end")):
        value = bench.metric_module(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = banned_modules()
    if found:
        raise RunError(f"modules of JAX or of the JAX package are loaded: {found}")
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits.get(k)}
                        for k in sorted(set(numbers) | set(limits))}
    result["checks"]["failed"] = {"value": int(failed), "limit": 0}
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})", file=log, flush=True)
    return result
