"""BENCHMARK.json and the files it names, held to the benchmark's contract: functions over
a `Bench` root, so that the repository's benchmark and a copy with new files added are
checked alike. Each raises AssertionError at what fails (FileNotFoundError where a
cell or configuration lacks the file that cuts it for the CPU copy).

A configuration file is held to its own source: its `published` block gives the widths
as the source states them, under the file's own keys, and every value there must be the
file's, unless `reduced` lists its path (dotted, `lm.num_hidden_layers`) or a group
above it. `reduced` never names a width, and a width inside a listed group is still held;
a file that lists anything states `deployment`: how many chips share a layer and how."""

from __future__ import annotations

import json
import math
import re

from benchmark.faults import FAULTS
from benchmark.harness import Bench
from benchmark.tests.tiny import read_cut

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the last key of a path that states a width: a hidden, intermediate, latent, state or
# projection size (a vocabulary may be sliced), a head's size, channels, experts per token
WIDTH = re.compile(r"(?<!vocab)_size$|_dim$|_rank$|channels?$|width$|^num_mels$"
                   r"|^num_experts_per_tok$")


def leaves(tree: dict, prefix: str = "") -> dict:
    """{dotted path: value} of every value under `tree` that is not a group."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def has(tree: dict, path: str) -> bool:
    for part in path.split("."):
        if not isinstance(tree, dict) or part not in tree:
            return False
        tree = tree[part]
    return True


def at(tree: dict, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def check_manifest(bench: Bench) -> None:
    m = bench.manifest
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60, 2 × 90
    # seconds of compiling a cell, 1,200 spare
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(m)) <= 64 * 1024


def check_names(bench: Bench) -> None:
    m = bench.manifest
    kinds = ("configs", "workloads", "end_to_end", "per_layer")
    assert all(NAME.match(x["name"]) for k in kinds for x in m[k])
    for kind in kinds:
        got = [x["name"] for x in m[kind]]
        assert len(got) == len(set(got)), kind
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (bench.root / c["file"]).is_file()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert next(x for x in m["end_to_end"] if x["name"] == "setup_s")["bound"] == 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def check_cell_reports(bench: Bench, cell: str) -> None:
    e2e = [x["name"] for x in bench.metrics(cell, "end_to_end")]
    layer = bench.metrics(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for x in layer:
        assert x["moves"] in e2e, (cell, x["name"])


def check_cell_parts(bench: Bench, cell: str) -> None:
    c = bench.cell(cell)
    for part, sub in (("kind", "traffic"), ("runner", "runners")):
        assert (bench.dir / sub / f"{c[part]}.py").is_file()
    assert c["limits"] and all(v >= 0 and math.isfinite(v) for v in c["limits"].values())
    assert c["trace_units"] >= 1 and c["control"]
    cut = read_cut(bench.root, "cells", cell)
    assert set(cut) == {"params", "trace_units", "sound_run", "faults"}
    assert set(cut["params"]) <= set(c["params"]), "the cut sets a parameter the cell lacks"
    assert cut["trace_units"] >= 1 and set(cut["faults"]) <= set(FAULTS)


def check_metric_reader(bench: Bench, metric: dict) -> None:
    mod = bench.metric_module(metric["name"])
    assert callable(mod.read)
    assert mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    for paths in getattr(mod, "SPANS", {}).values():
        assert all(p.split(".")[0] in ("model", "state") for p in
                   ([paths] if isinstance(paths, str) else paths))


def check_configuration(bench: Bench, name: str) -> None:
    c = bench.config(name)
    entry = next(x for x in bench.manifest["configs"] if x["name"] == name)
    assert c["name"] == name
    reduced, published = c["reduced"], c["published"]
    assert entry["reduced"] == reduced, f"{name}: BENCHMARK.json's reduced is not the file's"
    assert len(reduced) <= 16 and all(NAME.match(p) for p in reduced)
    assert isinstance(published, dict) and published
    for path in reduced:
        assert has(published, path), f"{name}: reduced lists {path}, which published lacks"
        assert not WIDTH.search(path.split(".")[-1]), f"{name}: reduced lists the width {path}"
    if reduced:
        d = c.get("deployment")
        assert isinstance(d, dict) and set(d) == {"chips_per_layer", "how"}, \
            f"{name}: reduced lists paths, so the file states its deployment"
        assert isinstance(d["chips_per_layer"], int) and d["chips_per_layer"] >= 1 and d["how"]
    for path, want in leaves(published).items():
        listed = any(path == r or path.startswith(r + ".") for r in reduced)
        if listed and not WIDTH.search(path.split(".")[-1]):
            continue
        assert has(c, path), f"{name}: the file lacks {path}, which its source gives"
        assert at(c, path) == want, f"{name}: {path} is {at(c, path)!r}, its source's {want!r}"
    assert math.prod(c["hifigan"]["upsample_rates"]) == c["hop_size"]
    assert (c["languasito"]["cond_type"] == "hf") == ("lm" in c)
    cut = read_cut(bench.root, "configs", name)
    assert all(k in c and (not isinstance(v, dict) or set(v) <= set(c[k]))
               for k, v in cut.items()), "the cut sets a key the configuration lacks"


def check_all(bench: Bench) -> None:
    """Every check, over every cell, configuration and metric that `bench` names."""
    check_manifest(bench)
    check_names(bench)
    for w in bench.manifest["workloads"]:
        check_cell_reports(bench, w["name"])
        check_cell_parts(bench, w["name"])
    for metric in bench.manifest["end_to_end"] + bench.manifest["per_layer"]:
        check_metric_reader(bench, metric)
    for c in bench.manifest["configs"]:
        check_configuration(bench, c["name"])
