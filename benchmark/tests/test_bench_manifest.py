"""BENCHMARK.json against the benchmark's contract, and every file it names found by
name: configurations, cells, traffic kinds, runners and metric readers."""

import json
import math
import re

import pytest

from benchmark.harness import Bench
from benchmark.tests.tiny import REPO

BENCH = Bench(REPO)
M = BENCH.manifest
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = [w["name"] for w in M["workloads"]]


def test_manifest_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60, 2 × 90
    # seconds of compiling a cell, 1,200 spare
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in M[kind]]
        assert len(got) == len(set(got)), kind
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in BENCH.metrics(cell, "end_to_end")]
    layer = BENCH.metrics(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_names_its_parts(cell):
    c = BENCH.cell(cell)
    for part, sub in (("kind", "traffic"), ("runner", "runners")):
        assert (REPO / "benchmark" / sub / f"{c[part]}.py").is_file()
    assert c["limits"] and all(v >= 0 and math.isfinite(v) for v in c["limits"].values())
    assert c["trace_units"] >= 1 and c["control"]


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_agree_with_the_manifest(metric):
    mod = BENCH.metric_module(metric["name"])
    assert callable(mod.read)
    assert mod.SOURCE == metric["source"]
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    for paths in getattr(mod, "SPANS", {}).values():
        assert all(p.split(".")[0] in ("model", "state") for p in
                   ([paths] if isinstance(paths, str) else paths))


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_configuration_files(name):
    c = BENCH.config(name)
    assert c["name"] == name and c["reduced"] == []
    entry = next(x for x in M["configs"] if x["name"] == name)
    assert entry["reduced"] == c["reduced"]
    h = c["hifigan"]
    assert math.prod(h["upsample_rates"]) == c["hop_size"] == 240
    assert h["upsample_initial_channel"] == 512 and h["resblock_kernel_sizes"] == [3, 7, 11]
    if c["languasito"]["cond_type"] == "hf":
        lm = c["lm"]
        assert (lm["hidden_size"], lm["num_hidden_layers"], lm["num_attention_heads"],
                lm["intermediate_size"], lm["vocab_size"]) == (768, 12, 12, 3072, 30522)
