"""The last line's shape, and runs that must give no result: no card, or a checkout that
holds only BENCHMARK.json and the benchmark's folder."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests.tiny import REPO, run_cpu

ARGS = ["--workload", "v1-synth-b128", "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_result_keys_in_order(tiny_root):
    r = run_cpu(tiny_root, "v1-synth-b128")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "synth_audio_s_per_s", "synth_batch_p90_ms"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    json.dumps(r)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a machine with a card runs the cell")
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""

