"""A new configuration, cell, traffic kind and metric are new files alone: the harness
finds them by name, with no file of it changed."""

import json

from benchmark.tests.tiny import run_cpu

KIND = '''"""Synthesis traffic whose items all have the longest phone count."""
from benchmark.traffic.synth_batch import Traffic as Base


class Traffic(Base):
    def batch(self, i):
        b = super().batch(i)
        b["x_char"][b["x_char"] == 0] = 1
        return b
'''

METRIC = '''"""Batches per second of the window."""
LAYER, SOURCE, MOVES = None, "host_clock", None


def read(run):
    return len(run.units) / run.elapsed_s
'''


def test_new_files_are_picked_up(tiny_root):
    b = tiny_root / "benchmark"
    (b / "traffic" / "full_synth.py").write_text(KIND)
    (b / "metrics" / "batches_per_s.py").write_text(METRIC)
    cfg = json.loads((b / "configs" / "cubegan-v1.json").read_text())
    cfg["name"] = "cubegan-v1-copy"
    (b / "configs" / "cubegan-v1-copy.json").write_text(json.dumps(cfg))
    cell = json.loads((b / "workloads" / "v1-synth-b128.json").read_text())
    cell.update(config="cubegan-v1-copy", traffic="full-b3", kind="full_synth")
    (b / "workloads" / "dummy-synth.json").write_text(json.dumps(cell))
    manifest_path = tiny_root / "BENCHMARK.json"
    saved = manifest_path.read_text()
    m = json.loads(saved)
    m["configs"].append({"name": "cubegan-v1-copy", "source": "https://example.org",
                         "file": "benchmark/configs/cubegan-v1-copy.json", "reduced": [],
                         "why": "a copy"})
    m["workloads"].append({"name": "dummy-synth", "config": "cubegan-v1-copy",
                           "traffic": "full-b3", "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["dummy-synth"]})
    manifest_path.write_text(json.dumps(m))
    try:
        r = run_cpu(tiny_root, "dummy-synth")
    finally:
        manifest_path.write_text(saved)
    assert r["correct"] and r["metrics"]["batches_per_s"]["value"] > 0
    assert set(r["metrics"]) == {"setup_s", "batches_per_s"}
