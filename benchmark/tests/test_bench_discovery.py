"""A new configuration, cell, traffic kind and metric are new files alone: the harness
finds them by name, the contract's checks hold a new configuration to its own published
source, and the CPU copy cuts a new cell and configuration by their own files, with no
file of the benchmark changed."""

import json
import re

import pytest

from benchmark.harness import Bench
from benchmark.tests import contract
from benchmark.tests.tiny import REPO, copy_benchmark, cut_file, make_root, run_cpu

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


# A voice conditioned on BERT-large (bert-base-uncased's sibling: neither of the
# benchmark's LM widths), its encoder cut to 4 of its 24 layers, trained on a new kind of
# traffic: what a configuration PR would add.
VOICE, CELL = "cubegan-v1-bert-large", "large-train-b16"
BERT_LARGE = {"vocab_size": 30522, "hidden_size": 1024, "num_hidden_layers": 24,
              "num_attention_heads": 16, "intermediate_size": 4096,
              "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
              "hidden_act": "gelu", "pad_token_id": 0}
ONE_SPEAKER = '''"""GAN training traffic of a single-speaker corpus: every utterance is the first
speaker's."""
from benchmark.traffic.gan_train import Traffic as Base


class Traffic(Base):
    def utterance(self, r, frames):
        u = super().utterance(r, frames)
        u["meta"]["speaker"] = self.speakers()[0]
        return u
'''


def write_json(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def add_voice(src):
    """Add to the benchmark under `src` the voice, its cell, its traffic kind and the
    files that cut both for the CPU copy; only BENCHMARK.json among its files changes."""
    b = src / "benchmark"
    cfg = json.loads((b / "configs" / "cubegan-v1-bert-base.json").read_text())
    cfg.update(name=VOICE, source="https://huggingface.co/bert-large-uncased",
               reduced=["lm.num_hidden_layers"],
               deployment={"chips_per_layer": 1, "how": "the encoder's first 4 of its 24 "
                           "layers; the other 20 lie on further chips as pipeline stages"},
               lm=dict(BERT_LARGE, num_hidden_layers=4))
    cfg["published"]["lm"] = BERT_LARGE
    write_json(b / "configs" / f"{VOICE}.json", cfg)
    (b / "traffic" / "one_speaker.py").write_text(ONE_SPEAKER)
    cell = json.loads((b / "workloads" / "bert-train-b16.json").read_text())
    cell.update(config=VOICE, traffic="one-speaker-b16", kind="one_speaker")
    write_json(b / "workloads" / f"{CELL}.json", cell)
    write_json(cut_file(src, "cells", CELL),
               {"params": {"batch": 2, "pool": 3, "frames": [70, 90], "watch_within": 2,
                           "context_extra": 0, "tokens_per_word": [1, 2]},
                "trace_units": 1, "sound_run": True, "faults": ["half_batch"]})
    write_json(cut_file(src, "configs", VOICE),
               {"lm": {"vocab_size": 1500, "hidden_size": 48, "num_attention_heads": 3,
                       "intermediate_size": 96, "max_position_embeddings": 128}})
    m = json.loads((src / "BENCHMARK.json").read_text())
    m["configs"].append({"name": VOICE, "source": cfg["source"],
                         "file": f"benchmark/configs/{VOICE}.json", "reduced": cfg["reduced"],
                         "why": "a voice conditioned on BERT-large"})
    m["workloads"].append({"name": CELL, "config": VOICE, "traffic": "one-speaker-b16",
                           "chips": 1, "why": "a single-speaker trainer of the BERT-large voice"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric["name"] in ("train_step_ms", "lm_encoder_fwd_ms.train"):
            metric["workloads"].append(CELL)
    write_json(src / "BENCHMARK.json", m)
    return src


def files(root) -> dict:
    b = root / "benchmark"
    return {p.relative_to(b): p.read_bytes() for p in b.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_a_new_voice_is_new_files_alone(tmp_path):
    src = add_voice(copy_benchmark(REPO, tmp_path / "src"))
    before, after = files(REPO), files(src)
    assert all(after[p] == v for p, v in before.items()) and len(after) == len(before) + 5
    contract.check_all(Bench(src))
    r = run_cpu(make_root(tmp_path / "tiny", src), CELL)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "train_step_ms"}


def _width_off(cfg, m):
    cfg["lm"]["hidden_size"] = 1000


def _width_listed(cfg, m):
    cfg["lm"]["hidden_size"] = 1000
    cfg["reduced"].append("lm.hidden_size")
    m["reduced"].append("lm.hidden_size")


def _no_deployment(cfg, m):
    del cfg["deployment"]


def _listed_outside_published(cfg, m):
    cfg["reduced"] = m["reduced"] = ["lm.num_layers"]


def _manifest_differs(cfg, m):
    m["reduced"] = []


@pytest.mark.parametrize("breakage,says", [
    (_width_off, "lm.hidden_size is 1000, its source's 1024"),
    (_width_listed, "reduced lists the width lm.hidden_size"),
    (_no_deployment, "states its deployment"),
    (_listed_outside_published, "reduced lists lm.num_layers, which published lacks"),
    (_manifest_differs, "BENCHMARK.json's reduced is not the file's")],
    ids=["width_off", "width_listed", "no_deployment", "listed_outside_published",
         "manifest_differs"])
def test_a_configuration_off_its_source_fails(tmp_path, breakage, says):
    """The voice above, with one thing changed: a width that differs from `published`
    without `reduced` listing it, a width listed in `reduced`, a cut without its
    deployment, a listed path `published` lacks, BENCHMARK.json's `reduced` not the
    file's."""
    src = add_voice(copy_benchmark(REPO, tmp_path, "tests"))
    contract.check_configuration(Bench(src), VOICE)
    path = src / "benchmark" / "configs" / f"{VOICE}.json"
    cfg, m = json.loads(path.read_text()), json.loads((src / "BENCHMARK.json").read_text())
    breakage(cfg, next(c for c in m["configs"] if c["name"] == VOICE))
    write_json(path, cfg)
    write_json(src / "BENCHMARK.json", m)
    with pytest.raises(AssertionError, match=re.escape(says)):
        contract.check_configuration(Bench(src), VOICE)
