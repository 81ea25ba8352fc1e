"""A whole run on the CPU (its look for a card skipped) at a small size, each cell's
committed limits: sound, it is correct; with its timed path broken underneath by one of
the faults its cell can have (`benchmark/faults.py`), it is not."""

import pytest

from benchmark.faults import FAULTS
from benchmark.tests.tiny import run_cpu

CASES = [("v1-synth-b128", None), ("v1-synth-b128", "altered_token"),
         ("v1-synth-long", "altered_token"),
         ("bert-train-b16", None), ("bert-train-b16", "half_batch"),
         ("bert-train-b16", "frozen_step")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(tiny_root, cell, fault):
    if fault is None:
        assert run_cpu(tiny_root, cell)["correct"]
        return
    with FAULTS[fault]():
        r = run_cpu(tiny_root, cell)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())
