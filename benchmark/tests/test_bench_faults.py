"""A whole run on the CPU (its look for a card skipped) at a small size, each cell's
committed limits: sound, it is correct; with its timed path broken underneath by one of
the faults its cell can have (`benchmark/faults.py`), it is not. The cases are read from
each cell's file under `benchmark/tests/tiny/cells/`: its `sound_run` and its `faults`."""

import pytest

from benchmark.faults import FAULTS
from benchmark.harness import Bench
from benchmark.tests.tiny import REPO, read_cut, run_cpu


def cases() -> list:
    out = []
    for w in Bench(REPO).manifest["workloads"]:
        cut = read_cut(REPO, "cells", w["name"])
        out += [(w["name"], f) for f in [None] * cut["sound_run"] + cut["faults"]]
    return out


@pytest.mark.parametrize("cell,fault", cases())
def test_fault_fails_the_check(tiny_root, cell, fault):
    if fault is None:
        assert run_cpu(tiny_root, cell)["correct"]
        return
    with FAULTS[fault]():
        r = run_cpu(tiny_root, cell)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())
