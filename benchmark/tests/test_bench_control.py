"""On a card, at each cell's own size: the control (one precision below the
configuration's, as the cell file names it: the program's own lower-precision path, or
the reference put in the program's place) fails the cell's committed limits on three
seeds. The readings the limits were set from are in PERF.md; `benchmark/calibrate.py`
reads them."""

import pytest

from benchmark.calibrate import control_numbers
from benchmark.harness import Bench, decide, window
from benchmark.tests.tiny import REPO

BENCH = Bench(REPO)


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH.manifest["workloads"]])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_control_fails_the_limits(cuda, cell_name, seed):
    cell = BENCH.cell(cell_name)
    config = BENCH.config(BENCH.entry(cell_name)["config"])
    traffic = BENCH.traffic(cell["kind"]).Traffic(cell["params"], config, seed)
    runner = BENCH.runner(cell["runner"]).Runner(cell, config, traffic, seed, cuda)
    runner.setup()
    window(runner, 3.0, runner.first_unit)
    runner.free()
    assert decide(runner.check(), cell["limits"], 0)
    assert not decide(control_numbers(BENCH, cell_name, runner, seed, cuda, 3.0),
                      cell["limits"], 0)
