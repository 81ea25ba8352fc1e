"""BENCHMARK.json against the benchmark's contract, and every file it names found by
name: configurations (each held to its own published source), cells, traffic kinds,
runners, metric readers, and the files that cut each cell and configuration for the CPU
copy. The checks are `benchmark/tests/contract.py`'s, here on the repository."""

import pytest

from benchmark.harness import Bench
from benchmark.tests import contract
from benchmark.tests.tiny import REPO

BENCH = Bench(REPO)
M = BENCH.manifest
CELLS = [w["name"] for w in M["workloads"]]


def test_manifest_keys_and_limits():
    contract.check_manifest(BENCH)


def test_names_units_and_keys():
    contract.check_names(BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    contract.check_cell_reports(BENCH, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_names_its_parts(cell):
    contract.check_cell_parts(BENCH, cell)


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_agree_with_the_manifest(metric):
    contract.check_metric_reader(BENCH, metric)


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_configuration_files(name):
    contract.check_configuration(BENCH, name)
