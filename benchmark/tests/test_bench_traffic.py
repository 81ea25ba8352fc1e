"""Each traffic kind repeats exactly from its seed and differs across seeds; seeds wider
than 32 bits work; training traffic gives every seed the same utterance lengths."""

import numpy as np
import pytest

from benchmark.harness import Bench
from benchmark.tests.tiny import REPO

BENCH = Bench(REPO)
CELLS = [w["name"] for w in BENCH.manifest["workloads"]]
SEEDS = (7, 2**31 + 5, 2**40 + 3)


def draw(cell_name: str, seed: int):
    e = BENCH.entry(cell_name)
    cell = BENCH.cell(cell_name)
    tr = BENCH.traffic(cell["kind"]).Traffic(cell["params"], BENCH.config(e["config"]), seed)
    if cell["kind"] == "synth_batch":
        return tr, [tr.batch(i) for i in range(3)] + tr.warmup()
    return tr, [tr.batch(0)] + [tr.starts(k, tr.lengths[k % len(tr.lengths)]) for k in range(3)]


def flat(x):
    """Every array and number in x, in order."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in flat(item)]
    return [np.asarray(x)]


def same(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(x.shape == y.shape and np.array_equal(x, y)
                                      for x, y in zip(fa, fb))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(cell, seed):
    assert same(draw(cell, seed)[1], draw(cell, seed)[1])


@pytest.mark.parametrize("cell", CELLS)
def test_seeds_differ(cell):
    assert not same(draw(cell, SEEDS[0])[1], draw(cell, SEEDS[1])[1])


@pytest.mark.parametrize("cell", [c for c in CELLS if BENCH.cell(c)["kind"] == "gan_train"])
def test_training_lengths_are_the_same_set_for_every_seed(cell):
    sets = [sorted(np.concatenate(draw(cell, s)[0].lengths)) for s in SEEDS]
    assert sets[0] == sets[1] == sets[2]
    p = BENCH.cell(cell)["params"]
    assert min(sets[0]) == p["frames"][0] and max(sets[0]) == p["frames"][1]


@pytest.mark.parametrize("cell", [c for c in CELLS if BENCH.cell(c)["kind"] == "synth_batch"])
def test_synthesis_batches_keep_to_their_parameters(cell):
    tr, batches = draw(cell, SEEDS[1])
    p = BENCH.cell(cell)["params"]
    for b in batches:
        n = (b["x_char"] != 0).sum(1)
        assert b["x_char"].shape[0] == p["batch"] and b["x_char"].shape[1] % p["pad_phones"] == 0
        assert n.min() >= 1 and n.max() <= p["phones"][1]
        assert b["x_speaker"].min() >= 1
    assert tr.keep(0) and len(tr.rows(0)) == p["check_rows"]
