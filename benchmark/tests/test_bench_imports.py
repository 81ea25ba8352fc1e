"""Nothing a run imports has `jax`, `jaxlib`, `flax` or the JAX package `ttscube_tpu` as
its top-level name (names compared whole: the port `ttscube_tpu_torch` begins with
`ttscube_tpu`), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import BANNED, banned_modules
from benchmark.tests.tiny import REPO

SOURCES = sorted(p for p in (REPO / "benchmark").rglob("*.py") if "tests" not in p.parts)


def top_names(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_names(path) & set(BANNED)


@pytest.mark.parametrize("path", sorted((REPO / "benchmark" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_names(path) <= {"__future__", "contextlib", "math", "statistics", "numpy", "torch",
                               "benchmark"}
    assert not any(n.startswith("ttscube") for n in top_names(path))


def test_whole_names_are_compared(monkeypatch):
    before = banned_modules()
    monkeypatch.setitem(sys.modules, "ttscube_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary.sub", sys)
    assert banned_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.sub", sys)
    assert "jaxlib" in banned_modules()


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_module_of_jax():
    """A whole (small, CPU) run of a synthesis cell and of a training cell, every
    metric reader loaded."""
    code = ("import tempfile, pathlib\n"
            "from benchmark.tests.tiny import make_root, run_cpu\n"
            "from benchmark.harness import Bench\n"
            "root = make_root(pathlib.Path(tempfile.mkdtemp()))\n"
            "b = Bench(root)\n"
            "[b.metric_module(m['name']) for k in ('end_to_end', 'per_layer') "
            "for m in b.manifest[k]]\n"
            "assert run_cpu(root, 'v1-synth-b128', seconds=0.1)['correct']\n")
    mods = _modules_after(code)
    assert "ttscube_tpu_torch" in mods and "torch" in mods
    assert not mods & set(BANNED)


def test_the_reference_alone_loads_nothing_of_the_program():
    mods = _modules_after("import benchmark.reference.cubegan, benchmark.reference.synthesis, "
                          "benchmark.reference.training, benchmark.reference.collate")
    assert not any(m.startswith("ttscube") for m in mods)
