"""The port runs on a machine that has PyTorch and numpy but no JAX, flax, optax, yaml
or msgpack. Every module of `ttscube_tpu_torch/`, `chip_smoke.py` and `chip_variants.py`
is parsed here: none may import JAX, flax, optax, yaml, msgpack or the JAX package
`ttscube_tpu` anywhere (the port reads and writes its checkpoint files with its own
`utils/serialization.py` and `utils/config_io.py`)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "ttscube_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "chip_variants.py"]
NEVER = {"jax", "jaxlib", "flax", "optax", "ttscube_tpu"}
NOT_AT_MODULE_LEVEL = {"yaml", "msgpack"}


def _imports(tree):
    """(top-level package, at module level?) for every import in the tree."""
    top_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top_level


def test_the_port_has_modules_to_check():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_module_level_yaml_or_msgpack(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for package, module_level in _imports(tree):
        assert package not in NEVER, f"{path.name} imports {package}"
        assert not (module_level and package in NOT_AT_MODULE_LEVEL), \
            f"{path.name} imports {package} at module level"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_yaml_or_msgpack_anywhere(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for package, _ in _imports(tree):
        assert package not in NOT_AT_MODULE_LEVEL, f"{path.name} imports {package}"


def test_the_trainer_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"ttscube_tpu_torch/utils/serialization.py", "ttscube_tpu_torch/utils/config_io.py",
            "ttscube_tpu_torch/utils/checkpoint.py", "ttscube_tpu_torch/train/loop.py",
            "ttscube_tpu_torch/scripts/train_cubegan.py", "ttscube_tpu_torch/ops/narrow_conv.py",
            "ttscube_tpu_torch/ops/fused_resblock.py"} <= names


def test_the_guard_catches_what_it_guards():
    bad = ast.parse("import yaml\nfrom ttscube_tpu.dsp import mel\n"
                    "def f():\n    import msgpack\n    import jax.numpy as jnp\n")
    found = list(_imports(bad))
    assert ("yaml", True) in found and ("ttscube_tpu", True) in found
    assert ("msgpack", False) in found and ("jax", False) in found
