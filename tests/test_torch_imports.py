"""The port runs on a machine that has PyTorch and numpy but no JAX, flax, optax, yaml,
msgpack, transformers, tokenizers, safetensors, PIL or tqdm. Every module of
`ttscube_tpu_torch/` (its mesh in `parallel/`, `entry.py` and the scripts included),
`chip_smoke.py`, `chip_variants.py` and `chip_probes.py` is parsed here: none may import
JAX, flax, optax, yaml, msgpack, transformers, tokenizers, safetensors, PIL, tqdm or the
JAX package `ttscube_tpu` anywhere (the port reads and writes its checkpoint files with
its own `utils/serialization.py` and `utils/config_io.py`, its PNGs with zlib, and an
HF directory's tokenizer.json and weights with `utils/hf.py` and `models/lm.py`)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "ttscube_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_variants.py", ROOT / "chip_probes.py"]
NEVER = {"jax", "jaxlib", "flax", "optax", "ttscube_tpu", "PIL", "tqdm", "transformers",
         "tokenizers", "safetensors"}
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


def test_the_mesh_and_the_corpus_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"ttscube_tpu_torch/parallel/mesh.py", "ttscube_tpu_torch/entry.py",
            "ttscube_tpu_torch/data/importers.py", "ttscube_tpu_torch/data/textgrid.py",
            "ttscube_tpu_torch/dsp/pitch.py", "ttscube_tpu_torch/utils/repository.py",
            "ttscube_tpu_torch/train/runtime.py"} <= names
    assert {f"ttscube_tpu_torch/scripts/{n}.py" for n in (
        "make_demo_corpus", "import_blizzard_2023", "import_phonemizer_blizzard",
        "import_textgrid", "import_corpus", "export_model")} <= names


def test_the_guard_catches_what_it_guards():
    bad = ast.parse("import yaml\nfrom ttscube_tpu.dsp import mel\n"
                    "def f():\n    import msgpack\n    import jax.numpy as jnp\n"
                    "    from PIL import Image\n    import tqdm\n"
                    "    from transformers import AutoTokenizer\n    import tokenizers\n"
                    "    from safetensors.numpy import load_file\n")
    found = list(_imports(bad))
    assert ("yaml", True) in found and ("ttscube_tpu", True) in found
    assert ("msgpack", False) in found and ("jax", False) in found
    assert ("PIL", False) in found and ("tqdm", False) in found
    assert {("transformers", False), ("tokenizers", False), ("safetensors", False)} <= set(found)


PHONEMIZER_MODULES = ("models.blocks", "models.g2p", "models.phonemizer", "train.states",
                      "scripts.train_phonemizer", "scripts.g2p", "scripts.import_corpus")
LM_MODULES = ("utils.hf", "utils.hfcond", "utils.wordvec", "models.lm", "models.cubegan",
              "api", "scripts.train_cubegan", "scripts.export_model", "scripts.make_demo_lm")
LEGACY_MODULES = ("ops.rnn", "ops.linear", "dsp.mulaw", "models.heads", "models.blocks",
                  "models.textcoder", "models.wavernn", "data.encodings", "data.collate",
                  "data.augment", "data.datasets", "data.legacy", "train.states",
                  "train.runtime", "convert", "utils.checkpoint", "scripts.train_textcoder",
                  "scripts.train_vocoder")


def test_the_phonemizer_family_is_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"ttscube_tpu_torch/{m.replace('.', '/')}.py" for m in PHONEMIZER_MODULES} <= names


def test_the_lm_conditioning_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"ttscube_tpu_torch/{m.replace('.', '/')}.py" for m in LM_MODULES} <= names


def test_the_legacy_generation_is_checked():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {f"ttscube_tpu_torch/{m.replace('.', '/')}.py" for m in LEGACY_MODULES} <= names


@pytest.mark.parametrize("module", PHONEMIZER_MODULES + LM_MODULES + LEGACY_MODULES)
def test_imports_with_the_missing_packages_blocked(module):
    """Each module of the phonemizer family, of LM conditioning and of the legacy
    generation (Textcoder, the WaveRNN vocoder, their data and trainers) imports in a fresh
    interpreter where jax, flax, optax, yaml, msgpack, transformers, tokenizers,
    safetensors and ttscube_tpu cannot be imported (None in sys.modules makes an import
    raise)."""
    blocked = ["jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "transformers",
               "tokenizers", "safetensors", "ttscube_tpu"]
    code = ("import sys\n" + "".join(f"sys.modules[{b!r}] = None\n" for b in blocked)
            + f"import ttscube_tpu_torch.{module}\n"
            + "assert not any(m.split('.')[0] in %r for m in sys.modules if sys.modules[m])\n"
            % (blocked,))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
