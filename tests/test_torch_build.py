"""The port's kernel build (`ttscube_tpu_torch/ops/_build.py`): which files a library's
path follows. Nothing is compiled here (no nvcc): the tests read and edit a copy of
`csrc/` and compare the paths `_build` would build to."""

import shutil

import pytest

from ttscube_tpu_torch.ops import _build

HEADER = "mma_sm90.cuh"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that `_build` reads in place of the package's."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def _edit(path, text=b"\n// edited\n"):
    path.write_bytes(path.read_bytes() + text)


@pytest.mark.parametrize("name", ["fused_tail_stage", "fused_mrf_stage"])
def test_library_path_follows_the_shared_header(csrc, name):
    """B1's and B3's sources include the shared header: an edit to it alone moves the
    library to a new path (a rebuild), and undoing the edit moves it back."""
    assert _build.sources(name) == [f"{name}.cu", HEADER]
    before = _build._target(name)
    original = (csrc / HEADER).read_bytes()
    _edit(csrc / HEADER)
    after = _build._target(name)
    assert after != before and after.name == before.name == f"lib{name}.so"
    (csrc / HEADER).write_bytes(original)
    assert _build._target(name) == before


@pytest.mark.parametrize("name", ["fused_tail_stage_grad", "narrow_conv"])
def test_sources_without_the_header_ignore_it(csrc, name):
    """B2's and B5's sources include no file of csrc/: the header does not move their
    libraries, their own text does."""
    assert _build.sources(name) == [f"{name}.cu"]
    before = _build._target(name)
    _edit(csrc / HEADER)
    assert _build._target(name) == before
    _edit(csrc / f"{name}.cu")
    assert _build._target(name) != before


def test_includes_are_followed_through_headers(csrc):
    """A header included by a header counts; system headers and names that are no file
    of csrc/ do not."""
    (csrc / "probe.cu").write_text('#include <cuda_runtime.h>\n  #  include "a.cuh"\n'
                                   '#include "missing.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    assert _build.sources("probe") == ["probe.cu", "a.cuh"] + ["b.cuh"]
    before = _build._target("probe")
    _edit(csrc / "b.cuh")
    assert _build._target("probe") != before


def test_library_path_follows_the_flags(csrc, monkeypatch):
    before = _build._target("fused_tail_stage")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target("fused_tail_stage") != before
