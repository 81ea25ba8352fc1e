"""Build and load the port's CUDA kernels: plain `nvcc` into a shared library with a C
interface, loaded with `ctypes`.

Each source `ttscube_tpu_torch/csrc/<name>.cu` becomes `lib<name>.so` in
`ttscube_tpu_torch/_build/<name>-<hash>/`, where the hash covers the source, every file
of `csrc/` it includes with `#include "…"` (such as the shared `mma_sm90.cuh`), and the
compiler flags, so a source whose text or headers changed is rebuilt and an unchanged
one is not. The build
runs at first use, and `nvcc`'s output (ptxas register and spill counts) is kept in
`nvcc.log` beside the library. A build is the span `tts.build.<name>` and adds to the
counters `kernels.built` and `kernels.build_s` (`utils/profiling`). Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ttscube_tpu_torch.utils.profiling import count, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """`<name>.cu` and every file of `csrc/` it includes with `#include "…"`, directly or
    through another such file, in the order they are first met."""
    found, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f not in found and (CSRC / f).is_file():
            found.append(f)
            todo += [m.decode() for m in _INCLUDE.findall((CSRC / f).read_bytes())]
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sources(name):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def _build(names: list) -> None:
    """One nvcc for each source, all started together, then waited for."""
    jobs = []
    for name in names:
        target = _target(name)
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        log = target.parent / "nvcc.log"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            jobs.append((name, target, tmp, log,
                         subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    failed = []
    for name, target, tmp, log, proc in jobs:
        if proc.wait() != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{log.read_text()}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent loader sees no half-written library
    if failed:
        raise RuntimeError("\n".join(failed))


def nvcc_log(name: str) -> str:
    """What `nvcc` printed when it built `csrc/<name>.cu` (empty before the build)."""
    log = _target(name).parent / "nvcc.log"
    return log.read_text() if log.exists() else ""


def load_all(names) -> list:
    """The loaded libraries for `csrc/<name>.cu` of each name, those not built yet
    built first, in parallel."""
    with _lock:
        missing = [n for n in names if n not in _libs and not _target(n).exists()]
        if missing:
            t0 = time.perf_counter()
            with span("tts.build." + "+".join(missing)):
                _build(missing)
            count("kernels.built", len(missing))
            count("kernels.build_s", time.perf_counter() - t0)
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(_target(n)))
        return [_libs[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    return load_all([name])[0]


def load_host(source: Path, flags: tuple) -> ctypes.CDLL:
    """A C++ source outside `csrc/` (such as the repo's `native/pitch.cpp`) built with
    `g++ <flags> -shared` into `_build/<stem>-<hash>/lib<stem>.so`, the hash over the
    source and the flags, at first use, and loaded. A failed build raises."""
    h = hashlib.sha256(source.read_bytes() + b"\0" + " ".join(flags).encode())
    target = BUILD_ROOT / f"{source.stem}-{h.hexdigest()[:16]}" / f"lib{source.stem}.so"
    key = str(target)
    with _lock:
        if key not in _libs:
            if not target.exists():
                target.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
                os.close(fd)
                r = subprocess.run(["g++", *flags, "-shared", "-o", tmp, str(source)],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"g++ failed for {source}:\n{r.stdout}{r.stderr}")
                os.replace(tmp, target)  # atomic, as for the kernels
            _libs[key] = ctypes.CDLL(key)
        return _libs[key]


_bound: set = set()  # (source, function) pairs already typed and checked


def bind(source: str, fn: str, argtypes: list, limits: dict):
    """The library built from `csrc/<source>.cu`, its function `fn` typed, and the
    tiling limits it reports (`<fn>_limits`) checked against the wrapper's `limits`
    (the first time only)."""
    lib = load(source)
    if (source, fn) not in _bound:
        p = ctypes.c_void_p
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn + "_limits").argtypes = [p]
        getattr(lib, fn + "_limits").restype = ctypes.c_int
        vals = (ctypes.c_int * len(limits))()
        getattr(lib, fn + "_limits")(ctypes.cast(vals, p))
        if dict(zip(limits, vals)) != limits:
            raise RuntimeError(f"{source}: the library's limits {list(vals)} for {fn} differ "
                               f"from the wrapper's {limits}")
        _bound.add((source, fn))
    return lib
