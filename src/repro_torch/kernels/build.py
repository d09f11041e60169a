"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes`.  The
build happens at first use (nothing is compiled when a module is imported),
from the sources in ``csrc/`` and nothing else, into ``_build/`` beside this
file.  A library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded.  A failed build
raises; nothing here falls back to another implementation.  The first build
of a run should go through :func:`compile_all`, which starts one ``nvcc`` per
source at once instead of one after another.  A source may include headers
of ``csrc/`` (``#include "name.cuh"``); their bytes enter the hash of every
library that includes them, so an edited header rebuilds its libraries too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_HERE = pathlib.Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the usual
    install prefix.  Raises when there is none."""
    candidates: List[Optional[str]] = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(name: str) -> List[pathlib.Path]:
    """The headers of ``csrc/`` that ``csrc/<name>.cu`` includes, directly
    or through another such header, sorted."""
    seen: Dict[str, pathlib.Path] = {}
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        for inc in _LOCAL_INCLUDE.findall(todo.pop().read_bytes()):
            path = CSRC_DIR / inc.decode()
            if path.name not in seen:
                if not path.is_file():
                    raise FileNotFoundError(f"{name}.cu includes {path}, "
                                            "which is not in csrc/")
                seen[path.name] = path
                todo.append(path)
    return [seen[k] for k in sorted(seen)]


def library_path(name: str) -> pathlib.Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha1(src.read_bytes())
    for header in local_headers(name):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def sources() -> List[str]:
    """Names of every kernel source, ``csrc/<name>.cu``, sorted."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _start(name: str) -> Tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path,
            out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)             # atomic: readers never see a partial file
    return log


def compile_library(name: str) -> str:
    """Run ``nvcc`` on ``csrc/<name>.cu``; returns the compiler's output
    (``ptxas`` reports each kernel's registers and spills there)."""
    return _finish(name, *_start(name))


def compile_all() -> Dict[str, str]:
    """Compile every source at once, one ``nvcc`` process each, all started
    before any is waited for; returns each source's compiler output.  Raises
    (after every process has ended) if any build failed."""
    started = {n: _start(n) for n in sources()}
    logs: Dict[str, str] = {}
    errors: List[str] = []
    for n, job in started.items():
        try:
            logs[n] = _finish(n, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def require_cuda(*tensors) -> None:
    """The launch precondition every kernel wrapper checks: all arguments
    on one CUDA device (raises otherwise; nothing falls back)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"arguments on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type != "cuda":
        raise RuntimeError(f"tensors on {dev}: the kernel runs on CUDA "
                           "tensors only")


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if need be."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            if not library_path(name).exists():
                compile_library(name)
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
