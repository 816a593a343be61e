"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface (it
may include the shared headers ``csrc/*.cuh``). It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
(git-ignored) at first use, named by the hash of the source and of the
headers so that an edited source or header rebuilds, and loaded with
``ctypes``. The
compiler's report (registers, shared memory, spills) is kept beside the
library as ``.log``. :func:`build` starts one ``nvcc`` per missing
library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = ("fused_gram_cholesky", "blocked_cholesky")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and headers (it may not be built yet)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile the libraries of ``names`` that are missing, one ``nvcc``
    process per source, all started together; returns each library's
    path. Raises with the compiler's errors if any build fails."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running.append((proc, src, tmp, lib))
    errors = []
    for proc, src, tmp, lib in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{err}")
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel ``name``, built if missing, with
    ``argtypes`` set and an ``int`` (CUDA error code) result."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    fn = getattr(_LOADED[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
