"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `.cu` file under this directory exposes a plain C interface and is
compiled on first use into `_build/` (listed in .gitignore) as a shared
library named after a hash of its source and flags, so an edited source is
never served from a stale build. Compiling a plain C file takes seconds;
PyTorch's extension builder would compile PyTorch's headers for minutes and
needs ninja. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # source name -> nvcc output (ptxas usage)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from `source` (a file name in this
    directory), compiling it first if no build of this exact source
    exists."""
    if source in _loaded:
        return _loaded[source]
    src_path = os.path.join(KERNEL_DIR, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build to a temporary name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                                  capture_output=True, text=True)
            build_logs[source] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{build_logs[source]}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    _loaded[source] = ctypes.CDLL(lib_path)
    return _loaded[source]
