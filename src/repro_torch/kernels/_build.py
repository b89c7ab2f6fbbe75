"""Build the port's CUDA kernel with ``nvcc`` and load it with ctypes.

The kernel source ``tiara_gather/csrc/tiara_gather.cu`` has a plain C
interface, so it compiles in seconds without PyTorch's headers.  The
shared library lands in ``build/torch_ext/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one is reused.  Nothing is
compiled at import: the CPU tests import every module, and a machine
with no CUDA toolkit must still import the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parents[2]
BUILD_DIR = _REPO / "build" / "torch_ext"
SOURCE = _PKG / "tiara_gather" / "csrc" / "tiara_gather.cu"

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIB: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand:
            p = Path(cand) / "bin" / "nvcc"
            if p.exists():
                return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, PATH): "
            "the CUDA kernel builds only on a machine with the CUDA toolkit")
    return found


def lib_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtiara_gather_{tag}.so"


def build() -> Path:
    """Compile the kernel unless it is built already; returns the shared
    library's path.  Raises :class:`KernelBuildError` with the compiler's
    output when the build fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc exited {proc.returncode}\n"
                               f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded shared library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB
