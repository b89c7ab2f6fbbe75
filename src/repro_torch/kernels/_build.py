"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every kernel source ``kernels/*/csrc/*.cu`` has a plain C interface, so
it compiles in seconds without PyTorch's headers.  The sources compile in
parallel, one ``nvcc -c`` each, all started together, and one more
``nvcc`` links the objects into ONE shared library.  The library lands in
``build/torch_ext/`` at the repository root (listed in ``.gitignore``),
named by a hash of every source, every header the sources share
(``kernels/*/csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged tree is reused.  Nothing is compiled at import:
the CPU tests import every module, and a machine with no CUDA toolkit
must still import the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent
_REPO = _PKG.parents[2]
BUILD_DIR = _REPO / "build" / "torch_ext"

ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
COMPILE_FLAGS = [ARCH_FLAG, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-lineinfo", "-Xptxas=-v"]
LINK_FLAGS = [ARCH_FLAG, "-shared"]

_LIB: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    pass


def sources() -> List[Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(_PKG.glob("*/csrc/*.cu"))


def headers() -> List[Path]:
    """Every header the CUDA sources include, in a stable order."""
    return sorted(_PKG.glob("*/csrc/*.cuh"))


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
            "the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.relative_to(_PKG).as_posix().encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"


def log_path() -> Path:
    """The compiler's output of the last build (``-Xptxas=-v``: registers,
    shared memory and spills of every kernel)."""
    return lib_path().with_suffix(".log")


def build() -> Path:
    """Compile every kernel unless the library is built already; returns
    its path.  Raises :class:`KernelBuildError` with the compiler's output
    when a source or the link fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    work = BUILD_DIR / f"{lib.stem}.obj{os.getpid()}"
    work.mkdir(exist_ok=True)
    objs, procs = [], []
    for src in sources():
        obj = work / f"{src.parent.parent.name}_{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for src, proc in procs:
        out = proc.communicate()[0].decode(errors="replace")
        logs.append(f"== {src.relative_to(_PKG)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exited {proc.returncode}")
    if failed:
        raise KernelBuildError("; ".join(failed) + "\n" + "\n".join(logs))
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *map(str, objs)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise KernelBuildError(f"link: nvcc exited {link.returncode}\n"
                               f"{link.stdout.decode(errors='replace')}")
    log_path().write_text("\n".join(logs))
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The loaded shared library, built on first use (once, when the
    mesh's shard threads ask for it together)."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                _LIB = ctypes.CDLL(str(build()))
    return _LIB
