"""Hand-written Hopper kernels of the port, one package per TPU kernel or
device program of the reference (``kernel.py`` launch wrapper +
``ref.py`` plain version + ``ops.py`` entry point + ``csrc/`` CUDA
source).  ``_build.py`` compiles every
``csrc/*.cu`` into one shared library on first use."""

from typing import Dict

import torch

IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``impl="auto"`` launches the CUDA kernel when ``x`` lies on a CUDA
    device and runs the plain version when it lies on the CPU.  The plain
    version is only for CPU tensors: on the card the kernel runs or the
    call raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "torch" and x.is_cuda:
        raise ValueError("impl='torch' takes CPU tensors; on the card the "
                         "CUDA kernel runs")
    return impl


def _modules():
    from repro_torch.kernels.flash_attention import kernel as _fa
    from repro_torch.kernels.lockstep_vm import kernel as _lv
    from repro_torch.kernels.paged_attention import kernel as _pa
    from repro_torch.kernels.selective_scan import kernel as _ss
    from repro_torch.kernels.tiara_gather import kernel as _tg
    from repro_torch.kernels.wkv6 import kernel as _wk
    return _tg, _pa, _fa, _lv, _ss, _wk


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launch_counts`:
    the merged ``COUNTS`` of the kernel modules, one entry per kernel
    entry point."""
    return {name: n for mod in _modules() for name, n in mod.COUNTS.items()}


def reset_launch_counts() -> None:
    for mod in _modules():
        for name in mod.COUNTS:
            mod.COUNTS[name] = 0
