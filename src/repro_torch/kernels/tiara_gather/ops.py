"""Public entry points of the double-indirection gathers."""

from __future__ import annotations

import torch

from repro_torch.kernels.tiara_gather.kernel import (
    tiara_gather_kernel, tiara_gather_window_kernel)
from repro_torch.kernels.tiara_gather.ref import (tiara_gather_ref,
                                                  tiara_gather_window_ref)

IMPLS = ("auto", "cuda", "torch")


def _resolve(impl: str, pool: torch.Tensor) -> str:
    """``impl="auto"`` launches the CUDA kernel when ``pool`` lies on a
    CUDA device and runs the plain version when it lies on the CPU.  The
    plain version is only for CPU tensors: on the card the kernel runs or
    the call raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "cuda" if pool.is_cuda else "torch"
    if impl == "torch" and pool.is_cuda:
        raise ValueError("impl='torch' takes CPU tensors; on the card the "
                         "CUDA kernel runs")
    return impl


def tiara_gather(pool: torch.Tensor, table: torch.Tensor,
                 ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``out[i] = pool[table[ids[i]]]`` for ``pool (N, R)``."""
    if _resolve(impl, pool) == "cuda":
        return tiara_gather_kernel(pool, table, ids)
    return tiara_gather_ref(pool, table, ids)


def tiara_gather_window(pool: torch.Tensor, table: torch.Tensor,
                        bases: torch.Tensor, ids: torch.Tensor, *,
                        width: int, mask: int,
                        impl: str = "auto") -> torch.Tensor:
    """``out[i, w] = pool[bases[id] + ((table[id] + w) & mask)]`` with
    ``id = ids[i]`` and ``w < width``, over a flat ``pool``."""
    if _resolve(impl, pool) == "cuda":
        return tiara_gather_window_kernel(pool, table, bases, ids,
                                          width=width, mask=mask)
    return tiara_gather_window_ref(pool, table, bases, ids, width=width,
                                   mask=mask)
