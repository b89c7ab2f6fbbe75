"""Public entry points of the double-indirection gathers."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.tiara_gather.kernel import (
    tiara_gather_kernel, tiara_gather_window_kernel)
from repro_torch.kernels.tiara_gather.ref import (tiara_gather_ref,
                                                  tiara_gather_window_ref)

def tiara_gather(pool: torch.Tensor, table: torch.Tensor,
                 ids: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``out[i] = pool[table[ids[i]]]`` for ``pool (N, R)``."""
    if resolve_impl(impl, pool) == "cuda":
        return tiara_gather_kernel(pool, table, ids)
    return tiara_gather_ref(pool, table, ids)


def tiara_gather_window(pool: torch.Tensor, table: torch.Tensor,
                        bases: torch.Tensor,
                        ids: Optional[torch.Tensor] = None, *,
                        width: int, mask: Union[int, torch.Tensor],
                        impl: str = "auto") -> torch.Tensor:
    """``out[i, w] = pool[bases[id] + ((table[id] + w) & mask)]`` with
    ``id = ids[i]`` (``id = i`` when ``ids`` is None) and ``w < width``,
    over a flat ``pool``; ``mask`` is one int or an int64 tensor shaped
    like ``table`` (``mask[id]``)."""
    if resolve_impl(impl, pool) == "cuda":
        return tiara_gather_window_kernel(pool, table, bases, ids,
                                          width=width, mask=mask)
    return tiara_gather_window_ref(pool, table, bases, ids, width=width,
                                   mask=mask)
