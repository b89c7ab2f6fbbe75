"""Plain PyTorch versions of the double-indirection gathers."""

from __future__ import annotations

from typing import Optional, Union

import torch


def tiara_gather_ref(pool: torch.Tensor, table: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    return pool[table.long()[ids.long()]]


def tiara_gather_window_ref(pool: torch.Tensor, table: torch.Tensor,
                            bases: torch.Tensor,
                            ids: Optional[torch.Tensor] = None, *,
                            width: int, mask: Union[int, torch.Tensor]
                            ) -> torch.Tensor:
    """The window form; ``ids`` None means entry ``i`` is id ``i``."""
    t, b = table.long(), bases
    if ids is not None:
        i = ids.long()
        t, b = t[i], b[i]
        if isinstance(mask, torch.Tensor):
            mask = mask[i]
    if isinstance(mask, torch.Tensor):
        mask = mask[:, None]
    w = torch.arange(width, dtype=torch.int64, device=pool.device)
    return pool[b[:, None] + ((t[:, None] + w) & mask)]
