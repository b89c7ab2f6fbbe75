"""Plain PyTorch versions of the double-indirection gathers."""

from __future__ import annotations

from typing import Union

import torch


def tiara_gather_ref(pool: torch.Tensor, table: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    return pool[table.long()[ids.long()]]


def tiara_gather_window_ref(pool: torch.Tensor, table: torch.Tensor,
                            bases: torch.Tensor, ids: torch.Tensor, *,
                            width: int, mask: Union[int, torch.Tensor]
                            ) -> torch.Tensor:
    i = ids.long()
    w = torch.arange(width, dtype=torch.int64, device=pool.device)
    if isinstance(mask, torch.Tensor):
        mask = mask[i][:, None]
    return pool[bases[i][:, None] + ((table.long()[i][:, None] + w) & mask)]
