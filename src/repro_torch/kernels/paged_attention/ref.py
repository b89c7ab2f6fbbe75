"""Plain PyTorch version of paged decode attention."""

from __future__ import annotations

from typing import Optional

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """out[b, h, g] = softmax(q . K[b]) V[b] over the first lengths[b]
    tokens of the pages named by block_tables[b].

    q (B, KVH, G, D); k/v_pages (P, page, KVH, D); block_tables (B, maxp);
    lengths (B,).  A row with ``length == 0`` gives 0, the Pallas kernel's
    answer (the reference's plain version gives NaN there)."""
    batch, kvh, group, head_dim = q.shape
    page_size = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = head_dim ** -0.5
    bt = block_tables.long()
    k = k_pages[bt].reshape(batch, max_pages * page_size, kvh, head_dim)
    v = v_pages[bt].reshape(batch, max_pages * page_size, kvh, head_dim)
    s = torch.einsum("bhgd,bshd->bhgs", q.float() * scale, k.float())
    pos = torch.arange(max_pages * page_size, device=q.device)
    mask = pos[None, None, None, :] < \
        lengths.to(q.device).long()[:, None, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.to(q.dtype)
