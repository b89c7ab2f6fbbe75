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


def paged_attention_partitioned_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    lengths: torch.Tensor, *,
                                    partition_tokens: int,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch: the logical tokens
    are cut into partitions of ``partition_tokens``, each partition keeps
    its own max ``m_p``, sum ``l_p`` and unnormalised ``acc_p``, and the
    partitions are combined in order,

        m = max_p m_p,  l = sum_p l_p e^(m_p - m),
        out = sum_p acc_p e^(m_p - m) / max(l, 1e-30).

    A partition with no live token has m_p = -1e30, l_p = 0, acc_p = 0 and
    adds nothing; a length-0 row gives 0.  Same arguments and layout as
    :func:`paged_attention_ref`.  A test helper: the serving path never
    calls it."""
    batch, kvh, group, head_dim = q.shape
    page_size = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = head_dim ** -0.5
    n_tok = max_pages * page_size
    n_part = -(-n_tok // partition_tokens)
    bt = block_tables.long()
    k = k_pages[bt].reshape(batch, n_tok, kvh, head_dim).float()
    v = v_pages[bt].reshape(batch, n_tok, kvh, head_dim).float()
    pad = n_part * partition_tokens - n_tok
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhgd,bshd->bhgs", q.float() * scale, k)
    pos = torch.arange(n_part * partition_tokens, device=q.device)
    live = pos[None, :] < lengths.to(q.device).long().clamp(0, n_tok)[:, None]
    live = live[:, None, None, :].expand_as(s)
    s = s.masked_fill(~live, -1e30)
    parts = (batch, kvh, group, n_part, partition_tokens)
    s, live = s.reshape(parts), live.reshape(parts)
    m_p = s.amax(dim=-1)                                  # (B, H, G, n_part)
    p = torch.where(live, torch.exp(s - m_p[..., None]), 0.0)
    l_p = p.sum(dim=-1)
    vp = v.reshape(batch, n_part, partition_tokens, kvh, head_dim)
    acc_p = torch.einsum("bhgnt,bnthd->bhgnd", p, vp)
    m = m_p.amax(dim=-1, keepdim=True)
    w = torch.exp(m_p - m)
    l = (l_p * w).sum(dim=-1)
    out = (acc_p * w[..., None]).sum(dim=-2) / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
