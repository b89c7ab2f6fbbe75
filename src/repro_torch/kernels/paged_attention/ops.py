"""Public entry point for paged decode attention.

Keeps the reference's ``(B, QH, D)`` layout and arguments and handles the
``(B, QH, D) <-> (B, KVH, G, D)`` GQA grouping.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, scale: Optional[float] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Decode attention against a paged KV cache.

    q: (B, QH, D) — one new token per sequence; k_pages/v_pages: (P,
    page, KVH, D); block_tables: (B, maxp) int32; lengths: (B,) int32.
    QH must be a multiple of KVH (GQA).

    impl: ``"auto"`` launches the CUDA kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"cuda"`` always launches the kernel;
    ``"torch"`` takes CPU tensors only (on the card the kernel runs).
    """
    qg = _grouped(q, k_pages)
    if resolve_impl(impl, q) == "cuda":
        out = paged_attention_kernel(qg.contiguous(), k_pages, v_pages,
                                     block_tables, lengths, scale=scale)
    else:
        out = paged_attention_ref(qg, k_pages, v_pages, block_tables,
                                  lengths, scale=scale)
    return out.reshape(q.shape)


def _grouped(q: torch.Tensor, k_pages: torch.Tensor) -> torch.Tensor:
    """(B, QH, D) -> (B, KVH, G, D)."""
    batch, qh, head_dim = q.shape
    kvh = k_pages.shape[2]
    if qh % kvh != 0:
        raise ValueError(f"q heads {qh} not a multiple of kv heads {kvh}")
    return q.reshape(batch, kvh, qh // kvh, head_dim)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version :func:`paged_attention` runs on CPU tensors, in
    its ``(B, QH, D)`` layout, on any device.  Never a fallback for the
    kernel — the dry-run's cells call it by name (``launch/cells.py``)."""
    out = paged_attention_ref(_grouped(q, k_pages), k_pages, v_pages,
                              block_tables, lengths, scale=scale)
    return out.reshape(q.shape)
