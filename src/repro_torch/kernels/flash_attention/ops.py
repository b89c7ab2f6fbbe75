"""Public entry point for prefill attention, with its gradient."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import (flash_attention_chunked,
                                                     flash_attention_ref)

#: from this many query rows on, the plain version loops over query chunks
#: so that it never builds a (B, H, S, S) score tensor
CHUNKED_FROM = 2048


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op.
    The forward launches ``flash_attention_kernel`` with ``return_lse``
    and saves ``q, k, v, out, lse, lengths``; the backward launches
    ``flash_attention_bwd_kernel`` — on the card both products of
    training run as kernels, never as the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale):
        out, lse = flash_attention_kernel(q, k, v, lengths, causal=causal,
                                          scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, lse, dout.contiguous(), lengths,
            causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    impl: str = "auto") -> torch.Tensor:
    """Causal (or full) attention, (B, H, S, D) layout, GQA-aware.

    ``block_q`` / ``block_k`` are the reference's tile sizes and are
    accepted as hints only: the CUDA kernel tiles by 64 and masks ragged
    edges itself, so S need not be a multiple of any tile.

    impl: ``"auto"`` launches the CUDA kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"cuda"`` always launches the kernel;
    ``"torch"`` takes CPU tensors only (on the card the kernel runs).

    Differentiable: on the card, when gradients are on and an input needs
    one, the call runs as :class:`FlashAttentionFn` (the backward is the
    CUDA backward kernel); on the CPU autograd runs through the plain
    version.
    """
    del block_q, block_k
    if resolve_impl(impl, q) == "cuda":
        args = (q.contiguous(), k.contiguous(), v.contiguous(),
                None if lengths is None else lengths.to(torch.int32)
                .contiguous())
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(*args, causal, scale)
        return flash_attention_kernel(*args, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, lengths, causal=causal,
                                 scale=scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version :func:`flash_attention` runs on CPU tensors, on
    any device: the query-chunked loop from ``CHUNKED_FROM`` rows on.
    Differentiable through autograd.  Never a fallback for the kernel —
    the dry-run's cells call it by name (``launch/cells.py``)."""
    if q.shape[2] >= CHUNKED_FROM:
        return flash_attention_chunked(q, k, v, lengths, causal=causal,
                                       scale=scale)
    return flash_attention_ref(q, k, v, lengths, causal=causal, scale=scale)
