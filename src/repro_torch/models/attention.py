"""GQA attention: training/prefill (flash path) and paged decode (Tiara path).

Weights: wq (D, QH*hd) / wk,wv (D, KVH*hd); wo (QH*hd, D).  Decode attends
against the paged KV pool through the block table — on the card the CUDA
``paged_attention`` kernel resolves the table itself; prefill scatters its
KV into the same pages so decode can continue.

Unlike the reference, whose arrays are immutable and whose functions
rebuild the page pools, the prefill scatter and the decode append here
write the pools IN PLACE (``index_put_`` on the caller's tensors) and
return them: a pool is hundreds of megabytes at tiny-lm's full width, and
a copy per layer per step would dominate the decode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.distributed.mesh import P
from repro_torch.models.param import ParamDef


def attn_defs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int):
    return {
        "wq": ParamDef((d_model, n_heads * head_dim),
                       spec=P("data", "model")),
        "wk": ParamDef((d_model, n_kv_heads * head_dim),
                       spec=P("data", "model")),
        "wv": ParamDef((d_model, n_kv_heads * head_dim),
                       spec=P("data", "model")),
        "wo": ParamDef((n_heads * head_dim, d_model),
                       fan_in=n_heads * head_dim, spec=P("model", "data")),
    }


def _qkv(params, x, n_heads, n_kv_heads, head_dim):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def _position_encode(q, k, cfg, positions, positions3):
    if cfg.rope == "mrope":
        q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def attention_full(params, x, cfg, *, positions=None, positions3=None,
                   lengths=None, causal=True,
                   kv_override: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None):
    """Training / prefill attention over the whole sequence.

    Returns (out, (k, v)) with k/v in (B, S, KVH, hd) layout (post-RoPE) so
    the caller can page them for serving.  ``kv_override`` supplies
    precomputed cross-attention KV (B, S_enc, KVH, hd) (encoder-decoder):
    k and v come from it and neither side is rotated.  (The reference
    still projects ``x`` to k and v there and drops the result; the port
    skips those two products.)"""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv_override is not None:
        q = (x @ params["wq"]).reshape(b, s, nh, hd)
        k, v = kv_override
    else:
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None]
        q, k, v = _qkv(params, x, nh, nkv, hd)
        q, k = _position_encode(q, k, cfg, positions, positions3)
    if cfg.attn_fn is not None:
        # a launcher's attention in place of the kernel's entry point
        out = cfg.attn_fn(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), lengths, causal=causal)
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), lengths, causal=causal,
                              impl=cfg.attn_impl)
    out = out.transpose(1, 2).reshape(b, s, nh * hd)
    return out @ params["wo"], (k, v)


class PagedKV(NamedTuple):
    """Per-attention-layer paged KV pool (the disaggregated memory region)."""
    k_pages: torch.Tensor    # (P, page, KVH, hd)
    v_pages: torch.Tensor


def scatter_prefill_kv(kv: PagedKV, k: torch.Tensor, v: torch.Tensor,
                       block_tables: torch.Tensor) -> PagedKV:
    """Write prefill KV (B, S, KVH, hd) into the pages named by the block
    table, in place; S is padded with zeros to whole pages (padded
    positions are never attended)."""
    b, s, nkv, hd = k.shape
    page = kv.k_pages.shape[1]
    maxp = block_tables.shape[1]
    assert s <= maxp * page, (s, maxp, page)
    pad = maxp * page - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    flat_idx = block_tables.reshape(-1).long()
    kv.k_pages[flat_idx] = k.reshape(b * maxp, page, nkv, hd) \
        .to(kv.k_pages.dtype)
    kv.v_pages[flat_idx] = v.reshape(b * maxp, page, nkv, hd) \
        .to(kv.v_pages.dtype)
    return kv


def append_token_kv(kv: PagedKV, k: torch.Tensor, v: torch.Tensor,
                    block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> None:
    """Write each sequence's new token KV (B, KVH, hd) into its page at
    position ``lengths``, in place."""
    page = kv.k_pages.shape[1]
    # the reference's take_along_axis clamps an index past the table
    col = (lengths // page).long().clamp(0, block_tables.shape[1] - 1)
    page_idx = block_tables.long().gather(1, col[:, None])[:, 0]
    page_off = (lengths % page).long()
    kv.k_pages[page_idx, page_off] = k.to(kv.k_pages.dtype)
    kv.v_pages[page_idx, page_off] = v.to(kv.v_pages.dtype)


def attention_decode(params, x, cfg, kv: PagedKV, block_tables, lengths, *,
                     positions3=None) -> Tuple[torch.Tensor, PagedKV]:
    """One-token decode: append this token's KV to its page (in place),
    then attend over lengths+1 tokens through the block table."""
    b, s, _ = x.shape
    assert s == 1, "decode is one token per sequence"
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(params, x, nh, nkv, hd)
    lengths = lengths.to(torch.int32)
    positions = lengths[:, None]
    q, k = _position_encode(q, k, cfg, positions, positions3)

    if cfg.paged_attn_fn is not None:
        # one-round sequence-parallel path (distributed/paged_decode):
        # pages never move; the request ships to their owners
        out, k_pages, v_pages = cfg.paged_attn_fn(
            q[:, 0], kv.k_pages, kv.v_pages, k[:, 0], v[:, 0],
            block_tables, lengths)
        out = out.reshape(b, 1, nh * hd)
        return out @ params["wo"], PagedKV(k_pages, v_pages)

    append_token_kv(kv, k[:, 0], v[:, 0], block_tables, lengths)
    out = paged_attention(q[:, 0], kv.k_pages, kv.v_pages,
                          block_tables.to(torch.int32),
                          lengths + 1, impl=cfg.attn_impl)
    out = out.reshape(b, 1, nh * hd)
    return out @ params["wo"], kv
