"""Layer blocks: norm + mixer (attn/mamba/rwkv) + norm + FFN (mlp/moe/cm).

The reference's ``block_defs``/``block_apply`` pair covers every assigned
architecture; the port has every branch but cross attention, which raises
until the slice that ports the encoder-decoder path.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import PagedKV
from repro_torch.models.layers import apply_norm, mlp, mlp_defs, norm_defs
from repro_torch.models.moe import moe_apply, moe_defs

_CROSS = ("cross attention (encoder-decoder) comes with the port's slice of "
          "the encoder-decoder models")


def block_defs(cfg: ArchConfig, spec: LayerSpec, *, cross: bool = False):
    d = cfg.d_model
    if cross:
        raise NotImplementedError(_CROSS)
    defs: Dict[str, Any] = {"norm1": norm_defs(cfg.norm, d)}
    if spec.kind == "attn":
        defs["mix"] = attn_mod.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                         cfg.head_dim)
    elif spec.kind == "mamba":
        defs["mix"] = mamba_mod.mamba_defs(d, cfg.mamba)
    elif spec.kind == "rwkv":
        defs["mix"] = rwkv_mod.rwkv_time_defs(d, cfg.rwkv)
    else:
        raise ValueError(spec.kind)
    defs["norm2"] = norm_defs(cfg.norm, d)
    if spec.mlp == "moe":
        defs["ffn"] = moe_defs(d, spec.moe)
    elif spec.mlp == "rwkv_cm":
        defs["ffn"] = rwkv_mod.rwkv_channel_defs(d, cfg.d_ff)
    else:
        defs["ffn"] = mlp_defs(d, cfg.d_ff, spec.mlp)
    return defs


class BlockCache(NamedTuple):
    """Cache of one layer: the field of its mixer is set, the others are
    None.  (The reference's cross-attention fields come with the
    encoder-decoder models.)"""
    paged: Optional[PagedKV] = None
    mamba: Optional[mamba_mod.MambaCache] = None
    rwkv: Optional[rwkv_mod.RWKVCache] = None


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     pages_per_layer: int, dtype: torch.dtype, *,
                     device=None) -> BlockCache:
    if spec.kind == "attn":
        shape = (pages_per_layer, cfg.page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        return BlockCache(paged=PagedKV(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device)))
    if spec.kind == "mamba":
        return BlockCache(mamba=mamba_mod.init_mamba_cache(
            batch, cfg.d_model, cfg.mamba, dtype, device=device))
    if spec.kind == "rwkv":
        return BlockCache(rwkv=rwkv_mod.init_rwkv_cache(
            batch, cfg.d_model, cfg.rwkv, dtype, device=device))
    raise ValueError(spec.kind)


def _store(dst, src) -> None:
    """Copy a new recurrent cache into the caller's (leaf by leaf)."""
    for a, b in zip(dst, src):
        a.copy_(b)


def block_apply(params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                *, mode: str,                  # train | prefill | decode
                ctx: Dict[str, Any],
                cache: Optional[BlockCache] = None,
                ) -> Tuple[torch.Tensor, Optional[BlockCache], torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  ``cache`` is updated in place
    (the paged pools as ``models/attention.py`` says, the recurrent states
    by copy) and returned; ``lengths`` reaches the recurrent layers in
    prefill only, as in the reference."""
    if "cross" in params:
        raise NotImplementedError(_CROSS)
    if spec.mlp == "moe" and cfg.moe_fn is not None:
        raise NotImplementedError(
            "the distributed expert-parallel MoE (cfg.moe_fn) comes with "
            "the port's distributed slice")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    lengths = ctx.get("lengths") if mode == "prefill" else None
    h = apply_norm(cfg.norm, params["norm1"], x)
    if spec.kind == "attn":
        if mode == "decode":
            out, _ = attn_mod.attention_decode(
                params["mix"], h, cfg, cache.paged, ctx["block_tables"],
                ctx["lengths"], positions3=ctx.get("positions3"))
        else:
            out, (k, v) = attn_mod.attention_full(
                params["mix"], h, cfg, positions=ctx.get("positions"),
                positions3=ctx.get("positions3"),
                causal=ctx.get("causal", True))
            if mode == "prefill" and cache is not None:
                attn_mod.scatter_prefill_kv(cache.paged, k, v,
                                            ctx["block_tables"])
    elif spec.kind == "mamba":
        out, mc = mamba_mod.mamba_forward(
            params["mix"], h, cfg.mamba,
            cache.mamba if cache is not None else None, lengths=lengths)
        if cache is not None:
            _store(cache.mamba, mc)
    elif spec.kind == "rwkv":
        rc = cache.rwkv if cache is not None else None
        out, (state, last_x) = rwkv_mod.rwkv_time_mix(
            params["mix"], h, cfg.rwkv, rc, lengths=lengths)
        if rc is not None:
            _store((rc.state, rc.x_time), (state, last_x))
    else:
        raise ValueError(spec.kind)
    x = x + out
    h = apply_norm(cfg.norm, params["norm2"], x)
    if spec.mlp == "moe":
        out, aux = moe_apply(params["ffn"], h, spec.moe,
                             hints=cfg.moe_hints)
    elif spec.mlp == "rwkv_cm":
        rc = cache.rwkv if cache is not None else None
        out, last_c = rwkv_mod.rwkv_channel_mix(
            params["ffn"], h, rc.x_chan if rc is not None else None,
            lengths=lengths)
        if rc is not None:
            rc.x_chan.copy_(last_c)
    else:
        out = mlp(params["ffn"], h, spec.mlp)
    x = x + out
    return x, cache, aux
