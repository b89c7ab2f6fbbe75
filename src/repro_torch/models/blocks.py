"""Layer blocks: norm + mixer (attn/mamba/rwkv) + norm + FFN (mlp/moe/cm).

The reference's ``block_defs``/``block_apply`` pair covers every
architecture, and so does the port's: the attention, Mamba and RWKV mixers,
the dense, MoE and channel-mix FFNs, and the decoder's cross attention of
an encoder-decoder model.
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


def block_defs(cfg: ArchConfig, spec: LayerSpec, *, cross: bool = False):
    d = cfg.d_model
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
    if cross:
        defs["norm_x"] = norm_defs(cfg.norm, d)
        defs["cross"] = attn_mod.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                           cfg.head_dim)
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
    None; a decoder layer of an encoder-decoder model also holds its
    cross-attention KV, ``cross_k`` / ``cross_v`` (B, S_enc, KVH, hd)."""
    paged: Optional[PagedKV] = None
    mamba: Optional[mamba_mod.MambaCache] = None
    rwkv: Optional[rwkv_mod.RWKVCache] = None
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     pages_per_layer: int, dtype: torch.dtype, *,
                     cross_len: int = 0, device=None) -> BlockCache:
    paged = mamba_c = rwkv_c = cross_k = cross_v = None
    if spec.kind == "attn":
        shape = (pages_per_layer, cfg.page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        paged = PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))
    elif spec.kind == "mamba":
        mamba_c = mamba_mod.init_mamba_cache(batch, cfg.d_model, cfg.mamba,
                                             dtype, device=device)
    elif spec.kind == "rwkv":
        rwkv_c = rwkv_mod.init_rwkv_cache(batch, cfg.d_model, cfg.rwkv,
                                          dtype, device=device)
    else:
        raise ValueError(spec.kind)
    if cross_len:
        cshape = (batch, cross_len, cfg.n_kv_heads, cfg.head_dim)
        cross_k = torch.zeros(cshape, dtype=dtype, device=device)
        cross_v = torch.zeros(cshape, dtype=dtype, device=device)
    return BlockCache(paged=paged, mamba=mamba_c, rwkv=rwkv_c,
                      cross_k=cross_k, cross_v=cross_v)


def _store(dst, src) -> None:
    """Copy a new recurrent cache into the caller's (leaf by leaf)."""
    for a, b in zip(dst, src):
        a.copy_(b)


def _cross_attention(params, x, cfg: ArchConfig, mode: str,
                     ctx: Dict[str, Any], cache: Optional[BlockCache]):
    hx = apply_norm(cfg.norm, params["norm_x"], x)
    if mode == "decode":
        kv = (cache.cross_k, cache.cross_v)
    else:
        enc = ctx["enc_out"]
        b, se, _ = enc.shape
        kv = tuple((enc @ params["cross"][w]).reshape(
            b, se, cfg.n_kv_heads, cfg.head_dim) for w in ("wk", "wv"))
        if cache is not None:
            if cache.cross_k.shape[1] != se:
                raise ValueError(
                    f"cross caches hold {cache.cross_k.shape[1]} encoder "
                    f"positions, the encoder gave {se} (init_caches("
                    f"cross_len=) must be S_enc)")
            _store((cache.cross_k, cache.cross_v), kv)
    out, _ = attn_mod.attention_full(
        params["cross"], hx, cfg, causal=False,
        lengths=ctx.get("enc_lengths"), kv_override=kv)
    return out


def block_apply(params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                *, mode: str,                  # train | prefill | decode
                ctx: Dict[str, Any],
                cache: Optional[BlockCache] = None,
                ) -> Tuple[torch.Tensor, Optional[BlockCache], torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  ``cache`` is updated in place
    (the paged pools as ``models/attention.py`` says, the recurrent states
    and the cross-attention KV by copy) and returned; ``lengths`` reaches
    the recurrent layers in prefill only, as in the reference.

    A block with ``cross`` weights attends the encoder after its mixer: in
    train and prefill it projects ``ctx["enc_out"]`` to this layer's
    cross KV (and stores it in the cache, in the cache's dtype), in decode
    it reads the cache; non-causal, keys masked past
    ``ctx["enc_lengths"]``."""
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
    if "cross" in params:
        x = x + _cross_attention(params, x, cfg, mode, ctx, cache)
    h = apply_norm(cfg.norm, params["norm2"], x)
    if spec.mlp == "moe":
        if cfg.moe_fn is not None:
            # local-dispatch expert parallelism (distributed/moe_ep)
            out, aux = cfg.moe_fn(params["ffn"], h)
        else:
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
