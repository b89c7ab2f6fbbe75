"""Layer blocks: norm + mixer + norm + FFN.

The reference's ``block_defs``/``block_apply`` pair covers every assigned
architecture.  The port has the attention mixer with a dense MLP or a
mixture of experts so far — what ``tiny-lm``, the dense decoder-only
configs and the Llama-4 MoE models run; the other branches raise until the
slice that ports the recurrent families (mamba, rwkv) or the
encoder-decoder path (cross attention).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import PagedKV
from repro_torch.models.layers import apply_norm, mlp, mlp_defs, norm_defs
from repro_torch.models.moe import moe_apply, moe_defs

_LATER = "comes with the port's slice of the other model families"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {_LATER}")


def block_defs(cfg: ArchConfig, spec: LayerSpec, *, cross: bool = False):
    d = cfg.d_model
    if spec.kind != "attn":
        raise _unported(f"the {spec.kind!r} mixer")
    if cross:
        raise _unported("cross attention (encoder-decoder)")
    if spec.mlp == "rwkv_cm":
        raise _unported(f"the {spec.mlp!r} FFN")
    return {"norm1": norm_defs(cfg.norm, d),
            "mix": attn_mod.attn_defs(d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim),
            "norm2": norm_defs(cfg.norm, d),
            "ffn": moe_defs(d, spec.moe) if spec.mlp == "moe"
            else mlp_defs(d, cfg.d_ff, spec.mlp)}


class BlockCache(NamedTuple):
    """Cache of one layer.  The reference's union also holds recurrent and
    cross-attention state; those fields come with their layers."""
    paged: Optional[PagedKV] = None


def init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     pages_per_layer: int, dtype: torch.dtype, *,
                     device=None) -> BlockCache:
    if spec.kind != "attn":
        raise _unported(f"the {spec.kind!r} cache")
    shape = (pages_per_layer, cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
    return BlockCache(paged=PagedKV(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device)))


def block_apply(params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                *, mode: str,                  # train | prefill | decode
                ctx: Dict[str, Any],
                cache: Optional[BlockCache] = None,
                ) -> Tuple[torch.Tensor, Optional[BlockCache], torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  The paged pools in ``cache`` are
    updated in place (see ``models/attention.py``)."""
    if spec.kind != "attn":
        raise _unported(f"the {spec.kind!r} mixer")
    if "cross" in params:
        raise _unported("cross attention (encoder-decoder)")
    if spec.mlp == "rwkv_cm":
        raise _unported(f"the {spec.mlp!r} FFN")
    if spec.mlp == "moe" and cfg.moe_fn is not None:
        raise NotImplementedError(
            "the distributed expert-parallel MoE (cfg.moe_fn) comes with "
            "the port's distributed slice")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = cache
    h = apply_norm(cfg.norm, params["norm1"], x)
    if mode == "decode":
        out, paged = attn_mod.attention_decode(
            params["mix"], h, cfg, cache.paged, ctx["block_tables"],
            ctx["lengths"], positions3=ctx.get("positions3"))
        new_cache = cache._replace(paged=paged)
    else:
        out, (k, v) = attn_mod.attention_full(
            params["mix"], h, cfg, positions=ctx.get("positions"),
            positions3=ctx.get("positions3"),
            causal=ctx.get("causal", True))
        if mode == "prefill" and cache is not None:
            new_cache = cache._replace(paged=attn_mod.scatter_prefill_kv(
                cache.paged, k, v, ctx["block_tables"]))
    x = x + out
    h = apply_norm(cfg.norm, params["norm2"], x)
    if spec.mlp == "moe":
        out, aux = moe_apply(params["ffn"], h, spec.moe,
                             hints=cfg.moe_hints)
    else:
        out = mlp(params["ffn"], h, spec.mlp)
    x = x + out
    return x, new_cache, aux
