"""Shared layers: norms, MLPs, rotary embeddings (RoPE + M-RoPE), embed.

The reference's ``models/layers.py`` in PyTorch, function for function,
with its layouts and its f32 islands (norm statistics, rotary angles,
logits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import P
from repro_torch.models.param import ParamDef

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(d: int):
    return {"scale": ParamDef((d,), init="ones", spec=P(None))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


def layernorm_defs(d: int):
    return {"scale": ParamDef((d,), init="ones", spec=P(None)),
            "bias": ParamDef((d,), init="zeros", spec=P(None))}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(dt)


def norm_defs(kind: str, d: int):
    return rmsnorm_defs(d) if kind == "rmsnorm" else layernorm_defs(d)


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------


def mlp_defs(d_model: int, d_ff: int, kind: str):
    if kind == "swiglu":
        return {"wi": ParamDef((d_model, d_ff), spec=P("data", "model")),
                "wg": ParamDef((d_model, d_ff), spec=P("data", "model")),
                "wo": ParamDef((d_ff, d_model), spec=P("model", "data"))}
    # relu2 (squared ReLU, Nemotron-4) and gelu share the 2-matrix shape
    return {"wi": ParamDef((d_model, d_ff), spec=P("data", "model")),
            "wo": ParamDef((d_ff, d_model), spec=P("model", "data"))}


def mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif kind == "relu2":
        h = F.relu(x @ params["wi"]).square()
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=device) / half
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exponent)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions (..., S).  Angles are
    f32 ``positions * freqs``, as in the reference."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (half,)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    if x.dim() == ang.dim() + 1:                              # head dim
        ang = ang[..., None, :]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 1_000_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, D); positions3: (3, B, S)
    temporal/height/width ids.  The half-dim frequency bands split into
    ``sections`` (t, h, w), each rotated by its own position stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang_all = positions3[..., None].float() * freqs            # (3,B,S,half)
    parts = []
    start = 0
    for sec_i, sec in enumerate(sections):
        parts.append(ang_all[sec_i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)[..., None, :]              # (B,S,1,half)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(vocab_padded: int, d_model: int, tie: bool):
    defs = {"tokens": ParamDef((vocab_padded, d_model), init="embed",
                               spec=P("model", "data"))}
    if not tie:
        defs["head"] = ParamDef((d_model, vocab_padded),
                               spec=P("data", "model"))
    return defs


def embed(params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # the reference's row gather; ``F.embedding``'s backward on the card
    # sums the rows of repeated tokens after a sort, in a fixed order
    return F.embedding(tokens.long(), params["tokens"].to(dtype))


def unembed(params, x: torch.Tensor,
            vocab: Optional[int] = None) -> torch.Tensor:
    if "head" in params:
        logits = (x @ params["head"]).float()
    else:
        logits = (x @ params["tokens"].T.to(x.dtype)).float()
    if vocab is not None and vocab < logits.shape[-1]:
        # mask padding rows so the softmax never sees them
        logits[..., vocab:] = -1e30
    return logits
