"""RWKV-6 (Finch) block — data-dependent decay linear attention.

The reference's ``models/rwkv.py`` in PyTorch.  Time mix: per-head matrix
state S (hd x hd) updated with an input-dependent diagonal decay w_t plus
a first-occurrence bonus u; channel mix: token-shifted squared-ReLU FFN.
The reference runs the time-mix recurrence as a ``lax.scan`` device
program; the port runs it through :func:`repro_torch.kernels.wkv6.wkv6`:
on the card one launch of the hand-written ``wkv6`` kernel per layer
call, on the CPU the plain version in chunks (``kernels/wkv6/ref.py``).
As in the reference, ``y`` reads the state before the decay update.  The
kernel has no backward yet: gradients flow through the scan on the CPU
(the plain version's autograd-safe form); on the card the scan raises
where they would.  (As in the reference, the time mix has no
group norm.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import P
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.param import ParamDef


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    head_size: int = 64
    decay_lora: int = 64


def rwkv_time_defs(d_model: int, spec: RWKVSpec):
    dl = spec.decay_lora
    return {
        # token-shift interpolation coefficients for r/k/v/w/g
        "mu": ParamDef((5, d_model), init="zeros", spec=P(None, None)),
        "wr": ParamDef((d_model, d_model), spec=P("data", "model")),
        "wk": ParamDef((d_model, d_model), spec=P("data", "model")),
        "wv": ParamDef((d_model, d_model), spec=P("data", "model")),
        "wg": ParamDef((d_model, d_model), spec=P("data", "model")),
        "wo": ParamDef((d_model, d_model), spec=P("model", "data")),
        # data-dependent decay LoRA (Finch): w_t = exp(-softplus(...))
        "w_base": ParamDef((d_model,), init="zeros", spec=P("model")),
        "w1": ParamDef((d_model, dl), spec=P("data", None)),
        "w2": ParamDef((dl, d_model), spec=P(None, "model")),
        "u_bonus": ParamDef((d_model,), init="zeros", spec=P("model")),
    }


def rwkv_channel_defs(d_model: int, d_ff: int):
    return {
        "mu": ParamDef((2, d_model), init="zeros", spec=P(None, None)),
        "wk": ParamDef((d_model, d_ff), spec=P("data", "model")),
        "wv": ParamDef((d_ff, d_model), spec=P("model", "data")),
        "wr": ParamDef((d_model, d_model), spec=P("data", "model")),
    }


class RWKVCache(NamedTuple):
    state: torch.Tensor     # (B, H, hd, hd) wkv matrix state, f32
    x_time: torch.Tensor    # (B, D) last input of the time-mix sublayer
    x_chan: torch.Tensor    # (B, D) last input of the channel-mix sublayer


def init_rwkv_cache(batch: int, d_model: int, spec: RWKVSpec,
                    dtype=torch.float32, device=None) -> RWKVCache:
    h = d_model // spec.head_size
    return RWKVCache(
        state=torch.zeros((batch, h, spec.head_size, spec.head_size),
                          dtype=torch.float32, device=device),
        x_time=torch.zeros((batch, d_model), dtype=dtype, device=device),
        x_chan=torch.zeros((batch, d_model), dtype=dtype, device=device))


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x (B,S,D) -> x shifted right by one (prev fills t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1), x[:, -1]


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * torch.sigmoid(mu).to(x.dtype)


def _last_valid(x: torch.Tensor,
                lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,S,D) -> the entry at position length-1 (or the final one)."""
    if lengths is None:
        return x[:, -1]
    idx = (lengths.to(x.device).long() - 1).clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1])
                        )[:, 0]


def _scan(state, rh, kh, vh, wh, uh, valid):
    """The wkv recurrence over the S steps of (B, S, H, hs) f32 inputs from
    ``state`` (B, H, hs, hs); steps where ``valid`` (B, S) is false leave
    the state as it was.  Returns (the last state, y (B, S, H, hs)): one
    ``wkv6`` launch on the card, the plain version on the CPU."""
    return wkv6(state, rh, kh, vh, wh, uh, valid)


def rwkv_time_mix(params, x: torch.Tensor, spec: RWKVSpec,
                  cache: Optional[RWKVCache] = None,
                  lengths: Optional[torch.Tensor] = None):
    """x (B,S,D) -> (out, (new_state, last_x)).  ``lengths``: right-padded
    prefill — padded steps leave the state untouched."""
    b, s, d = x.shape
    hs = spec.head_size
    nh = d // hs
    xs, _ = _token_shift(x, cache.x_time if cache is not None else None)
    last_x = _last_valid(x, lengths)
    mu = params["mu"]
    r = _mix(x, xs, mu[0]) @ params["wr"]
    k = _mix(x, xs, mu[1]) @ params["wk"]
    v = _mix(x, xs, mu[2]) @ params["wv"]
    xw = _mix(x, xs, mu[3])
    g = F.silu(_mix(x, xs, mu[4]) @ params["wg"])
    # data-dependent decay, in (0, 1), in f32
    w = torch.exp(-F.softplus(
        (params["w_base"] + (xw @ params["w1"]) @ params["w2"]).float()))
    u = params["u_bonus"].float()

    def heads(t):
        return t.reshape(b, s, nh, hs).float()

    valid = None
    if lengths is not None:
        valid = torch.arange(s, device=x.device)[None, :] \
            < lengths.to(x.device).long()[:, None]
    s0 = cache.state if cache is not None else x.new_zeros(
        (b, nh, hs, hs), dtype=torch.float32)
    s_t, y = _scan(s0, heads(r), heads(k), heads(v), w.reshape(b, s, nh, hs),
                   u.reshape(nh, hs), valid)
    y = y.reshape(b, s, d).to(x.dtype)
    out = (y * g) @ params["wo"]
    return out, (s_t, last_x)


def rwkv_channel_mix(params, x: torch.Tensor,
                     cache_prev: Optional[torch.Tensor] = None,
                     lengths: Optional[torch.Tensor] = None):
    xs, _ = _token_shift(x, cache_prev)
    last_x = _last_valid(x, lengths)
    mu = params["mu"]
    k = _mix(x, xs, mu[0]) @ params["wk"]
    kv = torch.square(F.relu(k)) @ params["wv"]
    r = torch.sigmoid(_mix(x, xs, mu[1]) @ params["wr"])
    return r * kv, last_x
