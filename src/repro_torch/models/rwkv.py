"""RWKV-6 (Finch) block — data-dependent decay linear attention.

The reference's ``models/rwkv.py`` in PyTorch.  Time mix: per-head matrix
state S (hd x hd) updated with an input-dependent diagonal decay w_t plus
a first-occurrence bonus u; channel mix: token-shifted squared-ReLU FFN.
The reference runs the time-mix recurrence as a ``lax.scan`` and has no
kernel for it, so the port's scan is plain PyTorch too.

The scan works in chunks of at most ``SCAN_CHUNK_BYTES`` per (C, B, H, hd,
hd) f32 tensor: the chunk's ``kv = k v^T`` is formed at once, the state
update ``S_t = w_t S_{t-1} + kv_t`` runs in place on it (one fused
multiply-add per step, so the buffer ends up holding the states), and the
outputs ``y_t = r_t (S_{t-1} + u kv_t)`` are two batched operations per
chunk.  The arithmetic per step is the reference's; as there, ``y`` reads
the state before the decay update.  When gradients flow, the update runs
out of place (``torch.addcmul``) and the chunk's states are stacked, as
autograd cannot differentiate through states overwritten in place: the
same arithmetic.  (As in the reference, the time mix has no group norm.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import P
from repro_torch.models.param import ParamDef

# Bytes of each f32 chunk tensor of the time-mix scan: it runs in chunks
# of as many steps as fit (at least one).
SCAN_CHUNK_BYTES = 1 << 28


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


def _chunk_steps(b: int, nh: int, hs: int) -> int:
    return max(1, SCAN_CHUNK_BYTES // (4 * b * nh * hs * hs))


def _scan(state, rh, kh, vh, wh, uh, valid):
    """The wkv recurrence over the S steps of (B, S, H, hs) f32 inputs from
    ``state`` (B, H, hs, hs); steps where ``valid`` (B, S) is false leave
    the state as it was.  Returns (the last state, y (B, S, H, hs))."""
    b, s, nh, hs = rh.shape
    ys = rh.new_empty((b, s, nh, hs))
    step = _chunk_steps(b, nh, hs)
    for c0 in range(0, s, step):
        c1 = min(s, c0 + step)

        def chunk(t):
            return t[:, c0:c1].transpose(0, 1)              # (C, B, H, hs)
        r_c, k_c, v_c, w_c = chunk(rh), chunk(kh), chunk(vh), chunk(wh)
        kv = k_c[..., :, None] * v_c[..., None, :]          # (C,B,H,hs,hs)
        # the state before each step, plus the bonus term
        pre = uh[:, :, None] * kv
        if valid is not None:
            vm = chunk(valid)[..., None, None, None]
            w_c = torch.where(vm[..., 0], w_c, 1.0)
            kv = torch.where(vm, kv, 0.0)
        s_in = state
        if torch.is_grad_enabled() and (kv.requires_grad
                                        or w_c.requires_grad
                                        or state.requires_grad):
            # out of place: autograd keeps every state
            states = [s_in]
            for t in range(c1 - c0):
                state = torch.addcmul(kv[t], w_c[t][..., None], state)
                states.append(state)
            pre = pre + torch.stack(states[:-1])
        else:
            for t in range(c1 - c0):  # kv[t] becomes the state after t
                state = kv[t].addcmul_(w_c[t][..., None], state)
            pre[0] += s_in
            pre[1:] += kv[:-1]
        ys[:, c0:c1] = torch.einsum("cbhi,cbhij->bchj", r_c, pre)
        del kv, pre                 # freed before the next chunk's
    return state.clone(), ys


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
