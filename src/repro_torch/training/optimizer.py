"""Optimizers: AdamW with f32 state, and 8-bit block-quantized AdamW.

The reference's ``training/optimizer.py`` in PyTorch.  The 8-bit variant
keeps both moments as int8 codes with per-block f32 absmax scales (blocks
of 256 along the last axis), the second moment quantized in the sqrt
domain; the quantization error is bounded by the blockwise absmax and
held to f32 Adam by a convergence test, as in the reference.

Unlike the reference, whose update returns new arrays, the port updates
the parameters and the state IN PLACE under ``torch.no_grad()`` (the
reference's trainer donates them to its jitted step): each leaf's new
value is computed in f32, as the reference computes it, and copied back
in the leaf's dtype.  The ``params`` and ``state`` passed to ``update``
are the ones returned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.param import tree_leaves, tree_map

QBLOCK = 256


# ---------------------------------------------------------------------------
# Blockwise int8 quantization
# ---------------------------------------------------------------------------


class Q8(NamedTuple):
    codes: torch.Tensor     # int8, original shape
    scales: torch.Tensor    # f32, x.shape[:-1] + (ceil(last/QBLOCK),)


def _is_q8(x) -> bool:
    return isinstance(x, Q8)


def _last_blocks(n: int) -> int:
    return (n + QBLOCK - 1) // QBLOCK


def quantize8(x: torch.Tensor) -> Q8:
    """Blockwise int8 along the LAST axis only (the reference's layout:
    shape-preserving per leading dim)."""
    *lead, n = x.shape
    nb = _last_blocks(n)
    blocks = F.pad(x.float(), (0, nb * QBLOCK - n)).reshape(*lead, nb,
                                                             QBLOCK)
    scale = (blocks.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    codes = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    codes = codes.to(torch.int8).reshape(*lead, nb * QBLOCK)[..., :n]
    return Q8(codes=codes.contiguous(), scales=scale)


def dequantize8(q: Q8, shape) -> torch.Tensor:
    *lead, n = shape
    nb = _last_blocks(n)
    flat = F.pad(q.codes.float(), (0, nb * QBLOCK - n))
    vals = flat.reshape(*lead, nb, QBLOCK) * q.scales[..., None]
    return vals.reshape(*lead, nb * QBLOCK)[..., :n]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """lr(step) -> f32 tensor: linear warmup, then cosine down to ``floor``
    x peak; ``step`` an int or a tensor (the result on its device)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_bits: int = 32          # 32 or 8


class AdamWState(NamedTuple):
    count: torch.Tensor     # int32 scalar
    mu: Any
    nu: Any


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def make_adamw(cfg: AdamWConfig):
    """Returns (init_fn, update_fn).  update: (grads, state, params) ->
    (params, state, metrics), the first two updated in place."""
    q8 = cfg.state_bits == 8

    # The second moment is quantized in the *sqrt domain*: linear int8
    # flushes small nu to zero inside high-dynamic-range blocks, which
    # explodes mu/sqrt(nu).
    def init(params) -> AdamWState:
        def zero(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return quantize8(z) if q8 else z
        dev = tree_leaves(params)[0].device
        return AdamWState(count=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                          mu=tree_map(zero, params),
                          nu=tree_map(zero, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        gnorm = _global_norm(grads)
        flat_g = [g.float() for g in tree_leaves(grads)]
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
            flat_g = [g * scale for g in flat_g]
        count = state.count.add_(1)
        lr = cfg.lr(count)
        c1 = 1 - cfg.b1 ** count.float()
        c2 = 1 - cfg.b2 ** count.float()
        flat_p = tree_leaves(params)
        flat_mu = tree_leaves(state.mu, is_leaf=_is_q8)
        flat_nu = tree_leaves(state.nu, is_leaf=_is_q8)
        for p, g, mu_s, nu_s in zip(flat_p, flat_g, flat_mu, flat_nu):
            if q8:
                mu = dequantize8(mu_s, p.shape)
                nu = torch.square(dequantize8(nu_s, p.shape))
            else:
                mu, nu = mu_s, nu_s
            mu = cfg.b1 * mu + (1 - cfg.b1) * g
            nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
            step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            step = step + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
            if q8:
                for dst, src in ((mu_s, quantize8(mu)),
                                 (nu_s, quantize8(torch.sqrt(nu)))):
                    dst.codes.copy_(src.codes)
                    dst.scales.copy_(src.scales)
            else:
                mu_s.copy_(mu)
                nu_s.copy_(nu)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, state, metrics

    return init, update
