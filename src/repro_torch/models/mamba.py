"""Mamba (S6) block — Jamba's attention-free layer.

The reference's ``models/mamba.py`` in PyTorch: a selective SSM with
input-dependent (dt, B, C), a linear recurrence over time on the state
``h`` (B, d_inner, d_state) in f32.  The reference runs the recurrence as
a ``lax.scan`` device program (its docstring names a chunked
selective-scan kernel as the fast path on real hardware); the port runs
it through :func:`repro_torch.kernels.selective_scan.selective_scan`: on
the card one launch of the hand-written ``selective_scan`` kernel per
layer call, on the CPU the plain version, which forms the reference's
per-step coefficients ``exp(dt A)`` and ``dt x B`` in chunks
(``kernels/selective_scan/ref.py``).  The kernel has no backward yet:
gradients flow through the scan on the CPU (the plain version's
autograd-safe form); on the card the scan raises where they would.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import P
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.param import ParamDef


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None

    def dims(self, d_model: int) -> Tuple[int, int]:
        d_inner = self.expand * d_model
        dt_rank = self.dt_rank or max(1, d_model // 16)
        return d_inner, dt_rank


def mamba_defs(d_model: int, spec: MambaSpec):
    d_inner, dt_rank = spec.dims(d_model)
    return {
        "in_proj": ParamDef((d_model, 2 * d_inner), spec=P("data", "model")),
        "conv_w": ParamDef((spec.d_conv, d_inner), spec=P(None, "model")),
        "conv_b": ParamDef((d_inner,), init="zeros", spec=P("model")),
        "x_proj": ParamDef((d_inner, dt_rank + 2 * spec.d_state),
                           spec=P("model", None)),
        "dt_proj": ParamDef((dt_rank, d_inner), spec=P(None, "model")),
        "dt_bias": ParamDef((d_inner,), init="zeros", spec=P("model")),
        "A_log": ParamDef((d_inner, spec.d_state), init="zeros",
                          spec=P("model", None)),
        "D_skip": ParamDef((d_inner,), init="ones", spec=P("model")),
        "out_proj": ParamDef((d_inner, d_model), spec=P("model", "data")),
    }


class MambaCache(NamedTuple):
    h: torch.Tensor         # (B, d_inner, d_state) SSM state, f32
    conv: torch.Tensor      # (B, d_conv - 1, d_inner) rolling conv window


def init_mamba_cache(batch: int, d_model: int, spec: MambaSpec,
                     dtype=torch.float32, device=None) -> MambaCache:
    d_inner, _ = spec.dims(d_model)
    return MambaCache(
        h=torch.zeros((batch, d_inner, spec.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, spec.d_conv - 1, d_inner), dtype=dtype,
                         device=device))


def _ssm_inputs(params, x_conv, spec: MambaSpec, dt_rank: int):
    """x_conv (B, S, d_inner) -> (dt, bm, cm), the small per-step inputs:
    ``dt`` is softplus in f32, ``bm`` and ``cm`` are cast to f32."""
    d_state = spec.d_state
    xdb = x_conv @ params["x_proj"]
    dt_r = xdb[..., :dt_rank]
    bm = xdb[..., dt_rank:dt_rank + d_state].float()
    cm = xdb[..., dt_rank + d_state:].float()
    dt = F.softplus((dt_r @ params["dt_proj"] + params["dt_bias"]).float())
    return dt, bm, cm


def _conv_causal(params, x, spec: MambaSpec,
                 prefix: Optional[torch.Tensor]):
    """Depthwise causal conv over time. prefix: (B, d_conv-1, d_inner).
    Returns (silu(conv), the last d_conv - 1 inputs)."""
    if prefix is None:
        prefix = x.new_zeros((x.shape[0], spec.d_conv - 1, x.shape[-1]))
    xp = torch.cat([prefix, x], dim=1)
    acc = torch.zeros_like(x) + params["conv_b"].to(x.dtype)
    s = x.shape[1]
    for j in range(spec.d_conv):
        acc = acc + xp[:, j:j + s] * params["conv_w"][j].to(x.dtype)
    return F.silu(acc), xp[:, -(spec.d_conv - 1):] \
        if spec.d_conv > 1 else prefix


def _scan(h, dt, xcf, bm, cm, a_mat, valid):
    """The recurrence ``h = exp(dt A) h + dt x B``, ``y = h . C`` over the
    S steps of (B, S, ...) inputs from the state ``h`` (B, d, N); steps
    where ``valid`` (B, S) is false leave the state as it was.  Returns
    (the last state, y (B, S, d) f32): one ``selective_scan`` launch on
    the card, the plain version on the CPU."""
    return selective_scan(h, dt, xcf, bm, cm, a_mat, valid)


def mamba_forward(params, x: torch.Tensor, spec: MambaSpec,
                  cache: Optional[MambaCache] = None,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """x (B, S, D); returns (out, new_cache if cache given).

    ``lengths`` (prefill with right-padding): positions >= length take an
    identity recurrence step so padding never pollutes the carried state,
    and the conv tail is gathered at the true sequence end (with the
    reference's clip)."""
    b, s, d_model = x.shape
    d_inner, dt_rank = spec.dims(d_model)
    xz = x @ params["in_proj"]
    x_in, z = xz[..., :d_inner], xz[..., d_inner:]
    prefix = cache.conv if cache is not None else None
    x_conv, conv_tail = _conv_causal(params, x_in, spec, prefix)
    dt, bm, cm = _ssm_inputs(params, x_conv, spec, dt_rank)
    xcf = x_conv.float()
    a_mat = -torch.exp(params["A_log"].float())             # (d_inner, N)

    valid = None
    if lengths is not None:
        lengths = lengths.to(x.device).long()
        valid = torch.arange(s, device=x.device)[None, :] < lengths[:, None]
        if spec.d_conv > 1:
            # the conv window ending at the true last token; xp coords are
            # offset by (d_conv - 1), so window index = length + j
            xp = torch.cat([prefix if prefix is not None else
                            x_in.new_zeros((b, spec.d_conv - 1, d_inner)),
                            x_in], dim=1)
            idx = (lengths[:, None]
                   + torch.arange(spec.d_conv - 1, device=x.device)[None]) \
                .clamp(0, xp.shape[1] - 1)
            conv_tail = torch.gather(
                xp, 1, idx[..., None].expand(-1, -1, d_inner))

    h0 = cache.h if cache is not None else x.new_zeros(
        (b, d_inner, spec.d_state), dtype=torch.float32)
    h_t, y = _scan(h0, dt, xcf, bm, cm, a_mat, valid)
    y = y + params["D_skip"].float() * xcf
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    new_cache = MambaCache(h=h_t, conv=conv_tail) \
        if cache is not None else None
    return out, new_cache
