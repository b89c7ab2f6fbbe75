"""Mixture-of-Experts layer with capacity-based dispatch.

The reference's ``models/moe.py`` in PyTorch: experts live as stacked
``(E, ...)`` tensors, and dispatch is the GShard-style capacity scheme —
each expert takes at most ``cap`` tokens, positions inside an expert are
given in the flat ``(token, k)`` order, and tokens past ``cap`` are
dropped.  The expert FFN's three products are plain batched matmuls
(``torch.bmm``), as the reference leaves its einsums to XLA.

The expert-id -> slab translation this layer performs at serving time is
the paper's §4.5 workload; the serving engine's tiara resolver resolves
it through the endpoint (``MoEExpertGather``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import P
from repro_torch.models.param import ParamDef


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False     # Llama-4 style always-on shared expert
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2


def moe_defs(d_model: int, spec: MoESpec):
    e, f = spec.n_experts, spec.d_ff_expert
    defs = {
        "router": ParamDef((d_model, e), spec=P("data", None)),
        "wi": ParamDef((e, d_model, f), spec=P("model", "data", None)),
        "wg": ParamDef((e, d_model, f), spec=P("model", "data", None)),
        "wo": ParamDef((e, f, d_model), fan_in=f,
                       spec=P("model", None, "data")),
    }
    if spec.shared_expert:
        defs["shared"] = {
            "wi": ParamDef((d_model, f), spec=P("data", "model")),
            "wg": ParamDef((d_model, f), spec=P("data", "model")),
            "wo": ParamDef((f, d_model), spec=P("model", "data")),
        }
    return defs


def _capacity(n_tokens: int, spec: MoESpec) -> int:
    cap = int(n_tokens * spec.top_k * spec.capacity_factor
              / spec.n_experts)
    return max(8, (cap + 3) // 4 * 4)


class Route(NamedTuple):
    """The router's decision for ``T`` tokens."""
    logits: torch.Tensor    # (T, E) f32
    probs: torch.Tensor     # (T, E) f32
    gate: torch.Tensor      # (T, K) f32, renormalised over the K chosen
    eidx: torch.Tensor      # (T, K) int64, best expert first


def moe_route(params, xf: torch.Tensor, spec: MoESpec) -> Route:
    """Router of ``xf (T, D)``: the model-dtype product cast to f32,
    softmax, then the top ``K`` experts.  Equal probabilities go to the
    lower expert id first, as ``jax.lax.top_k`` orders them: a stable
    descending sort keeps equal values in index order on the CPU and on
    the card, where ``torch.topk`` promises no order among them."""
    logits = (xf @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :spec.top_k], eidx[:, :spec.top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return Route(logits, probs, gate, eidx)


def moe_apply(params, x: torch.Tensor, spec: MoESpec, *,
              hints: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    ``hints`` are the reference's GSPMD sharding constraints on the
    dispatch buffers; one device has nothing to shard, so the argument is
    accepted and ignored."""
    del hints
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e, k = spec.n_experts, spec.top_k
    cap = _capacity(t, spec)
    route = moe_route(params, xf, spec)

    # position of each assignment within its expert, counted over the
    # flat (token, k) order; assignments past cap are dropped
    flat_oh = F.one_hot(route.eidx.reshape(t * k), e)          # (T*K, E)
    pos = ((flat_oh.cumsum(0) - flat_oh) * flat_oh).sum(-1)    # (T*K,)
    eflat = route.eidx.reshape(t * k)
    keep = pos < cap
    slot = pos.clamp_max(cap - 1)

    # dispatch into (E, C, D).  The reference adds every row at (expert,
    # slot) with the dropped rows zeroed and parked at cap - 1, so only
    # zeros ever collide with a kept row.  Here a dropped row goes to a
    # sink slot past cap instead, and the kept rows (at most one per
    # (expert, slot)) are written plainly: the same values, with no
    # accumulation and no host sync to pick the kept rows out.
    disp = xf.new_zeros((e, cap + 1, d))
    disp[eflat, torch.where(keep, pos, cap)] = xf.repeat_interleave(k, 0)
    disp = disp[:, :cap]

    # expert FFN (SwiGLU), one batched product per weight
    h = torch.bmm(disp, params["wi"].to(xf.dtype))
    g = torch.bmm(disp, params["wg"].to(xf.dtype))
    out_buf = torch.bmm(F.silu(g) * h, params["wo"].to(xf.dtype))

    # combine
    y = out_buf[eflat, slot] * keep[:, None].to(xf.dtype)      # (T*K, D)
    y = (y.reshape(t, k, d)
         * route.gate[..., None].to(xf.dtype)).sum(dim=1)

    if spec.shared_expert:
        sh = params["shared"]
        hs = F.silu(xf @ sh["wg"]) * (xf @ sh["wi"])
        y = y + hs @ sh["wo"]

    # aux losses: load balance (Switch) + router z-loss
    me = route.probs.mean(dim=0)                               # (E,)
    ce = flat_oh.reshape(t, k, e).sum(dim=1).float().mean(dim=0)
    balance = spec.balance_coef * e * torch.sum(me * ce) / k
    zloss = spec.router_z_coef * torch.mean(
        torch.square(torch.logsumexp(route.logits, dim=-1)))
    return y.reshape(b, s, d), balance + zloss
