"""Expert-parallel MoE with fully local dispatch (port of
``repro.distributed.moe_ep``).

Baseline ``moe_apply`` dispatches every token into (E, C, D) buffers on
one device.  This variant applies the paper's move at the MoE layer:
*the tokens are the requests; resolve them where the experts live.*
Under ``shard_map``:

  * activations are dp-sharded and model-replicated, so every model rank
    already holds its dp-shard's tokens: it dispatches *locally* into
    buffers for its OWN E/M experts — no dispatch collective at all;
  * expert weights are EP-sharded over ``model`` and FSDP-sharded over
    ``data``: the data-dim shards all-gather once per layer;
  * each rank's expert outputs combine with ONE psum over the model axis
    (every token's routed expert lives on exactly one rank).

Capacity is per dp shard (``_capacity`` of the local tokens), as in the
reference: the result equals ``moe_apply``'s where no assignment drops.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed.mesh import P, Sharded
from repro_torch.models.moe import MoESpec, _capacity, moe_route

WEIGHT_SPECS = {"wi": P("model", "data", None),
                "wg": P("model", "data", None),
                "wo": P("model", None, "data")}
SHARED_SPECS = {"wi": P(None, "model"), "wg": P(None, "model"),
                "wo": P("model", None)}


def make_moe_ep(mesh: dmesh.Mesh, dp: Tuple[str, ...], spec: MoESpec,
                model_axis: str = "model"):
    """Returns fn(params, x) -> (y, aux) matching moe_apply semantics;
    ``y`` comes back as one tensor on ``x``'s device.  The expert weights
    may be global tensors (split per call) or already per shard
    (:func:`shard_moe_params`: no copy per call)."""
    msize = mesh.shape[model_axis]
    if spec.n_experts % msize:
        raise ValueError(f"{spec.n_experts} experts do not split over "
                         f"{msize} model ranks")
    e_local = spec.n_experts // msize
    data_axis = "data"

    def local(router, wi, wg, wo, x, *shared):
        # x (B_local, S, D) — model-replicated; weights: router (D, E),
        # wi/wg (E_local, D/dsz, F), wo (E_local, F, D/dsz)
        b, s, d = x.shape
        t = b * s
        xf = x.reshape(t, d)
        e, k = spec.n_experts, spec.top_k
        cap = _capacity(t, spec)      # per-dp-shard capacity

        # FSDP: reassemble the D-sharded expert weights once per layer
        wi_full = dmesh.all_gather(wi, data_axis, axis=1, tiled=True)
        wg_full = dmesh.all_gather(wg, data_axis, axis=1, tiled=True)
        wo_full = dmesh.all_gather(wo, data_axis, axis=2, tiled=True)

        route = moe_route({"router": router}, xf, spec)
        flat_oh = F.one_hot(route.eidx.reshape(t * k), e)      # (T*K, E)
        pos = ((flat_oh.cumsum(0) - flat_oh) * flat_oh).sum(-1)
        eflat = route.eidx.reshape(t * k)
        keep = pos < cap

        # local dispatch: only this rank's experts; a row that is not
        # this rank's (or dropped) goes to a sink slot past cap
        midx = dmesh.axis_index(model_axis)
        live = keep & ((eflat // e_local) == midx)
        le = (eflat - midx * e_local).clamp(0, e_local - 1)
        slot = pos.clamp_max(cap - 1)
        disp = xf.new_zeros((e_local, cap + 1, d))
        disp[le, torch.where(live, slot, torch.full_like(slot, cap))] = \
            xf.repeat_interleave(k, 0)
        disp = disp[:, :cap]

        h = torch.bmm(disp, wi_full.to(xf.dtype))
        g = torch.bmm(disp, wg_full.to(xf.dtype))
        out_buf = torch.bmm(F.silu(g) * h, wo_full.to(xf.dtype))

        y = out_buf[le, slot] * live[:, None].to(xf.dtype)     # (T*K, D)
        y = (y.reshape(t, k, d)
             * route.gate[..., None].to(xf.dtype)).sum(dim=1)
        # every token's expert output lives on exactly one model rank
        y = dmesh.psum(y, model_axis)

        if shared:
            sh_wi, sh_wg, sh_wo = shared
            # shared expert is TP-sharded over model on F: partial + psum
            hs = F.silu(xf @ sh_wg) * (xf @ sh_wi)
            y = y + dmesh.psum(hs @ sh_wo, model_axis)

        me = route.probs.mean(dim=0)
        ce = flat_oh.reshape(t, k, e).sum(dim=1).float().mean(dim=0)
        balance = spec.balance_coef * e * torch.sum(me * ce) / k
        zloss = spec.router_z_coef * torch.mean(
            torch.square(torch.logsumexp(route.logits, dim=-1)))
        aux = dmesh.pmean(balance + zloss, dp)   # tokens are dp-sharded
        return y.reshape(b, s, d), aux

    in_specs = [P(None, None), WEIGHT_SPECS["wi"], WEIGHT_SPECS["wg"],
                WEIGHT_SPECS["wo"], P(tuple(dp), None, None)]
    if spec.shared_expert:
        in_specs += [SHARED_SPECS[n] for n in ("wi", "wg", "wo")]
    fn = dmesh.shard_map(local, mesh, in_specs=tuple(in_specs),
                         out_specs=(P(tuple(dp), None, None), P()))

    def apply(params, x):
        args = [params["router"], params["wi"], params["wg"], params["wo"],
                x]
        if spec.shared_expert:
            sh = params["shared"]
            args += [sh["wi"], sh["wg"], sh["wo"]]
        y, aux = fn(*args)
        if isinstance(y, Sharded):
            y = y.full(x.device)
        return y, aux.to(x.device)

    return apply


def shard_moe_params(mesh: dmesh.Mesh, ffn, *, stacked: bool = False):
    """An MoE layer's parameters with the expert weights (and the shared
    expert's) placed on the mesh by the specs ``make_moe_ep`` reads them
    with, so each shard keeps its own across calls.  ``stacked``: every
    weight carries a leading layer dimension (the model's stacked blocks;
    indexing a layer then keeps the shards)."""
    lead = (None,) if stacked else ()

    def put(x, spec):
        return mesh.put(x, P(*lead, *spec.entries))

    out = dict(ffn)
    for n, spec in WEIGHT_SPECS.items():
        out[n] = put(ffn[n], spec)
    if "shared" in ffn:
        out["shared"] = {n: put(ffn["shared"][n], spec)
                         for n, spec in SHARED_SPECS.items()}
    return out
