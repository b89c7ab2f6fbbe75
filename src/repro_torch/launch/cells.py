"""Dry-run cells: (arch x shape x mesh) -> step fn + arg specs + shardings
(port of ``repro.launch.cells``).

``make_cell()`` bundles the step function with its arguments as empty
``meta`` tensors (the reference's ``ShapeDtypeStruct`` stand-ins: no
allocation), their partition specs (the port's
:class:`~repro_torch.distributed.mesh.P`) and the donated arguments.
``cell.fn`` runs on any tensors: the ``meta`` ones of the dry-run, or
real ones of the same shapes on the CPU or the card.

The reference lowers a cell with ``jax.jit(...).lower()`` on the mesh;
the port has no compiler and no partitioner, so :func:`trace_cell` runs
``cell.fn`` once on the ``meta`` args under counters instead: the FLOPs,
the bytes every op reads and writes, the collectives and the peak bytes
of live storage (``roofline/analysis.py``).  A baseline cell runs
unsharded (its specs say how the reference would lay it out; the byte
counts per device come from them in ``launch/dryrun.py``); only the
variants built on ``shard_map`` (``tiara_decode*``, ``moe_ep*``) run per
shard and make collectives.

The attention runs the plain route by default, the reference's
``attn_impl="xla"`` (``FlopCounterMode`` cannot see the hand-written
kernels): ``cfg.attn_fn`` and ``cfg.paged_attn_fn`` call the plain
versions by name on any device, each counted as one op, as the kernel it
stands for is one.  ``attn_impl="cuda"`` builds the same cell on the
kernels' route instead (for the card).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ArchConfig, ShapeSpec, cell_applicable
from repro_torch.distributed.mesh import Mesh, P
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.launch.mesh import dp_axes, dp_size
from repro_torch.models import transformer as tf
from repro_torch.models.attention import PagedKV, append_token_kv
from repro_torch.models.blocks import BlockCache
from repro_torch.models.mamba import MambaCache
from repro_torch.models.param import tree_map
from repro_torch.models.rwkv import RWKVCache
from repro_torch.roofline import analysis as ra
from repro_torch.training.optimizer import (Q8, AdamWConfig, AdamWState,
                                            warmup_cosine)
from repro_torch.training.train_step import TrainState, make_train_step


@dataclasses.dataclass
class Cell:
    cfg: ArchConfig
    shape: ShapeSpec
    fn: Callable                 # the step function
    args: Tuple                  # trees of meta tensors
    in_specs: Tuple              # trees of P
    out_specs: Any               # tree of P
    donate: Tuple[int, ...] = ()


def _b(dp, size_b: int, dpsz: int):
    """Batch-dim spec: shard over dp when it divides, else replicate."""
    return dp if size_b % dpsz == 0 and size_b >= dpsz else None


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _train_batch(cfg: ArchConfig, shape: ShapeSpec, dp, dpsz):
    b, s = shape.global_batch, shape.seq_len
    bspec = _b(dp, b, dpsz)
    args = {"tokens": _sds((b, s), torch.int32),
            "labels": _sds((b, s), torch.int32)}
    specs = {"tokens": P(bspec, None), "labels": P(bspec, None)}
    _add_modality(cfg, args, specs, b, s, bspec)
    return args, specs


def _add_modality(cfg, args, specs, b, s, bspec, *, dtype=None):
    dtype = dtype or tf.model_dtype(cfg.dtype)
    if cfg.rope == "mrope":
        args["positions3"] = _sds((3, b, s), torch.int32)
        specs["positions3"] = P(None, bspec, None)
        args["embeds"] = _sds((b, s, cfg.d_model), dtype)
        specs["embeds"] = P(bspec, None, None)
    if cfg.enc_dec:
        args["enc_embeds"] = _sds((b, s, cfg.d_model), dtype)
        specs["enc_embeds"] = P(bspec, None, None)
        args["enc_lengths"] = _sds((b,), torch.int32)
        specs["enc_lengths"] = P(bspec)


def _cache_structs_and_specs(cfg: ArchConfig, b: int, maxp: int, dp, dpsz,
                             cross_len: int = 0, pool_all_axes=None):
    structs = tf.init_caches(cfg, b, maxp, cross_len=cross_len,
                             device="meta")
    bspec = _b(dp, b, dpsz)
    pool_spec = dp          # pool = b * maxp, page-granular "memory pool"
    specs = []
    for struct_el in structs:
        paged = mamba = rwkv = cross_k = cross_v = None
        if struct_el.paged is not None:
            if pool_all_axes is not None:
                # one-round variant: whole pages fully distributed over
                # every mesh axis; they never cross the wire
                pg = P(None, pool_all_axes, None, None, None)
            else:
                # baseline: pool over the dp bundle (pages are batch-
                # owned); the *page* (token-slot) dim over model
                pg = P(None, pool_spec, "model", None, None)
            paged = PagedKV(pg, pg)
        if struct_el.mamba is not None:
            mamba = MambaCache(h=P(None, bspec, "model", None),
                               conv=P(None, bspec, None, "model"))
        if struct_el.rwkv is not None:
            rwkv = RWKVCache(state=P(None, bspec, "model", None, None),
                             x_time=P(None, bspec, None),
                             x_chan=P(None, bspec, None))
        if struct_el.cross_k is not None:
            cross_k = P(None, bspec, None, "model", None)
            cross_v = P(None, bspec, None, "model", None)
        specs.append(BlockCache(paged=paged, mamba=mamba, rwkv=rwkv,
                                cross_k=cross_k, cross_v=cross_v))
    return structs, tuple(specs)


# ---------------------------------------------------------------------------
# The plain attention route
# ---------------------------------------------------------------------------


def _as_one_op(name: str, fn, *args, **kwargs):
    """``fn(...)``, counted as one op by an active byte counter."""
    counter = ra.ByteCounter.active()
    if counter is None:
        return fn(*args, **kwargs)
    return counter.one_op(name, fn, *args, **kwargs)


def _plain_attention(q, k, v, lengths, *, causal: bool):
    return _as_one_op("flash_attention", flash_attention_plain, q, k, v,
                      lengths, causal=causal)


def _plain_paged_decode(q, k_pages, v_pages, new_k, new_v, block_tables,
                        lengths):
    """The unsharded decode's append and attention, the attention being
    the plain version (``cfg.paged_attn_fn``'s signature)."""
    append_token_kv(PagedKV(k_pages, v_pages), new_k, new_v, block_tables,
                    lengths)
    out = _as_one_op("paged_attention", paged_attention_plain, q, k_pages,
                     v_pages, block_tables.to(torch.int32), lengths + 1)
    return out, k_pages, v_pages


def plain_route(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with the prefill/train attention and the paged decode
    attention on their plain versions, on any device (a hook the config
    already holds — a sharded decode — is kept)."""
    return cfg.replace(attn_impl="torch", attn_fn=_plain_attention,
                       paged_attn_fn=cfg.paged_attn_fn
                       or _plain_paged_decode)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def make_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh, *,
              state_bits: int = 32, variant: str = "baseline",
              attn_impl: str = "torch") -> Optional[Cell]:
    """The cell, or None where ``cell_applicable`` refuses it.
    ``attn_impl="torch"`` runs the plain attention (the dry-run's route);
    ``"cuda"`` or ``"auto"`` the kernels' (the card's)."""
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return None
    dp = dp_axes(mesh)
    dpsz = dp_size(mesh)
    b, s = shape.global_batch, shape.seq_len
    bspec = _b(dp, b, dpsz)
    pool_all_axes = None
    if variant in ("tiara_decode", "tiara_decode_v2") \
            and shape.kind == "decode":
        from repro_torch.distributed.paged_decode import \
            sharded_paged_attention
        cfg = cfg.replace(
            paged_attn_fn=sharded_paged_attention(
                mesh, dp, "model",
                contiguous=(variant == "tiara_decode_v2"),
                batch_sharded=bspec is not None))
        pool_all_axes = tuple(dp) + ("model",)
    elif variant == "remat_layer":
        cfg = cfg.replace(remat_unit="layer")
    elif variant == "moe_hints":
        cfg = cfg.replace(moe_hints=True)
    elif variant == "remat_layer+moe_hints":
        cfg = cfg.replace(remat_unit="layer", moe_hints=True)
    elif variant in ("moe_ep", "moe_ep+remat_layer"):
        from repro_torch.distributed.moe_ep import make_moe_ep
        moe_specs = {sp.moe for sp in cfg.pattern if sp.moe is not None}
        assert len(moe_specs) == 1, "one MoE spec per arch"
        cfg = cfg.replace(
            moe_fn=make_moe_ep(mesh, dp, next(iter(moe_specs))),
            remat_unit="layer" if "remat" in variant else cfg.remat_unit)
    elif variant not in ("baseline", "tiara_decode", "tiara_decode_v2"):
        raise ValueError(f"unknown variant {variant!r}")
    cfg = plain_route(cfg) if attn_impl == "torch" \
        else cfg.replace(attn_impl=attn_impl)
    pspecs = tf.param_specs(cfg)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(lr=warmup_cosine(3e-4, 100, 10_000),
                              state_bits=state_bits)
        init_state, train_step = make_train_step(cfg, opt_cfg)
        state_struct = init_state(device="meta")
        if state_bits == 8:
            # scales mirror the codes' leading-dim sharding (the last
            # dim collapses into per-block scales)
            mu_spec = tree_map(
                lambda sp: Q8(codes=sp,
                              scales=P(*sp.entries[:-1], None)
                              if len(sp) else P()),
                pspecs, is_leaf=lambda x: isinstance(x, P))
        else:
            mu_spec = pspecs
        state_spec = TrainState(step=P(), params=pspecs,
                                opt=AdamWState(count=P(), mu=mu_spec,
                                               nu=mu_spec))
        batch_struct, batch_spec = _train_batch(cfg, shape, dp, dpsz)
        metrics_spec = {k: P() for k in
                        ("nll", "aux", "loss", "grad_norm", "lr")}
        return Cell(cfg=cfg, shape=shape, fn=train_step,
                    args=(state_struct, batch_struct),
                    in_specs=(state_spec, batch_spec),
                    out_specs=(state_spec, metrics_spec),
                    donate=(0,))

    # serving shapes
    param_struct = tf.param_shapes(cfg)
    maxp = s // cfg.page_size + (1 if shape.kind == "decode" else 0)
    maxp = (maxp + 63) // 64 * 64      # pool divisibility on the dp bundle
    if pool_all_axes is not None:
        # pool (= b * maxp) must divide the full chip count for the
        # fully-distributed page layout
        chips = dpsz * mesh.shape["model"]
        need = chips // math.gcd(b, chips)
        maxp = (maxp + need - 1) // need * need
    cross_len = s if cfg.enc_dec else 0
    cache_structs, cache_specs = _cache_structs_and_specs(
        cfg, b, maxp, dp, dpsz, cross_len=cross_len,
        pool_all_axes=pool_all_axes)

    if shape.kind == "prefill":
        batch = {"tokens": _sds((b, s), torch.int32),
                 "block_tables": _sds((b, maxp), torch.int32),
                 "lengths": _sds((b,), torch.int32)}
        bsp = {"tokens": P(bspec, None), "block_tables": P(bspec, None),
               "lengths": P(bspec)}
        _add_modality(cfg, batch, bsp, b, s, bspec)

        def prefill_step(params, caches, batch):
            out = tf.apply_model(params, cfg, {**batch, "caches": caches},
                                 mode="prefill")
            idx = torch.clamp(batch["lengths"].long() - 1, min=0)
            last = out.logits.gather(
                1, idx[:, None, None].expand(-1, 1, out.logits.shape[-1]))
            return last[:, 0], out.caches

        out_specs = (P(bspec, "model"), cache_specs)
        return Cell(cfg=cfg, shape=shape, fn=prefill_step,
                    args=(param_struct, cache_structs, batch),
                    in_specs=(pspecs, cache_specs, bsp),
                    out_specs=out_specs, donate=(1,))

    # decode: one new token against a seq_len-token cache
    batch = {"tokens": _sds((b, 1), torch.int32),
             "block_tables": _sds((b, maxp), torch.int32),
             "lengths": _sds((b,), torch.int32)}
    bsp = {"tokens": P(bspec, None), "block_tables": P(bspec, None),
           "lengths": P(bspec)}
    if cfg.rope == "mrope":
        batch["positions3"] = _sds((3, b, 1), torch.int32)
        bsp["positions3"] = P(None, bspec, None)
    if cfg.enc_dec:
        batch["enc_lengths"] = _sds((b,), torch.int32)
        bsp["enc_lengths"] = P(bspec)

    def decode_step(params, caches, batch):
        out = tf.apply_model(params, cfg, {**batch, "caches": caches},
                             mode="decode")
        return out.logits[:, 0], out.caches

    out_specs = (P(bspec, "model"), cache_specs)
    return Cell(cfg=cfg, shape=shape, fn=decode_step,
                args=(param_struct, cache_structs, batch),
                in_specs=(pspecs, cache_specs, bsp),
                out_specs=out_specs, donate=(1,))


# ---------------------------------------------------------------------------
# Tracing (the counterpart of lower_cell)
# ---------------------------------------------------------------------------


class Trace(NamedTuple):
    flops: int                   # whole program, every shard
    bytes: int                   # every op's inputs and outputs
    peak_bytes: int              # live storage allocated by the step
    coll_per_kind: Dict[str, int]   # result bytes per device, per kind
    coll_counts: Dict[str, int]
    out: Any                     # the step's outputs (meta tensors)
    seconds: float


def trace_cell(cell: Cell, mesh: Optional[Mesh] = None,
               args: Optional[Tuple] = None) -> Trace:
    """Run ``cell.fn`` once on ``args`` (the cell's ``meta`` args unless
    given) under ``FlopCounterMode``, a :class:`~repro_torch.roofline.
    analysis.ByteCounter` and ``mesh``'s collective counters (reset
    first)."""
    args = cell.args if args is None else args
    flops = FlopCounterMode(display=False)
    counter = ra.ByteCounter()
    counter.ignore_storages(args)
    if mesh is not None:
        mesh.reset_stats()
    t0 = time.time()
    with flops, counter:
        out = cell.fn(*args)
    seconds = time.time() - t0
    if mesh is not None:
        _, coll = ra.collective_bytes(mesh)
        counts = ra.collective_counts(mesh)
    else:
        coll, counts = {}, {k: 0 for k in ra.COLLECTIVE_KINDS}
    return Trace(flops=int(flops.get_total_flops()), bytes=counter.bytes,
                 peak_bytes=counter.peak_bytes, coll_per_kind=coll,
                 coll_counts=counts, out=out, seconds=seconds)
