"""Pattern-stacked transformer covering every family of the reference:
dense, MoE, hybrid Mamba + attention, attention-free RWKV, the vision
decoder with M-RoPE, and the encoder-decoder (an encoder stack, then a
decoder whose blocks cross-attend the encoder's output).  Modality
frontends are stubs that supply precomputed embeddings, as in the
reference.

The reference stacks the repeating layer pattern per pattern element and
runs one ``lax.scan`` over repetitions.  The port keeps the stacked
leading layer dimension of every parameter and cache leaf — so weights
cross between the frameworks by name and shape — and walks the
repetitions with a Python loop.

Three modes share one code path:
  train    full-sequence forward, no caches, differentiable: when
           gradients flow to the blocks' weights, ``cfg.remat``
           checkpoints the decoder stack as the reference's
           ``jax.checkpoint`` does, through ``torch.utils.checkpoint``
           (non-reentrant) around each pattern repetition, or each layer
           under ``remat_unit="layer"``; ``"full"`` saves nothing inside,
           ``"dots"`` saves the outputs of the matrix products with no
           batch dims, ``"none"`` checkpoints nothing.  Remat changes
           memory, never values;
  prefill  full-sequence forward that fills the paged KV pool and the
           recurrent states (``lengths`` marks right-padding);
  decode   one token per sequence against the paged pool (Tiara path)
           and the recurrent states.

Parameters are a nested dict of tensors with the reference tree's names
(``embed/tokens``, ``blocks[j]/mix/wq``, ...).  :class:`Transformer` holds
them as an ``nn.Module`` for ``.to(device)`` and ``state_dict()``; its
``forward`` calls :func:`apply_model`.  :func:`trainable` marks a tree's
tensors (the module's too) as requiring gradients, in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.core.vm import resolve_device
from repro_torch.models.blocks import (BlockCache, block_apply, block_defs,
                                       init_block_cache)
from repro_torch.models.layers import (apply_norm, embed, embed_defs,
                                       norm_defs, unembed)
from repro_torch.models.param import (materialize, shape_tree, spec_tree,
                                      stack_defs, tree_leaves, tree_map)


def model_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``cfg.dtype``, ``cfg.param_dtype``) as a
    torch dtype."""
    return getattr(torch, name)


ENC_SPEC = LayerSpec(kind="attn", mlp="gelu")


def model_defs(cfg: ArchConfig):
    defs: Dict[str, Any] = {
        "embed": embed_defs(cfg.vocab_padded, cfg.d_model,
                            cfg.tie_embeddings),
        "final_norm": norm_defs(cfg.norm, cfg.d_model),
        "blocks": tuple(stack_defs(block_defs(cfg, spec, cross=cfg.enc_dec),
                                   cfg.n_repeat)
                        for spec in cfg.pattern),
    }
    if cfg.enc_dec:
        defs["encoder"] = {
            "blocks": stack_defs(block_defs(cfg, ENC_SPEC),
                                 cfg.n_enc_layers),
            "final_norm": norm_defs(cfg.norm, cfg.d_model),
        }
    return defs


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None,
                generator: Optional[torch.Generator] = None):
    """Random weights, drawn leaf by leaf in tree order and placed on
    ``device`` (the card unless named).  By default they come from a CPU
    ``torch.Generator`` seeded with ``seed``: the same values whatever the
    device.  A caller may pass its own seeded ``generator`` instead
    (``seed`` is then unused), for example one on the card, which draws a
    full-width model there without a pass through host memory; its values
    are that generator's.  On ``device="meta"`` nothing is drawn: the
    tensors are built there directly (:func:`param_shapes`)."""
    device = resolve_device(device)
    dtype = dtype or model_dtype(cfg.param_dtype)
    if device.type == "meta":
        # the structure only, built on meta directly: nothing is drawn
        return param_shapes(cfg, dtype)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(int(seed))
    params = materialize(model_defs(cfg), gen, dtype)
    return tree_map(lambda a: a.to(device), params)


def param_specs(cfg: ArchConfig):
    """The partition-spec tree of the weights (the reference's)."""
    return spec_tree(model_defs(cfg))


def param_shapes(cfg: ArchConfig, dtype=None):
    """The weights as empty tensors on ``meta`` (no allocation)."""
    return shape_tree(model_defs(cfg), dtype or model_dtype(cfg.param_dtype))


def trainable(params):
    """Mark every tensor of a parameter tree as requiring gradients, in
    place (no copy), and return the tree: ``init_params``'s draws and a
    :class:`Transformer`'s weights hold none."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _map_cache(fn, cache: BlockCache) -> BlockCache:
    """``fn`` over every tensor of a layer cache, keeping its structure."""
    return BlockCache(*(None if f is None
                        else fn(f) if isinstance(f, torch.Tensor)
                        else type(f)(*map(fn, f)) for f in cache))


def init_caches(cfg: ArchConfig, batch: int, max_pages: int, *,
                dtype=None, n_pages: Optional[int] = None,
                cross_len: int = 0, device=None):
    """One stacked BlockCache per pattern element, each leaf with a
    leading ``n_repeat`` dim, on ``device`` (the card unless named).  The
    paged pool gives each (layer, sequence) its own pages: ``n_pages``
    defaults to ``batch * max_pages`` (the serving engine asks for one
    scratch page more); the recurrent layers keep ``batch`` states; an
    encoder-decoder's layers keep ``cross_len`` encoder positions of
    cross-attention KV (S_enc of the prefill's ``enc_embeds``)."""
    dtype = dtype or model_dtype(cfg.dtype)
    device = resolve_device(device)
    pool = batch * max_pages if n_pages is None else int(n_pages)
    return tuple(
        _map_cache(lambda a: a.new_zeros((cfg.n_repeat,) + a.shape),
                   init_block_cache(cfg, spec, batch, pool, dtype,
                                    cross_len=cross_len if cfg.enc_dec
                                    else 0, device=device))
        for spec in cfg.pattern)


def default_block_tables(cfg: ArchConfig, batch: int, max_pages: int,
                         device=None) -> torch.Tensor:
    """Identity allocation: sequence b owns pages [b*maxp, (b+1)*maxp)."""
    return (torch.arange(batch, dtype=torch.int32, device=device)[:, None]
            * max_pages
            + torch.arange(max_pages, dtype=torch.int32, device=device)[None])


def _layer_cache(stacked: BlockCache, r: int) -> BlockCache:
    """Repetition ``r`` of a stacked cache: views, so in-place writes land
    in the stacked caches."""
    return _map_cache(lambda a: a[r], stacked)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class ModelOutput(NamedTuple):
    logits: torch.Tensor
    caches: Optional[Tuple]
    aux_loss: torch.Tensor


def _run_encoder(params, cfg: ArchConfig, enc_embeds, enc_lengths):
    """The encoder stack: non-causal, RoPE positions ``arange(S)``, mode
    "train", then its final norm.  ``enc_lengths`` rides in the context
    as the reference's does, where no encoder layer reads it: the
    encoder's self-attention attends the padded frames of a ragged batch
    too (only the decoder's cross attention masks them)."""
    x = enc_embeds.to(model_dtype(cfg.dtype))
    s = x.shape[1]
    ctx = {"causal": False,
           "positions": torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None],
           "lengths": enc_lengths}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["encoder"]["blocks"]
    for i in range(cfg.n_enc_layers):
        x, _, a = block_apply(tree_map(lambda t, i=i: t[i], blocks), x, cfg,
                              ENC_SPEC, mode="train", ctx=ctx)
        aux = aux + a
    return apply_norm(cfg.norm, params["encoder"]["final_norm"], x), aux


def apply_model(params, cfg: ArchConfig, batch: Dict[str, Any], *,
                mode: str = "train") -> ModelOutput:
    """batch keys: tokens (B,S) int; optional embeds (B,S,D) added to the
    token embeddings; positions (B,S); positions3 (3,B,S) (M-RoPE, in
    every mode); enc_embeds (B,S_enc,D) / enc_lengths (B,)
    (encoder-decoder: the encoder runs in train and prefill, decode reads
    the cross caches); caches, block_tables, lengths (prefill/decode).
    The caches are updated in place and returned."""
    dtype = model_dtype(cfg.dtype)
    x = embed(params["embed"], batch["tokens"], dtype)
    if batch.get("embeds") is not None:
        x = x + batch["embeds"].to(dtype)
    ctx: Dict[str, Any] = {
        "positions": batch.get("positions"),
        "positions3": batch.get("positions3"),
        "causal": True,
        "block_tables": batch.get("block_tables"),
        "lengths": batch.get("lengths"),
    }
    enc_aux = None
    if cfg.enc_dec:
        ctx["enc_lengths"] = batch.get("enc_lengths")
        if mode != "decode":
            ctx["enc_out"], enc_aux = _run_encoder(
                params, cfg, batch["enc_embeds"], batch.get("enc_lengths"))
    caches = batch.get("caches")

    def one_layer(h, aux, r, j):
        bp = tree_map(lambda a: a[r], params["blocks"][j])
        bc = None if caches is None else _layer_cache(caches[j], r)
        h, _, a = block_apply(bp, h, cfg, cfg.pattern[j], mode=mode,
                              ctx=ctx, cache=bc)
        return h, aux + a

    grads_flow = mode == "train" and torch.is_grad_enabled() and any(
        p.requires_grad for p in tree_leaves(params["blocks"]))
    remat = _remat(cfg) if grads_flow else None
    if remat is not None and cfg.remat_unit == "layer":
        layer = functools.partial(remat, one_layer)
    else:
        layer = one_layer

    def one_repetition(h, aux, r):
        for j in range(len(cfg.pattern)):
            h, aux = layer(h, aux, r, j)
        return h, aux

    if remat is not None and cfg.remat_unit != "layer":
        repetition = functools.partial(remat, one_repetition)
    else:
        repetition = one_repetition
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.n_repeat):
        x, aux = repetition(x, aux, r)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = unembed(params["embed"], x, cfg.vocab)
    if enc_aux is not None:
        aux = aux + enc_aux
    return ModelOutput(logits=logits, caches=caches, aux_loss=aux)


# The matrix products with no batch dims (``x @ w``): what the reference's
# ``dots_with_no_batch_dims_saveable`` keeps under ``remat="dots"``.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig):
    """``fn(*args)`` under the checkpoint ``cfg.remat`` names, or None for
    ``"none"``; any other value recomputes everything, as the reference's
    ``nothing_saveable``."""
    if cfg.remat == "none":
        return None
    kw: Dict[str, Any] = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, **kw)


def prefill(params, cfg: ArchConfig, batch):
    return apply_model(params, cfg, batch, mode="prefill")


def decode_step(params, cfg: ArchConfig, batch):
    return apply_model(params, cfg, batch, mode="decode")


# ---------------------------------------------------------------------------
# Module holder
# ---------------------------------------------------------------------------


def _to_module(tree) -> nn.Module:
    if isinstance(tree, tuple):
        return nn.ModuleList([_to_module(t) for t in tree])
    mod = nn.Module()
    for name, val in tree.items():
        if isinstance(val, torch.Tensor):
            mod.register_parameter(name, nn.Parameter(val,
                                                      requires_grad=False))
        else:
            mod.add_module(name, _to_module(val))
    return mod


def _to_tree(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return tuple(_to_tree(m) for m in mod)
    out: Dict[str, Any] = dict(mod.named_parameters(recurse=False))
    out.update({name: _to_tree(m) for name, m in mod.named_children()})
    return out


class Transformer(nn.Module):
    """The parameter tree as a module: ``state_dict()`` keys are the tree's
    paths under ``tree.`` (``tree.blocks.0.mix.wq``), ``.to(device)``
    moves every weight, and
    ``forward`` runs :func:`apply_model`."""

    def __init__(self, cfg: ArchConfig, params) -> None:
        super().__init__()
        self.cfg = cfg
        self.tree = _to_module(params)

    @property
    def params(self):
        """The nested-dict view of the weights, the reference tree's
        layout."""
        return _to_tree(self.tree)

    def forward(self, batch: Dict[str, Any], mode: str = "train"
                ) -> ModelOutput:
        return apply_model(self.params, self.cfg, batch, mode=mode)
