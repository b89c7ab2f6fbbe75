"""Train-step builder: loss, gradient accumulation, remat (``cfg.remat``,
in the model), an optional gradient compressor.

The reference's ``training/train_step.py`` in PyTorch: ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the parameter tree's tensors, and the
micro-batch ``lax.scan`` a Python loop that sums the gradients in f32.  On
the card the attention runs through ``flash_attention``'s forward and
backward kernels.  The step updates the state in place (the optimizer's
docstring says why) and returns it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            make_adamw)


class TrainState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    params: Any
    opt: AdamWState


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, z_coef: float = 1e-4):
    """Next-token cross entropy + z-loss; logits f32 (B, S, V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    per_tok = nll + z_coef * torch.square(logz)
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    mask = mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(per_tok * mask) / denom
    return loss, {"nll": torch.sum(nll * mask) / denom}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    micro_batches: int = 1,
                    grad_compressor: Optional[Callable] = None):
    """Returns (init_state_fn, train_step_fn).

    ``init_state(seed=0, device=None, generator=None)`` draws the weights
    with ``tf.init_params`` on ``device`` (the card unless named), marks
    them as requiring gradients and builds the optimizer state.
    ``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    tensors on the state's device (``tokens``, ``labels``, optional
    ``loss_mask`` and the model's extra inputs).  ``grad_compressor``:
    optional fn(grads) -> grads between the accumulation and the optimizer
    (``distributed.compression.make_grad_compressor``: the int8
    all-reduce over a mesh's pod axis)."""
    opt_init, opt_update = make_adamw(opt_cfg)

    def init_state(seed: int = 0, *, device=None,
                   generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        params = tf.trainable(tf.init_params(cfg, seed, device=device,
                                             generator=generator))
        dev = tree_leaves(params)[0].device
        return TrainState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          params=params, opt=opt_init(params))

    def loss_fn(params, batch):
        out = tf.apply_model(params, cfg, batch, mode="train")
        loss, m = lm_loss(out.logits, batch["labels"],
                          batch.get("loss_mask"))
        return loss + out.aux_loss, {**m, "aux": out.aux_loss,
                                     "loss": loss}

    def one_micro(params, mbatch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            total, metrics = loss_fn(params, mbatch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        if micro_batches <= 1:
            grads, metrics = one_micro(params, batch)
        else:
            def part(x, i):
                return x.reshape((micro_batches,
                                  x.shape[0] // micro_batches)
                                 + tuple(x.shape[1:]))[i]
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            for i in range(micro_batches):
                g, metrics = one_micro(
                    params, {k: part(v, i) for k, v in batch.items()})
                for a, gi in zip(grads, g):
                    a.add_(gi.float())
            grads = [a / micro_batches for a in grads]
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        params, opt, opt_metrics = opt_update(grads, state.opt, params)
        state.step.add_(1)
        return TrainState(step=state.step, params=params, opt=opt), \
            {**metrics, **opt_metrics}

    return init_state, train_step
