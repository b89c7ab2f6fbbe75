"""Parameter descriptors: shape + initializer, as one tree.

Modules describe their parameters as ``ParamDef`` trees (nested dicts and
tuples, the reference's tree shape); ``materialize`` turns a def-tree into
a tensor-tree.  The shapes, init kinds and fan-in scales are the
reference's; the draws come from an explicit ``torch.Generator`` and are
not JAX's values — weights cross between the frameworks as numpy arrays
(``repro_torch.convert.params_from_numpy``).  The reference's
``PartitionSpec`` has no counterpart until the sharded slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    fan_in: Optional[int] = None  # overrides shape[-2] for scaled init

    def instantiate(self, generator: torch.Generator,
                    dtype: torch.dtype) -> torch.Tensor:
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=dev)
        if self.init == "embed":
            scale = 1.0
        else:
            fan = self.fan_in if self.fan_in is not None else (
                self.shape[-2] if len(self.shape) >= 2 else self.shape[-1])
            scale = fan ** -0.5
        # scaled in place: one f32 buffer at a time (a full-width
        # expert stack is gigabytes)
        return torch.randn(self.shape, generator=generator,
                           dtype=torch.float32, device=dev) \
            .mul_(scale).to(dtype)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable[[Any], Any], tree, is_leaf=None):
    """Map over the leaves of a tree of dicts, tuples and lists (dict keys
    in sorted order, as ``jax.tree_util`` walks them)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf=None) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf)
    return out


def materialize(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32):
    """Instantiate a ParamDef tree into tensors, leaf by leaf in tree
    order from one generator."""
    return tree_map(lambda d: d.instantiate(generator, dtype), defs,
                    is_leaf=is_def)


def stack_defs(defs, n: int):
    """Prepend a stacking dim of ``n`` (layer repeats) to every def."""
    def bump(d: ParamDef) -> ParamDef:
        return ParamDef(shape=(n,) + tuple(d.shape), init=d.init,
                        fan_in=d.fan_in if d.fan_in is not None else (
                            d.shape[-2] if len(d.shape) >= 2 else None))
    return tree_map(bump, defs, is_leaf=is_def)


def count_params(tree) -> int:
    """Elements in a tree of tensors or of ParamDefs."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))
