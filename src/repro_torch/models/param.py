"""Parameter descriptors: shape + sharding spec + initializer, as one tree.

Modules describe their parameters as ``ParamDef`` trees (nested dicts and
tuples, the reference's tree shape); ``materialize`` turns a def-tree into
a tensor-tree and ``spec_tree`` extracts the partition-spec tree (the
port's :class:`~repro_torch.distributed.mesh.P`) that the dry-run and the
distributed layer place the weights by.  The shapes, specs, init kinds and
fan-in scales are the reference's; the draws come from an explicit
``torch.Generator`` and are not JAX's values — weights cross between the
frameworks as numpy arrays (``repro_torch.convert.params_from_numpy``).
On the ``meta`` device nothing is drawn: ``shape_tree`` builds the empty
tensors there directly, as the reference's dry-run uses
``ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.distributed.mesh import P


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    fan_in: Optional[int] = None  # overrides shape[-2] for scaled init
    # a keyword, unlike the reference's second field: the port's call
    # sites pass the shape alone positionally
    spec: P = dataclasses.field(default=P(), kw_only=True)

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


def _rebuild(tree, children):
    if hasattr(tree, "_fields"):                # a NamedTuple
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable[[Any], Any], tree, is_leaf=None):
    """Map over the leaves of a tree of dicts, tuples (NamedTuples too)
    and lists (dict keys in sorted order, as ``jax.tree_util`` walks
    them)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [tree_map(fn, t, is_leaf) for t in tree])
    return fn(tree)


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree,
                       is_leaf=None, _path: Tuple = ()):
    """:func:`tree_map` with ``fn(path, leaf)``: ``path`` holds the dict
    keys, NamedTuple field names and sequence indices from the root (the
    reference's ``tree_flatten_with_path`` keys)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(_path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], is_leaf, _path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        return _rebuild(tree, [
            tree_map_with_path(fn, t, is_leaf, _path + (n,))
            for n, t in zip(names, tree)])
    return fn(_path, tree)


def tree_leaves(tree, is_leaf=None) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf)
    return out


def tree_leaves_with_path(tree, is_leaf=None) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in tree order, ``None`` leaves left out (an
    empty subtree, as in ``jax.tree_util``)."""
    out: List[Tuple[Tuple, Any]] = []

    def keep(path, leaf):
        if leaf is not None:
            out.append((path, leaf))
    tree_map_with_path(keep, tree, is_leaf)
    return out


def materialize(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32):
    """Instantiate a ParamDef tree into tensors, leaf by leaf in tree
    order from one generator (on ``meta``, :func:`shape_tree` builds the
    tree with no draw)."""
    return tree_map(lambda d: d.instantiate(generator, dtype), defs,
                    is_leaf=is_def)


def spec_tree(defs):
    return tree_map(lambda d: d.spec, defs, is_leaf=is_def)


def shape_tree(defs, dtype: torch.dtype = torch.float32):
    """A tree of empty tensors on ``meta`` — the reference's
    ``ShapeDtypeStruct`` tree, used by the dry-run (no allocation)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"),
                    defs, is_leaf=is_def)


def stack_defs(defs, n: int):
    """Prepend a stacking dim of ``n`` (layer repeats) to every def, and
    ``None`` to its spec."""
    def bump(d: ParamDef) -> ParamDef:
        return ParamDef(shape=(n,) + tuple(d.shape),
                        spec=P(*((None,) + tuple(d.spec.entries))),
                        init=d.init,
                        fan_in=d.fan_in if d.fan_in is not None else (
                            d.shape[-2] if len(d.shape) >= 2 else None))
    return tree_map(bump, defs, is_leaf=is_def)


def count_params(tree) -> int:
    """Elements in a tree of tensors or of ParamDefs."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))
