"""Carry the reference's state into the port.

The Tiara state is the memory pool and the encoded operator programs;
the serving stack adds model weights and the decode caches (paged KV,
the recurrent states and the cross-attention KV), and training the
train state (weights, AdamW moments, counters).  The reference
keeps pools and programs as plain numpy
(``int64[n_devices, pool_words]`` pools, ``int64[n, INSTR_WIDTH]``
instruction words), so carrying them across needs no import of the
reference package — only its arrays and, for region tables, any object
with the reference ``RegionTable``'s read surface (``pool_words``,
``as_arrays()`` and iteration over regions with ``.name``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.isa import Op
from repro_torch.core.memory import RegionTable
from repro_torch.core.program import TiaraProgram
from repro_torch.core.vm import resolve_device
from repro_torch.models.attention import PagedKV
from repro_torch.models.blocks import BlockCache
from repro_torch.models.mamba import MambaCache
from repro_torch.models.rwkv import RWKVCache
from repro_torch.models.param import tree_map
from repro_torch.models.transformer import trainable
from repro_torch.training.optimizer import AdamWState, Q8
from repro_torch.training.train_step import TrainState


def pool_from_numpy(mem, device=None) -> torch.Tensor:
    """The reference's ``int64[n_devices, pool_words]`` pool as a device
    tensor (a copy) on ``device`` — the card unless named."""
    arr = np.asarray(mem, dtype=np.int64)
    if arr.ndim != 2:
        raise ValueError(f"pool must be (n_devices, pool_words); got "
                         f"shape {arr.shape}")
    return torch.from_numpy(arr).to(resolve_device(device), copy=True)


def regions_from(table) -> RegionTable:
    """The port's :class:`RegionTable` with the same region ids, names,
    bases, sizes and writability as ``table`` (a reference table or
    view: its ``as_arrays()`` are the backing table's, in rid order)."""
    base, mask, writable = (np.asarray(a, dtype=np.int64)
                            for a in table.as_arrays())
    names = {}
    backing = getattr(table, "table", table)
    for r in backing:
        names[int(r.rid)] = r.name
    rt = RegionTable(int(backing.pool_words))
    for rid in range(base.shape[0]):
        rt.register(names[rid], int(mask[rid]) + 1, base=int(base[rid]),
                    writable=bool(writable[rid]))
    return rt


def _region_sets(code: np.ndarray) -> Tuple[Tuple[int, ...],
                                            Tuple[int, ...]]:
    """Region ids a program touches and writes, derived from its words
    the way the builder declares them: every region an instruction names
    is read; STORE/CAS/CAA and the MEMCPY destination also write."""
    read, written = set(), set()
    for ins in isa.decode_program(code):
        if ins.op == Op.LOAD:
            read.add(int(ins.a))
        elif ins.op in (Op.STORE, Op.CAS, Op.CAA):
            read.add(int(ins.a))
            written.add(int(ins.a))
        elif ins.op == Op.MEMCPY:
            read.update((int(ins.a), int(ins.d)))
            written.add(int(ins.a))
    return tuple(sorted(read)), tuple(sorted(written))


def program_from_code(code, name: str, n_params: int, regions, *,
                      regions_read: Optional[Sequence[int]] = None,
                      regions_written: Optional[Sequence[int]] = None
                      ) -> TiaraProgram:
    """Rebuild the port's :class:`TiaraProgram` from the reference's
    encoded instruction words.  ``regions`` is the table the program was
    built against (reference or port); the declared read/write region
    sets default to the ones the code implies."""
    code = np.asarray(code, dtype=np.int64).reshape(-1, isa.INSTR_WIDTH)
    rd, wr = _region_sets(code)
    return TiaraProgram(
        name=name, code=code.copy(), n_params=int(n_params),
        regions_read=tuple(regions_read) if regions_read is not None
        else rd,
        regions_written=tuple(regions_written)
        if regions_written is not None else wr,
        region_names=tuple(regions.names()))


def params_from_numpy(tree, device=None):
    """The reference's parameter tree, given as numpy arrays (for example
    ``jax.tree_util.tree_map(np.asarray, params)``), as the port's tree of
    tensors on ``device`` — the card unless named.  Names, nesting (dicts
    and the per-pattern tuple under ``blocks``), shapes and dtypes are
    kept; bf16 arrays (numpy has no bf16, JAX gives ``ml_dtypes``) cross
    through f32."""
    dev = resolve_device(device)

    def leaf(a):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return tree_map(leaf, tree)


def caches_from_numpy(caches, device=None):
    """The reference's decode caches — a tuple of ``BlockCache`` per
    pattern element, each leaf stacked ``(n_repeat, ...)``: the ``paged``
    pools, the ``mamba`` (h, conv) and the ``rwkv`` (state, x_time,
    x_chan) states, and an encoder-decoder's ``cross_k`` / ``cross_v``,
    whichever the layer has — as the port's caches on ``device``.  Numpy
    leaves or JAX arrays (read through ``np.asarray``) both cross."""
    fields = (("paged", PagedKV), ("mamba", MambaCache), ("rwkv", RWKVCache))
    out = []
    for c in caches:
        kw = {}
        for name, kind in fields:
            f = getattr(c, name)
            if f is not None:
                kw[name] = kind(*params_from_numpy(tuple(f), device))
        for name in ("cross_k", "cross_v"):
            f = getattr(c, name, None)
            if f is not None:
                kw[name] = params_from_numpy(f, device)
        out.append(BlockCache(**kw))
    return tuple(out)


def _is_q8(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) \
        == ("codes", "scales")


def train_state_from_numpy(state, device=None) -> TrainState:
    """The reference's ``TrainState`` as numpy (``step``, ``params``,
    ``opt`` an ``AdamWState`` of ``count``, ``mu``, ``nu`` whose leaves are
    arrays, or ``Q8`` (codes, scales) pairs under 8-bit state) as the
    port's, on ``device`` — the card unless named; the weights require
    gradients.  Numpy leaves or JAX arrays both cross."""
    dev = resolve_device(device)

    def moment(tree):
        def leaf(x):
            if _is_q8(x):
                return Q8(*params_from_numpy(tuple(x), dev))
            return params_from_numpy(x, dev)
        return tree_map(leaf, tree, is_leaf=_is_q8)
    opt = state.opt
    return TrainState(
        step=params_from_numpy(state.step, dev),
        params=trainable(params_from_numpy(state.params, dev)),
        opt=AdamWState(count=params_from_numpy(opt.count, dev),
                       mu=moment(opt.mu), nu=moment(opt.nu)))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's train state with every tensor copied to a numpy array
    (bf16 as f32, as :func:`params_from_numpy` takes it), in the port's
    ``TrainState`` / ``AdamWState`` / ``Q8`` tuples, whose field names are
    the reference's."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    def moment(tree):
        return tree_map(lambda x: Q8(*map(leaf, x)) if _is_q8(x)
                        else leaf(x), tree, is_leaf=_is_q8)
    return TrainState(step=leaf(state.step),
                      params=tree_map(leaf, state.params),
                      opt=AdamWState(count=leaf(state.opt.count),
                                     mu=moment(state.opt.mu),
                                     nu=moment(state.opt.nu)))
