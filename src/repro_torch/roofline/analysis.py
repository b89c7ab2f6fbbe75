"""Roofline terms from a traced step (port of
``repro.roofline.analysis``).

    compute    = FLOPs / (chips x 989e12 FLOP/s)
    memory     = bytes / (chips x 3.35e12 B/s)
    collective = collective bytes / (chips x 450e9 B/s)

The constants are the NVIDIA H100 SXM5's published figures, where the
reference's are TPU v5e-class: ``PEAK_FLOPS`` is its dense bf16 tensor
core peak (989 TFLOP/s, no sparsity), ``HBM_BW`` its HBM3 bandwidth
(3.35 TB/s), and ``NVLINK_BW`` takes the place of the reference's
``ICI_BW``: NVLink 4's 450 GB/s per direction per GPU (900 GB/s both
ways).

The counts come from running the step once on ``meta`` tensors
(``launch/cells.trace_cell``), where the reference reads the compiled
program: FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (the
reference's ``cost_analysis()["flops"]``), bytes from
:class:`ByteCounter`, a dispatch mode that adds up every op's input and
output bytes (``"bytes accessed"``), and the collectives from the mesh's
counters (:func:`collective_bytes`, :func:`collective_counts`: one count
per op, each op's result bytes on one participating device, as the
reference reads them off the HLO's result shapes).  A step that runs no
``shard_map`` records no collective: the port has no partitioner, so the
collectives the reference's GSPMD inserts into an unsharded program have
no counterpart here.
MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) exposes remat/routing
waste via the MODEL/traced ratio.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack)

from repro_torch.models.param import tree_leaves_with_path

PEAK_FLOPS = 989e12          # H100 SXM5, dense bf16 per GPU
HBM_BW = 3.35e12             # H100 SXM5 HBM3, B/s per GPU
NVLINK_BW = 450e9            # H100 NVLink 4, B/s per direction per GPU

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_bytes(mesh) -> Tuple[int, Dict[str, int]]:
    """Result bytes of the mesh's collectives since its last
    ``reset_stats``: (total, per kind).

    Counts each op once by its result on one participating device (the
    payload that crosses the interconnect per device, up to the op's
    algorithmic factor — all-reduce moves ~2x in a ring; the raw bytes
    are reported and the factors applied in the term computation)."""
    per_kind = mesh.collective_result_bytes()
    return sum(per_kind.values()), per_kind


def collective_counts(mesh) -> Dict[str, int]:
    calls = mesh.collective_counts()
    return {kind: int(calls.get(kind, 0)) for kind in COLLECTIVE_KINDS}


# algorithmic on-wire factors per collective (ring algorithms), applied to
# the result bytes counted above
_ALGO_FACTOR = {
    "all-gather": 1.0,        # result is the gathered (full) buffer
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,    # input-sized traffic, result is the shard
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class Roofline:
    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_per_kind: Dict[str, int]
    model_flops: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        if not self.model_flops or not self.hlo_flops:
            return None
        return self.model_flops / self.hlo_flops

    def row(self) -> Dict:
        return {
            "name": self.name, "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "coll_per_kind": self.coll_per_kind,
        }


def from_counts(name: str, flops: float, nbytes: float, chips: int, *,
                coll: Optional[Dict[str, int]] = None,
                model_flops: Optional[float] = None) -> Roofline:
    """The counterpart of the reference's ``from_compiled``: a roofline
    from a trace's whole-program FLOPs and bytes over ``chips`` and its
    collectives' result bytes on one device per kind (``coll``), the
    algorithmic factors applied (``coll_bytes`` is that times ``chips``,
    as the reference's dry-run scales its per-device count)."""
    per_kind = dict(coll or {})
    return Roofline(name=name, chips=chips, hlo_flops=float(flops),
                    hlo_bytes=float(nbytes),
                    coll_bytes=weighted_coll_bytes(per_kind) * chips,
                    coll_per_kind=per_kind, model_flops=model_flops)


def weighted_coll_bytes(per_kind: Dict[str, int]) -> float:
    """On-wire bytes per device: each kind's result bytes times its
    algorithmic factor."""
    return float(sum(_ALGO_FACTOR[k] * v for k, v in per_kind.items()))


# ---------------------------------------------------------------------------
# Bytes and live storage, counted op by op
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that move no data: allocation without initialisation, aliasing
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.detach.default,
             _aten.lift_fresh.default, _aten.alias.default}
# reads of rows picked by an index: the rows read, not the whole source
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.index_select.default, _aten.embedding.default}
# in-place writes of rows picked by an index: the rows written
_SCATTERS = {_aten.index_put_.default, _aten._index_put_impl_.default}
# in-place ops that write their first argument without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}


def _tensors(x) -> Sequence[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_KINDS: Dict[Any, str] = {}


def _kind(func) -> str:
    """``"out"`` (writes its ``out=`` arguments), ``"inplace"`` (writes
    its first argument, ``add_``) or ``"func"``, from the op's schema."""
    kind = _KINDS.get(func)
    if kind is None:
        schema = func._schema
        kind = "out" if any(a.is_out for a in schema.arguments) \
            else "inplace" if schema.name.endswith("_") else "func"
        _KINDS[func] = kind
    return kind


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one op reads and writes: every tensor input once and
    every output once; 0 for an allocation or an op whose result aliases
    an input (a view, ``_unsafe_view``); the picked rows (and the
    indices) for a gather or an indexed write, as XLA's cost analysis
    counts a gather or a scatter; no read of the destination for a copy
    or a fill."""
    if func in _NO_BYTES or getattr(func, "is_view", False):
        return 0
    if func in _GATHERS:
        idx = sum(_nbytes(t) for t in _tensors(args[1:]))
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + idx
    if func in _SCATTERS:
        idx = sum(_nbytes(t) for t in _tensors(args[1]))
        return 2 * _nbytes(args[2]) + idx
    kind = _kind(func)
    ins = _tensors(args if kind == "out" else (args, kwargs))
    outs = _tensors(out)
    if kind == "inplace":
        if func in _WRITE_ONLY:
            ins = ins[1:]
    elif outs and ins:
        keys = {_key(t) for t in ins}
        if any(_key(t) in keys for t in outs):
            return 0
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


class ByteCounter(TorchDispatchMode):
    """Counts, over the ops dispatched while it is entered:

    * ``bytes``: :func:`op_bytes` summed (``per_op``: by op name);
    * ``peak_bytes``: the most bytes of storage, allocated while it is
      entered, alive at once.  Each storage counts once — views and
      in-place results share their base's — and it stays alive as long
      as anything holds it (autograd's saved tensors included).
      Storages that existed before (the step's arguments) never count.

    :meth:`one_op` runs a function as one op: its inner ops' bytes are
    replaced by its inputs' and outputs' (its storages still count).
    The dry-run counts the plain attention this way, as the kernel it
    stands for is one op."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.per_op: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._old: set = set()
        self._inner = 0
        self._closed = False

    @staticmethod
    def active() -> Optional["ByteCounter"]:
        """The innermost entered counter of this thread, or None."""
        for m in reversed(_get_current_dispatch_mode_stack()):
            if isinstance(m, ByteCounter):
                return m
        return None

    def ignore_storages(self, tree) -> None:
        """Mark the storages of every tensor in ``tree`` as pre-existing."""
        for t in _tensors(tree):
            self._old.add(t.untyped_storage()._cdata)

    def _add(self, name: str, n: int) -> None:
        if n:
            self.bytes += n
            self.per_op[name] = self.per_op.get(name, 0) + n

    def _freed(self, key: int, n: int) -> None:
        if not self._closed and self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._old:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._inner:
            self._add(func.__name__, op_bytes(func, args, kwargs, out))
        self._track(out)
        return out

    def one_op(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` counted as one op named ``name``."""
        self._inner += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inner -= 1
        if not self._inner:
            self._add(name, sum(_nbytes(t) for t in _tensors((args, kwargs)))
                      + sum(_nbytes(t) for t in _tensors(out)))
        return out

    def __exit__(self, *exc):
        self._closed = True
        return super().__exit__(*exc)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6 * N * D (dense) or 6 * N_active * D (MoE)
# ---------------------------------------------------------------------------


def model_flops(cfg, shape, n_params_total: int,
                n_params_active: int) -> float:
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        tokens = shape.global_batch          # one new token per sequence
        return 2.0 * n_params_active * tokens   # forward only
    if shape.kind == "prefill":
        return 2.0 * n_params_active * tokens
    return 6.0 * n_params_active * tokens


def count_active_params(cfg, params_or_shapes: Any) -> Tuple[int, int]:
    """(total, active) parameter counts; active scales MoE expert blocks
    by top_k/n_experts (+ shared expert fully)."""
    total = 0
    active = 0
    for path, leaf in tree_leaves_with_path(params_or_shapes):
        n = int(math.prod(leaf.shape))
        total += n
        # the reference's key names: sequence indices carry none
        keys = [p for p in path if isinstance(p, str)]
        if "ffn" in keys and any(k in ("wi", "wg", "wo") for k in keys) \
                and "shared" not in keys:
            # stacked expert tensors (E, ...) on a MoE layer
            moe_specs = [s.moe for s in cfg.pattern if s.moe is not None]
            if moe_specs and len(leaf.shape) >= 3:
                spec = moe_specs[0]
                n = n * spec.top_k // spec.n_experts
        active += n
    return total, active
