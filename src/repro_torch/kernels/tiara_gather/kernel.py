"""Launch wrappers of the hand-written CUDA ``tiara_gather`` kernel.

One kernel library (``csrc/tiara_gather.cu``, the algorithm in
``csrc/tiara_gather.cuh``) serves two forms of the double-indirection
gather:

* :func:`tiara_gather_kernel` — ``out[i] = pool[table[ids[i]]]`` for
  ``pool (N, R)``, ``table (T,)`` int32 or int64 and ``ids (n,)`` int32;
* :func:`tiara_gather_window_kernel` — ``out[i, w] = pool[bases[id] +
  ((table[id] + w) & mask)]`` with ``id = ids[i]`` over a flat pool, or
  ``id = i`` when ``ids`` is None (the engines' callers): the memcpy of the
  compiled trace and of the lockstep engine's host loop (any word
  alignment, wrapping inside the region as the interpreter does); ``mask``
  is one int, or a tensor shaped like ``table`` with one mask per entry
  (the lockstep engine's lanes copy from different regions).

The wrapper picks the kernel's regime from the window's width: windows of
at most ``SMALL_MAX_WIDTH`` elements (the resolvers' one-word windows) run
one thread per element, longer ones (8 KiB rows) on the persistent
bulk-copy stream.

The kernel replaces the Pallas TPU kernel ``tiara_gather_kernel``
(``src/repro/kernels/tiara_gather/kernel.py``); see the source for its
design.  It is built with ``nvcc`` for ``sm_90a`` on first use.

``COUNTS["tiara_gather"]`` counts the kernel's launches — the one place
it is incremented is right where the kernel is launched, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Union

import torch

from repro_torch.kernels import _build

COUNTS = {"tiara_gather": 0}
# the mesh's shards launch from their own host threads
_COUNT_LOCK = threading.Lock()

# a pool's dtype -> its element's bytes
_ELEM_BYTES = {torch.int64: 8, torch.float32: 4, torch.bfloat16: 2,
               torch.int32: 4}
_TABLE_BYTES = {torch.int32: 4, torch.int64: 8}
# windows of at most this many elements take the small regime (one thread
# per element); the source's kSmallMaxWidth
SMALL_MAX_WIDTH = 32

# one launch's int64 operands, in the source's Operand order
OPERANDS = ("pool", "table", "table_bytes", "ids", "bases", "masks", "out",
            "n", "width", "stride", "mask", "elem_bytes", "regime")

_FN = None
# each host thread packs its launches' operands into an array of its own
# (the mesh's shards launch from their own threads)
_PACK = threading.local()


def _launcher():
    """The library's launch entry, its argument types bound once."""
    global _FN
    if _FN is None:
        fn = _build.load().tiara_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch_empty() -> None:
    """Launch the library's empty kernel on the current stream: the launch
    floor that the gather's times stand beside (counted nowhere)."""
    lib = _build.load()
    lib.tiara_gather_empty.argtypes = [ctypes.c_void_p]
    lib.tiara_gather_empty.restype = ctypes.c_int
    err = lib.tiara_gather_empty(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiara_gather_empty failed: cudaError {err}")


def config() -> dict:
    """The launch's constants as the built library reports them."""
    out = (ctypes.c_int64 * 6)()
    _build.load().tiara_gather_config(out)
    return dict(zip(("threads", "small_max_width", "unit_bytes",
                     "ring_slots", "blocks_per_sm", "smem_bytes"), out))


def _bad(msg: str):
    raise ValueError(msg)


def _launch(pool, table, ids, bases, masks, *, width: int, stride: int,
            mask: int) -> torch.Tensor:
    """Check the operands, then launch.  Raises on anything the kernel
    does not take; there is no fallback."""
    dev = pool.get_device()
    elem = _ELEM_BYTES.get(pool.dtype)
    tbytes = _TABLE_BYTES.get(table.dtype)
    if dev < 0:
        _bad("tiara_gather_kernel needs CUDA tensors")
    if elem is None or not pool.is_contiguous():
        _bad(f"the pool must be contiguous and int64, float32, bfloat16 or "
             f"int32; got {pool.dtype}")
    if tbytes is None or table.dim() != 1 or not table.is_contiguous() \
            or table.get_device() != dev:
        _bad("table must be (T,) int32 or int64, contiguous, on the pool's "
             "device")
    T = table.shape[0]
    n = T
    if ids is not None:
        if ids.dtype != torch.int32 or ids.dim() != 1 \
                or not ids.is_contiguous() or ids.get_device() != dev:
            _bad("ids must be (n,) int32, contiguous, on the pool's device")
        n = ids.shape[0]
    for t in (bases, masks):
        if t is not None and (t.dtype != torch.int64 or t.dim() != 1
                              or t.shape[0] != T or not t.is_contiguous()
                              or t.get_device() != dev):
            _bad("bases and masks must be int64, shaped like table, "
                 "contiguous, on the pool's device")
    out = pool.new_empty((n, width))
    if n == 0 or width == 0:
        return out
    a = getattr(_PACK, "a", None)
    if a is None:
        a = _PACK.a = (ctypes.c_int64 * len(OPERANDS))()
    a[:] = (pool.data_ptr(), table.data_ptr(), tbytes,
            0 if ids is None else ids.data_ptr(),
            0 if bases is None else bases.data_ptr(),
            0 if masks is None else masks.data_ptr(), out.data_ptr(), n,
            width, stride, mask, elem, 0 if width <= SMALL_MAX_WIDTH else 1)
    if dev == torch._C._cuda_getDevice():
        err = _launcher()(ctypes.addressof(a), len(OPERANDS),
                          torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _launcher()(ctypes.addressof(a), len(OPERANDS),
                              torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"tiara_gather launch failed: cudaError {err}")
    with _COUNT_LOCK:
        COUNTS["tiara_gather"] += 1
    return out


def tiara_gather_kernel(pool: torch.Tensor, table: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """Row gather on CUDA tensors; returns ``(n, R)`` in ``pool``'s
    dtype.  Raises on anything the kernel does not take — there is no
    fallback."""
    if ids is None:
        _bad("the row form takes ids")
    if pool.dim() != 2:
        _bad(f"expected pool (N, R); got {tuple(pool.shape)}")
    R = pool.shape[1]
    return _launch(pool, table, ids, None, None, width=R, stride=R, mask=-1)


def tiara_gather_window_kernel(pool: torch.Tensor, table: torch.Tensor,
                               bases: torch.Tensor,
                               ids: Optional[torch.Tensor] = None, *,
                               width: int, mask: Union[int, torch.Tensor]
                               ) -> torch.Tensor:
    """Window gather on CUDA tensors: ``out[i, w] = pool[bases[id] +
    ((table[id] + w) & mask)]``, ``id = ids[i]`` (``id = i`` when ``ids``
    is None), ``w < width``, with ``mask`` one int or ``mask[id]`` from an
    int64 tensor shaped like ``table``; returns ``(n, width)``.  ``pool``
    is flat; every index must lie in it, and every mask must be
    non-negative."""
    masks = mask if isinstance(mask, torch.Tensor) else None
    if pool.dim() != 1:
        _bad(f"expected a flat pool; got {tuple(pool.shape)}")
    if bases is None:
        _bad("the window form takes bases")
    if width < 0 or (masks is None and mask < 0):
        _bad("width and mask must be non-negative")
    return _launch(pool, table, ids, bases, masks, width=int(width),
                   stride=1, mask=0 if masks is not None else int(mask))
