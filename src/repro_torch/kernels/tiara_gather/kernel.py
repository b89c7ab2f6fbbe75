"""Launch wrappers of the hand-written CUDA ``tiara_gather`` kernel.

One kernel (``csrc/tiara_gather.cu``) serves two forms of the
double-indirection gather:

* :func:`tiara_gather_kernel` — ``out[i] = pool[table[ids[i]]]`` for
  ``pool (N, R)``, ``table (T,)`` int32 or int64 and ``ids (n,)`` int32;
* :func:`tiara_gather_window_kernel` — ``out[i, w] = pool[bases[id] +
  ((table[id] + w) & mask)]`` with ``id = ids[i]`` over a flat pool, the
  memcpy of the compiled gather chain and of the lockstep engine (any
  word alignment, wrapping inside the region as the interpreter does);
  ``mask`` is one int, or a tensor shaped like ``table`` with one mask
  per entry (the lockstep engine's lanes copy from different regions).

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

_DTYPES = (torch.int64, torch.float32, torch.bfloat16, torch.int32)


def _launcher():
    fn = _build.load().tiara_gather_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(pool: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
           bases: Optional[torch.Tensor],
           masks: Optional[torch.Tensor] = None) -> None:
    ts = [pool, table, ids] + [t for t in (bases, masks) if t is not None]
    if not all(t.is_cuda for t in ts):
        raise ValueError("tiara_gather_kernel needs CUDA tensors")
    if any(t.device != pool.device for t in ts):
        raise ValueError("all tiara_gather operands must share one device")
    if pool.dtype not in _DTYPES:
        raise ValueError(f"unsupported pool dtype {pool.dtype}")
    if table.dim() != 1 or ids.dim() != 1:
        raise ValueError(f"expected table (T,) and ids (n,); got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)}")
    if table.dtype not in (torch.int32, torch.int64) \
            or ids.dtype != torch.int32:
        raise ValueError("table must be int32 or int64 and ids int32")
    if bases is not None and (bases.dtype != torch.int64
                              or bases.shape != table.shape):
        raise ValueError("bases must be int64 and shaped like table")
    if masks is not None and (masks.dtype != torch.int64
                              or masks.shape != table.shape):
        raise ValueError("masks must be int64 and shaped like table")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("tiara_gather operands must be contiguous")


def _launch(pool, table, ids, bases, masks, *, width: int, stride: int,
            mask: int) -> torch.Tensor:
    n = int(ids.shape[0])
    out = torch.empty((n, width), dtype=pool.dtype, device=pool.device)
    if n == 0 or width == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = launch(pool.data_ptr(), table.data_ptr(),
                     table.element_size(), ids.data_ptr(),
                     None if bases is None else bases.data_ptr(),
                     None if masks is None else masks.data_ptr(),
                     out.data_ptr(), n, width, stride, mask,
                     pool.element_size(), stream)
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
    _check(pool, table, ids, None)
    if pool.dim() != 2:
        raise ValueError(f"expected pool (N, R); got {tuple(pool.shape)}")
    R = int(pool.shape[1])
    return _launch(pool, table, ids, None, None, width=R, stride=R,
                   mask=-1)


def tiara_gather_window_kernel(pool: torch.Tensor, table: torch.Tensor,
                               bases: torch.Tensor, ids: torch.Tensor, *,
                               width: int, mask: Union[int, torch.Tensor]
                               ) -> torch.Tensor:
    """Window gather on CUDA tensors: ``out[i, w] = pool[bases[id] +
    ((table[id] + w) & mask)]``, ``id = ids[i]``, ``w < width``, with
    ``mask`` one int or ``mask[id]`` from an int64 tensor shaped like
    ``table``; returns ``(n, width)``.  ``pool`` is flat; every index must
    lie in it, and every mask must be non-negative."""
    masks = mask if isinstance(mask, torch.Tensor) else None
    _check(pool, table, ids, bases, masks)
    if pool.dim() != 1:
        raise ValueError(f"expected a flat pool; got {tuple(pool.shape)}")
    if width < 0 or (masks is None and mask < 0):
        raise ValueError("width and mask must be non-negative")
    return _launch(pool, table, ids, bases, masks, width=int(width),
                   stride=1, mask=0 if masks is not None else int(mask))
