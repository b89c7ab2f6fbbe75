"""Launch wrapper of the hand-written CUDA ``selective_scan`` kernel.

:func:`selective_scan_kernel` runs Mamba's recurrence ``h = exp(dt A) h +
dt x B``, ``y = h . C`` over the S steps of ``dt``, ``x`` (B, S, d) and
``bm``, ``cm`` (B, S, N) from the state ``h`` (B, d, N), all f32, in one
launch: one thread per channel (b, d) walking the steps with its N <= 32
states in registers (see ``csrc/selective_scan.cu``; the per-step
arithmetic is in ``csrc/selective_scan.cuh``).  It replaces the
reference's ``lax.scan`` device program (``src/repro/models/mamba.py``),
which no Pallas kernel implements.  It is built with ``nvcc`` for
``sm_90a`` on first use.

``COUNTS["selective_scan"]`` counts the kernel's launches — the one place
it is incremented is right where the kernel is launched.  The kernel has
no backward yet: :func:`repro_torch.kernels.selective_scan.selective_scan`
raises on the card when autograd needs the graph.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

COUNTS = {"selective_scan": 0}

#: the most states a channel takes (the source's kMaxState)
MAX_STATE = 32
# one launch's int64 operands, in the source's Operand order
OPERANDS = ("h0", "dt", "x", "bm", "cm", "a", "valid", "h_out", "y",
            "batch", "steps", "channels", "states", "bm_b", "bm_s", "cm_b",
            "cm_s")

_FN = None
# each host thread packs its launches' operands into an array of its own
_PACK = threading.local()


def _launcher():
    """The library's launch entry, its argument types bound once."""
    global _FN
    if _FN is None:
        fn = _build.load().selective_scan_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bad(msg: str):
    raise ValueError(msg)


def _check(h, dt, x, bm, cm, a_mat, valid) -> None:
    if dt.dim() != 3 or a_mat.dim() != 2:
        _bad(f"expected dt (B, S, d) and a_mat (d, N); got "
             f"{tuple(dt.shape)}, {tuple(a_mat.shape)}")
    b, s, d = dt.shape
    n = a_mat.shape[1]
    dev = dt.device
    if dev.type != "cuda":
        _bad("selective_scan_kernel needs CUDA tensors")
    for t in (h, dt, x, bm, cm, a_mat):
        if t.device != dev or t.dtype != torch.float32:
            _bad(f"selective_scan takes f32 operands on one device; got "
                 f"{t.dtype} on {t.device}")
    if x.shape != dt.shape or h.shape != (b, d, n) \
            or bm.shape != (b, s, n) or cm.shape != (b, s, n) \
            or a_mat.shape[0] != d:
        _bad(f"shapes: h {tuple(h.shape)}, dt {tuple(dt.shape)}, x "
             f"{tuple(x.shape)}, bm {tuple(bm.shape)}, cm "
             f"{tuple(cm.shape)}, a_mat {tuple(a_mat.shape)}; expected h "
             f"(B, d, N), dt and x (B, S, d), bm and cm (B, S, N), a_mat "
             f"(d, N)")
    if n > MAX_STATE or b > 65535:
        _bad(f"d_state {n} > {MAX_STATE} or batch {b} > 65535 (the grid's "
             f"second dimension)")
    if not (h.is_contiguous() and dt.is_contiguous() and x.is_contiguous()
            and a_mat.is_contiguous()):
        _bad("h, dt, x and a_mat must be contiguous")
    if n > 1 and (bm.stride(2) != 1 or cm.stride(2) != 1):
        _bad("bm and cm must have unit stride along N")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (b, s)
                              or valid.device != dev
                              or not valid.is_contiguous()):
        _bad(f"valid must be a contiguous (B, S) bool mask on the "
             f"operands' device; got {valid.dtype} {tuple(valid.shape)}")


def selective_scan_kernel(h: torch.Tensor, dt: torch.Tensor,
                          x: torch.Tensor, bm: torch.Tensor,
                          cm: torch.Tensor, a_mat: torch.Tensor,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan on CUDA tensors in one launch; returns (the last state (B,
    d, N), y (B, S, d)).  ``bm`` and ``cm`` may be strided views (unit
    stride along N).  Raises on anything the kernel does not take — there
    is no fallback."""
    _check(h, dt, x, bm, cm, a_mat, valid)
    b, s, d = dt.shape
    n = a_mat.shape[1]
    y = dt.new_empty((b, s, d))
    h_out = torch.empty_like(h)
    if b == 0 or d == 0 or n == 0:
        return h_out, y.zero_()
    if s == 0:
        return h_out.copy_(h), y
    a = getattr(_PACK, "a", None)
    if a is None:
        a = _PACK.a = (ctypes.c_int64 * len(OPERANDS))()
    a[:] = (h.data_ptr(), dt.data_ptr(), x.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), a_mat.data_ptr(),
            0 if valid is None else valid.data_ptr(), h_out.data_ptr(),
            y.data_ptr(), b, s, d, n, bm.stride(0), bm.stride(1),
            cm.stride(0), cm.stride(1))
    dev = dt.get_device()
    if dev == torch._C._cuda_getDevice():
        err = _launcher()(ctypes.addressof(a), len(OPERANDS),
                          torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _launcher()(ctypes.addressof(a), len(OPERANDS),
                              torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    COUNTS["selective_scan"] += 1
    return h_out, y
