"""Launch wrapper of the hand-written CUDA ``wkv6`` kernel.

:func:`wkv6_kernel` runs RWKV-6's time-mix recurrence ``y_t = r_t (S_{t-1}
+ u k_t v_t^T)``, ``S_t = w_t S_{t-1} + k_t v_t^T`` over the S steps of
(B, S, H, hs) f32 inputs from the state (B, H, hs, hs), in one launch: one
block per head, each thread holding a 4 x 4 block of the state in
registers (see ``csrc/wkv6.cu``; the per-step arithmetic is in
``csrc/wkv6.cuh``).
It replaces the reference's ``lax.scan`` device program
(``src/repro/models/rwkv.py``), which no Pallas kernel implements.  It is
built with ``nvcc`` for ``sm_90a`` on first use.

``COUNTS["wkv6"]`` counts the kernel's launches — the one place it is
incremented is right where the kernel is launched.  The kernel has no
backward yet: :func:`repro_torch.kernels.wkv6.wkv6` raises on the card
when autograd needs the graph.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

COUNTS = {"wkv6": 0}

#: the largest head a block takes (the source's kMaxHead)
MAX_HEAD = 64
# one launch's int64 operands, in the source's Operand order
OPERANDS = ("s0", "r", "k", "v", "w", "u", "valid", "s_out", "y", "batch",
            "steps", "heads", "head_size")

_FN = None
# each host thread packs its launches' operands into an array of its own
_PACK = threading.local()


def _launcher():
    """The library's launch entry, its argument types bound once."""
    global _FN
    if _FN is None:
        fn = _build.load().wkv6_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bad(msg: str):
    raise ValueError(msg)


def _check(state, rh, kh, vh, wh, uh, valid) -> None:
    if rh.dim() != 4:
        _bad(f"expected r (B, S, H, hs); got {tuple(rh.shape)}")
    b, s, nh, hs = rh.shape
    dev = rh.device
    if dev.type != "cuda":
        _bad("wkv6_kernel needs CUDA tensors")
    for t in (state, rh, kh, vh, wh, uh):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            _bad(f"wkv6 takes contiguous f32 operands on one device; got "
                 f"{t.dtype} on {t.device}")
    if kh.shape != rh.shape or vh.shape != rh.shape \
            or wh.shape != rh.shape or uh.shape != (nh, hs) \
            or state.shape != (b, nh, hs, hs):
        _bad(f"shapes: state {tuple(state.shape)}, r {tuple(rh.shape)}, k "
             f"{tuple(kh.shape)}, v {tuple(vh.shape)}, w {tuple(wh.shape)},"
             f" u {tuple(uh.shape)}; expected state (B, H, hs, hs), r, k, "
             f"v and w (B, S, H, hs), u (H, hs)")
    if hs > MAX_HEAD:
        _bad(f"head size {hs} > {MAX_HEAD}")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (b, s)
                              or valid.device != dev
                              or not valid.is_contiguous()):
        _bad(f"valid must be a contiguous (B, S) bool mask on the "
             f"operands' device; got {valid.dtype} {tuple(valid.shape)}")


def wkv6_kernel(state: torch.Tensor, rh: torch.Tensor, kh: torch.Tensor,
                vh: torch.Tensor, wh: torch.Tensor, uh: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence on CUDA tensors in one launch; returns (the last
    state (B, H, hs, hs), y (B, S, H, hs)).  Raises on anything the kernel
    does not take — there is no fallback."""
    _check(state, rh, kh, vh, wh, uh, valid)
    b, s, nh, hs = rh.shape
    y = rh.new_empty((b, s, nh, hs))
    s_out = torch.empty_like(state)
    if b == 0 or nh == 0 or hs == 0:
        return s_out, y.zero_()
    if s == 0:
        return s_out.copy_(state), y
    a = getattr(_PACK, "a", None)
    if a is None:
        a = _PACK.a = (ctypes.c_int64 * len(OPERANDS))()
    a[:] = (state.data_ptr(), rh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
            wh.data_ptr(), uh.data_ptr(),
            0 if valid is None else valid.data_ptr(), s_out.data_ptr(),
            y.data_ptr(), b, s, nh, hs)
    dev = rh.get_device()
    if dev == torch._C._cuda_getDevice():
        err = _launcher()(ctypes.addressof(a), len(OPERANDS),
                          torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _launcher()(ctypes.addressof(a), len(OPERANDS),
                              torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    COUNTS["wkv6"] += 1
    return s_out, y
