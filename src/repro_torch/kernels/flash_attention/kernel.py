"""Launch wrapper of the hand-written CUDA ``flash_attention`` kernel.

:func:`flash_attention_kernel` computes causal or full attention of ``q
(B, QH, Sq, D)`` against ``k/v (B, KVH, Sk, D)`` (head ``h`` reads kv head
``h // group``), keys masked past ``lengths[b]``, in f32 or bf16 with
``D`` in {16, 32, 64, 128}.  It replaces the Pallas TPU kernel
``flash_attention_kernel`` (``src/repro/kernels/flash_attention/
kernel.py``); see ``csrc/flash_attention.cu`` for its design: both
products run on the tensor cores in 3xTF32 (Hopper's ``wgmma``), their
sums ordered and cut so that the error against f64 stays at the plain
f32 version's.  It is built with ``nvcc`` for ``sm_90a`` on first use.

``LAUNCHES`` counts the kernel's launches — the one place it is
incremented is right where the kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def _launcher():
    fn = _build.load().flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [
            ctypes.c_float, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths) -> None:
    ts = [q, k, v] + ([] if lengths is None else [lengths])
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_kernel needs CUDA tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("all flash_attention operands must share one "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be f32 or bf16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, QH, Sq, D) and k/v (B, KVH, Sk, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, qh, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] == 0 \
            or qh % k.shape[1] != 0:
        raise ValueError(f"GQA layout mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if lengths is not None and (lengths.dtype != torch.int32
                                or tuple(lengths.shape) != (b,)):
        raise ValueError(f"lengths must be int32 ({b},)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the "
                         "kernel loads 16-byte vectors)")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None, *,
                           causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention on CUDA tensors; returns ``(B, QH, Sq, D)`` in ``q``'s
    dtype.  Any ``Sq`` and ``Sk``: the kernel masks ragged tiles.  Raises
    on anything the kernel does not take — there is no fallback."""
    global LAUNCHES
    _check(q, k, v, lengths)
    b, qh, sq, d = q.shape
    kvh, sk = int(k.shape[1]), int(k.shape[2])
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if lengths is None else lengths.data_ptr(),
                     out.data_ptr(), b, qh, kvh, sq, sk, d, float(scale),
                     int(bool(causal)), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
