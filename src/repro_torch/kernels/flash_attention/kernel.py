"""Launch wrapper of the hand-written CUDA ``flash_attention`` kernel.

:func:`flash_attention_kernel` computes causal or full attention of ``q
(B, QH, Sq, D)`` against ``k/v (B, KVH, Sk, D)`` (head ``h`` reads kv head
``h // group``), keys masked past ``lengths[b]``, in f32 or bf16 with
``D`` in {16, 32, 64, 128}.  It replaces the Pallas TPU kernel
``flash_attention_kernel`` (``src/repro/kernels/flash_attention/
kernel.py``) with one route per input type, both on Hopper's tensor
cores (``wgmma``): f32 in 3xTF32 (``csrc/flash_attention.cu``), its sums
ordered and cut so that the error against f64 stays at the plain f32
version's; bf16 in a kernel of its own (``csrc/flash_attention_bf16.cu``):
one bf16 pass for Q K^T, two for P V with P split into two bf16 parts,
K and V read by wgmma straight from the tiles TMA lands, a producer warp
and two consumer warpgroups.  With ``return_lse`` it also gives each
row's log-sum-exp, which :func:`flash_attention_bwd_kernel` reads.

:func:`flash_attention_bwd_kernel` is the gradient of the same function
(``csrc/flash_attention_bwd.cu``): ``dq``, ``dk`` and ``dv`` from the
forward's inputs, its output and log-sum-exp, and the output's gradient.
All five of its products run on the tensor cores (``wgmma``): in bf16
with P and dS split into two bf16 parts, in f32 as 3xTF32; no atomics, so
every call gives the same bits.  It replaces no TPU kernel: the reference
lets JAX differentiate the plain route of its Pallas kernel.  Both are
built with ``nvcc`` for ``sm_90a`` on first use.

``COUNTS`` counts the launches of the forward (``"flash_attention"``)
and of the backward (``"flash_attention_bwd"``; its pre-pass and two
kernels count as one launch of the op); the one place each is
incremented is right where its kernel is launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

COUNTS = {"flash_attention": 0, "flash_attention_bwd": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def _launcher():
    fn = _build.load().flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 + [
            ctypes.c_float, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_launcher():
    fn = _build.load().flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 6 + [
            ctypes.c_float, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths, *more) -> None:
    """The operands the kernels take; ``more`` are tensors shaped like q
    (the backward's ``out`` and ``dout``)."""
    for t in more:
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"out and dout must be shaped and typed like q "
                             f"{tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    ts = [q, k, v, *more] + ([] if lengths is None else [lengths])
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
    if any(t.data_ptr() % 16 for t in (q, k, v, *more)):
        raise ValueError("q, k and v (and out and dout) must start on a "
                         "16-byte boundary (the kernels load 16-byte "
                         "vectors)")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None, *,
                           causal: bool = True,
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    """Attention on CUDA tensors; returns ``(B, QH, Sq, D)`` in ``q``'s
    dtype, and with ``return_lse`` also ``lse (B, QH, Sq)`` f32: each
    row's ``log sum_j exp(scale q . k_j)`` over its live keys, natural
    log, ``+inf`` for a row with no live key.  Asking for ``lse`` leaves
    the output's bits as they are.  Any ``Sq`` and ``Sk``: the kernel
    masks ragged tiles.  Raises on anything the kernel does not take —
    there is no fallback."""
    _check(q, k, v, lengths)
    b, qh, sq, d = q.shape
    kvh, sk = int(k.shape[1]), int(k.shape[2])
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, qh, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if lengths is None else lengths.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     b, qh, kvh, sq, sk, d, float(scale), int(bool(causal)),
                     DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    COUNTS["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None, *,
                               causal: bool = True,
                               scale: Optional[float] = None):
    """The gradient of :func:`flash_attention_kernel` on CUDA tensors:
    ``(dq, dk, dv)`` in the inputs' dtype, from the forward's inputs, its
    ``out`` and ``lse`` (``return_lse=True``) and ``dout``, the gradient
    of ``out``.  Deterministic (no atomics): the same bits on every call.
    Raises on anything the kernel does not take — there is no
    fallback."""
    _check(q, k, v, lengths, out, dout)
    b, qh, sq, d = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, qh, sq) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous f32 ({b}, {qh}, {sq}) on "
                         f"{q.device}")
    kvh, sk = int(k.shape[1]), int(k.shape[2])
    if scale is None:
        scale = d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, qh, sq), dtype=torch.float32, device=q.device)
    launch = _bwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     None if lengths is None else lengths.data_ptr(),
                     delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), b, qh, kvh, sq, sk, d, float(scale),
                     int(bool(causal)), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {err}")
    COUNTS["flash_attention_bwd"] += 1
    return dq, dk, dv
