"""Launch wrapper of the hand-written CUDA ``paged_attention`` kernel.

:func:`paged_attention_kernel` computes one-token GQA decode attention of
``q (B, KVH, G, D)`` against the paged pool ``k/v_pages (P, page, KVH,
D)`` through ``block_tables (B, maxp)`` and ``lengths (B,)``, in f32 or
bf16 with ``D`` in {16, 32, 64, 128}.  It replaces the Pallas TPU kernel
``paged_attention_kernel`` (``src/repro/kernels/paged_attention/
kernel.py``); see ``csrc/paged_attention.cu`` for its design: the
sequence is split into partitions of ``PARTITION_TOKENS`` tokens, one
CTA each, and a second kernel on the same stream combines the partitions'
partial softmax sums in partition order.  It is built with ``nvcc`` for
``sm_90a`` on first use.

``COUNTS["paged_attention"]`` counts the op's launches, one per call: the partition kernel
and its combine kernel are one launch of the op, counted right where the
C function that launches both returns.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

COUNTS = {"paged_attention": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
#: the kernel's chunk of tokens; a partition is a multiple of it
CHUNK_TOKENS = 64
#: tokens a CTA owns, a multiple of CHUNK_TOKENS: at tiny-lm's decode path
#: shape about 3 CTAs per SM.  The wrapper reads it at every call.
PARTITION_TOKENS = 128


def _launcher():
    fn = _build.load().paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 7 + [
            ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, lengths) -> None:
    ts = (q, k_pages, v_pages, block_tables, lengths)
    if not all(t.is_cuda for t in ts):
        raise ValueError("paged_attention_kernel needs CUDA tensors")
    if any(t.device != q.device for t in ts):
        raise ValueError("all paged_attention operands must share one "
                         "device")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"q, k_pages and v_pages must all be f32 or bf16; "
                         f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"expected q (B, KVH, G, D) and pages (P, page, "
                         f"KVH, D); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    b, kvh, _, d = q.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[2] != kvh \
            or k_pages.shape[3] != d:
        raise ValueError(f"KV layout mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"expected block_tables ({b}, maxp) and lengths "
                         f"({b},); got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention operands must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages and v_pages must start on a 16-byte "
                         "boundary (the kernel copies 16-byte vectors)")


def paged_attention_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention on CUDA tensors; returns ``(B, KVH, G, D)`` in
    ``q``'s dtype.  Every ``block_tables`` entry a live token reaches must
    name a page of the pool.  Raises on anything the kernel does not take
    — there is no fallback."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    b, kvh, g, d = q.shape
    page, maxp = int(k_pages.shape[1]), int(block_tables.shape[1])
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if b == 0 or kvh == 0 or g == 0:
        return out
    if maxp == 0 or page == 0:
        return out.zero_()
    n_part = -(-maxp * page // PARTITION_TOKENS)
    part_m = torch.empty((b, kvh, n_part, g), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kvh, n_part, g, d), dtype=torch.float32,
                           device=q.device)
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_tables.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                     part_acc.data_ptr(), b, kvh, g, d, page, maxp,
                     PARTITION_TOKENS, float(scale), DTYPES[q.dtype],
                     stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    COUNTS["paged_attention"] += 1
    return out
