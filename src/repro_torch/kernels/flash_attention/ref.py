"""Plain PyTorch versions of tiled causal attention and of its
gradient."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _mask(seq_q: int, seq_k: int, q0: int, lengths, causal: bool,
          device) -> Optional[torch.Tensor]:
    """(B or 1, 1, Sq, Sk) keep-mask for query rows ``q0..q0+Sq``, or None
    when every key is kept."""
    kpos = torch.arange(seq_k, device=device)[None, :]
    mask = None
    if causal:
        qpos = q0 + torch.arange(seq_q, device=device)[:, None]
        mask = (kpos <= qpos)[None, None]
    if lengths is not None:
        lm = kpos[None, None] < lengths.to(device).long()[:, None, None,
                                                          None]
        mask = lm if mask is None else mask & lm
    return mask


def _attend(q, k, v, mask, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B, QH, Sq, D); k/v (B, KVH, Sk, D) with GQA broadcast (head h
    reads kv head h // group).  A row with no live key gives 0."""
    batch, qh, seq_q, head_dim = q.shape
    group = qh // k.shape[1]
    if scale is None:
        scale = head_dim ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    mask = _mask(seq_q, k.shape[2], 0, lengths, causal, q.device)
    return _attend(q, k, v, mask, scale).to(q.dtype)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None, *,
                            causal: bool = True,
                            scale: Optional[float] = None,
                            chunk: int = 1024) -> torch.Tensor:
    """The same function with O(S * chunk) score memory: a loop over query
    chunks, so a long prompt never builds a (B, H, S, S) score tensor."""
    batch, qh, seq_q, head_dim = q.shape
    group = qh // k.shape[1]
    if scale is None:
        scale = head_dim ** -0.5
    chunk = min(chunk, seq_q)
    if seq_q % chunk != 0:
        return flash_attention_ref(q, k, v, lengths, causal=causal,
                                   scale=scale)
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    outs = []
    for q0 in range(0, seq_q, chunk):
        mask = _mask(chunk, kr.shape[2], q0, lengths, causal, q.device)
        outs.append(_attend(q[:, :, q0:q0 + chunk], kr, vr, mask,
                            scale).to(q.dtype))
    return torch.cat(outs, dim=2)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None, *,
                            causal: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel's ``lse`` output: each row's ``log sum_j
    exp(scale q . k_j)`` over its live keys, (B, QH, Sq) f32, natural
    log, ``+inf`` for a row with no live key."""
    seq_q, head_dim = q.shape[2], q.shape[3]
    if scale is None:
        scale = head_dim ** -0.5
    kr = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    mask = _mask(seq_q, k.shape[2], 0, lengths, causal, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isneginf(lse), float("inf"), lse)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None, *,
                            causal: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradient of :func:`flash_attention_ref`, written out as the
    CUDA backward (``csrc/flash_attention_bwd.cu``) computes it, in f32:
    with ``s = scale q k^T`` and the forward's ``o`` and ``lse`` (natural
    log, ``+inf`` on a row with no live key),

        P = exp(s - lse) on live keys, 0 elsewhere;   dV = P^T dO
        D = rowsum(dO o);   dS = P (dO V^T - D);      dQ = scale dS K
        dK = scale dS^T Q, summed over each kv head's query group.

    Returns ``(dq, dk, dv)`` in the inputs' dtype.  The tests and the chip
    smoke hold the kernel against it; no training path calls it."""
    batch, qh, seq_q, head_dim = q.shape
    kvh, seq_k = k.shape[1], k.shape[2]
    group = qh // kvh
    if scale is None:
        scale = head_dim ** -0.5
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    p = torch.exp(s - lse.float()[..., None])
    mask = _mask(seq_q, seq_k, 0, lengths, causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def per_kv_head(t):
        return t.reshape(batch, kvh, group, seq_k, head_dim).sum(2)
    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x = big + small`` with both parts TF32 values (f32 with the low 13
    mantissa bits 0), as the CUDA kernel splits its operands: ``big`` is
    ``x`` rounded to the nearest TF32, ties away from zero (PTX
    ``cvt.rna.tf32.f32``), and ``small`` is ``x - big`` rounded the same
    way.  Returns f32 tensors.  A test helper: the serving path never
    calls it."""
    def rna(y: torch.Tensor) -> torch.Tensor:
        bits = y.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    x = x.float()
    big = rna(x)
    return big, rna(x - big)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` with both parts bf16, as the CUDA backward splits P
    and dS for its bf16 products (two passes against the same operand):
    ``hi`` is ``x`` rounded to the nearest bf16 (ties to even, as
    ``__floats2bfloat162_rn``), ``lo`` is ``x - hi`` rounded the same way.
    Returns bf16 tensors.  A test helper: no training path calls it."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def flash_attention_bf16_split(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None, *,
                               causal: bool = True,
                               scale: Optional[float] = None,
                               block_k: int = 128, p_passes: int = 2,
                               return_lse: bool = False):
    """The arithmetic of the bf16 forward kernel
    (``csrc/flash_attention_bf16.cu``) in plain PyTorch, on bf16 ``q``,
    ``k``, ``v`` laid out as :func:`flash_attention_ref` takes them.  Key
    tiles of ``block_k`` go through an online softmax in f32:

    * S = Q K^T from the raw bf16 operands, summed in f32 (each product of
      two bf16 values is exact in f32), then scaled: x = S scale log2(e);
    * m = the running row max of x, P = exp2(x - m) on live keys, 0
      elsewhere; the running sum l and the output are rescaled by
      exp2(m_old - m);
    * P V with P split ``hi + lo`` (:func:`split_bf16`), two bf16 passes
      against the same V tile, lo first (``p_passes=1``: P rounded once to
      bf16, the route the kernel rejects);
    * out = O / l rounded to bf16 once; a row with no live key gives 0.

    With ``return_lse`` also each row's log-sum-exp in natural log,
    ``(m + log2 l) ln 2``, ``+inf`` for a row with no live key.  A test
    helper: no serving or training path calls it."""
    if p_passes not in (1, 2):
        raise ValueError(f"p_passes must be 1 or 2, got {p_passes}")
    batch, qh, seq_q, head_dim = q.shape
    seq_k = k.shape[2]
    group = qh // k.shape[1]
    if scale is None:
        scale = head_dim ** -0.5
    c = scale * 1.4426950408889634
    qf = q.float()
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    keep = _mask(seq_q, seq_k, 0, lengths, causal, q.device)
    if keep is None:
        keep = torch.ones((1, 1, seq_q, seq_k), dtype=torch.bool)
    keep = keep.expand(batch, qh, seq_q, seq_k)
    m = torch.full((batch, qh, seq_q, 1), -1e30)
    l = torch.zeros((batch, qh, seq_q, 1))
    o = torch.zeros((batch, qh, seq_q, head_dim))
    for k0 in range(0, seq_k, block_k):
        sl = slice(k0, k0 + block_k)
        live = keep[..., sl]
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kr[:, :, sl]) * c
        x = torch.where(live, x, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(live, torch.exp2(x - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        parts = split_bf16(p) if p_passes == 2 else (p.to(torch.bfloat16),)
        o = o * alpha
        for part in parts[::-1]:            # lo first, as the kernel
            o = o + part.float() @ vr[:, :, sl]
        m = m_new
    out = (o / l.clamp(min=1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, (m + torch.log2(l.clamp(min=1e-30)))
                      * 0.6931471805599453, float("inf"))
    return out, lse[..., 0]
