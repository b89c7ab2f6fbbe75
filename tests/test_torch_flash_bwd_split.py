"""The arithmetic of the backward kernel's two routes, on the CPU.

``csrc/flash_attention_bwd.cu`` runs all five products of the backward on
the tensor cores.  This file emulates its two routes with f32 sums of
products that are exact in f32:

* bf16: S = Q K^T and dP = dO V^T from the bf16 operands; P and dS split
  ``hi + lo`` (``split_bf16``) for dV = P^T dO, dK = dS^T Q and dQ = dS K,
  two passes each against the same operand; the gradients rounded to bf16
  once.
* f32: every product in 3xTF32 (``split_tf32``: small . big + big . small
  + big . big).

Each is held against ``flash_attention_bwd_ref``, the plain backward in
f32: bf16 at the card test's ``BWD_TOL`` (two bf16 ulps, plus 1e-4 of the
largest gradient for entries near 0), f32 within 1e-4 of the largest
gradient; and, in f32, against ``jax.vjp`` of the reference's
``flash_attention(impl="xla")`` at ``test_torch_flash_grad.py``'s 1e-5.
The two routes the kernel rejects (P and dS rounded once to bf16, as
FlashAttention does; one TF32 pass) are held to miss those limits.  Run
as a script, the file prints each route's share of its limit at S = 1024:

    PYTHONPATH=src python tests/test_torch_flash_bwd_split.py
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import split_bf16, split_tf32

# (atol as a share of the largest gradient, rtol): tests/test_torch_cuda.py
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2 ** -6)}
JAX_TOL = 1e-5                      # tests/test_torch_flash_grad.py's TOL
# the kernel's route per input dtype, and the one each replaced
ROUTES = {torch.bfloat16: "bf16", torch.float32: "tf32"}
REJECTED = {torch.bfloat16: "bf16_once", torch.float32: "tf32_1pass"}

# (batch, q heads, kv heads, Sq, Sk, D, causal, lengths)
CASES = [
    (2, 4, 4, 96, 160, 64, True, (160, 77)),     # G = 1, Sq < Sk
    (1, 8, 2, 128, 128, 32, False, None),        # G = 4, full
    (2, 4, 1, 200, 136, 64, True, (136, 0)),     # G = 4, Sq > Sk, no key
    (1, 2, 2, 256, 256, 16, False, (201,)),      # G = 1, D = 16
]


def _mm_tf32(a, b, passes):
    """``a @ b`` from TF32 operands summed in f32: 3xTF32 or one pass."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    if passes == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def _parts(x, route):
    """The bf16 A operands one f32 factor (P or dS) becomes."""
    if route == "bf16":
        return [t.float() for t in split_bf16(x)]
    return [x.to(torch.bfloat16).float()]


def bwd_emulated(q, k, v, o, lse, do, lengths=None, *, causal=True,
                 route="bf16"):
    """``(dq, dk, dv)`` in the inputs' dtype as a route of the kernel
    computes them: ``"bf16"`` (S and dP from the bf16 operands, P and dS
    split hi + lo), ``"bf16_once"`` (P and dS rounded once to bf16),
    ``"tf32"`` (every product 3xTF32) or ``"tf32_1pass"`` (one TF32
    pass); P and dS as the plain backward forms them, in f32."""
    group = q.shape[1] // k.shape[1]
    scale = q.shape[-1] ** -0.5
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    if route.startswith("tf32"):
        passes = 1 if route == "tf32_1pass" else 3

        def mm(a, b, x=None):
            return _mm_tf32(a, b, passes)
    else:
        def mm(a, b, x=None):
            if x is None:                   # bf16 operands: exact products
                return a @ b
            return sum(p @ b for p in _parts(x, route))
    s = mm(qf, kr.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float()[..., None])
    keep = torch.ones(s.shape[-2:], dtype=torch.bool)
    if causal:
        keep = keep.tril()
    keep = keep.expand_as(s)
    if lengths is not None:
        keys = torch.arange(s.shape[-1])
        keep = keep & (keys < lengths.long()[:, None, None, None])
    p = torch.where(keep, p, 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (mm(dof, vr.transpose(-1, -2)) - delta)
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dv = mm(pt, dof, pt)
    dk = mm(dst, qf, dst) * scale
    dq = mm(ds, kr, ds) * scale
    b, kvh, sk, d = k.shape

    def per_kv_head(t):
        return t.reshape(b, kvh, group, sk, d).sum(2)
    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _inputs(case, dtype, seed):
    b, qh, kvh, sq, sk, d, causal, lengths = case
    rng = np.random.default_rng(seed)
    arr = {n: rng.standard_normal(s).astype(np.float32)
           for n, s in (("q", (b, qh, sq, d)), ("k", (b, kvh, sk, d)),
                        ("v", (b, kvh, sk, d)), ("do", (b, qh, sq, d)))}
    t = {n: torch.from_numpy(a).to(dtype) for n, a in arr.items()}
    ln = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    t["o"] = flash_attention_ref(t["q"], t["k"], t["v"], ln, causal=causal)
    t["lse"] = flash_attention_lse_ref(t["q"], t["k"], ln, causal=causal)
    return arr, t, ln, causal


def _grads(t, ln, causal, route=None):
    args = (t["q"], t["k"], t["v"], t["o"], t["lse"], t["do"], ln)
    if route is None:
        return flash_attention_bwd_ref(*args, causal=causal)
    return bwd_emulated(*args, causal=causal, route=route)


def limit_share(got, want, dtype):
    """The largest |got - want| over its limit, BWD_TOL[dtype]: 1 is the
    limit."""
    atol, rtol = BWD_TOL[dtype]
    w = want.double()
    limit = atol * float(w.abs().max()) + rtol * w.abs()
    return float(((got.double() - w).abs() / limit).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_matches_plain_backward(case, dtype):
    _, t, ln, causal = _inputs(case, dtype, 0)
    want = _grads(t, ln, causal)
    got = _grads(t, ln, causal, ROUTES[dtype])
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert limit_share(g, w, dtype) <= 1.0
    if ln is not None and (ln == 0).any():
        row = int((ln == 0).nonzero()[0])
        assert not any(g[row].any() for g in got)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[-1] is None or 0 not in c[-1]])
def test_tf32_route_matches_jax_vjp(case):
    """The f32 route against JAX differentiating the reference's plain
    route (a length of 0 is left out: there the reference's gradient can
    be NaN, see test_torch_flash_grad.py)."""
    arr, t, ln, causal = _inputs(case, torch.float32, 1)
    got = _grads(t, ln, causal, "tf32")
    jl = None if ln is None else jnp.asarray(ln.numpy())
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, jl, causal=causal,
                                            impl="xla"),
                     *(jnp.asarray(arr[n]) for n in ("q", "k", "v")))
    for g, w in zip(got, vjp(jnp.asarray(arr["do"]))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=JAX_TOL,
                                   atol=JAX_TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rejected_route_misses_the_limit(dtype):
    """Why two bf16 passes and three TF32 ones: one pass each misses the
    limit where the kernel's route keeps well inside it."""
    _, t, ln, causal = _inputs((1, 4, 1, 256, 256, 64, True, None), dtype,
                               2)
    want = _grads(t, ln, causal)
    kept = max(limit_share(g, w, dtype) for g, w in
               zip(_grads(t, ln, causal, ROUTES[dtype]), want))
    missed = max(limit_share(g, w, dtype) for g, w in
                 zip(_grads(t, ln, causal, REJECTED[dtype]), want))
    assert kept < 0.6 and missed > 1.0


def test_split_bf16_parts():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(100000).astype(np.float32)
                         * 10.0 ** rng.integers(-6, 3, 100000))
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -16
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -8


def route_shares(seq=1024):
    """Each route's share of its limit against the plain backward at the
    shapes the kernel's routes were chosen at: bf16 1 x 7/1 x S x 128
    causal and 1 x 4/4 x S x 64 full, f32 1 x 3/1 x S x 64 causal."""
    out = []
    for dtype, case in ((torch.bfloat16, (1, 7, 1, seq, seq, 128, True,
                                          None)),
                        (torch.bfloat16, (1, 4, 4, seq, seq, 64, False,
                                          None)),
                        (torch.float32, (1, 3, 1, seq, seq, 64, True,
                                         None))):
        _, t, ln, causal = _inputs(case, dtype, 0)
        want = _grads(t, ln, causal)
        row = {"dtype": str(dtype).replace("torch.", ""),
               "shape": list(case[:6]), "causal": causal}
        for route in (ROUTES[dtype], REJECTED[dtype]):
            got = _grads(t, ln, causal, route)
            row[route] = {n: round(limit_share(g, w, dtype), 4)
                          for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        out.append(row)
    return out


if __name__ == "__main__":
    for r in route_shares():
        print(json.dumps(r))
