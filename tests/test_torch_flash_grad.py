"""The gradient of the port's ``flash_attention``, on the CPU.

``flash_attention_bwd_ref`` writes out the mathematics of the CUDA
backward kernel (P recomputed from the forward's log-sum-exp, D = rowsum(dO
o), dS = P (dP - D), dK summed over each kv head's query group).  Here it is
held against ``torch.autograd.grad`` of the port's plain forward and
against ``jax.vjp`` of the reference's ``flash_attention(impl="xla")``, on
the same seeded numpy inputs: causal and full, G = 1 and G = 3, Sq != Sk,
ragged ``lengths``, D = 32 and 64.  Tolerance: 1e-5 of each gradient's
largest entry, plus 1e-5 relative — the three compute the same f32 sums in
other orders (einsums of up to 64 terms; the reference's softmax against
exp(s - lse)).

A length of 0 is held on the port's side only: the reference's plain
route takes a softmax over all -inf and zeroes the NaN output afterwards,
so its gradient there can be NaN and is no reference; the port gives 0.

The kernel itself needs the card: ``tests/test_torch_cuda.py`` holds it
against ``flash_attention_bwd_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)

TOL = 1e-5

# (batch, q heads, kv heads, Sq, Sk, D, causal, lengths)
CASES = [
    (2, 6, 2, 24, 40, 32, True, (40, 17)),       # G = 3, Sq < Sk
    (2, 4, 4, 40, 24, 64, False, (24, 9)),       # G = 1, Sq > Sk
    (1, 3, 1, 32, 32, 64, True, None),           # G = 3, square, no lengths
    (3, 2, 2, 16, 48, 32, False, (48, 1, 30)),   # G = 1, a single live key
]


def _inputs(case, seed):
    b, qh, kvh, sq, sk, d, causal, lengths = case
    rng = np.random.default_rng(seed)
    arr = {n: rng.standard_normal(s).astype(np.float32)
           for n, s in (("q", (b, qh, sq, d)), ("k", (b, kvh, sk, d)),
                        ("v", (b, kvh, sk, d)), ("do", (b, qh, sq, d)))}
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    return arr, ln, causal


def _port_bwd(arr, ln, causal):
    q, k, v, do = (torch.from_numpy(arr[n]) for n in ("q", "k", "v", "do"))
    lengths = None if ln is None else torch.from_numpy(ln)
    o = flash_attention_ref(q, k, v, lengths, causal=causal)
    lse = flash_attention_lse_ref(q, k, lengths, causal=causal)
    return flash_attention_bwd_ref(q, k, v, o, lse, do, lengths,
                                   causal=causal)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_autograd_and_jax(case):
    arr, ln, causal = _inputs(case, 0)
    got = _port_bwd(arr, ln, causal)

    q, k, v = (torch.from_numpy(arr[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    lengths = None if ln is None else torch.from_numpy(ln)
    out = flash_attention_ref(q, k, v, lengths, causal=causal)
    want_torch = torch.autograd.grad(out, (q, k, v),
                                     torch.from_numpy(arr["do"]))

    jl = None if ln is None else jnp.asarray(ln)
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, jl, causal=causal,
                                            impl="xla"),
                     *(jnp.asarray(arr[n]) for n in ("q", "k", "v")))
    want_jax = vjp(jnp.asarray(arr["do"]))

    for g, wt, wj in zip(got, want_torch, want_jax):
        _close(g.numpy(), wt.numpy())
        _close(g.numpy(), wj)


@pytest.mark.parametrize("case", CASES[:2] + [
    (2, 4, 2, 20, 24, 32, True, (24, 0))])       # a row with no live key
def test_lse_ref_matches_float64_logsumexp(case):
    """The plain version of the forward kernel's ``lse`` output (natural
    log, +inf on a row with no live key) against a float64 numpy
    log-sum-exp of the masked scaled scores, within 1e-5 relative (f32
    sums of up to 64 products)."""
    arr, ln, causal = _inputs(case, 5)
    q, k = arr["q"].astype(np.float64), arr["k"].astype(np.float64)
    b, qh, sq, d = q.shape
    sk = k.shape[2]
    s = np.einsum("bhqd,bhkd->bhqk", q,
                  np.repeat(k, qh // k.shape[1], axis=1)) * d ** -0.5
    live = np.ones((b, 1, sq, sk), bool)
    if causal:
        live &= np.tril(np.ones((sq, sk), bool))
    if ln is not None:
        live &= (np.arange(sk) < ln[:, None])[:, None, None]
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    want = np.where(live.any(-1), want, np.inf)
    got = flash_attention_lse_ref(
        torch.from_numpy(arr["q"]), torch.from_numpy(arr["k"]),
        None if ln is None else torch.from_numpy(ln), causal=causal).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(want)],
                               want[np.isfinite(want)], rtol=TOL, atol=TOL)
    if ln is not None and (ln == 0).any():
        assert np.isposinf(got[ln == 0]).all()


def test_bwd_ref_gives_zero_for_a_row_with_no_live_key():
    arr, ln, causal = _inputs((3, 4, 2, 20, 24, 32, False, (24, 0, 7)), 1)
    dq, dk, dv = _port_bwd(arr, ln, causal)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
        assert not g[1].any()
    # ... and the other batch rows are the plain version's autograd
    q, k, v = (torch.from_numpy(arr[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    out = flash_attention_ref(q, k, v, torch.from_numpy(ln), causal=causal)
    want = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arr["do"]))
    for g, w in zip((dq, dk, dv), want):
        _close(g.numpy(), w.numpy())


def test_flash_attention_differentiates_the_plain_version_on_the_cpu():
    """On CPU tensors ``flash_attention`` runs the plain version, autograd
    runs through it, and no kernel is counted."""
    arr, ln, causal = _inputs(CASES[0], 2)
    q, k, v = (torch.from_numpy(arr[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    kernels.reset_launch_counts()
    out = flash_attention(q, k, v, torch.from_numpy(ln), causal=causal)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arr["do"]))
    assert not any(kernels.launch_counts().values())
    for g, w in zip(got, _port_bwd(arr, ln, causal)):
        _close(g.numpy(), w.numpy())


def test_autograd_function_refuses_cpu_tensors():
    """``FlashAttentionFn`` launches the kernels or raises: there is no
    plain-version fallback inside it."""
    arr, ln, causal = _inputs(CASES[2], 3)
    q, k, v = (torch.from_numpy(arr[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    with pytest.raises(ValueError, match="CUDA"):
        FlashAttentionFn.apply(q, k, v, None, causal, None)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, causal=causal, impl="cuda")
