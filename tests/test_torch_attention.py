"""The port's attention kernels' plain versions against the JAX reference.

Same numpy-seeded inputs through ``repro.kernels.{paged,flash}_attention``
(``impl="xla"``, the reference's plain version, and
``impl="kernel_interpret"``, its Pallas kernel run in interpret mode) and
through the port's entry points on CPU tensors, which run the plain
PyTorch versions.  Tolerances are ``tests/test_kernels.py``'s: 3e-5 in
f32, 0.05 in bf16 (bf16 inputs are rounded from the same f32 values in
both frameworks; both compute in f32 and round the output once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_chunked,
                                                 flash_attention_ref)
from repro_torch.kernels.paged_attention import paged_attention

TOL = {"float32": 3e-5, "bfloat16": 0.05}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               torch_out.float().numpy(), atol=tol,
                               rtol=tol)


def _paged_inputs(seed, dtype, b, qh, kvh, d, pages, page, maxp):
    rng = np.random.default_rng(seed)
    q = _pair(rng, (b, qh, d), dtype)
    k = _pair(rng, (pages, page, kvh, d), dtype)
    v = _pair(rng, (pages, page, kvh, d), dtype)
    bt = rng.integers(0, pages, (b, maxp)).astype(np.int32)
    ln = rng.integers(1, maxp * page + 1, (b,)).astype(np.int32)
    return q, k, v, bt, ln


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,qh,kvh,d,pages,page,maxp", [
    (2, 4, 4, 32, 8, 8, 3),      # MHA
    (3, 8, 2, 64, 16, 8, 5),     # GQA 4:1
    (1, 7, 1, 16, 4, 4, 2),      # MQA, odd heads
    (2, 4, 2, 128, 8, 16, 4),    # head_dim 128
])
def test_paged_attention_matches_jax(dtype, b, qh, kvh, d, pages, page,
                                     maxp):
    q, k, v, bt, ln = _paged_inputs(b * 100 + d, dtype, b, qh, kvh, d,
                                    pages, page, maxp)
    want = jax_paged(q[0], k[0], v[0], jnp.asarray(bt), jnp.asarray(ln),
                     impl="xla")
    got = paged_attention(q[1], k[1], v[1], torch.from_numpy(bt),
                          torch.from_numpy(ln))
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    _close(want, got, TOL[dtype])


def test_paged_attention_matches_pallas_kernel_with_empty_row():
    """Against the Pallas kernel in interpret mode, with a length-0 row:
    0 in both (the reference's plain version gives NaN there)."""
    q, k, v, bt, ln = _paged_inputs(7, "float32", 3, 6, 2, 32, 12, 8, 4)
    ln[1] = 0
    want = jax_paged(q[0], k[0], v[0], jnp.asarray(bt), jnp.asarray(ln),
                     impl="kernel_interpret")
    got = paged_attention(q[1], k[1], v[1], torch.from_numpy(bt),
                          torch.from_numpy(ln))
    _close(want, got, TOL["float32"])
    assert np.all(np.asarray(want)[1] == 0) and torch.all(got[1] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,qh,kvh,s,d", [
    (2, 4, 2, 64, 32),
    (1, 8, 8, 128, 64),
    (2, 6, 2, 96, 16),
])
def test_flash_attention_matches_jax(dtype, causal, b, qh, kvh, s, d):
    rng = np.random.default_rng(b * 1000 + s + d)
    q, k, v = (_pair(rng, (b, h, s, d), dtype) for h in (qh, kvh, kvh))
    ln = rng.integers(1, s + 1, (b,)).astype(np.int32)
    want = jax_flash(q[0], k[0], v[0], jnp.asarray(ln), causal=causal,
                     impl="xla")
    got = flash_attention(q[1], k[1], v[1], torch.from_numpy(ln),
                          causal=causal)
    assert got.dtype == q[1].dtype and got.shape == q[1].shape
    _close(want, got, TOL[dtype])


def test_flash_attention_matches_pallas_kernel_with_empty_row():
    """Against the Pallas kernel in interpret mode; batch row 1 has no
    live key and gives 0 in both."""
    rng = np.random.default_rng(11)
    q, k, v = (_pair(rng, (2, h, 32, 16), "float32") for h in (4, 2, 2))
    ln = np.array([23, 0], np.int32)
    want = jax_flash(q[0], k[0], v[0], jnp.asarray(ln), causal=True,
                     impl="kernel_interpret", block_q=16, block_k=16)
    got = flash_attention(q[1], k[1], v[1], torch.from_numpy(ln))
    _close(want, got, TOL["float32"])
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunked_matches_dense(causal):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1024, 16))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 1024, 16))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 1024, 16))
                         .astype(np.float32))
    ln = torch.tensor([1024, 300], dtype=torch.int32)
    a = flash_attention_ref(q, k, v, ln, causal=causal)
    c = flash_attention_chunked(q, k, v, ln, causal=causal, chunk=256)
    torch.testing.assert_close(a, c, atol=2e-5, rtol=2e-5)


def test_paged_matches_flash_on_same_kv():
    """Cross-kernel consistency of the port's plain versions: decode over
    a paged layout == the single-query row of full attention over the
    equivalent contiguous KV."""
    rng = np.random.default_rng(5)
    b, qh, kvh, d, page, maxp = 2, 4, 2, 32, 8, 4
    s = maxp * page
    k_lin = torch.from_numpy(rng.standard_normal((b, kvh, s, d))
                             .astype(np.float32))
    v_lin = torch.from_numpy(rng.standard_normal((b, kvh, s, d))
                             .astype(np.float32))
    q1 = torch.from_numpy(rng.standard_normal((b, qh, d)).astype(np.float32))
    bt = (torch.arange(b)[:, None] * maxp + torch.arange(maxp)[None]) \
        .to(torch.int32)
    k_pages = k_lin.permute(0, 2, 1, 3).reshape(b * maxp, page, kvh, d)
    v_pages = v_lin.permute(0, 2, 1, 3).reshape(b * maxp, page, kvh, d)
    ln = torch.tensor([s, s - 5], dtype=torch.int32)
    out_paged = paged_attention(q1, k_pages, v_pages, bt, ln)
    out_flash = flash_attention(q1[:, :, None], k_lin, v_lin, ln,
                                causal=False)[:, :, 0]
    torch.testing.assert_close(out_paged, out_flash, atol=3e-5, rtol=3e-5)


def test_cpu_tensors_never_launch():
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted, and impl="cuda" refuses CPU tensors."""
    before = launch_counts()
    q = torch.zeros((1, 2, 8, 16))
    flash_attention(q, q, q)
    pages = torch.zeros((2, 4, 2, 16))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.ones((1,), dtype=torch.int32)
    paged_attention(q[:, :, 0], pages, pages, bt, ln)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention(q[:, :, 0], pages, pages, bt, ln, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(q, q, q, impl="xla")
