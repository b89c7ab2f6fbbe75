"""The arithmetic of the bf16 forward kernel, on the CPU.

``csrc/flash_attention_bf16.cu`` runs both products of bf16 attention on
the bf16 tensor cores: S = Q K^T in one pass from the raw bf16 operands
(every product exact in the f32 accumulator), scaled after the sum, and
P V with P split ``hi + lo`` into two bf16 values, two passes against the
same V tile.  ``flash_attention_bf16_split`` emulates that tile by tile,
with its online softmax; here it is held against the reference package's
``flash_attention`` (``impl="xla"``) on the same seeded bf16 inputs within
two bf16 ulps (``SCOUT_ATTN_TOL`` of ``chip_smoke.py``), and its ``lse``
against ``flash_attention_lse_ref``.  P rounded once to bf16 (what a
one-pass P V would do) misses that limit.  Run as a script, the file
prints both designs' share of the limit at S = 1024:

    PYTHONPATH=src python tests/test_torch_flash_bf16_split.py
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention_lse_ref
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bf16_split)

# chip_smoke.py's SCOUT_ATTN_TOL: (atol, rtol), two bf16 ulps
TOL = (1e-4, 2 ** -6)
LSE_TOL = 1e-5                      # relative, chip_smoke.py's LSE_TOL

# (batch, kv heads, Sq, Sk, lengths) per group size G; Sq != Sk, ragged
# against the 128-key tile, one request with no live key
SHAPES = {1: (2, 2, 96, 160, (131, 0)),
          5: (1, 1, 200, 136, None),
          7: (2, 1, 130, 257, (257, 0))}


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(g, d, seed):
    b, kvh, sq, sk, lens = SHAPES[g]
    rng = np.random.default_rng(seed)
    arr = [_bf16(rng, (b, h, n, d)) for h, n in
           ((g * kvh, sq), (kvh, sk), (kvh, sk))]
    ln = None if lens is None else np.asarray(lens, np.int32)
    return arr, ln


def _jax(arr, ln, causal):
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in arr)
    out = jax_flash(q, k, v, None if ln is None else jnp.asarray(ln),
                    causal=causal, impl="xla")
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _torch(arr, ln):
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arr]
    return t, None if ln is None else torch.from_numpy(ln)


def limit_share(got, want, tol=TOL):
    """The largest |got - want| / (atol + rtol |want|): 1 is the limit."""
    atol, rtol = tol
    w = want.double()
    return float(((got.double() - w).abs() / (atol + rtol * w.abs()))
                 .max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", sorted(SHAPES))
def test_bf16_split_matches_jax(g, d, causal):
    arr, ln = _inputs(g, d, g * 100 + d)
    (q, k, v), lens = _torch(arr, ln)
    block = 64 if d == 128 else 128        # the kernel's key tile
    got, lse = flash_attention_bf16_split(q, k, v, lens, causal=causal,
                                          block_k=block, return_lse=True)
    want = _jax(arr, ln, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert limit_share(got, want) <= 1.0
    want_lse = flash_attention_lse_ref(q, k, lens, causal=causal)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    assert float(((lse - want_lse)[finite].abs()
                  / want_lse[finite].abs().clamp(min=1.0)).max()) <= LSE_TOL
    if ln is not None and (ln == 0).any():
        row = int(np.flatnonzero(ln == 0)[0])
        assert not got[row].any()
        assert torch.isinf(lse[row]).all()


def test_bf16_split_does_not_depend_on_the_tile():
    """64- and 128-key tiles give the output to an ulp: the online
    softmax's rescaling moves nothing past the f32 sums' last bits."""
    arr, ln = _inputs(7, 128, 3)
    (q, k, v), lens = _torch(arr, ln)
    a = flash_attention_bf16_split(q, k, v, lens, block_k=64)
    b = flash_attention_bf16_split(q, k, v, lens, block_k=128)
    assert limit_share(a, b) <= 0.5


def designs(seq=256, d=64, heads=4, seed=2, std=1.0):
    """Each P V design's share of the limit against the reference package
    on one causal case of ``heads`` q heads over one kv head, q scaled so
    that the logits' standard deviation is about ``std``."""
    rng = np.random.default_rng(seed)
    arr = [_bf16(rng, (1, h, seq, d)) for h in (heads, 1, 1)]
    arr[0] = arr[0] * np.float32(std)
    want = _jax(arr, None, True)
    (q, k, v), _ = _torch(arr, None)
    return {f"p_passes={n}": limit_share(
        flash_attention_bf16_split(q, k, v, p_passes=n), want)
        for n in (2, 1)}


def test_rejected_design_misses_the_limit():
    """Why P V keeps two passes: P rounded once to bf16 misses two ulps
    where the split keeps well inside them."""
    shares = designs()
    assert shares["p_passes=2"] < 0.6 and shares["p_passes=1"] > 1.0


if __name__ == "__main__":
    for std in (1.0, 4.0, 16.0):
        print(json.dumps(dict(seq=1024, d=128, logit_std=std,
                              **designs(1024, 128, 4, 0, std))))
