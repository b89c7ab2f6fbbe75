"""The port's model code against the JAX reference on reduced tiny-lm.

Weights are the reference's ``init_params`` draws, carried across as
numpy by ``repro_torch.convert.params_from_numpy`` (the two frameworks'
generators differ).  Inputs are numpy-seeded.  The port runs on the CPU
with its kernels' plain versions.

Tolerance for whole-model logits: 1e-4 absolute and relative, in f32.
Both sides compute in f32 but sum in different orders (XLA's CPU dot
against PyTorch's, one softmax against another); over 2 layers at width
128 the differences measured here were below 3e-6, and 1e-4 leaves room
for other BLAS builds while staying far below the top-2 logit margins
the serving test relies on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.models.blocks import block_apply as jax_block_apply
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.blocks import block_apply
from repro_torch.models.param import count_params, tree_leaves

LOGIT_TOL = 1e-4
LAYER_TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduce_config(jax_get_config("tiny-lm"))
    tcfg = reduce_config(get_config("tiny-lm"))
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def test_reduced_config_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "vocab_padded", "page_size", "rope_theta",
              "dtype", "n_repeat"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    full_j, full_t = jax_get_config("tiny-lm"), get_config("tiny-lm")
    assert (full_j.n_layers, full_j.d_model, full_j.vocab, full_j.page_size) \
        == (full_t.n_layers, full_t.d_model, full_t.vocab, full_t.page_size)
    # the port's own init draws the same tree: names, shapes, count
    own = ttf.init_params(tcfg, seed=1, device="cpu")
    assert [tuple(a.shape) for a in tree_leaves(own)] == \
        [tuple(a.shape) for a in tree_leaves(tparams)]
    assert count_params(own) == count_params(ttf.model_defs(tcfg)) == \
        sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jparams))


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        tl.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        atol=LAYER_TOL, rtol=LAYER_TOL)
    pos = rng.integers(0, 64, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        tl.apply_rope(_t(x), _t(pos), 10000.0).numpy(),
        atol=LAYER_TOL, rtol=LAYER_TOL)
    pos3 = rng.integers(0, 64, (3, 2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        np.asarray(jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                  (4, 6, 6), 1e6)),
        tl.apply_mrope(_t(x), _t(pos3), (4, 6, 6), 1e6).numpy(),
        atol=LAYER_TOL, rtol=LAYER_TOL)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    for kind in ("swiglu", "relu2", "gelu"):
        np.testing.assert_allclose(
            np.asarray(jl.mlp({k: jnp.asarray(a) for k, a in w.items()},
                              jnp.asarray(h), kind)),
            tl.mlp({k: _t(a) for k, a in w.items()}, _t(h), kind).numpy(),
            atol=LAYER_TOL, rtol=LAYER_TOL)


def test_block_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    jbp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][0])
    tbp = {k: {n: a[0] for n, a in v.items()}
           for k, v in tparams["blocks"][0].items()}
    want, _, _ = jax_block_apply(jbp, jnp.asarray(x), jcfg, jcfg.pattern[0],
                                 mode="train", ctx={})
    got, _, _ = block_apply(tbp, _t(x), tcfg, tcfg.pattern[0], mode="train",
                            ctx={})
    np.testing.assert_allclose(np.asarray(want), got.numpy(),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_prefill_and_decode_match_reference(models):
    """apply_model prefill, then two decode steps: logits and the live
    pages of the paged caches agree with the reference."""
    jcfg, tcfg, jparams, tparams = models
    b, s, maxp = 2, 16, 4
    rng = np.random.default_rng(2)
    toks = rng.integers(1, tcfg.vocab, (b, s)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    bt = np.asarray(jtf.default_block_tables(jcfg, b, maxp))
    jc = jtf.init_caches(jcfg, b, maxp)
    tc = ttf.init_caches(tcfg, b, maxp, device="cpu")
    assert np.array_equal(bt, ttf.default_block_tables(tcfg, b, maxp))

    jout = jtf.apply_model(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "caches": jc,
        "block_tables": jnp.asarray(bt), "lengths": jnp.asarray(lengths)},
        mode="prefill")
    tout = ttf.apply_model(tparams, tcfg, {
        "tokens": _t(toks), "caches": tc, "block_tables": _t(bt),
        "lengths": _t(lengths)}, mode="prefill")
    np.testing.assert_allclose(np.asarray(jout.logits), tout.logits.numpy(),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jc = jout.caches
    for step in range(2):
        nxt = rng.integers(1, tcfg.vocab, (b, 1)).astype(np.int32)
        lens = lengths + step
        jout = jtf.apply_model(jparams, jcfg, {
            "tokens": jnp.asarray(nxt), "caches": jc,
            "block_tables": jnp.asarray(bt), "lengths": jnp.asarray(lens)},
            mode="decode")
        tout = ttf.apply_model(tparams, tcfg, {
            "tokens": _t(nxt), "caches": tc, "block_tables": _t(bt),
            "lengths": _t(lens)}, mode="decode")
        np.testing.assert_allclose(np.asarray(jout.logits),
                                   tout.logits.numpy(), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        jc = jout.caches
    # the paged pools: every position a sequence has written
    want = caches_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                             device="cpu")
    page = tcfg.page_size
    for wc, gc in zip(want, tout.caches):
        for wp, gp in zip(wc.paged, gc.paged):
            for seq in range(b):
                n = int(lengths[seq]) + 2
                rows = [(int(bt[seq, t // page]), t % page) for t in range(n)]
                idx = tuple(torch.tensor(r) for r in zip(*rows))
                torch.testing.assert_close(gp[:, idx[0], idx[1]],
                                           wp[:, idx[0], idx[1]],
                                           atol=LAYER_TOL, rtol=LAYER_TOL)


def test_transformer_module_holds_the_tree(models):
    _, tcfg, _, tparams = models
    m = ttf.Transformer(tcfg, tparams)
    sd = m.state_dict()
    assert "tree.blocks.0.mix.wq" in sd and "tree.embed.tokens" in sd
    assert len(sd) == len(tree_leaves(tparams))
    toks = torch.randint(1, tcfg.vocab, (1, 8), generator=torch.Generator()
                         .manual_seed(0))
    want = ttf.apply_model(tparams, tcfg, {"tokens": toks}).logits
    torch.testing.assert_close(m({"tokens": toks}).logits, want)
