"""The port's multimodal families against the JAX reference, on the CPU.

The reduced Qwen2-VL (a vision stub and M-RoPE) and SeamlessM4T (an
encoder-decoder: an encoder stack, then decoder blocks that cross-attend
its output) through ``init_caches``, ``prefill`` and ``decode_step``:
logits and every cache leaf (the paged KV, ``cross_k`` / ``cross_v``)
after a ragged prefill and two decode steps, a decode step from the
reference's own caches, and the analogue of
``test_prefill_decode_matches_full_forward``.  Inputs and weights are
drawn with numpy from a seed and handed to both packages; the norms'
scales and biases are drawn too, so that a block reading the wrong norm
shows.  Everything is f32; the JAX side runs jitted, its attention the plain
version, as its own tests run it on the CPU (``impl="auto"`` resolves to
``"xla"``).

The M-RoPE streams are distinct, by the Qwen2-VL rule (``get_rope_index``
of the public Qwen2-VL code): a prefix of vision tokens takes grid ids (t
= 0, h = row, w = col) on an image grid, the text after it continues from
the largest id + 1 on all three streams, and decode continues per request
from its own next id.  With equal streams a mistake in the order of the
sections could not show.

SeamlessM4T's ``enc_lengths`` is ragged and holds a 0: that request's
cross attention has no live key and gives 0, as the reference's plain
version does.  The reference's encoder attends the
padded frames of a ragged batch (its ``block_apply`` passes no lengths to
the encoder's self-attention); the port matches it, and these inputs show
the match.

Tolerances: 1e-4 for whole-model logits and caches
(``tests/test_torch_models.py``'s, a few layers of f32 at width 128); 1e-5
for one attention layer; 2e-3 for prefill + decode against the full
forward, as ``tests/test_arch_smoke.py`` holds the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.param import (count_params, is_def, tree_leaves,
                                      tree_map)

FN_TOL = 1e-5
LOGIT_TOL = 1e-4
FULL_TOL = 2e-3
QWEN, SEAMLESS = "qwen2-vl-7b", "seamless-m4t-medium"
ARCHS = (QWEN, SEAMLESS)

B, S, MAXP = 2, 16, 3
LENGTHS = np.array([16, 11], np.int32)
STEPS = 3                                    # prefill + 2 decode steps
GRIDS = ((2, 3), (3, 2))                     # each request's image (h, w)
S_ENC = 12
ENC_LENGTHS = (7, 0)                         # of S_ENC frames


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def mrope_positions(grid, n):
    """(3, n) t/h/w ids of one request: an image prefix of ``grid`` (h,
    w) patches at (0, row, col), then text from the largest id + 1 on all
    three streams."""
    gh, gw = grid
    nv = gh * gw
    pos = np.empty((3, n), np.int32)
    i = np.arange(min(nv, n))
    pos[:, :len(i)] = np.stack([np.zeros_like(i), i // gw, i % gw])
    st = max(gh, gw)                          # largest vision id + 1
    pos[:, nv:] = st + np.arange(n - nv)
    return pos


def _cfgs(arch):
    return (jax_reduce_config(jax_get_config(arch)),
            reduce_config(get_config(arch)))


def _model_weights(arch, seed):
    """Numpy weights of the reduced model at the reference's parameter
    shapes, drawn from ``seed``: each matrix normal over the square root
    of its fan-in, the token table normal, every norm's scale around 1
    and its bias around 0, so that a block reading the wrong norm shows."""
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name == "bias":
            a = 0.2 * rng.standard_normal(shape)
        elif name == "tokens":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * shape[-2] ** -0.5
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jtf.param_shapes(jcfg))


def _inputs(cfg, enc_lengths):
    """Numpy inputs of the three steps (prefill, two decode tokens)."""
    rng = np.random.default_rng(6)
    inp = dict(toks=[rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)]
               + [rng.integers(1, cfg.vocab, (B, 1)).astype(np.int32)
                  for _ in range(STEPS - 1)])
    if cfg.rope == "mrope":
        pos = np.stack([mrope_positions(g, S + STEPS) for g in GRIDS], 1)
        emb = np.zeros((B, S, cfg.d_model), np.float32)
        for i, (gh, gw) in enumerate(GRIDS):
            emb[i, :gh * gw] = rng.standard_normal((gh * gw, cfg.d_model))
        inp.update(pos=pos, embeds=emb)
    if cfg.enc_dec:
        inp.update(enc_embeds=rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32),
            enc_lengths=np.asarray(enc_lengths, np.int32))
    return inp


def _lengths(step):
    return LENGTHS + max(step - 1, 0)


def _step_batch(cfg, inp, step, cv):
    """Step ``step``'s batch (without caches and tables), its arrays made
    by ``cv`` (``jnp.asarray`` or ``torch.from_numpy``)."""
    batch = dict(tokens=cv(inp["toks"][step]), lengths=cv(_lengths(step)))
    if cfg.rope == "mrope":
        if step == 0:
            pos3 = inp["pos"][:, :, :S]
            batch["embeds"] = cv(inp["embeds"])
        else:                                 # each request's next id
            col = LENGTHS + step - 1
            pos3 = inp["pos"][:, np.arange(B), col][:, :, None]
        batch["positions3"] = cv(np.ascontiguousarray(pos3))
    if cfg.enc_dec:
        batch["enc_lengths"] = cv(inp["enc_lengths"])
        if step == 0:
            batch["enc_embeds"] = cv(inp["enc_embeds"])
    return batch


_jax_apply = jax.jit(jtf.apply_model, static_argnames=("cfg", "mode"))


def _run_jax(arch, enc_lengths):
    jcfg, _ = _cfgs(arch)
    w = _model_weights(arch, 0)
    inp = _inputs(jcfg, enc_lengths)
    bt = np.asarray(jtf.default_block_tables(jcfg, B, MAXP))
    caches = jtf.init_caches(jcfg, B, MAXP,
                             cross_len=S_ENC if jcfg.enc_dec else 0)
    logits, states, aux = [], [], []
    for step in range(STEPS):
        out = _jax_apply(_j(w), cfg=jcfg, batch=dict(
            _step_batch(jcfg, inp, step, jnp.asarray), caches=caches,
            block_tables=jnp.asarray(bt)),
            mode="prefill" if step == 0 else "decode")
        caches = out.caches
        logits.append(np.asarray(out.logits))
        states.append(jax.tree_util.tree_map(np.asarray, caches))
        aux.append(float(out.aux_loss))
    return dict(w=w, inp=inp, bt=bt, logits=logits, states=states, aux=aux)


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's prefill and decode steps, once per family."""
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _run_jax(arch, ENC_LENGTHS)
        return runs[arch]
    return get


def _leaves(caches):
    """Every tensor of a tuple of layer caches, in field order."""
    out = []
    for c in caches:
        for f in c:
            if f is None:
                continue
            out.extend([f] if hasattr(f, "shape") else f)
    return out


def _port_caches(tcfg):
    return ttf.init_caches(tcfg, B, MAXP, device="cpu",
                           cross_len=S_ENC if tcfg.enc_dec else 0)


@pytest.mark.parametrize("arch", ARCHS, ids=["qwen2_vl", "seamless"])
def test_model_prefill_and_decode_match_reference(arch, jax_runs):
    """Prefill (ragged lengths), then two decode steps: logits and every
    cache leaf (paged KV; SeamlessM4T's cross KV) agree with the
    reference after each step, with distinct M-RoPE streams and ragged
    ``enc_lengths`` that hold a 0."""
    ref = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params = params_from_numpy(ref["w"], device="cpu")
    caches = _port_caches(tcfg)
    for step in range(STEPS):
        fn = ttf.prefill if step == 0 else ttf.decode_step
        out = fn(params, tcfg, dict(
            _step_batch(tcfg, ref["inp"], step, _t), caches=caches,
            block_tables=_t(ref["bt"])))
        _close(out.logits, ref["logits"][step], LOGIT_TOL)
        got, want = _leaves(out.caches), _leaves(ref["states"][step])
        assert len(got) == len(want) == (4 if tcfg.enc_dec else 2)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w, LOGIT_TOL)
        _close(float(out.aux_loss), ref["aux"][step], FN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_caches_cross_into_the_port(arch, jax_runs):
    """``caches_from_numpy`` carries the reference's caches after its
    prefill (the paged pools and the cross KV); the port's decode step
    from them gives the reference's decode logits and caches."""
    ref = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    caches = caches_from_numpy(ref["states"][0], device="cpu")
    out = ttf.decode_step(params_from_numpy(ref["w"], device="cpu"), tcfg,
                          dict(_step_batch(tcfg, ref["inp"], 1, _t),
                               caches=caches, block_tables=_t(ref["bt"])))
    _close(out.logits, ref["logits"][1], LOGIT_TOL)
    got, want = _leaves(out.caches), _leaves(ref["states"][1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(arch, jax_runs):
    """The port's analogue of ``test_prefill_decode_matches_full_forward``
    with ragged prompts: each request's decode logits equal the full
    forward (``mode="train"``) on its prompt plus the token, at the last
    position — with its own M-RoPE ids and image embeddings, or its own
    encoder frames and ``enc_lengths``."""
    ref = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    inp = ref["inp"]
    params = params_from_numpy(ref["w"], device="cpu")
    caches = _port_caches(tcfg)
    bt = _t(ref["bt"])
    ttf.prefill(params, tcfg, dict(_step_batch(tcfg, inp, 0, _t),
                                   caches=caches, block_tables=bt))
    dec = ttf.decode_step(params, tcfg, dict(_step_batch(tcfg, inp, 1, _t),
                                             caches=caches, block_tables=bt))
    for i, n in enumerate(LENGTHS):
        full = {"tokens": _t(np.concatenate(
            [inp["toks"][0][i:i + 1, :n], inp["toks"][1][i:i + 1]], 1))}
        if tcfg.rope == "mrope":
            full["positions3"] = _t(inp["pos"][:, i:i + 1, :n + 1])
            full["embeds"] = _t(np.concatenate(
                [inp["embeds"][i:i + 1, :n],
                 np.zeros((1, 1, tcfg.d_model), np.float32)], 1))
        if tcfg.enc_dec:
            full["enc_embeds"] = _t(inp["enc_embeds"][i:i + 1])
            full["enc_lengths"] = _t(inp["enc_lengths"][i:i + 1])
        f = ttf.apply_model(params, tcfg, full, mode="train")
        err = float((dec.logits[i, 0] - f.logits[0, -1]).abs().max())
        assert err < FULL_TOL, (arch, i, err)


@pytest.mark.parametrize("sq", (1, 7))
def test_cross_attention_matches_reference(sq):
    """One cross-attention layer (``attention_full`` with ``kv_override``,
    non-causal, keys masked past ``lengths``) against the reference's, at
    Sq != Sk: Sq = 1 as in every decode step, and 7 as in a prefill; one
    request's encoder length is 0 (its output is 0, not NaN)."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = _cfgs(SEAMLESS)
    d, nh, nkv, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, \
        tcfg.head_dim
    w = {name: (rng.standard_normal(shape) * shape[0] ** -0.5)
         .astype(np.float32) for name, shape in (
             ("wq", (d, nh * hd)), ("wk", (d, nkv * hd)),
             ("wv", (d, nkv * hd)), ("wo", (nh * hd, d)))}
    ln = np.array([13, 0, 5], np.int32)
    k = rng.standard_normal((3, 13, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((3, 13, nkv, hd)).astype(np.float32)
    x = rng.standard_normal((3, sq, d)).astype(np.float32)
    jout, _ = jattn.attention_full(
        _j(w), jnp.asarray(x), jcfg, causal=False, lengths=jnp.asarray(ln),
        kv_override=(jnp.asarray(k), jnp.asarray(v)))
    tout, _ = tattn.attention_full(
        params_from_numpy(w, device="cpu"), _t(x), tcfg, causal=False,
        lengths=_t(ln), kv_override=(_t(k), _t(v)))
    assert np.isfinite(np.asarray(jout)).all()
    _close(tout, jout, FN_TOL)
    assert not tout[1].any()                  # no live key: 0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_defs_match_reference(arch):
    """The parameter trees cross name for name and shape for shape (the
    encoder subtree and the decoder's ``norm_x`` / ``cross`` included),
    at the reduced and the published widths."""
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       _cfgs(arch)):
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                      jtf.param_shapes(jcfg))
        got = tree_map(lambda d: tuple(d.shape), ttf.model_defs(tcfg),
                       is_leaf=is_def)
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       _cfgs(arch)):
        for f in dataclasses.fields(tcfg):
            got = getattr(tcfg, f.name)
            if f.name == "attn_fn":     # the port's own hook: unset
                assert got is None
                continue
            want = getattr(jcfg, f.name)
            if f.name == "pattern":
                assert [dataclasses.asdict(s) for s in got] == \
                    [dataclasses.asdict(s) for s in want]
            elif dataclasses.is_dataclass(got):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name


def test_published_config_numbers():
    """The published widths (Qwen2-VL-7B: arXiv:2409.12191;
    SeamlessM4T-medium: arXiv:2308.11596) and the parameter counts the
    chip smoke runs whole: 7,615,487,488 and 877,260,800."""
    qwen, sm = get_config(QWEN), get_config(SEAMLESS)
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.n_kv_heads,
            qwen.head_dim, qwen.d_ff, qwen.vocab, qwen.rope,
            qwen.mrope_sections, qwen.page_size) == \
        (28, 3584, 28, 4, 128, 18944, 152064, "mrope", (16, 24, 24), 128)
    assert (sm.n_layers, sm.n_enc_layers, sm.d_model, sm.n_heads,
            sm.n_kv_heads, sm.head_dim, sm.d_ff, sm.vocab, sm.vocab_padded,
            sm.norm, sm.pattern[0].mlp, sm.enc_dec) == \
        (12, 12, 1024, 16, 16, 64, 4096, 256206, 256256, "layernorm",
         "gelu", True)
    assert count_params(ttf.model_defs(qwen)) == 7_615_487_488
    assert count_params(ttf.model_defs(sm)) == 877_260_800


def test_mrope_positions_follow_the_qwen2_vl_rule():
    """The helper's ids: grid ids on the image, then text from the
    largest id + 1 on all three streams."""
    pos = mrope_positions((2, 3), 9)
    assert pos.tolist() == [[0, 0, 0, 0, 0, 0, 3, 4, 5],
                            [0, 0, 0, 1, 1, 1, 3, 4, 5],
                            [0, 1, 2, 0, 1, 2, 3, 4, 5]]


def test_cross_len_must_match_the_encoder():
    """The port writes the cross KV into the caller's caches in place, so
    their encoder length must be the prefill's."""
    _, tcfg = _cfgs(SEAMLESS)
    params = ttf.init_params(tcfg, seed=0, device="cpu")
    inp = _inputs(tcfg, ENC_LENGTHS)
    caches = ttf.init_caches(tcfg, B, MAXP, device="cpu", cross_len=S_ENC + 1)
    with pytest.raises(ValueError, match="cross_len"):
        ttf.prefill(params, tcfg, dict(
            _step_batch(tcfg, inp, 0, _t), caches=caches,
            block_tables=ttf.default_block_tables(tcfg, B, MAXP)))
    assert len(tree_leaves(params["encoder"])) > 0
