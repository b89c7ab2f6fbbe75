"""The port's recurrent families against the JAX reference, on the CPU.

``repro_torch.models.mamba`` and ``repro_torch.models.rwkv`` against
``repro.models.mamba`` and ``repro.models.rwkv``, function by function —
with no cache, with a cache, with ragged ``lengths`` (right-padded
prefill), one decode token, and at S = 512, where the reference takes its
chunked scan — then the reduced Jamba (hybrid Mamba + attention + top-2
MoE) and RWKV-6 models through ``init_caches``, ``prefill`` and
``decode_step``: logits and every carried state.  Inputs and weights are
drawn with numpy from a seed and handed to both packages; the weights'
zero- and one-initialised leaves (``A_log``, ``dt_bias``, ``mu``,
``u_bonus``, ``w_base``, ...) are drawn too, so every term of the
recurrences is exercised.  Everything is f32.

Tolerances:

* functions: 1e-5 absolute and relative.  The port runs the reference's
  arithmetic step for step (``exp(dt A) h + dt x B``; ``w S + k v^T``);
  what differs is the summation order of the matmuls (XLA's CPU dot
  against the CPU BLAS, sums of 32-256 terms, about 1e-6 of the value)
  and of the fused products, and the recurrences, with decays in
  (0, 1), do not amplify it.  A wrong mask, a state read after instead of
  before its update or a missed cast is O(0.1) or more.
* whole-model logits and states: 1e-4, ``tests/test_torch_models.py``'s
  tolerance for a few layers of f32 at width 128.
* prefill + decode against the full forward (port only): 2e-3, as
  ``tests/test_arch_smoke.py`` holds the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.kernels.selective_scan import ref as ss_ref
from repro_torch.kernels.wkv6 import ref as wkv6_ref
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttf
from repro_torch.models.param import count_params, is_def, tree_map
from repro_torch.serving import ServingEngine

FN_TOL = 1e-5
LOGIT_TOL = 1e-4
FULL_TOL = 2e-3
ARCHS = ("jamba-v0.1-52b", "rwkv6-1.6b")
# leaves the reference initialises to zeros or ones, drawn here instead
_CONST = {"conv_b", "dt_bias", "A_log", "D_skip", "mu", "w_base", "u_bonus"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _draw(rng, defs):
    """Numpy weights of a port def tree, scaled as the reference's init
    scales them; the constant-initialised leaves drawn near their
    constants."""
    def leaf(path_name, pd):
        if path_name in _CONST:
            return (rng.standard_normal(pd.shape) * 0.5).astype(np.float32)
        fan = pd.fan_in if pd.fan_in is not None else (
            pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
        return (rng.standard_normal(pd.shape) * fan ** -0.5) \
            .astype(np.float32)
    return {k: leaf(k, v) for k, v in defs.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# -- functions ---------------------------------------------------------------

D = 32
MSPEC = tmamba.MambaSpec(d_state=8, d_conv=4, expand=2, dt_rank=4)
RSPEC = trwkv.RWKVSpec(head_size=8, decay_lora=8)
# (batch, seq, cache given, lengths)
CASES = {
    "no_cache": (2, 24, False, None),
    "cache": (2, 24, True, None),
    "ragged": (3, 24, True, (24, 7, 2)),
    "ragged_no_cache": (3, 24, False, (24, 7, 0)),
    "decode": (3, 1, True, None),
    "chunked_512": (2, 512, True, (512, 300)),
}


def _case(name, seed):
    b, s, with_cache, lengths = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    return rng, x, with_cache, ln


@pytest.mark.parametrize("name", sorted(CASES))
def test_mamba_forward_matches_reference(name):
    rng, x, with_cache, ln = _case(name, 1)
    w = _draw(rng, tmamba.mamba_defs(D, MSPEC))
    d_inner, _ = MSPEC.dims(D)
    cache = None
    if with_cache:
        cache = (rng.standard_normal((x.shape[0], d_inner, MSPEC.d_state))
                 .astype(np.float32),
                 rng.standard_normal((x.shape[0], MSPEC.d_conv - 1,
                                      d_inner)).astype(np.float32))
    jspec = jmamba.MambaSpec(**dataclasses.asdict(MSPEC))
    jout, jc = jmamba.mamba_forward(
        _j(w), jnp.asarray(x), jspec,
        None if cache is None else jmamba.MambaCache(*map(jnp.asarray,
                                                          cache)),
        lengths=None if ln is None else jnp.asarray(ln))
    tout, tc = tmamba.mamba_forward(
        params_from_numpy(w, device="cpu"), _t(x), MSPEC,
        None if cache is None else tmamba.MambaCache(*map(_t, cache)),
        lengths=None if ln is None else _t(ln))
    _close(tout, jout, FN_TOL)
    assert (tc is None) == (jc is None)
    if tc is not None:
        _close(tc.h, jc.h, FN_TOL)
        _close(tc.conv, jc.conv, FN_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rwkv_mixes_match_reference(name):
    rng, x, with_cache, ln = _case(name, 2)
    tw = _draw(rng, trwkv.rwkv_time_defs(D, RSPEC))
    cw = _draw(rng, trwkv.rwkv_channel_defs(D, 48))
    b, nh = x.shape[0], D // RSPEC.head_size
    cache = None
    if with_cache:
        cache = (rng.standard_normal((b, nh, RSPEC.head_size,
                                      RSPEC.head_size)).astype(np.float32),
                 rng.standard_normal((b, D)).astype(np.float32),
                 rng.standard_normal((b, D)).astype(np.float32))
    jspec = jrwkv.RWKVSpec(**dataclasses.asdict(RSPEC))
    jl = None if ln is None else jnp.asarray(ln)
    tl = None if ln is None else _t(ln)
    jout, (js, jx) = jrwkv.rwkv_time_mix(
        _j(tw), jnp.asarray(x), jspec,
        None if cache is None else jrwkv.RWKVCache(*map(jnp.asarray,
                                                        cache)),
        lengths=jl)
    tout, (ts, tx) = trwkv.rwkv_time_mix(
        params_from_numpy(tw, device="cpu"), _t(x), RSPEC,
        None if cache is None else trwkv.RWKVCache(*map(_t, cache)),
        lengths=tl)
    _close(tout, jout, FN_TOL)
    _close(ts, js, FN_TOL)
    _close(tx, jx, FN_TOL)
    prev = None if cache is None else cache[2]
    jout, jx = jrwkv.rwkv_channel_mix(
        _j(cw), jnp.asarray(x), None if prev is None else jnp.asarray(prev),
        lengths=jl)
    tout, tx = trwkv.rwkv_channel_mix(
        params_from_numpy(cw, device="cpu"), _t(x),
        None if prev is None else _t(prev), lengths=tl)
    _close(tout, jout, FN_TOL)
    _close(tx, jx, FN_TOL)


def test_padded_steps_leave_the_states_alone():
    """A right-padded prefill carries exactly the state of the unpadded
    one: the padded positions hold garbage tokens, not zeros."""
    rng = np.random.default_rng(3)
    mw = params_from_numpy(_draw(rng, tmamba.mamba_defs(D, MSPEC)),
                           device="cpu")
    rw = params_from_numpy(_draw(rng, trwkv.rwkv_time_defs(D, RSPEC)),
                           device="cpu")
    x = _t(rng.standard_normal((1, 20, D)).astype(np.float32))
    mc = tmamba.init_mamba_cache(1, D, MSPEC)
    rc = trwkv.init_rwkv_cache(1, D, RSPEC)
    n = torch.tensor([13])
    _, want = tmamba.mamba_forward(mw, x[:, :13], MSPEC, mc)
    _, got = tmamba.mamba_forward(mw, x, MSPEC, mc, lengths=n)
    assert all(torch.allclose(a, b, atol=FN_TOL) for a, b in zip(got, want))
    _, want = trwkv.rwkv_time_mix(rw, x[:, :13], RSPEC, rc)
    _, got = trwkv.rwkv_time_mix(rw, x, RSPEC, rc, lengths=n)
    assert all(torch.allclose(a, b, atol=FN_TOL) for a, b in zip(got, want))


def test_scan_chunking_does_not_change_the_result(monkeypatch):
    """The port's chunk size is a memory knob: one step per chunk gives
    the whole sequence's result in one chunk, to rounding (the vector and
    scalar paths of the CPU's elementwise kernels and batched products
    may differ in the last bit; 1e-6 is a few f32 ulps of values up to
    about 10)."""
    rng = np.random.default_rng(4)
    mw = params_from_numpy(_draw(rng, tmamba.mamba_defs(D, MSPEC)),
                           device="cpu")
    rw = params_from_numpy(_draw(rng, trwkv.rwkv_time_defs(D, RSPEC)),
                           device="cpu")
    x = _t(rng.standard_normal((2, 40, D)).astype(np.float32))
    ln = torch.tensor([40, 17])
    outs = []
    for chunk_bytes in (1 << 30, 1):
        monkeypatch.setattr(ss_ref, "SCAN_CHUNK_BYTES", chunk_bytes)
        monkeypatch.setattr(wkv6_ref, "SCAN_CHUNK_BYTES", chunk_bytes)
        m = tmamba.mamba_forward(mw, x, MSPEC,
                                 tmamba.init_mamba_cache(2, D, MSPEC),
                                 lengths=ln)
        r = trwkv.rwkv_time_mix(rw, x, RSPEC,
                                trwkv.init_rwkv_cache(2, D, RSPEC),
                                lengths=ln)
        outs.append([m[0], *m[1], r[0], *r[1]])
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-6


def test_moe_top2_at_capacity_1_25_drops_the_reference_tokens():
    """Jamba's MoE: 16 experts, top-2, capacity factor 1.25.  Skewed
    routing overflows the favourite experts, so tokens are dropped, and
    the port drops the same ones as the reference."""
    spec = tmoe.MoESpec(n_experts=16, top_k=2, d_ff_expert=32,
                        capacity_factor=1.25)
    rng = np.random.default_rng(5)
    w = tree_map(lambda pd: (rng.standard_normal(pd.shape)
                             * (pd.fan_in or pd.shape[-2]) ** -0.5)
                 .astype(np.float32), tmoe.moe_defs(64, spec),
                 is_leaf=is_def)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    x[..., 0] = 2.0
    w["router"][0, :2] = 1.5                 # experts 0 and 1 favoured
    cap = tmoe._capacity(128, spec)
    route = tmoe.moe_route(params_from_numpy(w, device="cpu"),
                           _t(x.reshape(128, 64)), spec)
    counts = np.bincount(route.eidx.reshape(-1).numpy(), minlength=16)
    assert cap == 20 and int(np.maximum(counts - cap, 0).sum()) > 0
    jout, jaux = jmoe.moe_apply(_j(w), jnp.asarray(x),
                                jmoe.MoESpec(**dataclasses.asdict(spec)))
    tout, taux = tmoe.moe_apply(params_from_numpy(w, device="cpu"), _t(x),
                                spec)
    _close(tout, jout, FN_TOL)
    _close(taux, jaux, FN_TOL)


# -- models ------------------------------------------------------------------


def _with_cf(cfg, cf):
    """``cfg`` (either package's) with every MoE at capacity factor
    ``cf``; None keeps reduce_config's."""
    if cf is None:
        return cfg
    return cfg.replace(pattern=tuple(
        dataclasses.replace(s, moe=None if s.moe is None else
                            dataclasses.replace(s.moe, capacity_factor=cf))
        for s in cfg.pattern))


def _cfgs(arch, cf=None):
    """(reference, port) reduced configs of one period: n_repeat 1."""
    jcfg = jax_reduce_config(jax_get_config(arch))
    tcfg = reduce_config(get_config(arch))
    n = len(tcfg.pattern)
    return (_with_cf(jcfg.replace(n_layers=n), cf),
            _with_cf(tcfg.replace(n_layers=n), cf))


def _model_weights(arch, seed):
    """Numpy weights of the reduced model: the reference's init draws,
    with every constant-initialised recurrent leaf redrawn."""
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtf.init_params(jcfg,
                                                  jax.random.PRNGKey(seed)))
    for blk in tree["blocks"]:
        for part in ("mix", "ffn"):
            for k in _CONST & set(blk[part]):
                blk[part][k] = (rng.standard_normal(blk[part][k].shape)
                                * 0.5).astype(np.float32)
    return tree


B, S, MAXP = 2, 16, 3
LENGTHS = np.array([16, 11], np.int32)
STEPS = 3                                    # prefill + 2 decode steps


def _run_jax(arch, cf=None):
    jcfg, _ = _cfgs(arch, cf)
    w = _model_weights(arch, 0)
    rng = np.random.default_rng(6)
    toks = [rng.integers(1, jcfg.vocab, (B, S)).astype(np.int32)] + \
        [rng.integers(1, jcfg.vocab, (B, 1)).astype(np.int32)
         for _ in range(STEPS - 1)]
    bt = np.asarray(jtf.default_block_tables(jcfg, B, MAXP))
    caches = jtf.init_caches(jcfg, B, MAXP)
    logits, states = [], []
    for step in range(STEPS):
        out = jtf.apply_model(_j(w), jcfg, dict(
            tokens=jnp.asarray(toks[step]), caches=caches,
            block_tables=jnp.asarray(bt),
            lengths=jnp.asarray(LENGTHS + max(step - 1, 0))),
            mode="prefill" if step == 0 else "decode")
        caches = out.caches
        logits.append(np.asarray(out.logits))
        states.append(jax.tree_util.tree_map(np.asarray, caches))
    return dict(w=w, toks=toks, bt=bt, logits=logits, states=states,
                aux=float(out.aux_loss), cf=cf)


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's prefill and decode steps, once per model (and once
    more for Jamba at its published capacity factor 1.25)."""
    runs = {}

    def get(arch, cf=None):
        if (arch, cf) not in runs:
            runs[arch, cf] = _run_jax(arch, cf)
        return runs[arch, cf]
    return get


def _leaves(caches):
    """Every tensor of a tuple of layer caches, in field order."""
    out = []
    for c in caches:
        for f in c:
            if f is not None:
                out.extend(f)
    return out


@pytest.mark.parametrize("arch,cf", [(ARCHS[0], None), (ARCHS[0], 1.25),
                                     (ARCHS[1], None)],
                         ids=["jamba", "jamba_cf1.25", "rwkv6"])
def test_model_prefill_and_decode_match_reference(arch, cf, jax_runs):
    """Prefill (ragged lengths), then two decode steps: logits and every
    carried state (paged KV, Mamba h and conv window, RWKV state and token
    shifts) agree with the reference after each step."""
    ref = jax_runs(arch, cf)
    _, tcfg = _cfgs(arch, cf)
    params = params_from_numpy(ref["w"], device="cpu")
    caches = ttf.init_caches(tcfg, B, MAXP, device="cpu")
    kinds = {s.kind for s in tcfg.pattern}
    assert kinds == ({"attn", "mamba"} if arch == ARCHS[0] else {"rwkv"})
    for step in range(STEPS):
        fn = ttf.prefill if step == 0 else ttf.decode_step
        out = fn(params, tcfg, dict(
            tokens=_t(ref["toks"][step]), caches=caches,
            block_tables=_t(ref["bt"]),
            lengths=_t(LENGTHS + max(step - 1, 0))))
        _close(out.logits, ref["logits"][step], LOGIT_TOL)
        got, want = _leaves(out.caches), _leaves(ref["states"][step])
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w, LOGIT_TOL)
    _close(float(out.aux_loss), ref["aux"], FN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_caches_cross_into_the_port(arch, jax_runs):
    """``caches_from_numpy`` carries the reference's caches after its
    prefill (paged, mamba and rwkv fields); the port's decode step from
    them gives the reference's decode logits and states."""
    ref = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    caches = caches_from_numpy(ref["states"][0], device="cpu")
    out = ttf.decode_step(params_from_numpy(ref["w"], device="cpu"), tcfg,
                          dict(tokens=_t(ref["toks"][1]), caches=caches,
                               block_tables=_t(ref["bt"]),
                               lengths=_t(LENGTHS)))
    _close(out.logits, ref["logits"][1], LOGIT_TOL)
    for g, w in zip(_leaves(out.caches), _leaves(ref["states"][1])):
        _close(g, w, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(arch, jax_runs):
    """The port's analogue of ``test_prefill_decode_matches_full_forward``
    with ragged prompts: each sequence's decode logits equal the full
    forward on its prompt plus the token, at the last position."""
    ref = jax_runs(arch)
    _, tcfg = _cfgs(arch)
    params = params_from_numpy(ref["w"], device="cpu")
    caches = ttf.init_caches(tcfg, B, MAXP, device="cpu")
    bt = _t(ref["bt"])
    ttf.prefill(params, tcfg, dict(tokens=_t(ref["toks"][0]), caches=caches,
                                   block_tables=bt, lengths=_t(LENGTHS)))
    nxt = _t(ref["toks"][1])
    dec = ttf.decode_step(params, tcfg, dict(tokens=nxt, caches=caches,
                                             block_tables=bt,
                                             lengths=_t(LENGTHS)))
    for i, n in enumerate(LENGTHS):
        full = torch.cat([_t(ref["toks"][0][i:i + 1, :n]), nxt[i:i + 1]], 1)
        f = ttf.apply_model(params, tcfg, {"tokens": full}, mode="train")
        err = float((dec.logits[i, 0] - f.logits[0, -1]).abs().max())
        assert err < FULL_TOL, (arch, i, err)


# -- entry points and configs ------------------------------------------------


def test_engine_refuses_the_recurrent_archs():
    """As the reference's engine does (tests/test_checkpoint_serving.py),
    the port's serves attention-only decoders."""
    for arch in ARCHS:
        cfg = reduce_config(get_config(arch))
        with pytest.raises(AssertionError):
            ServingEngine(cfg, ttf.init_params(cfg, seed=0, device="cpu"),
                          device="cpu")


def test_init_caches_needs_a_device(monkeypatch):
    cfg = _cfgs(ARCHS[0])[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_caches(cfg, 1, 2)
    caches = ttf.init_caches(cfg, 1, 2, device="cpu")
    assert all(a.device.type == "cpu" for a in _leaves(caches))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       (jax_reduce_config(jax_get_config(arch)),
                        reduce_config(get_config(arch)))):
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
    """The published widths (Jamba v0.1: arXiv:2403.19887; RWKV-6 1.6B:
    arXiv:2404.05892) and the parameter counts the chip smoke runs: Jamba
    cut to one period of 8 layers (13.295 G), RWKV-6 whole (1.584 G)."""
    jamba, rwkv = get_config(ARCHS[0]), get_config(ARCHS[1])
    assert (jamba.n_layers, jamba.d_model, jamba.n_heads, jamba.n_kv_heads,
            jamba.head_dim, jamba.d_ff, jamba.vocab) == \
        (32, 4096, 32, 8, 128, 14336, 65536)
    assert [s.kind for s in jamba.pattern] == ["attn"] + ["mamba"] * 7
    assert [s.mlp for s in jamba.pattern] == ["swiglu", "moe"] * 4
    moe = jamba.pattern[1].moe
    assert (moe.n_experts, moe.top_k, moe.d_ff_expert, moe.capacity_factor,
            moe.shared_expert) == (16, 2, 14336, 1.25, False)
    assert jamba.mamba.dims(jamba.d_model) == (8192, 256)
    assert (jamba.mamba.d_state, jamba.mamba.d_conv, jamba.rope,
            jamba.page_size) == (16, 4, "none", 128)
    assert (rwkv.n_layers, rwkv.d_model, rwkv.d_ff, rwkv.vocab,
            rwkv.rwkv.head_size, rwkv.rwkv.decay_lora, rwkv.norm) == \
        (24, 2048, 7168, 65536, 64, 64, "layernorm")
    assert rwkv.is_attention_free and jamba.sub_quadratic
    assert round(count_params(ttf.model_defs(jamba.replace(n_layers=8)))
                 / 1e9, 3) == 13.295
    assert round(count_params(ttf.model_defs(jamba)) / 1e9, 1) == 51.6
    assert round(count_params(ttf.model_defs(rwkv)) / 1e9, 3) == 1.584
