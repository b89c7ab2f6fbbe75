"""The port's training path against the JAX reference, on the CPU.

One train step (``make_train_step``: forward in train mode, loss, autograd,
AdamW) of six reduced families — tiny-lm, Llama-4 Scout (MoE), Jamba
(Mamba + attention + MoE), RWKV-6, Qwen2-VL (M-RoPE over distinct
streams) and SeamlessM4T (encoder-decoder, ragged ``enc_lengths``) —
against the reference's on the same weights, batch and optimizer state:
the loss, every gradient and every updated parameter.  The state crosses
as numpy through ``repro_torch.convert.train_state_from_numpy``; both
sides catch the gradients through their ``grad_compressor`` hook.  The
weights are drawn with numpy from a seed at the reference's shapes (every
norm's scale and bias too, so that a block reading the wrong norm shows).
Everything is f32; the reference runs jitted with ``remat="none"`` (one
compile per family, shared by a module-scope fixture) and the port with
the default ``remat="full"``: remat changes memory, never values.
Tolerance ``STEP_TOL``: 1e-4 of each leaf's largest entry plus 1e-4
relative, as ``tests/test_torch_models.py`` holds whole-model logits (a
few layers of f32 at width 128, summed in other orders).  The step's
AdamW takes ``eps = STEP_EPS`` = 1e-3 instead of 1e-8: Adam's first step
is ``g / (|g| + eps)``, whose slope near ``g = 0`` is ``1 / eps``, so with
1e-8 a gradient entry of about 1e-8 (each package's f32 sums give such
entries a few 1e-8 apart while the leaf's largest is 0.1) moves its
parameter by up to half the learning rate between the packages; with
1e-3 a gradient error of 1e-4 of the leaf moves a parameter by at most
1e-5 of it.  The default eps is held in
``test_adamw_update_matches_reference``, on gradients away from 0.

Then, port only or port against the reference module by module: the
optimizer (quantize8, AdamW 8-bit against 32-bit, one update of each
against the reference's), gradient accumulation, remat, the recurrent
scans' autograd-safe form, checkpoints (the reference's tests, and a
checkpoint crossing between the packages both ways), the trainer
(loss falls, restart, the straggler watchdog), the data pipeline, the
launcher and the device rules.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data import DataConfig as JDataConfig
from repro.data import LMPipeline as JLMPipeline
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import kernels
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data import DataConfig, LMPipeline
from repro_torch.kernels.selective_scan import ref as ss_ref
from repro_torch.kernels.wkv6 import ref as wkv6_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import transformer as ttf
from repro_torch.models.param import tree_leaves
from repro_torch.training import Trainer, TrainerConfig
from repro_torch.training import optimizer as topt
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, Q8,
                                            dequantize8, make_adamw,
                                            quantize8, warmup_cosine)
from repro_torch.training.train_step import TrainState, make_train_step

STEP_TOL = 1e-4
STEP_EPS = 1e-3
FAMILIES = ("tiny-lm", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
            "rwkv6-1.6b", "qwen2-vl-7b", "seamless-m4t-medium")
B, S, S_ENC = 2, 16, 12
ENC_LENGTHS = (12, 7)


def _cfgs(arch):
    kw = dict(dtype="float32", param_dtype="float32")
    return (jax_reduce_config(jax_get_config(arch)).replace(**kw),
            reduce_config(get_config(arch)).replace(**kw))


def _weights(jcfg, seed):
    """Numpy weights at the reference's shapes: matrices normal over the
    square root of their fan-in, the token table normal, norms' scales
    around 1 and biases around 0."""
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


def _batch(cfg, seed):
    """A numpy batch: tokens and labels, and the family's extra inputs
    (M-RoPE ids over distinct t/h/w streams with image embeddings; encoder
    frames with ragged lengths)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.rope == "mrope":
        i = np.arange(S)
        pos = np.stack([np.where(i < 6, 0, i - 3), np.where(i < 6, i // 3,
                                                            i - 3),
                        np.where(i < 6, i % 3, i - 3)]).astype(np.int32)
        b["positions3"] = np.repeat(pos[:, None], B, 1)
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                       * (i < 6)[None, :, None]).astype(np.float32)
    if cfg.enc_dec:
        b["enc_embeds"] = rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32)
        b["enc_lengths"] = np.asarray(ENC_LENGTHS, np.int32)
    return b


def _opt_cfg(mod, bits=32, eps=1e-8):
    return mod.AdamWConfig(lr=mod.warmup_cosine(1e-3, 2, 10), eps=eps,
                           state_bits=bits)


def _run_jax(arch):
    jcfg, _ = _cfgs(arch)
    w = _weights(jcfg, 0)
    batch = _batch(jcfg, 1)
    opt_init, _ = jopt.make_adamw(_opt_cfg(jopt))
    params = jax.tree_util.tree_map(jnp.asarray, w)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt=opt_init(params))
    np_state = jax.tree_util.tree_map(np.asarray, state)

    def run(st, bt):
        cap = {}

        def catch(g):
            cap["g"] = g
            return g
        _, step = jts.make_train_step(jcfg.replace(remat="none"),
                                      _opt_cfg(jopt, eps=STEP_EPS),
                                      grad_compressor=catch)
        new, metrics = step(st, bt)
        return cap["g"], new, metrics
    grads, new, metrics = jax.jit(run)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    tonp = jax.tree_util.tree_map
    return dict(state=np_state, batch=batch, grads=tonp(np.asarray, grads),
                new=tonp(np.asarray, new),
                loss=float(metrics["loss"]))


@pytest.fixture(scope="module")
def jax_steps():
    """The reference's train step, once per family."""
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _run_jax(arch)
        return runs[arch]
    return get


def _close(got, want, tol=STEP_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(jax_steps, arch):
    ref = jax_steps(arch)
    _, tcfg = _cfgs(arch)
    state = train_state_from_numpy(ref["state"], device="cpu")
    caught = {}

    def catch(g):
        caught["g"] = g
        return g
    _, step = make_train_step(tcfg, _opt_cfg(topt, eps=STEP_EPS),
                              grad_compressor=catch)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in ref["batch"].items()})
    assert abs(float(metrics["loss"]) - ref["loss"]) \
        <= STEP_TOL * abs(ref["loss"])
    got_g = tree_leaves(caught["g"])
    want_g = _jleaves(ref["grads"])
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        _close(g.numpy(), w)
    for p, w in zip(tree_leaves(state.params), _jleaves(ref["new"].params)):
        _close(p.detach().numpy(), w)
    assert int(state.step) == int(ref["new"].step) == 1
    assert int(state.opt.count) == int(ref["new"].opt.count) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """One step of every architecture's reduced config on the port: a
    finite loss, the step counted, finite parameters (the reference's
    ``tests/test_arch_smoke.py::test_train_step_smoke``)."""
    cfg = reduce_config(get_config(arch))
    init, step = make_train_step(cfg, AdamWConfig(lr=warmup_cosine(1e-3, 2,
                                                                   10)))
    state = init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])), arch
    assert int(state.step) == 1
    for p in tree_leaves(state.params):
        assert torch.isfinite(p).all(), f"{arch}: NaN in params"


# -- optimizer ---------------------------------------------------------------


def test_quantize8_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(5000)
                         .astype(np.float32) * 3.0)
    q = quantize8(x)
    xd = dequantize8(q, x.shape)
    assert float((x - xd).abs().max() / x.abs().max()) < 0.02
    assert q.codes.dtype == torch.int8
    jq = jopt.quantize8(jnp.asarray(x.numpy()))
    assert np.array_equal(q.codes.numpy(), np.asarray(jq.codes))
    assert np.array_equal(q.scales.numpy(), np.asarray(jq.scales))


def test_adamw8_tracks_adamw32():
    """8-bit state must converge like f32 on a quadratic."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(512)
                              .astype(np.float32))
    results = {}
    for bits in (32, 8):
        init, update = make_adamw(AdamWConfig(lr=lambda s: 0.05,
                                              weight_decay=0.0,
                                              state_bits=bits))
        params = {"w": torch.zeros(512)}
        state = init(params)
        for _ in range(150):
            g = {"w": 2 * (params["w"] - target)}
            params, state, _ = update(g, state, params)
        results[bits] = float(torch.sum(torch.square(params["w"] - target)))
    assert results[32] < 0.5, results
    assert results[8] < 1.5, results


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_update_matches_reference(bits):
    """One update from the same params, grads and (nonzero) state: the new
    params and moments equal the reference's within 1e-5 relative (f32
    arithmetic in another order); 8-bit moments within one code step."""
    rng = np.random.default_rng(bits)
    shapes = {"a": (3, 300), "b": {"c": (40,)}}
    draw = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params, grads = draw, jax.tree_util.tree_map(lambda a: a * 0.3 - 0.1,
                                                 draw)
    mu = jax.tree_util.tree_map(lambda a: a * 0.01, draw)
    nu = jax.tree_util.tree_map(lambda a: np.square(a) * 1e-3, draw)
    if bits == 8:
        mu = jax.tree_util.tree_map(jopt.quantize8, mu)
        nu = jax.tree_util.tree_map(lambda a: jopt.quantize8(np.sqrt(a)),
                                    nu)
    jstate = jopt.AdamWState(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu)
    _, jupdate = jopt.make_adamw(_opt_cfg(jopt, bits))
    want_p, want_s, _ = jupdate(grads, jstate, params)

    ts = train_state_from_numpy(jts.TrainState(
        step=np.int32(0), params=params,
        opt=jax.tree_util.tree_map(np.asarray, jstate)), device="cpu")
    _, update = make_adamw(_opt_cfg(topt, bits))
    got_p, got_s, _ = update(
        jax.tree_util.tree_map(torch.from_numpy, grads), ts.opt, ts.params)
    for g, w in zip(tree_leaves(got_p), _jleaves(want_p)):
        _close(g.detach().numpy(), w, 1e-5)
    assert int(got_s.count) == int(want_s.count) == 4
    for name in ("mu", "nu"):
        gl = tree_leaves(getattr(got_s, name),
                         is_leaf=lambda x: isinstance(x, Q8))
        wl = jax.tree_util.tree_leaves(
            getattr(want_s, name),
            is_leaf=lambda x: isinstance(x, jopt.Q8))
        for g, w in zip(gl, wl):
            if bits == 32:
                _close(g.numpy(), w, 1e-5)
            else:
                _close(g.scales.numpy(), w.scales, 1e-5)
                step = np.abs(g.codes.numpy().astype(int)
                              - np.asarray(w.codes).astype(int))
                assert int(step.max()) <= 1


def test_grad_accumulation_equivalence():
    cfg = reduce_config(get_config("tiny-lm"))
    opt = AdamWConfig(lr=warmup_cosine(1e-3, 2, 10), clip_norm=None)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))}
    params = []
    for micro in (1, 2):
        init, step = make_train_step(cfg, opt, micro_batches=micro)
        state, _ = step(init(0, device="cpu"), batch)
        params.append([p.detach() for p in tree_leaves(state.params)])
    worst = max(float((a - b).abs().max()) for a, b in zip(*params))
    assert worst < 5e-3, worst


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("unit", ["pattern", "layer"])
def test_remat_gives_the_same_gradients(monkeypatch, remat, unit):
    """Reduced Jamba (Mamba, attention and MoE layers): every remat mode
    gives the gradients of ``remat="none"``, bit for bit, and a
    checkpointing mode runs each attention layer's forward again in the
    backward."""
    calls = [0]
    plain = attn_mod.flash_attention

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    monkeypatch.setattr(attn_mod, "flash_attention", counted)
    cfg = reduce_config(get_config("jamba-v0.1-52b"))
    n_attn = cfg.n_repeat * sum(s.kind == "attn" for s in cfg.pattern)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    grads = {}
    for mode in ("none", remat):
        c = cfg.replace(remat=mode, remat_unit=unit)
        params = ttf.trainable(ttf.init_params(c, seed=2, device="cpu"))
        calls[0] = 0
        out = ttf.apply_model(params, c, batch, mode="train")
        loss = out.logits.logsumexp(-1).mean() + out.aux_loss
        grads[mode] = torch.autograd.grad(loss, tree_leaves(params))
        assert calls[0] == n_attn * (1 if mode == "none" else 2)
    assert all(torch.equal(a, b) for a, b in zip(grads["none"],
                                                  grads[remat]))


# -- scans -------------------------------------------------------------------


@pytest.mark.parametrize("chunk_bytes", [1 << 28, 4096])
def test_scans_autograd_safe_form_equals_in_place(monkeypatch, chunk_bytes):
    """Under gradients the Mamba and RWKV scans run out of place; their
    results equal the in-place form's (the inference path) within 1e-5 of
    the largest value, over ragged ``valid`` masks and several chunks, and
    a backward runs through them."""
    monkeypatch.setattr(ss_ref, "SCAN_CHUNK_BYTES", chunk_bytes)
    monkeypatch.setattr(wkv6_ref, "SCAN_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(5)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape)
                                .astype(np.float32))
    b, s, d, n, nh, hs = 2, 9, 8, 4, 2, 4
    valid = torch.arange(s)[None] < torch.tensor([9, 5])[:, None]
    mamba_in = (t(b, d, n), t(b, s, d, lo=0.0), t(b, s, d), t(b, s, n),
                t(b, s, n), -t(d, n, lo=0.1, hi=1.0), valid)
    rwkv_in = (t(b, nh, hs, hs), t(b, s, nh, hs), t(b, s, nh, hs),
               t(b, s, nh, hs), t(b, s, nh, hs, lo=0.5, hi=0.99),
               t(nh, hs), valid)
    for scan, args in ((mamba_mod._scan, mamba_in),
                       (rwkv_mod._scan, rwkv_in)):
        with torch.no_grad():
            want = scan(*args)
        leaves = [a.clone().requires_grad_(True) if a.is_floating_point()
                  else a for a in args]
        got = scan(*leaves)
        for g, w in zip(got, want):
            _close(g.detach().numpy(), w.numpy(), 1e-5)
        grads = torch.autograd.grad(sum(g.sum() for g in got),
                                    [a for a in leaves if a.requires_grad])
        assert all(torch.isfinite(g).all() for g in grads)


# -- checkpoints -------------------------------------------------------------


def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)},
            "t": (torch.zeros(2), torch.tensor(7))}


def test_checkpoint_atomic_retention_async(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    saver = ckpt.AsyncSaver()
    for step in (10, 20, 30, 40):
        saver.save(tree, d, step)
    saver.wait()
    assert ckpt.latest_step(d) == 40
    removed = ckpt.retain(d, keep=2)
    assert len(removed) == 2 and ckpt.latest_step(d) == 40
    out = ckpt.restore(tree, d)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert int(out["t"][1]) == 7
    assert ckpt.meta(d, 40)["n_arrays"] == 4


def test_checkpoint_restore_onto_a_device(tmp_path):
    """The reference's reshard-on-load: ``device=`` places every leaf."""
    d = str(tmp_path)
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    ckpt.save(tree, d, 1)
    out = ckpt.restore(tree, d, device="cpu")
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], tree["w"])


def test_checkpoint_missing_key_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save({"a": torch.zeros(2)}, d, 1)
    with pytest.raises(KeyError):
        ckpt.restore({"a": torch.zeros(2), "b": torch.zeros(2)}, d)


def _np_train_state(bits):
    """A reference TrainState as numpy: f32 and bf16 weights, 8-bit or f32
    moments, nonzero counters."""
    rng = np.random.default_rng(bits)
    w = {"embed": {"tokens": rng.standard_normal((8, 4))
                   .astype(np.float32)},
         "blocks": ({"w": rng.standard_normal((2, 4, 300))
                     .astype(jnp.bfloat16)},)}
    mom = jax.tree_util.tree_map(
        lambda a: np.abs(a.astype(np.float32)) * 0.1, w)
    if bits == 8:
        mom = jax.tree_util.tree_map(jopt.quantize8, mom)
    mom = jax.tree_util.tree_map(np.asarray, mom)
    return jts.TrainState(step=np.int32(5), params=w,
                          opt=jopt.AdamWState(count=np.int32(5), mu=mom,
                                              nu=mom))


@pytest.mark.parametrize("bits", [32, 8])
def test_checkpoint_crosses_between_the_packages(tmp_path, bits):
    """A checkpoint saved by the reference restores into the port, and one
    saved by the port restores into the reference, leaf for leaf, bf16 and
    8-bit state included."""
    want = _np_train_state(bits)
    jckpt.save(want, str(tmp_path / "jax"), 5)
    like = train_state_from_numpy(want, device="cpu")
    for p in tree_leaves(like.params):
        p.detach().zero_()
    got = ckpt.restore(like, str(tmp_path / "jax"))
    assert got.params["blocks"][0]["w"].dtype == torch.bfloat16
    want_l = _jleaves(want)
    got_l = _jleaves(train_state_to_numpy(got))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert np.array_equal(g, np.asarray(w).astype(g.dtype))

    ckpt.save(got, str(tmp_path / "port"), 5)
    back = jckpt.restore(jax.tree_util.tree_map(jnp.asarray, want),
                         str(tmp_path / "port"))
    for g, w in zip(_jleaves(back), want_l):
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_async_saver_copies_before_returning(tmp_path, monkeypatch):
    """The port's optimizer updates tensors in place: a step taken while
    the saver's thread still waits to write must not reach the file."""
    go = threading.Event()
    write = ckpt._write

    def held(*a, **k):
        go.wait(10)
        return write(*a, **k)
    monkeypatch.setattr(ckpt, "_write", held)
    init, update = make_adamw(AdamWConfig(lr=lambda s: 0.1))
    params = {"w": torch.ones(300)}
    opt = init(params)
    saver = ckpt.AsyncSaver()
    saver.save((params, opt), str(tmp_path), 1)
    update({"w": torch.ones(300)}, opt, params)       # in place
    assert not torch.equal(params["w"], torch.ones(300))
    go.set()
    saver.wait()
    back = ckpt.restore(({"w": torch.zeros(300)}, init({"w": torch.zeros(
        300)})), str(tmp_path))
    assert torch.equal(back[0]["w"], torch.ones(300))
    assert int(back[1].count) == 0 and not back[1].mu["w"].any()


def test_train_state_crosses_through_numpy():
    want = _np_train_state(8)
    got = train_state_to_numpy(train_state_from_numpy(want, device="cpu"))
    assert isinstance(got.opt, AdamWState) and isinstance(got, TrainState)
    for g, w in zip(_jleaves(got), _jleaves(want)):
        assert np.array_equal(g, np.asarray(w).astype(g.dtype))


# -- trainer, data, launcher, devices --------------------------------------


def test_trainer_loss_decreases_and_restarts(tmp_path):
    cfg = reduce_config(get_config("tiny-lm"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    tcfg = TrainerConfig(total_steps=40, log_every=10, ckpt_every=20,
                         ckpt_dir=str(tmp_path), peak_lr=2e-3, warmup=5)
    tr = Trainer(cfg, tcfg, dcfg, device="cpu")
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0], losses
    assert ckpt.latest_step(str(tmp_path)) == 40

    # preemption + restart: resumes at the checkpointed step
    tr2 = Trainer(cfg, TrainerConfig(total_steps=43, log_every=1,
                                     ckpt_dir=str(tmp_path), peak_lr=2e-3,
                                     warmup=5), dcfg, device="cpu")
    st2 = tr2.init_or_restore()
    assert int(st2.step) == 40
    assert all(p.requires_grad for p in tree_leaves(st2.params))
    st2 = tr2.run(st2)
    assert int(st2.step) == 43


def test_straggler_watchdog_bookkeeping():
    cfg = reduce_config(get_config("tiny-lm"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    tcfg = TrainerConfig(total_steps=12, log_every=100,
                         straggler_factor=0.0)   # everything is "slow"
    flagged = []
    tr = Trainer(cfg, tcfg, dcfg, device="cpu",
                 straggler_hook=lambda step, ratio: flagged.append(step))
    tr.run()
    # first 7 steps build the window; afterwards every step flags
    assert len(tr.straggler_steps) >= 4
    assert flagged == tr.straggler_steps


def test_pipeline_matches_reference_bit_for_bit(tmp_path):
    for kw in (dict(vocab=100, seq_len=8, global_batch=4, seed=7),
               dict(vocab=32000, seq_len=64, global_batch=6, shard=1,
                    num_shards=2)):
        port, ref = LMPipeline(DataConfig(**kw)), JLMPipeline(
            JDataConfig(**kw))
        for step in (0, 13, 14):
            a, b = port.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
        assert port.state(3) == ref.state(3)
    assert not np.array_equal(port.batch(13)["tokens"],
                              port.batch(14)["tokens"])
    port.save_state(str(tmp_path / "d.json"), 9)
    assert LMPipeline.load_state(str(tmp_path / "d.json"))["step"] == 9


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "tiny-lm", "--reduced", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt", str(tmp_path), "--state-bits", "8"])
    assert "finished at step 3" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_init_params_needs_a_device(monkeypatch):
    cfg = reduce_config(get_config("tiny-lm"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_params(cfg, seed=0)
    params = ttf.init_params(cfg, seed=0, device="cpu")
    assert all(p.device.type == "cpu" for p in tree_leaves(params))
    assert not any(p.requires_grad for p in tree_leaves(params))


def test_trainable_marks_the_weights_in_place():
    """``tf.trainable`` makes a ``Transformer``'s weights require
    gradients without copying them: the module's parameters, the tree it
    hands out and the tensors it was built from are the same storage."""
    cfg = reduce_config(get_config("tiny-lm"))
    params = ttf.init_params(cfg, seed=0, device="cpu")
    module = ttf.Transformer(cfg, params)
    assert not any(p.requires_grad for p in module.parameters())
    tree = ttf.trainable(module.params)
    assert all(p.requires_grad for p in module.parameters())
    assert [p.data_ptr() for p in tree_leaves(tree)] == \
        [p.data_ptr() for p in tree_leaves(params)]


def test_trainer_needs_a_device(monkeypatch):
    cfg = reduce_config(get_config("tiny-lm"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainerConfig(total_steps=1), dcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, AdamWConfig(lr=lambda s: 1e-3))[0](0)
    assert Trainer(cfg, TrainerConfig(total_steps=1), dcfg,
                   device="cpu").device.type == "cpu"


def test_config_keeps_the_reference_remat_fields():
    for arch in ARCH_IDS:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        assert (tcfg.remat, tcfg.remat_unit) == (jcfg.remat,
                                                 jcfg.remat_unit)
    assert {f.name for f in dataclasses.fields(get_config("tiny-lm"))} \
        >= {"remat", "remat_unit"}
