"""The port's MoE family and dense decoder configs against the JAX reference.

``repro_torch.models.moe.moe_apply`` against ``repro.models.moe.moe_apply``
on numpy-seeded weights and inputs; prefill and decode of reduced Llama-4
Scout and Maverick, and forward passes of the reduced dense configs,
against the JAX model with the reference's ``init_params`` draws carried
across by ``repro_torch.convert.params_from_numpy``; the serving engine on
reduced Scout against the JAX engine and under the tiara resolver, whose
decode steps also resolve expert routes through ``MoEExpertGather``.  The
port runs on the CPU with its kernels' plain versions.

Tolerances, f32 throughout:

* ``moe_apply`` out and aux: 1e-5 absolute and relative.  One MoE layer at
  width 64 sums in other orders than XLA's CPU dot (differences measured
  here below 1e-6); routing is a discrete choice, so any gap beyond
  rounding would be a dropped or misrouted token, far above 1e-5.
* whole-model logits: 1e-4, ``tests/test_torch_models.py``'s tolerance
  and its reasons.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.blocks import block_apply
from repro_torch.models.param import is_def, tree_leaves, tree_map
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
MOE_TOL = 1e-5
LOGIT_TOL = 1e-4
MOE_ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b")
DENSE_ARCHS = ("nemotron-4-15b", "granite-3-8b", "internlm2-1.8b",
               "stablelm-1.6b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, d, spec):
    """Numpy weights of the port's ``moe_defs`` tree, scaled as the
    reference's init scales them."""
    def draw(pd):
        fan = pd.fan_in if pd.fan_in is not None else pd.shape[-2]
        return (rng.standard_normal(pd.shape) * fan ** -0.5) \
            .astype(np.float32)
    return tree_map(draw, tmoe.moe_defs(d, spec), is_leaf=is_def)


def _both(w, x, spec):
    """(JAX out, JAX aux, port out, port aux) on the same weights."""
    jout, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, w),
                                jnp.asarray(x),
                                jmoe.MoESpec(**dataclasses.asdict(spec)))
    tout, taux = tmoe.moe_apply(params_from_numpy(w, device="cpu"), _t(x),
                                spec)
    return np.asarray(jout), float(jaux), tout.numpy(), float(taux)


def _check(w, x, spec):
    jout, jaux, tout, taux = _both(w, x, spec)
    np.testing.assert_allclose(tout, jout, atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(taux, jaux, atol=MOE_TOL, rtol=MOE_TOL)
    return tout


# -- moe_apply --------------------------------------------------------------


@pytest.mark.parametrize("spec,shape", [
    (tmoe.MoESpec(n_experts=4, top_k=1, d_ff_expert=32, shared_expert=True,
                  capacity_factor=2.0), (2, 12, 64)),
    (tmoe.MoESpec(n_experts=6, top_k=2, d_ff_expert=32), (2, 10, 64)),
], ids=["top1_shared", "top2"])
def test_moe_apply_matches_reference(spec, shape):
    rng = np.random.default_rng(0)
    w = _weights(rng, shape[-1], spec)
    x = rng.standard_normal(shape).astype(np.float32)
    _check(w, x, spec)


def test_moe_apply_drops_the_reference_tokens():
    """Low capacity and skewed routing: most tokens want expert 0, which
    takes ``cap`` of them in flat (token, k) order; the rest are dropped
    (a zero row with no shared expert), exactly as in the reference."""
    spec = tmoe.MoESpec(n_experts=4, top_k=1, d_ff_expert=32,
                        capacity_factor=0.25)
    rng = np.random.default_rng(1)
    w = _weights(rng, 64, spec)
    x = rng.standard_normal((1, 64, 64)).astype(np.float32)
    x[..., 0] = 2.0
    w["router"][0, 0] = 1.5                  # +3 on expert 0's logit
    cap = tmoe._capacity(64, spec)
    route = tmoe.moe_route(params_from_numpy(w, device="cpu"),
                           _t(x[0]), spec)
    counts = np.bincount(route.eidx[:, 0].numpy(), minlength=4)
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert cap == 8 and dropped > 0
    out = _check(w, x, spec)
    assert int((np.abs(out[0]).sum(-1) == 0).sum()) == dropped


def test_moe_apply_breaks_router_ties_toward_the_lower_expert():
    """Experts 1, 2 and 3 get the same logits, exact in f32 (integer
    weights and inputs): top-2 takes 1 then 2, as ``jax.lax.top_k``
    does."""
    spec = tmoe.MoESpec(n_experts=4, top_k=2, d_ff_expert=32)
    rng = np.random.default_rng(2)
    w = _weights(rng, 64, spec)
    x = rng.integers(-1, 2, (2, 8, 64)).astype(np.float32)
    x[..., 0] = 1.0
    col = rng.integers(-2, 3, 64).astype(np.float32)
    col[0] = 60.0
    w["router"][:] = rng.integers(-2, 3, (64, 4)).astype(np.float32)
    w["router"][:, 1:] = col[:, None]
    route = tmoe.moe_route(params_from_numpy(w, device="cpu"),
                           _t(x.reshape(16, 64)), spec)
    assert (route.eidx.numpy() == [1, 2]).all()
    assert (route.gate.numpy() == 0.5).all()
    _check(w, x, spec)


# -- configs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
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
        assert (tcfg.vocab_padded, tcfg.n_repeat) == \
            (jcfg.vocab_padded, jcfg.n_repeat)


# -- models ----------------------------------------------------------------


def _models(arch):
    jcfg = jax_reduce_config(jax_get_config(arch))
    tcfg = reduce_config(get_config(arch))
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def scout():
    return _models("llama4-scout-17b-a16e")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(arch, scout):
    """Prefill, then two decode steps, of reduced Scout and Maverick:
    logits and aux loss agree with the reference; the MoE leaves crossed
    by name and shape."""
    jcfg, tcfg, jparams, tparams = scout if arch == MOE_ARCHS[0] \
        else _models(arch)
    j = len(tcfg.pattern) - 1                  # the MoE pattern element
    ffn = tparams["blocks"][j]["ffn"]
    assert set(ffn) == {"router", "wi", "wg", "wo", "shared"}
    assert [tuple(a.shape) for a in tree_leaves(ffn)] == \
        [tuple(a.shape) for a in
         jax.tree_util.tree_leaves(jparams["blocks"][j]["ffn"])]
    b, s, maxp = 2, 16, 4
    rng = np.random.default_rng(2)
    toks = rng.integers(1, tcfg.vocab, (b, s)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    bt = np.asarray(jtf.default_block_tables(jcfg, b, maxp))
    jc = jtf.init_caches(jcfg, b, maxp)
    tc = ttf.init_caches(tcfg, b, maxp, device="cpu")
    batch = {"tokens": toks, "lengths": lengths}
    for step in range(3):
        mode = "prefill" if step == 0 else "decode"
        jout = jtf.apply_model(jparams, jcfg, dict(
            {k: jnp.asarray(v) for k, v in batch.items()}, caches=jc,
            block_tables=jnp.asarray(bt)), mode=mode)
        tout = ttf.apply_model(tparams, tcfg, dict(
            {k: _t(v) for k, v in batch.items()}, caches=tc,
            block_tables=_t(bt)), mode=mode)
        np.testing.assert_allclose(tout.logits.numpy(),
                                   np.asarray(jout.logits), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        np.testing.assert_allclose(float(tout.aux_loss),
                                   float(jout.aux_loss), atol=MOE_TOL,
                                   rtol=MOE_TOL)
        assert float(tout.aux_loss) > 0
        jc = jout.caches
        batch = {"tokens": rng.integers(1, tcfg.vocab, (b, 1))
                 .astype(np.int32), "lengths": lengths + step}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_forward_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    toks = np.random.default_rng(3).integers(1, tcfg.vocab, (2, 12)) \
        .astype(np.int32)
    want = jtf.apply_model(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got = ttf.apply_model(tparams, tcfg, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_moe_block_refuses_the_distributed_moe(scout):
    """The distributed MoE hook: with ``cfg.moe_fn`` set, ``block_apply``
    hands the layer's MoE to it (the expert-parallel ``make_moe_ep`` on a
    2 x 2 mesh of CPU shards) instead of refusing it, and the block equals
    the one through ``moe_apply`` where no assignment drops.  (The name is
    kept from when the port refused the hook.)"""
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed.moe_ep import make_moe_ep
    _, tcfg, _, tparams = scout
    bp = tree_map(lambda a: a[0], tparams["blocks"][0])
    spec = dataclasses.replace(tcfg.pattern[0].moe, capacity_factor=8.0)
    layer = dataclasses.replace(tcfg.pattern[0], moe=spec)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, tcfg.d_model)).astype(np.float32)).to(
            tree_leaves(bp)[0].dtype)
    calls = []
    mesh = dmesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    ep_fn = make_moe_ep(mesh, ("data",), spec)

    def moe_fn(p, h):
        calls.append(h.shape)
        return ep_fn(p, h)

    cfg = tcfg.replace(moe_fn=moe_fn)
    got, _, _ = block_apply(bp, x, cfg, layer, mode="train", ctx={})
    want, _, _ = block_apply(bp, x, tcfg, layer, mode="train", ctx={})
    assert calls == [(2, 4, tcfg.d_model)]
    torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_init_params_takes_an_explicit_generator():
    cfg = reduce_config(get_config("llama4-scout-17b-a16e"))
    want = ttf.init_params(cfg, seed=5, device="cpu")
    got = ttf.init_params(cfg, generator=torch.Generator().manual_seed(5),
                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(want)))


# -- serving ---------------------------------------------------------------


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, cfg.vocab, 4 + i)))
            for i in range(n)]


def _serve(cfg, params, **kw):
    eng = ServingEngine(cfg, params, max_slots=2, max_seq=64,
                        temperature=0.0, eos_id=-1, device="cpu", **kw)
    hs = [eng.submit(p, max_new=3) for p in _prompts(cfg, 2)]
    out = eng.run_to_completion()
    assert all(h.ok for h in hs)
    return eng, out


@pytest.fixture(scope="module")
def scout_host(scout):
    return _serve(scout[1], scout[3])[1]


@pytest.fixture(scope="module")
def scout_tiara(scout):
    return _serve(scout[1], scout[3], resolver="tiara", n_homes=2)


def test_scout_engine_greedy_tokens_match_jax_engine(scout, scout_host):
    jcfg, _, jparams, _ = scout
    jeng = JaxEngine(jcfg, jparams, max_slots=2, max_seq=64,
                     temperature=0.0, eos_id=-1)
    for p in _prompts(jcfg, 2):
        jeng.submit(p, max_new=3)
    assert scout_host == jeng.run_to_completion()


def test_scout_engine_tiara_matches_host(scout_host, scout_tiara):
    assert scout_tiara[1] == scout_host


def test_scout_engine_tiara_gathers_experts(scout_tiara):
    """The reference's ``test_tiara_parity_moe_expert_gather``:
    ``resolve_step`` checks every gathered expert slab against the
    requested route, so finishing at parity proves the MoEExpertGather
    path ran clean."""
    eng = scout_tiara[0]
    assert eng.resolver is not None and eng.resolver.moe is not None
    assert eng.resolver.loop.stats.executed > 0


def test_serve_launcher_runs_scout_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama4-scout-17b-a16e", "--reduced", "--device", "cpu",
         "--requests", "2", "--max-new", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["seq 0", "seq 1"]
    assert all(len(ast.literal_eval(ln.split(": ", 1)[1])) == 3
               for ln in lines)
