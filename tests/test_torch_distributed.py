"""The port's distributed layer (``repro_torch.distributed``) on meshes of
CPU shards, against the JAX package's modules and plain baselines:

* ``tiara_fetch``: bit-equal to ``reference_fetch`` with exactly two
  ``all_to_all``s, the client-side baseline with at least three
  collectives; a quota that overflows zeroes the same rows as the
  reference's (JAX at one device, a numpy model of its routing at four);
* ``int8_psum`` / ``make_grad_compressor``: the JAX ``_quant`` /
  ``_dequant`` bit for bit, the reference's 0.02 bound, and the hook in
  ``make_train_step``;
* ``sharded_paged_attention``: a small decode step within 2e-4 of the
  port's and the JAX package's unsharded step (the reference's
  tolerance), pages staying per shard;
* ``make_moe_ep``: JAX's ``make_moe_ep`` on a 1 x 1 mesh at 1e-5, and the
  port at 2 x 2 within 1e-4 relative of ``moe_apply`` where nothing drops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.distributed import compression as jcomp
from repro.distributed import moe_ep as jmoe_ep
from repro.distributed import tiara_fetch as jtfetch
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.distributed import compression as comp
from repro_torch.distributed import mesh as M
from repro_torch.distributed import moe_ep, paged_decode
from repro_torch.distributed import tiara_fetch as tfetch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.param import is_def, tree_map
from repro_torch.training.optimizer import AdamWConfig, warmup_cosine
from repro_torch.training.train_step import make_train_step

DECODE_TOL = 2e-4          # tests/test_distributed.py:205
MOE_REL_TOL = 1e-4
MOE_JAX_TOL = 1e-5
INT8_REL_TOL = 0.02        # tests/test_distributed.py:71-85


def _pool_mesh(n=4):
    return M.make_device_mesh(n, devices=["cpu"] * n)


def _grid(a, b, names=("data", "model")):
    return M.make_mesh((a, b), names, ["cpu"] * (a * b))


# -- tiara_fetch --------------------------------------------------------------


def _fetch_inputs(n_shards, T=64, N=64, R=16, n_ids=32, seed=0):
    rng = np.random.default_rng(seed)
    t_shard = T // n_shards
    table = np.concatenate([s * t_shard + rng.permutation(t_shard)
                            for s in range(n_shards)]).astype(np.int32)
    pool = rng.standard_normal((N, R)).astype(np.float32)
    ids = rng.integers(0, T, n_ids).astype(np.int32)
    return table, pool, ids


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tiara_fetch_one_round_vs_client_side():
    mesh = _pool_mesh()
    table, pool, ids = _fetch_inputs(4)
    fetch = tfetch.make_tiara_fetch(mesh, "pool", 64, 64, quota=8)
    mesh.reset_stats()
    out = fetch(_t(table), _t(pool), _t(ids))
    assert isinstance(out, M.Sharded)
    assert np.array_equal(out.full().numpy(),
                          tfetch.reference_fetch(table, pool, ids))
    tc, tb = mesh.collective_counts(), mesh.collective_bytes()
    # one round: exactly 2 all_to_alls, no gathers of pool or table
    assert tc == {"all-to-all": 2}
    mesh.reset_stats()
    base = tfetch.client_side_fetch(mesh, "pool", _t(table), _t(pool),
                                    _t(ids))
    assert np.array_equal(base.full().numpy(), out.full().numpy())
    cc, cb = mesh.collective_counts(), mesh.collective_bytes()
    assert sum(cc.values()) >= 3, cc
    assert sum(cb.values()) > sum(tb.values())


def _routed_zero_rows(ids, n_shards, t_shard, quota):
    """The reference's routing as numpy: an id past its owner's quota is
    dropped, and its -1 parks on the bucket's last slot, where the last
    write wins — so that slot's id reads zeros too."""
    zero = np.zeros(ids.shape[0], bool)
    owner = ids // t_shard
    for o in range(n_shards):
        lanes = np.nonzero(owner == o)[0]
        if lanes.size > quota:
            zero[lanes[quota - 1:]] = True
    return zero


@pytest.mark.parametrize("quota", [32, 5])
def test_tiara_fetch_matches_jax_at_one_shard(quota):
    table, pool, ids = _fetch_inputs(1)
    jmesh = jax.make_mesh((1,), ("pool",))
    want = np.asarray(jax.jit(jtfetch.make_tiara_fetch(
        jmesh, "pool", 64, 64, quota=quota))(
            jnp.asarray(table), jnp.asarray(pool), jnp.asarray(ids)))
    got = tfetch.make_tiara_fetch(_pool_mesh(1), "pool", 64, 64, quota)(
        _t(table), _t(pool), _t(ids)).full().numpy()
    assert np.array_equal(got, want)
    zero = _routed_zero_rows(ids, 1, 64, quota)
    assert np.array_equal(np.abs(got).sum(1) == 0, zero)


def test_tiara_fetch_quota_overflow_zeroes_rows():
    table, pool, ids = _fetch_inputs(4, n_ids=64, seed=2)
    quota = 3
    out = tfetch.make_tiara_fetch(_pool_mesh(), "pool", 64, 64, quota)(
        _t(table), _t(pool), _t(ids)).full().numpy()
    want = tfetch.reference_fetch(table, pool, ids)
    zero = np.concatenate([_routed_zero_rows(ids[s * 16:(s + 1) * 16], 4,
                                             16, quota) for s in range(4)])
    assert zero.any() and not zero.all()
    assert np.array_equal(out[~zero], want[~zero])
    assert not out[zero].any()


# -- int8 gradient all-reduce ------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (7, 37), (3,), (300, 2)])
def test_quant_matches_jax(shape):
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * 3).astype(np.float32)
    jc, js = jcomp._quant(jnp.asarray(x))
    pc, ps = comp._quant(_t(x))
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert np.array_equal(ps.numpy(), np.asarray(js))
    jd = np.asarray(jcomp._dequant(jc, js, shape))
    assert np.array_equal(comp._dequant(pc, ps, shape).numpy(), jd)
    # one participant: the all-reduce is the quantize round trip
    mesh = _grid(1, 1, ("pod", "data"))
    for wire in (False, True):
        got = comp.make_grad_compressor(mesh, "pod", wire=wire)(
            {"w": _t(x)})["w"]
        np.testing.assert_array_equal(got.numpy(), jd)


@pytest.mark.parametrize("wire", [False, True])
def test_int8_psum_accuracy(wire):
    """All pods contributed the same replicated gradient: the compressed
    psum is 2 * g within the reference's 0.02."""
    mesh = _grid(2, 2, ("pod", "data"))
    comp_fn = comp.make_grad_compressor(mesh, "pod", wire=wire)
    g = np.random.default_rng(0).standard_normal((64, 64)) \
        .astype(np.float32)
    out = comp_fn({"w": _t(g), "b": _t(g[0])})
    for k, want in (("w", g), ("b", g[0])):
        rel = float(np.abs(out[k].numpy() - 2 * want).max()
                    / np.abs(want).max())
        assert rel < INT8_REL_TOL, (k, rel)
    assert comp.make_grad_compressor(_grid(2, 2), "pod") is None


def test_grad_compressor_plugs_into_the_train_step():
    cfg = reduce_config(get_config("tiny-lm")).replace(
        dtype="float32", param_dtype="float32")
    mesh = _grid(2, 2, ("pod", "data"))
    inner = comp.make_grad_compressor(mesh, "pod")
    seen = {}

    def hook(grads):
        seen["in"] = grads
        seen["out"] = inner(grads)
        return seen["out"]

    init, step = make_train_step(cfg, AdamWConfig(lr=warmup_cosine(1e-3, 2,
                                                                   10)),
                                 grad_compressor=hook)
    state = init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (2, 16)).astype(np.int64))
    _, metrics = step(state, {"tokens": toks, "labels": toks})
    assert np.isfinite(float(metrics["loss"]))
    g_in = [a for a in jax.tree_util.tree_leaves(
        tree_map(lambda a: a.numpy(), seen["in"]))]
    g_out = [a for a in jax.tree_util.tree_leaves(
        tree_map(lambda a: a.numpy(), seen["out"]))]
    for a, b in zip(g_in, g_out):
        assert a.shape == b.shape
        if np.abs(a).max() > 0:
            assert np.abs(b - 2 * a).max() / np.abs(a).max() \
                < INT8_REL_TOL


# -- sharded paged decode -----------------------------------------------------


@pytest.fixture(scope="module")
def decode_case():
    """Reduced tiny-lm in f32 with paged caches filled at random, one
    decode step of the JAX package and of the port, unsharded."""
    jcfg = jax_reduce_config(jax_get_config("tiny-lm")).replace(
        dtype="float32", param_dtype="float32")
    tcfg = reduce_config(get_config("tiny-lm")).replace(
        dtype="float32", param_dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    b, maxp = 4, 16
    caches = []
    for ci, c in enumerate(jtf.init_caches(jcfg, b, maxp)):
        r2 = np.random.default_rng(100 + ci)
        kp = np.asarray(c.paged.k_pages)
        caches.append(c._replace(paged=c.paged._replace(
            k_pages=jnp.asarray(r2.standard_normal(kp.shape)
                                .astype(kp.dtype) * 0.1),
            v_pages=jnp.asarray(r2.standard_normal(kp.shape)
                                .astype(kp.dtype) * 0.1))))
    caches = tuple(caches)
    bt = np.asarray(jtf.default_block_tables(jcfg, b, maxp))
    rng = np.random.default_rng(7)
    steps = [rng.integers(0, tcfg.vocab, (b, 1)).astype(np.int32)
             for _ in range(2)]
    lengths = np.array([40, 17, 100, 5], np.int32)
    jc, want = caches, []
    for i, toks in enumerate(steps):
        out = jtf.decode_step(jparams, jcfg, {
            "tokens": jnp.asarray(toks), "caches": jc,
            "block_tables": jnp.asarray(bt),
            "lengths": jnp.asarray(lengths + i)})
        want.append(np.asarray(out.logits))
        jc = out.caches
    host = jax.tree_util.tree_map(np.array, caches)
    return tcfg, tparams, host, bt, lengths, steps, want


def _port_decode(cfg, params, caches, bt, lengths, steps):
    got = []
    for i, toks in enumerate(steps):
        out = ttf.decode_step(params, cfg, {
            "tokens": _t(toks), "caches": caches, "block_tables": _t(bt),
            "lengths": _t(lengths + i)})
        got.append(out.logits.numpy())
        caches = out.caches
    return got, caches


@pytest.mark.parametrize("contiguous", [False, True])
def test_sharded_paged_decode_matches_unsharded(decode_case, contiguous):
    tcfg, tparams, host, bt, lengths, steps, want = decode_case
    base, base_caches = _port_decode(
        tcfg, tparams, caches_from_numpy(host, device="cpu"), bt, lengths,
        steps)
    mesh = _grid(2, 2)
    cfg = tcfg.replace(paged_attn_fn=paged_decode.sharded_paged_attention(
        mesh, ("data",), "model", contiguous=contiguous))
    sc = paged_decode.shard_pages(mesh, caches_from_numpy(host,
                                                          device="cpu"),
                                  ("data", "model"))
    ptrs = [s.data_ptr() for s in sc[0].paged.k_pages.shards]
    mesh.reset_stats()
    got, sc_out = _port_decode(cfg, tparams, sc, bt, lengths, steps)
    for g, b_, w in zip(got, base, want):
        np.testing.assert_allclose(g, b_, atol=DECODE_TOL, rtol=DECODE_TOL)
        np.testing.assert_allclose(g, w, atol=DECODE_TOL, rtol=DECODE_TOL)
    # the pages stayed per shard, written in place, and agree with the
    # unsharded step's
    kp = sc_out[0].paged.k_pages
    assert isinstance(kp, M.Sharded)
    assert [s.data_ptr() for s in kp.shards] == ptrs
    np.testing.assert_allclose(kp.full().numpy(),
                               base_caches[0].paged.k_pages.numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    # the only collectives are the merge's, per attention layer
    assert set(mesh.collective_counts()) == {"all-reduce"}


# -- expert-parallel MoE -------------------------------------------------------


def _moe_weights(rng, d, spec):
    def draw(pd):
        fan = pd.fan_in if pd.fan_in is not None else pd.shape[-2]
        return (rng.standard_normal(pd.shape) * fan ** -0.5) \
            .astype(np.float32)
    return tree_map(draw, tmoe.moe_defs(d, spec), is_leaf=is_def)


MOE_SPECS = {
    "top1_shared": tmoe.MoESpec(n_experts=4, top_k=1, d_ff_expert=32,
                                shared_expert=True, capacity_factor=4.0),
    "top2": tmoe.MoESpec(n_experts=6, top_k=2, d_ff_expert=32,
                         capacity_factor=4.0),
}


@pytest.mark.parametrize("name", list(MOE_SPECS))
def test_moe_ep_matches_jax_on_a_1x1_mesh(name):
    spec = MOE_SPECS[name]
    rng = np.random.default_rng(0)
    w = _moe_weights(rng, 64, spec)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    jspec = jmoe.MoESpec(**dataclasses.asdict(spec))
    jy, jaux = jax.jit(jmoe_ep.make_moe_ep(
        jax.make_mesh((1, 1), ("data", "model")), ("data",), jspec))(
            jax.tree_util.tree_map(jnp.asarray, w), jnp.asarray(x))
    y, aux = moe_ep.make_moe_ep(_grid(1, 1), ("data",), spec)(
        params_from_numpy(w, device="cpu"), _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_JAX_TOL,
                               rtol=MOE_JAX_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=MOE_JAX_TOL,
                               rtol=MOE_JAX_TOL)


@pytest.mark.parametrize("name", ["top1_shared"])
def test_moe_ep_2x2_matches_moe_apply_where_nothing_drops(name):
    spec = MOE_SPECS[name]
    rng = np.random.default_rng(1)
    w = params_from_numpy(_moe_weights(rng, 64, spec), device="cpu")
    x = _t(rng.standard_normal((2, 12, 64)).astype(np.float32))
    want, _ = tmoe.moe_apply(w, x, spec)
    mesh = _grid(2, 2)
    # the capacity is per dp shard: check that nothing dropped there
    route = tmoe.moe_route(w, x.reshape(-1, 64), spec)
    for half in route.eidx.reshape(2, -1):
        assert np.bincount(half.numpy(), minlength=spec.n_experts).max() \
            <= tmoe._capacity(12, spec)
    fn = moe_ep.make_moe_ep(mesh, ("data",), spec)
    mesh.reset_stats()
    got, _ = fn(w, x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) / scale < MOE_REL_TOL
    assert mesh.collective_counts() == {"all-gather": 3, "all-reduce": 3}
    # expert weights placed per shard once pass through with no copy
    sw = moe_ep.shard_moe_params(mesh, w)
    assert torch.equal(fn(sw, x)[0], got)
