"""The port's dry-run cells (``repro_torch.launch.cells``) against the JAX
package's, on the CPU:

* the parameter specs and shapes of every architecture, leaf for leaf;
* ``SHAPES`` and ``cell_applicable``;
* ``make_cell``'s argument shapes and dtypes, in/out specs and donated
  arguments, against JAX's ``make_cell`` on an ``AbstractMesh`` (no
  devices), on both production meshes, every kind, each variant once and
  8-bit optimizer state once;
* the reference's sharded-decode check replayed on a 2 x 2 mesh of CPU
  shards: ``baseline``, ``tiara_decode`` and ``tiara_decode_v2`` within
  2e-4 of each other (``tests/test_distributed.py:200``), and the
  baseline within 1e-4 of JAX's baseline ``cell.fn`` on a 1 x 1 mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.jaxcompat import mesh_context
from repro.launch import cells as jcells
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.mesh import P
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.param import tree_leaves_with_path

DECODE_TOL = 2e-4            # tests/test_distributed.py:200
JAX_TOL = 1e-4

ARCHS = list(configs.ARCH_IDS) + ["tiny-lm"]


def _jkey(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _entry(e):
    """A spec entry with a one-name tuple written as the name (JAX's
    spelling)."""
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return e


def _norm(spec):
    ents = spec.entries if isinstance(spec, P) else tuple(spec)
    return tuple(_entry(e) for e in ents)


def _jax_leaves(tree, is_leaf=None):
    return [(tuple(_jkey(k) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _jax_specs(tree):
    return [(p, _norm(s)) for p, s in
            _jax_leaves(tree, lambda x: isinstance(x, JP))]


def _port_specs(tree):
    return [(p, _norm(s)) for p, s in
            tree_leaves_with_path(tree, lambda x: isinstance(x, P))]


def _jax_shapes(tree):
    return [(p, tuple(s.shape), jnp.dtype(s.dtype).name)
            for p, s in _jax_leaves(tree)]


def _port_shapes(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shapes_match_jax(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert _port_specs(tf.param_specs(cfg)) == \
        _jax_specs(jtf.param_specs(jcfg))
    assert _port_shapes(tf.param_shapes(cfg)) == \
        _jax_shapes(jtf.param_shapes(jcfg))
    # the meta init builds the same structure and draws nothing
    meta = tf.init_params(cfg, device="meta")
    assert _port_shapes(meta) == _port_shapes(tf.param_shapes(cfg))


def test_shapes_and_cell_applicable_match_jax():
    assert {k: tuple(vars(v).values()) for k, v in configs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCH_IDS:
        for name in configs.SHAPES:
            assert configs.cell_applicable(configs.get_config(arch),
                                           configs.SHAPES[name]) == \
                jconfigs.cell_applicable(jconfigs.get_config(arch),
                                         jconfigs.SHAPES[name])


def _jax_mesh(multi):
    if multi:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


# (arch, shape, multi-pod mesh, variant, state_bits)
CELLS = [
    ("granite-3-8b", "train_4k", False, "baseline", 32),
    ("llama4-scout-17b-a16e", "train_4k", True, "baseline", 8),
    ("internlm2-1.8b", "prefill_32k", True, "baseline", 32),
    ("seamless-m4t-medium", "prefill_32k", False, "baseline", 32),
    ("qwen2-vl-7b", "decode_32k", True, "baseline", 32),
    ("jamba-v0.1-52b", "long_500k", False, "baseline", 32),
    ("rwkv6-1.6b", "decode_32k", True, "baseline", 32),
    ("granite-3-8b", "decode_32k", False, "tiara_decode", 32),
    ("internlm2-1.8b", "decode_32k", True, "tiara_decode_v2", 32),
    ("stablelm-1.6b", "train_4k", True, "remat_layer", 32),
    ("nemotron-4-15b", "prefill_32k", False, "moe_hints", 32),
    ("llama4-maverick-400b-a17b", "decode_32k", False,
     "remat_layer+moe_hints", 32),
    ("llama4-scout-17b-a16e", "prefill_32k", True, "moe_ep", 32),
    ("jamba-v0.1-52b", "decode_32k", False, "moe_ep+remat_layer", 32),
]


@pytest.mark.parametrize("arch,shape,multi,variant,bits", CELLS,
                         ids=["-".join(map(str, c)) for c in CELLS])
def test_make_cell_matches_jax(arch, shape, multi, variant, bits):
    jcell = jcells.make_cell(jconfigs.get_config(arch),
                             jconfigs.SHAPES[shape], _jax_mesh(multi),
                             state_bits=bits, variant=variant)
    cell = cells.make_cell(configs.get_config(arch), configs.SHAPES[shape],
                           make_production_mesh(multi_pod=multi),
                           state_bits=bits, variant=variant)
    assert _port_shapes(cell.args) == _jax_shapes(jcell.args)
    assert all(t.device.type == "meta"
               for _, t in tree_leaves_with_path(cell.args))
    assert _port_specs(cell.in_specs) == _jax_specs(jcell.in_specs)
    assert _port_specs(cell.out_specs) == _jax_specs(jcell.out_specs)
    assert cell.donate == jcell.donate


def test_make_cell_skips_long_500k_for_full_attention():
    mesh = make_production_mesh()
    assert cells.make_cell(configs.get_config("granite-3-8b"),
                           configs.SHAPES["long_500k"], mesh) is None


# -- the sharded decode, replayed ---------------------------------------------


def _decode_inputs(cfg, maxp, b=4):
    caches = []
    for ci, c in enumerate(tf.init_caches(cfg, b, maxp, device="cpu")):
        r2 = np.random.default_rng(100 + ci)
        kp = c.paged.k_pages
        k = r2.standard_normal(tuple(kp.shape)).astype(np.float32) * 0.1
        v = r2.standard_normal(tuple(kp.shape)).astype(np.float32) * 0.1
        caches.append(c._replace(paged=c.paged._replace(
            k_pages=torch.from_numpy(k), v_pages=torch.from_numpy(v))))
    rb = np.random.default_rng(7)
    batch = {"tokens": rb.integers(0, cfg.vocab, (b, 1)).astype(np.int32),
             "block_tables": (np.arange(b)[:, None] * maxp
                              + np.arange(maxp)[None]).astype(np.int32),
             "lengths": np.array([40, 17, 510, 5], np.int32)}
    return tuple(caches), batch


def test_sharded_paged_decode_matches_baseline():
    """The reference's ``test_sharded_paged_decode_matches_baseline`` on
    a 2 x 2 mesh of CPU shards (its 2 x 4 needs 8 devices)."""
    jcfg0 = jconfigs.reduce_config(jconfigs.get_config("granite-3-8b")) \
        .replace(dtype="float32", param_dtype="float32")
    cfg0 = configs.reduce_config(configs.get_config("granite-3-8b")) \
        .replace(dtype="float32", param_dtype="float32")
    shape = configs.ShapeSpec("decode_tiny", "decode", 64, 4)
    jparams = jtf.init_params(jcfg0.replace(attn_impl="xla"),
                              jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    mesh = make_host_mesh(2, 2, device="cpu")
    outs = {}
    for variant in ("baseline", "tiara_decode", "tiara_decode_v2"):
        cell = cells.make_cell(cfg0, shape, mesh, variant=variant)
        maxp = cell.args[2]["block_tables"].shape[1]
        caches, batch = _decode_inputs(cell.cfg, maxp)
        logits, _ = cell.fn(params, caches,
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        outs[variant] = logits.numpy()
    for v in ("tiara_decode", "tiara_decode_v2"):
        np.testing.assert_allclose(outs[v], outs["baseline"],
                                   atol=DECODE_TOL, rtol=DECODE_TOL)

    # Auto axes: on Explicit ones (jax.make_mesh's default since 0.7) the
    # reference's activation hints assert instead of constraining
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto, AxisType.Auto))
    jcell = jcells.make_cell(jcfg0, shape, jmesh)
    maxp = jcell.args[2]["block_tables"].shape[1]
    caches, batch = _decode_inputs(cfg0, maxp)
    jcaches = tuple(jc._replace(paged=jc.paged._replace(
        k_pages=jnp.asarray(c.paged.k_pages.numpy()),
        v_pages=jnp.asarray(c.paged.v_pages.numpy())))
        for jc, c in zip(jtf.init_caches(jcell.cfg, 4, maxp), caches))
    with mesh_context(jmesh):
        jlogits, _ = jax.jit(jcell.fn)(
            jparams, jcaches, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(outs["baseline"], np.asarray(jlogits),
                               atol=JAX_TOL, rtol=JAX_TOL)
