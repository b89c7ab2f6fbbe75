"""The port's roofline (``repro_torch.roofline.analysis``) against the
reference's, on the CPU:

* ``count_active_params`` and ``model_flops``: the reference's, exactly,
  for every architecture at its full width;
* the ``Roofline`` terms: the reference's formulas with the H100's
  constants in place of the TPU's, and the same ``row()`` keys;
* the mesh's result-bytes counter over the program of
  ``test_torch_mesh.py::test_counters_count_calls_and_bytes``: the
  reference's ``collective_bytes`` of an HLO text with the same result
  shapes;
* the FLOPs and bytes of a traced reduced dense cell: hand counts.
"""

import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.roofline import analysis as jra
from repro_torch import configs
from repro_torch.distributed import mesh as M
from repro_torch.distributed.mesh import P
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tf
from repro_torch.roofline import analysis as ra


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = ra.count_active_params(cfg, tf.param_shapes(cfg))
    want = jra.count_active_params(jcfg, jtf.param_shapes(jcfg))
    assert got == want
    for name in configs.SHAPES:
        assert ra.model_flops(cfg, configs.SHAPES[name], *got) == \
            jra.model_flops(jcfg, jconfigs.SHAPES[name], *want)


def test_roofline_terms_are_the_reference_formulas_on_h100_constants():
    kw = dict(name="x", chips=8, hlo_flops=3.0e15, hlo_bytes=7.0e12,
              coll_bytes=5.0e11, coll_per_kind={"all-reduce": 10},
              model_flops=2.0e15)
    got, want = ra.Roofline(**kw), jra.Roofline(**kw)
    assert ra.PEAK_FLOPS == 989e12 and ra.HBM_BW == 3.35e12 \
        and ra.NVLINK_BW == 450e9
    assert got.compute_s == want.compute_s * jra.PEAK_FLOPS / ra.PEAK_FLOPS
    assert got.memory_s == want.memory_s * jra.HBM_BW / ra.HBM_BW
    assert got.collective_s == want.collective_s * jra.ICI_BW / ra.NVLINK_BW
    assert got.useful_ratio == want.useful_ratio
    assert got.row().keys() == want.row().keys()
    assert ra._ALGO_FACTOR == jra._ALGO_FACTOR
    # from_counts scales the per-device collective bytes by the chips,
    # as the reference's dry-run does
    roof = ra.from_counts("x", 1.0, 2.0, 4,
                          coll={"all-reduce": 100, "all-gather": 10})
    assert roof.coll_bytes == 4 * (2.0 * 100 + 10)


def test_result_bytes_counter_matches_the_reference_hlo_count():
    mesh = M.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    x = torch.zeros(8, 16, dtype=torch.float32)     # blocks of 2 x 16

    def f(xl):
        M.psum(xl, "model")                         # f32[2,16]
        M.all_gather(xl, ("data", "model"))         # f32[4,2,16]
        M.all_to_all(xl, "data", 1, 1, tiled=True)  # f32[2,16]
        return xl

    mesh.reset_stats()
    M.shard_map(f, mesh, in_specs=(P(("data", "model")),),
                out_specs=P(("data", "model")))(x)
    hlo = "\n".join([
        "  %all-reduce.1 = f32[2,16]{1,0} all-reduce(f32[2,16]{1,0} %p0), "
        "replica_groups={{0,1},{2,3}}, to_apply=%add",
        "  %all-gather.2 = f32[4,2,16]{2,1,0} all-gather(f32[1,2,16]{2,1,0} "
        "%b), replica_groups={{0,1,2,3}}, dimensions={0}",
        "  %all-to-all.3 = f32[2,16]{1,0} all-to-all(f32[2,16]{1,0} %p0), "
        "replica_groups={{0,2},{1,3}}, dimensions={1}",
    ])
    assert ra.collective_bytes(mesh) == jra.collective_bytes(hlo)
    assert ra.collective_counts(mesh) == jra.collective_counts(hlo)


def test_traced_flops_and_bytes_of_a_reduced_dense_cell():
    """A reduced InternLM2 prefill (``reduce_config``: 2 layers, d 128,
    GQA heads of 32, d_ff 160, vocab 512): FLOPs counted by hand, and the
    plain attention counted as one op of its inputs and output."""
    cfg = configs.reduce_config(configs.get_config("internlm2-1.8b"))
    b, s = 2, 64
    shape = configs.ShapeSpec("prefill_tiny", "prefill", s, b)
    mesh = make_host_mesh(1, 1, device="cpu")
    cell = cells.make_cell(cfg, shape, mesh)
    tr = cells.trace_cell(cell, mesh)
    t, d, hd, ff = b * s, cfg.d_model, cfg.head_dim, cfg.d_ff
    nh, nkv, v = cfg.n_heads, cfg.n_kv_heads, cfg.vocab_padded
    per_layer = (2 * t * d * (nh + 2 * nkv) * hd      # wq, wk, wv
                 + 2 * 2 * b * nh * s * s * hd        # q k^T, p v
                 + 2 * t * nh * hd * d                # wo
                 + 3 * 2 * t * d * ff)                # swiglu
    assert tr.flops == cfg.n_layers * per_layer + 2 * t * d * v
    assert tr.coll_per_kind == {}
    # the attention: q, k, v in and out, f32, no lengths
    attn = 4 * b * s * nh * hd * 4 - 2 * b * s * (nh - nkv) * hd * 4
    counter = ra.ByteCounter()
    q = torch.zeros(b, nh, s, hd, device="meta")
    k = torch.zeros(b, nkv, s, hd, device="meta")
    with counter:
        cells._plain_attention(q, k, k, None, causal=True)
    assert counter.bytes == attn
    assert counter.per_op == {"flash_attention": attn}
    assert tr.bytes > cfg.n_layers * attn and tr.peak_bytes > 0
