"""The port's production meshes and dry-run (``repro_torch.launch.{mesh,
dryrun}``) on the CPU, against the JAX package where it has a
counterpart:

* the production mesh shapes and ``dp_axes``
  (``tests/test_distributed.py::test_production_mesh_shapes``);
* ``run_cell``'s per-device argument bytes: the sum over JAX's cell of
  ``NamedSharding(AbstractMesh, spec).shard_shape`` bytes, on both meshes;
* the CLI on an 8-shard mesh ends with ``0 fail``
  (``test_dryrun_small_mesh_cell``);
* the committed sweep under ``experiments/dryrun_torch/``
  (``test_full_dryrun_artifacts_if_present``);
* every ``.py`` under ``src/repro/`` has a counterpart under
  ``src/repro_torch/``.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro_torch import configs
from repro_torch.distributed.mesh import make_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dp_axes, dp_size, make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_production_mesh_shapes():
    m1 = make_production_mesh()
    assert dict(m1.shape) == {"data": 16, "model": 16}
    assert m1.size == 256 and m1.device(255).type == "meta"
    m2 = make_production_mesh(multi_pod=True)
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m2.size == 512
    assert dp_axes(m2) == ("pod", "data") and dp_size(m2) == 32
    assert dp_axes(m1) == ("data",) and dp_size(m1) == 16


def _jax_arg_bytes(jcell, mesh, which=None):
    args = jcell.args if which is None else [jcell.args[i] for i in which]
    specs = jcell.in_specs if which is None \
        else [jcell.in_specs[i] for i in which]
    leaves = jax.tree_util.tree_leaves(args)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(NamedSharding(mesh, sp).shard_shape(a.shape))
               * jnp.dtype(a.dtype).itemsize
               for a, sp in zip(leaves, spec_leaves))


@pytest.mark.parametrize("arch,shape,multi", [
    ("internlm2-1.8b", "decode_32k", False),
    ("internlm2-1.8b", "decode_32k", True),
    ("rwkv6-1.6b", "long_500k", True),
    ("qwen2-vl-7b", "decode_32k", False),
])
def test_run_cell_argument_bytes_match_jax_shard_shapes(arch, shape,
                                                        multi):
    mesh = make_production_mesh(multi_pod=multi)
    rec = dryrun.run_cell(arch, shape, mesh, "m", "")
    assert rec["status"] == "ok", rec
    jmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi \
        else AbstractMesh((16, 16), ("data", "model"))
    jcell = jcells.make_cell(jconfigs.get_config(arch),
                             jconfigs.SHAPES[shape], jmesh)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _jax_arg_bytes(jcell, jmesh)
    assert mem["alias_size_in_bytes"] == \
        _jax_arg_bytes(jcell, jmesh, jcell.donate)
    assert rec["per_device_bytes"] == mem["argument_size_in_bytes"] \
        + mem["temp_size_in_bytes"]
    assert rec["coll_basis"] == "mesh counters" and rec["temp_basis"]
    assert rec["roofline"]["chips"] == mesh.size


@pytest.mark.parametrize("arch,shape,variant,per_layer", [
    # pmax over model, then psum of the accumulators and of l
    ("granite-3-8b", "decode_32k", "tiara_decode", {"all-reduce": 3}),
    # three FSDP gathers; psum of y and of the shared expert's, pmean aux
    ("llama4-scout-17b-a16e", "prefill_32k", "moe_ep",
     {"all-gather": 3, "all-reduce": 3}),
])
def test_shard_map_variants_record_their_collectives(arch, shape, variant,
                                                     per_layer):
    """The variants built on ``shard_map`` run per shard on the meta mesh
    and record the collectives they make (reduced widths, 8 shards)."""
    cfg = configs.reduce_config(configs.get_config(arch))
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    rec = dryrun.run_cell(arch, shape, mesh, "ovr8", "", cfg_override=cfg,
                          variant=variant)
    assert rec["status"] == "ok", rec
    want = {k: 0 for k in rec["collective_counts"]}
    want.update({k: v * cfg.n_layers for k, v in per_layer.items()})
    assert rec["collective_counts"] == want
    assert rec["per_device_coll_bytes"] > 0
    assert rec["roofline"]["collective_s"] > 0


def test_dryrun_small_mesh_cli(tmp_path, capsys):
    """The reference's ``test_dryrun_small_mesh_cell``: the CLI over
    InternLM2's cells on 8 meta shards."""
    dryrun.main(["--arch", "internlm2-1.8b", "--mesh", "single",
                 "--devices-override", "8", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "0 fail" in out.split("complete:")[1]
    rec = json.load(open(
        tmp_path / "internlm2-1.8b__train_4k__pod16x16_ovr8.json"))
    assert rec["status"] == "ok"
    assert rec["roofline"]["hlo_flops"] > 1e15
    assert rec["memory"]["argument_size_in_bytes"] > 0
    skip = json.load(open(
        tmp_path / "internlm2-1.8b__long_500k__pod16x16_ovr8.json"))
    assert skip["status"] == "skip" and skip["why"]


def test_full_dryrun_artifacts_if_present():
    """The committed sweep over both production meshes."""
    d = os.path.join(REPO, "experiments", "dryrun_torch")
    if not os.path.isdir(d) or not os.listdir(d):
        pytest.skip("production dry-run not yet executed")
    recs = [json.load(open(os.path.join(d, f)))
            for f in os.listdir(d)
            # baseline cells only: arch__shape__mesh.json
            if f.endswith(".json") and f.count("__") == 2]
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skip"]
    fail = [r for r in recs if r["status"] == "fail"]
    assert not fail, [r["arch"] + "/" + r["shape"] for r in fail]
    # 40 assigned cells x 2 meshes = 64 traced + 16 documented skips
    assert len(ok) + len(skip) == 80, (len(ok), len(skip))
    assert len(ok) == 64
    assert all(r["shape"] == "long_500k" for r in skip)
    multi = [r for r in ok if r["mesh"] == "pod2x16x16"]
    assert len(multi) == 32
    for r in ok:
        assert r["roofline"]["hlo_flops"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0


def test_every_reference_module_has_a_counterpart():
    ref = os.path.join(REPO, "src", "repro")
    port = os.path.join(REPO, "src", "repro_torch")
    rename = {"jaxcompat.py": os.path.join("distributed", "mesh.py")}
    missing = []
    for root, _, files in os.walk(ref):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), ref)
            if not os.path.isfile(os.path.join(port, rename.get(rel, rel))):
                missing.append(rel)
    assert not missing, missing
