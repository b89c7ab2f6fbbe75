"""Multi-pod dry-run: trace every (arch x shape) cell on the production
mesh and record its memory, cost and collectives (port of
``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
      --shape train_4k --mesh single
  ... --devices-override 8      # small-mesh smoke mode

Outputs one JSON per cell under --out (default experiments/dryrun_torch/),
with the reference's keys.  The mesh's shards lie on the ``meta`` device
and every cell runs once on ``meta`` tensors (``cells.trace_cell``):
nothing is allocated, nothing is compiled, no device is needed, and no
``XLA_FLAGS``-style device forcing is involved.  Where the reference's
numbers come from the compiler, these come from the trace:

* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: the bytes
  of one device's block of every argument / output, from its partition
  spec (ceil division where a dimension does not split evenly, as XLA
  pads); ``alias_size_in_bytes``: the donated arguments' per device;
* ``memory.temp_size_in_bytes``: the trace's peak of live storage
  allocated by the step (its outputs included), over the whole unsharded
  program, divided by the chip count (``temp_basis`` says so);
* ``per_device_flops`` / the roofline's bytes: ``FlopCounterMode`` and
  the byte counter over the whole program, divided by the chip count;
* the collectives: the mesh's counters (``coll_basis``).  A baseline cell
  runs unsharded, with no collective, because the port has no
  partitioner: the collectives GSPMD puts into the reference's baseline
  program have no counterpart here.  Only the variants built on
  ``shard_map`` (``tiara_decode*``, ``moe_ep*``) record collectives.

There are no calibration programs: the reference compiles two unrolled
ones only because XLA's cost analysis counts a scan's body once; the
port's eager trace runs, and counts, every layer.  A baseline cell's
trace does not depend on the mesh, so with ``--mesh both`` each cell is
traced once and its counts serve both meshes (``trace_from``).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_applicable,
                                 get_config)
from repro_torch.distributed.mesh import Mesh, P, make_mesh
from repro_torch.launch import cells as cells_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.param import tree_leaves_with_path
from repro_torch.roofline import analysis as ra

TEMP_BASIS = ("peak bytes of live storage allocated by the step (outputs "
              "included), traced once on meta over the whole unsharded "
              "program, divided by the chip count")
COLL_BASIS = "mesh counters"
# card_check: the dry-run's argument + temp bytes against the card step's
# peak memory, and the roofline floor against the step's wall (a floor
# over its wall by more than timing noise is no floor)
MEM_TOL, MAX_SHARE = 0.10, 1.05

# variants whose program does not depend on the mesh (no shard_map)
_MESH_FREE = ("baseline", "remat_layer", "moe_hints",
              "remat_layer+moe_hints")


def make_mesh_for(args, multi_pod: bool) -> Mesh:
    if args.devices_override:
        n = args.devices_override
        if multi_pod:
            return make_mesh((2, n // 8, 4), ("pod", "data", "model"),
                             ["meta"] * n)
        return make_mesh((n // 4, 4), ("data", "model"), ["meta"] * n)
    return make_production_mesh(multi_pod=multi_pod)


def per_device_bytes(tree, specs, mesh: Mesh) -> int:
    """The bytes of one device's block of every tensor of ``tree`` laid
    out by ``specs`` (a tree of P of the same structure; ``None`` where
    the value is ``None``), each dimension split by ceil division."""
    if isinstance(specs, P) or specs is None:
        if tree is None:
            return 0
        if isinstance(tree, torch.Tensor):
            spec = specs if specs is not None else P()
            n = 1
            for i, d in enumerate(tree.shape):
                k = math.prod(mesh.shape[a] for a in spec.names(i))
                n *= -(-int(d) // k)
            return n * tree.element_size()
        leaves = tree.values() if isinstance(tree, dict) else tree
        return sum(per_device_bytes(t, specs, mesh) for t in leaves)
    if isinstance(specs, dict):
        return sum(per_device_bytes(tree[k], specs[k], mesh) for k in tree)
    return sum(per_device_bytes(t, s, mesh) for t, s in zip(tree, specs))


def run_cell(arch: str, shape_name: str, mesh: Mesh, mesh_name: str,
             out_dir: str, state_bits: int = 32,
             cfg_override=None, variant: str = "baseline",
             memo: Optional[Dict[Any, Any]] = None) -> dict:
    """Build the cell, trace it once on ``meta`` (or take the trace from
    ``memo``, keyed by everything but the mesh, where the program does not
    depend on the mesh) and record the reference's fields."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": dict(mesh.shape), "status": "skip", "why": why}
    if not ok:
        return rec
    chips = mesh.size
    cell = cells_mod.make_cell(cfg, shape, mesh, state_bits=state_bits,
                               variant=variant)
    mesh_free = variant in _MESH_FREE or (
        variant.startswith("tiara_decode") and shape.kind != "decode")
    key = (arch, shape_name, state_bits, variant)
    hit = memo.get(key) if memo is not None and mesh_free \
        and cfg_override is None else None
    if hit is None:
        trace = cells_mod.trace_cell(cell, mesh)
        trace_from = mesh_name
        if memo is not None and mesh_free and cfg_override is None:
            memo[key] = (trace, mesh_name)
    else:
        trace, trace_from = hit

    arg_b = per_device_bytes(cell.args, cell.in_specs, mesh)
    mem_rec = {
        "argument_size_in_bytes": arg_b,
        "output_size_in_bytes": per_device_bytes(trace.out, cell.out_specs,
                                                 mesh),
        "alias_size_in_bytes": sum(
            per_device_bytes(cell.args[i], cell.in_specs[i], mesh)
            for i in cell.donate),
        "temp_size_in_bytes": -(-trace.peak_bytes // chips),
    }
    n_total, n_active = ra.count_active_params(cfg, tf.param_shapes(cfg))
    mf = ra.model_flops(cfg, shape, n_total, n_active)
    roof = ra.from_counts(f"{arch}/{shape_name}/{mesh_name}", trace.flops,
                          trace.bytes, chips, coll=trace.coll_per_kind,
                          model_flops=mf)
    rec.update(
        status="ok",
        seconds_trace=round(trace.seconds, 2),
        trace_from=trace_from,
        memory=mem_rec,
        temp_basis=TEMP_BASIS,
        coll_basis=COLL_BASIS,
        per_device_bytes=(mem_rec["argument_size_in_bytes"]
                          + mem_rec["temp_size_in_bytes"]),
        per_device_flops=trace.flops / chips,
        per_device_coll_bytes=ra.weighted_coll_bytes(trace.coll_per_kind),
        n_params_total=n_total, n_params_active=n_active,
        collective_counts=trace.coll_counts,
        roofline=roof.row(),
    )
    return rec


# ---------------------------------------------------------------------------
# The card cross-check
# ---------------------------------------------------------------------------


def card_args(cell: cells_mod.Cell, device) -> Tuple:
    """Real arguments for ``cell`` on ``device``, made by the port's own
    entry points (``init_state`` / ``init_params``, ``init_caches``,
    ``default_block_tables``) with random weights drawn there from seed
    0: tokens at random, every sequence full (``lengths`` is the shape's
    sequence length), M-RoPE positions ``arange``."""
    cfg, shape = cell.cfg, cell.shape
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    s_in = 1 if shape.kind == "decode" else s
    dtype = tf.model_dtype(cfg.dtype)

    def ints(high, size):
        return torch.randint(0, high, size, generator=gen, device=dev,
                             dtype=torch.int32)

    def full(n):
        return torch.full((b,), n, dtype=torch.int32, device=dev)

    batch: Dict[str, Any] = {"tokens": ints(cfg.vocab, (b, s_in))}
    if cfg.rope == "mrope":
        pos = torch.arange(s_in, dtype=torch.int32, device=dev) \
            + (s if shape.kind == "decode" else 0)
        batch["positions3"] = pos.expand(3, b, s_in).contiguous()
        if shape.kind != "decode":
            batch["embeds"] = torch.randn(
                (b, s, cfg.d_model), generator=gen, device=dev,
                dtype=torch.float32).mul_(0.02).to(dtype)
    if cfg.enc_dec:
        if shape.kind != "decode":
            batch["enc_embeds"] = torch.randn(
                (b, s, cfg.d_model), generator=gen, device=dev,
                dtype=torch.float32).to(dtype)
        batch["enc_lengths"] = full(s)
    if shape.kind == "train":
        from repro_torch.training.optimizer import (AdamWConfig,
                                                    warmup_cosine)
        from repro_torch.training.train_step import make_train_step
        init_state, _ = make_train_step(cfg, AdamWConfig(
            lr=warmup_cosine(3e-4, 100, 10_000)))
        batch["labels"] = ints(cfg.vocab, (b, s))
        return init_state(device=dev, generator=gen), batch
    maxp = cell.args[2]["block_tables"].shape[1]
    params = tf.init_params(cfg, device=dev, generator=gen)
    caches = tf.init_caches(cfg, b, maxp, device=dev,
                            cross_len=s if cfg.enc_dec else 0)
    batch["block_tables"] = tf.default_block_tables(cfg, b, maxp, device=dev)
    batch["lengths"] = full(s)
    return params, caches, batch


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves_with_path(tree))


def _median_wall(fn, reps: int) -> float:
    """The median wall of ``reps`` calls, each from a synchronized card
    to its end, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(statistics.median(walls))


def card_check(cfg, shape, device, *, reps: int = 5) -> dict:
    """The dry-run of one cell on a 1 x 1 mesh, held against the same step
    run for real on the card ``device``:

    1. the dry-run's argument bytes equal the bytes of the inputs the
       port's entry points make on the card (:func:`card_args`), exactly;
    2. its FLOPs equal ``FlopCounterMode``'s count of the card step on the
       plain route (``cells.plain_route``), exactly;
    3. its argument plus temp bytes are within ``MEM_TOL`` of the step's
       ``max_memory_allocated`` (reset before the step; what was
       allocated before it, other than the inputs, taken off);
    4. the roofline floor ``max(compute_s, memory_s)`` is at most
       ``MAX_SHARE`` times the median step wall on the plain route and on
       the kernels' route (``attn_impl="cuda"``).

    Returns the numbers; raises AssertionError where a check fails."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(device)
    mesh = make_host_mesh(1, 1, device=dev)
    plain = cells_mod.make_cell(cfg, shape, mesh)
    kern = cells_mod.make_cell(cfg, shape, mesh, attn_impl="cuda")
    trace = cells_mod.trace_cell(plain, mesh)
    arg_b = per_device_bytes(plain.args, plain.in_specs, mesh)
    n_total, n_active = ra.count_active_params(cfg, tf.param_shapes(cfg))
    roof = ra.from_counts(f"{cfg.name}/{shape.name}/1x1", trace.flops,
                          trace.bytes, 1, coll=trace.coll_per_kind,
                          model_flops=ra.model_flops(cfg, shape, n_total,
                                                     n_active))
    floor_s = max(roof.compute_s, roof.memory_s)

    args = card_args(plain, dev)
    card_b = _tensor_bytes(args)
    plain.fn(*args)                       # warm-up: lazy init, workspaces
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated(dev) - card_b
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as fc:
        out = plain.fn(*args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - other
    logits = out[1]["loss"] if shape.kind == "train" else out[0]
    finite = bool(torch.isfinite(logits).all())
    del out, logits
    card_flops = int(fc.get_total_flops())

    wall_plain = _median_wall(lambda: plain.fn(*args), reps)
    wall_cuda = _median_wall(lambda: kern.fn(*args), reps)
    rec = {
        "cell": roof.name, "arg_bytes": arg_b, "card_arg_bytes": card_b,
        "flops": trace.flops, "card_flops": card_flops,
        "bytes": trace.bytes, "temp_bytes": trace.peak_bytes,
        "card_peak_bytes": peak,
        "mem_ratio": (arg_b + trace.peak_bytes) / peak,
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "floor_s": floor_s, "wall_plain_s": wall_plain,
        "wall_cuda_s": wall_cuda,
        "share_plain": floor_s / wall_plain,
        "share_cuda": floor_s / wall_cuda,
        "mfu_plain": roof.model_flops / (wall_plain * ra.PEAK_FLOPS),
        "mfu_cuda": roof.model_flops / (wall_cuda * ra.PEAK_FLOPS),
        "model_flops": roof.model_flops, "trace_s": trace.seconds,
        "finite": finite,
    }
    assert finite, f"{roof.name}: the step's output is not finite"
    assert card_b == arg_b, f"{roof.name}: argument bytes {arg_b} on " \
        f"meta, {card_b} on the card"
    assert card_flops == trace.flops, f"{roof.name}: FLOPs " \
        f"{trace.flops} traced, {card_flops} on the card"
    assert abs(rec["mem_ratio"] - 1) <= MEM_TOL, \
        f"{roof.name}: argument + temp {arg_b + trace.peak_bytes} B " \
        f"against a peak of {peak} B on the card"
    for route in ("plain", "cuda"):
        assert rec["share_" + route] <= MAX_SHARE, \
            f"{roof.name}: the roofline floor {floor_s * 1e3:.3f} ms " \
            f"over {MAX_SHARE} x the {route} route's " \
            f"{rec['wall_' + route + '_s'] * 1e3:.3f} ms"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help="one shape, or several separated by commas")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--state-bits", type=int, default=32)
    ap.add_argument("--devices-override", type=int, default=0,
                    help="small-mesh smoke mode: a mesh of this many "
                         "meta shards")
    ap.add_argument("--variant", default="baseline",
                    help="baseline | tiara_decode | tiara_decode_v2 | "
                         "remat_layer | moe_hints | remat_layer+moe_hints "
                         "| moe_ep | moe_ep+remat_layer")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = args.shape.split(",") if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    memo: Dict[Any, Any] = {}
    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        mesh = make_mesh_for(args, multi)
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        if args.devices_override:
            mesh_name += f"_ovr{args.devices_override}"
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape_name, mesh, mesh_name,
                                   args.out, state_bits=args.state_bits,
                                   variant=args.variant, memo=memo)
                except Exception as e:      # noqa: BLE001 — record & go on
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                rec["wall_s"] = round(time.time() - t0, 2)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_fail += st == "fail"
                extra = ""
                if st == "ok":
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']} "
                             f"comp={r['compute_s']*1e3:.2f}ms "
                             f"mem={r['memory_s']*1e3:.2f}ms "
                             f"coll={r['collective_s']*1e3:.2f}ms "
                             f"dev={rec['per_device_bytes']/2**30:.2f}GiB")
                elif st == "fail":
                    extra = rec["error"][:120]
                print(f"[{st:4s}] {tag} ({rec['wall_s']}s) {extra}",
                      flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
