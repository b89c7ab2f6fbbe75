"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the Tiara endpoint: register operators,
post on sessions, ring the doorbell, retire CQEs, then the serving loop —
at a real deployment size (a 1 GiB paged-KV pool of 8 KiB blocks plus a
one-million-node graph), and holds the hand-written CUDA kernel against
its plain PyTorch version on the card.  Phases:

1. device and build: the card's name and power limit; every CUDA kernel
   of the port built from the checkout's sources with ``nvcc``;
2. each kernel against its plain version at the main path's shapes
   (exact equality; the gather chain's window form also at unaligned and
   wrapping windows), with its time, the plain version's time and the
   least time the card could take for the same bytes;
3. the endpoint at real size: a compiled and a double-buffered compiled
   paged-KV wave (which must launch the kernel once and once per chunk),
   a mixed auto wave, a split-phase pair, and a pyvm replay against a
   downloaded copy of the pool, every result checked; each wave prints
   the engine its doorbell ran and its kernel launches;
4. the serving loop on a virtual clock with its exactly-one-CQE
   identity.

Any failure raises and the script exits non-zero.  It prints, before the
last line, the card's name and power limit and one JSON object with each
kernel's numbers; the last line is ``{"ok": true, "device": ...}``.
Detailed numbers go to ``chiprun_out/chip_smoke.json``.  It needs one
CUDA card and refuses to run without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def flush_l2(scratch: torch.Tensor) -> None:
    """Overwrite a buffer larger than the 50 MB L2 so the next launch
    finds its rows cold, as the gather chain does."""
    scratch.add_(1)


def time_cuda(fn, scratch, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, each call timed alone with CUDA
    events after an L2 flush."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush_l2(scratch)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    dt = time.perf_counter() - t0
    log(f"[build] {lib.name} built for sm_90a in {dt:.1f} s")
    return dt


def phase_kernel(dev, scratch):
    """tiara_gather against its plain version on the card."""
    from repro_torch.kernels.tiara_gather.ops import tiara_gather
    from repro_torch.kernels.tiara_gather.ref import tiara_gather_ref

    rng = np.random.default_rng(0)
    # small dtype sweep, including a row width that takes the 4-byte path
    for dtype, rows, r in [(torch.float32, 64, 256), (torch.bfloat16, 64, 128),
                           (torch.int32, 64, 96), (torch.int32, 32, 3),
                           (torch.int64, 16, 5)]:
        pool = torch.from_numpy(rng.standard_normal((rows, r))) \
            .to(dev, dtype) if dtype.is_floating_point else \
            torch.from_numpy(rng.integers(0, 1 << 30, (rows, r))).to(dev, dtype)
        table = torch.from_numpy(rng.permutation(rows).astype(np.int32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, rows, 9).astype(np.int32)).to(dev)
        out = tiara_gather(pool, table, ids)
        torch.cuda.synchronize()
        if not torch.equal(out, tiara_gather_ref(pool, table, ids)):
            raise AssertionError(f"tiara_gather != plain for {dtype} "
                                 f"({rows}x{r})")
    log("[kernel] tiara_gather == plain version for f32, bf16, int32, "
        "int64 small cases")

    # window form, unaligned offsets and windows that wrap in the region
    from repro_torch.kernels.tiara_gather.ops import tiara_gather_window
    from repro_torch.kernels.tiara_gather.ref import tiara_gather_window_ref
    for dtype, width, mask in [(torch.int64, 1024, 4095), (torch.int64, 5, 63),
                               (torch.float32, 64, 63),
                               (torch.bfloat16, 9, 31)]:
        flat = torch.from_numpy(rng.integers(0, 1 << 30, 2 * (mask + 1) + 1)) \
            .to(dev, dtype)
        table = torch.from_numpy(
            rng.integers(0, mask + 1, 12).astype(np.int32)).to(dev)
        table[0] = mask
        bases = torch.from_numpy(rng.integers(0, 2, 12) * (mask + 1)).to(dev)
        ids = torch.from_numpy(rng.integers(0, 12, 9).astype(np.int32)).to(dev)
        ids[0] = 0
        out = tiara_gather_window(flat, table, bases, ids, width=width,
                                  mask=mask)
        want = tiara_gather_window_ref(flat, table, bases, ids, width=width,
                                       mask=mask)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"tiara_gather_window != plain for {dtype} "
                                 f"width {width} mask {mask}")
    log("[kernel] tiara_gather_window == plain version for unaligned and "
        "wrapping windows (int64, f32, bf16)")

    # The main path's shape.  The compiled gather chain of a 256-post
    # paged-KV wave calls the window form over the engine's flat pool:
    # 4096 entries (256 posts x 16 blocks), 1024-word rows (8 KiB
    # blocks), offsets into the 1 GiB kvpool region (mask 2**27 - 1) at
    # the block-aligned translations the stock table holds, ids = arange.
    # The row form runs on the same bytes as a (131072, 1024) view.
    n_rows, R, n = 131072, 1024, 4096
    mask = n_rows * R - 1
    flat = torch.randint(-(1 << 62), 1 << 62, (n_rows * R + 1,),
                         dtype=torch.int64, device=dev)
    blocks = rng.choice(n_rows, n, replace=False)
    offs = torch.from_numpy((blocks * R).astype(np.int32)).to(dev)
    bases = torch.zeros(n, dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def win():
        return tiara_gather_window(flat, offs, bases, ids, width=R, mask=mask)

    def win_plain():
        return tiara_gather_window_ref(flat, offs, bases, ids, width=R,
                                       mask=mask)

    out, ref = win(), win_plain()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("tiara_gather_window != plain at the path shape")
    max_abs_err = int((out - ref).abs().max().item())
    ms = time_cuda(win, scratch)
    plain_ms = time_cuda(win_plain, scratch)
    # bytes the function must move: each distinct requested row read
    # once, each output row written once, the ids, offsets and bases
    # read once
    uniq = int(np.unique(blocks).size)
    moved = uniq * R * 8 + n * R * 8 + n * (4 + 4 + 8)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3

    pool2d = flat[:n_rows * R].view(n_rows, R)
    table = torch.from_numpy(blocks.astype(np.int32)).to(dev)
    out_r = tiara_gather(pool2d, table, ids)
    torch.cuda.synchronize()
    if not torch.equal(out_r, tiara_gather_ref(pool2d, table, ids)) \
            or not torch.equal(out_r, out):
        raise AssertionError("tiara_gather != plain at the path shape")
    row_ms = time_cuda(lambda: tiara_gather(pool2d, table, ids), scratch)
    row_plain_ms = time_cuda(lambda: tiara_gather_ref(pool2d, table, ids),
                             scratch)
    log(f"[kernel] path shape: flat int64 pool {flat.numel() * 8 >> 20} MiB, "
        f"n={n} rows of {R} words: equal; window kernel {ms * 1e3:.2f} us "
        f"({moved / ms / 1e6:.0f} GB/s), plain {plain_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us; row form kernel "
        f"{row_ms * 1e3:.2f} us, plain {row_plain_ms * 1e3:.2f} us")
    del flat, out, ref, out_r, pool2d
    torch.cuda.empty_cache()
    return dict(name="tiara_gather", route="cuda",
                source="src/repro_torch/kernels/tiara_gather/csrc/"
                       "tiara_gather.cu",
                replaces="src/repro/kernels/tiara_gather/kernel.py:28",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                bytes_moved=moved, shape=[n_rows, R, n],
                row_form_ms=row_ms, row_form_plain_ms=row_plain_ms)


def check_kv_slots(kvs, kv, host0, table, blocks, slots, slot_words):
    expect = kv.reference(host0, kvs.view, table, blocks)
    got = kvs.read_region("reply", count=slots * slot_words) \
        .reshape(slots, slot_words)
    bad = [i for i in range(slots) if not np.array_equal(got[i], expect)]
    if bad:
        raise AssertionError(f"kv reply slots wrong: {bad[:8]}")


def phase_endpoint(dev):
    from repro_torch.core import isa, pyvm
    from repro_torch.core import operators as ops
    from repro_torch.core.endpoint import TiaraEndpoint
    from repro_torch.core.serving_loop import (ServingConfig, ServingLoop,
                                               VirtualClock)

    walls = {}
    kv = ops.PagedKVFetch(n_blocks_pool=131072, block_bytes=8192,
                          max_req_blocks=16, reply_slots=256)
    gw = ops.GraphWalk(n_nodes=1 << 20, reply_words=8 * 256)
    vc = VirtualClock()
    t0 = time.perf_counter()
    ep, ss = TiaraEndpoint.for_tenants(
        [("kv", kv.regions()), ("gw", gw.regions())], device=dev,
        clock=vc, sleep=vc.sleep)
    kvs, gws = ss["kv"], ss["gw"]
    host0 = kvs.pool                        # host copy, authoritative
    table = kv.populate(host0, kvs.view, seed=1)
    order = gw.populate(host0, gws.view, seed=2)
    kvs.register(kv.build(kvs.view, reply_param=True))
    gws.register(gw.build(gws.view, reply_param=True))
    blocks = np.random.default_rng(3).choice(kv.n_blocks_pool, 16,
                                             replace=False)
    kvs.write_region("req", blocks)
    pool = ep.mem                           # upload once
    torch.cuda.synchronize()
    log(f"[endpoint] pool {tuple(pool.shape)} int64 = "
        f"{pool.numel() * 8 / 2**30:.2f} GiB resident on {pool.device}; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    slot = 16 * kv.block_words

    from repro_torch.core import compile as tc
    from repro_torch.kernels.tiara_gather import kernel as tg
    launches, ran = {}, {}

    def picked(asked, before):
        d = ep.last_decision
        if d is None or d is before:
            return f"{asked} (forced: no cost-model decision)"
        return f"{d.mode} {d.costs}"

    def wave(name, asked, fn):
        """Run one wave; record its wall time, the engine the doorbell
        picked and the kernel launches it made."""
        torch.cuda.synchronize()
        d0, n0 = ep.last_decision, tg.LAUNCHES
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        launches[name] = tg.LAUNCHES - n0
        ran[name] = picked(asked, d0)
        log(f"[wave] {name}: mode={asked} -> {ran[name]}; tiara_gather "
            f"launches {launches[name]}; {walls[name] * 1e3:.1f} ms")
        return out

    # 1. compiled paged-KV wave: the gather chain through the kernel, once
    #    monolithic (one launch) and once double-buffered (one launch per
    #    chunk of DBUF_CHUNK blocks)
    chunks = -(-16 // tc.DBUF_CHUNK)
    for mode, want_launches in (("compiled", 1), ("compiled_dbuf", chunks)):
        kvs.write_region("reply", np.zeros(256 * slot, dtype=np.int64))
        cs = [kvs.post("paged_kv_fetch", [16, i * slot]) for i in range(256)]
        wave(f"kv_{mode}", mode, lambda: ep.doorbell(mode=mode))
        if launches[f"kv_{mode}"] != want_launches:
            raise AssertionError(f"kv wave mode={mode} launched tiara_gather "
                                 f"{launches[f'kv_{mode}']} times, expected "
                                 f"{want_launches}")
        if any(c.status != isa.STATUS_OK or c.ret != 16 for c in cs):
            raise AssertionError(f"kv wave mode={mode}: statuses/rets wrong")
        check_kv_slots(kvs, kv, host0, table, blocks, 256, slot)
        log(f"[endpoint] kv wave (256 posts, {mode}): all 256 reply slots "
            f"== reference")

    # 2. mixed auto wave: 256 kv + 256 graph walks of depth 10
    starts = [int(order[i]) for i in range(256)]
    kc = [kvs.post("paged_kv_fetch", [16, i * slot]) for i in range(256)]
    gc = [gws.post("graph_walk", [s * 8, 10, 8 * i])
          for i, s in enumerate(starts)]
    wave("mixed_auto", "auto", lambda: ep.doorbell(mode="auto"))
    if any(c.ret != 16 or not c.ok for c in kc):
        raise AssertionError("mixed wave: kv rets wrong")
    want = [gw.reference(order, s, 10) for s in starts]
    if [c.ret for c in gc] != want or not all(c.ok for c in gc):
        raise AssertionError("mixed wave: graph-walk rets wrong")
    check_kv_slots(kvs, kv, host0, table, blocks, 256, slot)
    log("[endpoint] mixed wave (256 kv + 256 graph walk): every ret == "
        "reference")

    # 3. split-phase pair
    def split():
        a = [gws.post("graph_walk", [s * 8, 5, 8 * i])
             for i, s in enumerate(starts[:64])]
        d0 = ep.last_decision
        h1 = ep.doorbell(wait=False)
        ran["split_phase_1"] = picked("auto", d0)
        b = [kvs.post("paged_kv_fetch", [8, i * slot]) for i in range(64)]
        d0 = ep.last_decision
        h2 = ep.doorbell(wait=False)
        ran["split_phase_2"] = picked("auto", d0)
        n = ep.wait_all()
        return a, b, h1, h2, n
    a, b, h1, h2, n = wave("split_phase", "auto", split)
    if n != 128 or not (h1.done and h2.done):
        raise AssertionError("split-phase pair did not retire")
    if [c.ret for c in a] != [gw.reference(order, s, 5) for s in starts[:64]] \
            or any(c.ret != 8 or not c.ok for c in b):
        raise AssertionError("split-phase rets wrong")
    log(f"[endpoint] split-phase pair (64 + 64, wait=False then wait_all): "
        f"graph-walk doorbell -> {ran['split_phase_1']}; kv doorbell -> "
        f"{ran['split_phase_2']}; every ret == reference")

    # 4. pyvm replay of 8 posts against a downloaded copy of the pool
    pre = ep._host_view().copy()
    posts = [(kvs, "paged_kv_fetch", [16, i * slot]) for i in range(4)] + \
        [(gws, "graph_walk", [starts[i] * 8, 10, 8 * i]) for i in range(4)]
    cs = [s.post(op, p) for s, op, p in posts]
    wave("replay8", "auto", lambda: ep.doorbell(mode="auto"))
    vops = ep.registry.store_ops()
    mem = pre
    for c in cs:
        r = pyvm.run(vops[c.op_id], ep.regions, mem, list(c.params),
                     home=c.home)
        if (r.ret, r.status, r.steps) != (c.ret, c.status, c.steps):
            raise AssertionError(f"pyvm replay differs for seq {c.seq}")
    if not np.array_equal(ep._host_view(), mem):
        raise AssertionError("pyvm replay: pool differs")
    log("[endpoint] 8 posts == pyvm replay bit for bit (ret, status, "
        "steps, whole pool)")

    # 5. the serving loop on a virtual clock
    n0 = tg.LAUNCHES
    t = time.perf_counter()
    loop = ServingLoop(ep, ServingConfig(ring_size=16, max_inflight_waves=2))
    subs = []
    for i in range(64):
        if i % 2:
            subs.append(("gw", loop.submit("gw", "graph_walk",
                                           [starts[i] * 8, 7, 8 * i]), i))
        else:
            subs.append(("kv", loop.submit("kv", "paged_kv_fetch",
                                           [4, i * slot]), i))
        loop.pump()
    st = loop.drain()
    ep.wait_all()
    walls["serving_64"] = time.perf_counter() - t
    launches["serving_64"] = tg.LAUNCHES - n0
    total = st.executed + st.flushed + st.timed_out + st.rejected + st.shed
    if st.submitted != 64 or total != 64:
        raise AssertionError(f"CQE identity broken: {st}")
    for kind, c, i in subs:
        if not c.ok:
            continue
        want = 4 if kind == "kv" else gw.reference(order, starts[i], 7)
        if c.ret != want:
            raise AssertionError(f"serving loop ret wrong for {kind} {i}")
    log(f"[serving] 64 submissions: submitted {st.submitted} == executed "
        f"{st.executed} + flushed {st.flushed} + timed_out {st.timed_out} "
        f"+ rejected {st.rejected} + shed {st.shed}; ok {st.ok}; "
        f"tiara_gather launches {launches['serving_64']}; "
        f"{walls['serving_64'] * 1e3:.1f} ms for the whole phase")
    return walls, launches, ran


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import kernels

    dev = torch.device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    build_s = phase_build()
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)  # 256 MiB
    kinfo = phase_kernel(dev, scratch)
    del scratch
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()           # the main path starts here
    walls, launches, ran = phase_endpoint(dev)
    counts = kernels.launch_counts()         # ... and ends here
    if counts["tiara_gather"] < 1:
        raise AssertionError("main path never launched tiara_gather")
    kinfo["launches"] = counts["tiara_gather"]

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernel": kinfo,
                   "wave_wall_s": walls, "wave_launches": launches,
                   "wave_engine": ran}, f,
                  indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kinfo[k] for k in keys}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
