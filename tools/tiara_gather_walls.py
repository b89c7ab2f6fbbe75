"""Time the ``tiara_gather`` kernel of one source tree at the shapes the
port's records follow, on the card.

For each shape below the tree's own entry point is called on inputs made
on the card from a seed, its output held to the tree's plain version bit
for bit, then timed three ways:

* ``us``: the kernel's device time, CUDA events around one call after an
  L2 flush (a 256 MiB buffer rewritten), the median of ``--reps`` calls;
  ``us_clean_l2`` the same after a flush that only reads the buffer (no
  dirty line left to write back while the kernel runs); ``kernel_us`` the
  kernels' own duration from ``torch.profiler`` (no launch or event
  cost), the median of 10 calls after a write flush;
* ``host_us``: the host wall of one call, launch included: after 50
  warm-up calls, the median of 5 rounds of ``--calls`` calls back to
  back, each ended by one synchronise;
* ``library_us``: ``pool.index_select(0, table[ids])`` on the same inputs
  where that computes the same function (the row form), timed as ``us``.

Beside them: the byte bound (each input byte read once, each output byte
written once, at 3.35 TB/s), the latency bound (the dependent global loads
of one window, ids -> table -> pool or table -> pool, times the card's
cold-word latency: one thread chasing pointers through 1 GiB), and the
launch floor (an empty kernel of the same library, timed as ``us``) where
the tree has one.  Windows go in without ``ids`` where the tree's
``tiara_gather_window`` takes that (as the engines call it), else with
``arange``.  One JSON line per shape:

    {"tree": ..., "shape": ..., "n": ..., "width": ..., "ids": ...,
     "us": ..., "us_clean_l2": ..., "kernel_us": ..., "host_us": ...,
     "byte_bound_us": ..., "latency_bound_us": ..., "floor_us": ...,
     "library_us": ..., "card": "<nvidia-smi name, power.limit>"}

To compare two trees on one card, run both in one command, in turns
(parent, change, change, parent), e.g. with a parent commit unpacked by
``git archive`` into a directory ``.gitignore`` lists:

    python tools/tiara_gather_walls.py --src build/chip/parent/src --label parent
    python tools/tiara_gather_walls.py --src src --label change

The shapes: the main path's 4096 windows of 1024 int64 words (8 KiB) in a
1 GiB region (mask 2**27 - 1) at block-aligned offsets, and the row form
on the same bytes as a (131072, 1024) view; tiny-lm's resolver on
compiled segments (one window of one word); Scout's resolver on the
lockstep host loop (16 windows of one word, one mask per lane); the
sharded engine's owner reads (the lanes of all four shards, one mask per
lane) of tiny-lm over 4 homes (32 windows of one word) and of the
acceptance wave (1100 windows of 4 words), as the chip smoke records
them.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
POOL_WORDS = 1 << 27            # a 1 GiB int64 region

# (name, entries, width, per-lane masks)
WINDOW_SHAPES = (("tiny-lm resolver, compiled segments", 1, 1, False),
                 ("scout resolver, lockstep host loop", 16, 1, True),
                 ("tiny-lm over 4 homes, sharded owner reads", 32, 1, True),
                 ("acceptance wave, sharded owner reads", 1100, 4, True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src",
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tiara_gather_walls: no CUDA device available",
              file=sys.stderr)
        return 1
    import time
    from repro_torch.kernels.lockstep_vm.kernel import pointer_chase
    from repro_torch.kernels.tiara_gather import kernel as tk
    from repro_torch.kernels.tiara_gather.ops import (tiara_gather,
                                                      tiara_gather_window)
    from repro_torch.kernels.tiara_gather.ref import (
        tiara_gather_ref, tiara_gather_window_ref)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    scratch = torch.zeros(32 << 20, dtype=torch.int64, device=dev)

    def device_us(fn, clean=False):
        for _ in range(3):
            fn()
        times = []
        for _ in range(args.reps):
            if clean:
                scratch.max()
            else:
                scratch.add_(1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        return float(np.median(times))

    def kernel_us(fn):
        """The kernels' own device time from torch.profiler (CUPTI), after
        a write flush outside the profiled window; None if it records
        none."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        times = []
        for _ in range(10):
            scratch.add_(1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            times.append(sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == DeviceType.CUDA))
        us = float(np.median(times))
        return us if us > 0 else None

    def host_us(fn):
        for _ in range(50):
            fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) / args.calls * 1e6)
        return float(np.median(times))

    # the cold-word latency: one thread through 2^20 words 1 KiB apart
    nodes = 1 << 20
    perm = torch.randperm(nodes, generator=torch.Generator().manual_seed(0)
                          ).to(dev) * (POOL_WORDS // nodes)
    buf = torch.zeros(POOL_WORDS, dtype=torch.int64, device=dev)
    buf[perm] = torch.roll(perm, -1)
    pointer_chase(buf, int(perm[0]), 1000)
    steps = 100_000
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    pointer_chase(buf, int(perm[3]), steps)
    b.record()
    b.synchronize()
    latency_ns = a.elapsed_time(b) * 1e6 / steps
    del buf, perm
    floor = device_us(tk.launch_empty) if hasattr(tk, "launch_empty") \
        else None
    floor_clean = device_us(tk.launch_empty, clean=True) \
        if hasattr(tk, "launch_empty") else None
    takes_no_ids = inspect.signature(tiara_gather_window) \
        .parameters["ids"].default is None

    def emit(shape, n, width, ids, fn, moved, loads, library=None):
        print(json.dumps({
            "tree": args.label, "shape": shape, "n": n, "width": width,
            "ids": ids, "host_us": host_us(fn), "us": device_us(fn),
            "us_clean_l2": device_us(fn, clean=True),
            "kernel_us": kernel_us(fn),
            "byte_bound_us": moved / HBM_BYTES_PER_S * 1e6,
            "latency_bound_us": loads * latency_ns * 1e-3,
            "latency_ns": latency_ns, "floor_us": floor,
            "floor_us_clean_l2": floor_clean,
            "library_us": library and device_us(library),
            "library_us_clean_l2": library and device_us(library, clean=True),
            "library_kernel_us": library and kernel_us(library),
            "card": card}), flush=True)

    rng = np.random.default_rng(0)
    R, n = 1024, 4096
    flat = torch.randint(-(1 << 62), 1 << 62, (POOL_WORDS + 1,),
                         dtype=torch.int64, device=dev)
    blocks = rng.choice(POOL_WORDS // R, n, replace=False)
    offs = torch.from_numpy((blocks * R).astype(np.int32)).to(dev)
    bases = torch.zeros(n, dtype=torch.int64, device=dev)
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    ids = None if takes_no_ids else arange

    def win():
        return tiara_gather_window(flat, offs, bases, ids, width=R,
                                   mask=POOL_WORDS - 1)
    want = tiara_gather_window_ref(flat, offs, bases, arange, width=R,
                                   mask=POOL_WORDS - 1)
    if not torch.equal(win(), want):
        raise AssertionError("window form != plain at the path shape")
    emit("path, window form", n, R, ids is not None, win,
         2 * n * R * 8 + n * (4 + 8 + (4 if ids is not None else 0)),
         3 if ids is not None else 2)
    pool2d = flat[:POOL_WORDS].view(-1, R)
    table = torch.from_numpy(blocks.astype(np.int32)).to(dev)

    def row():
        return tiara_gather(pool2d, table, arange)

    def library():
        return pool2d.index_select(0, table[arange])
    if not (torch.equal(row(), want) and torch.equal(
            row(), tiara_gather_ref(pool2d, table, arange))
            and torch.equal(library(), want)):
        raise AssertionError("row form != plain at the path shape")
    emit("path, row form", n, R, True, row, 2 * n * R * 8 + n * 8, 3,
         library)
    del flat, pool2d, want

    pool = torch.randint(-(1 << 62), 1 << 62, (POOL_WORDS + 1,),
                         dtype=torch.int64, device=dev)
    for name, n, width, per_lane in WINDOW_SHAPES:
        region = 1 << 20
        offs = torch.from_numpy(rng.integers(0, region, n)).to(dev)
        bases = torch.from_numpy(rng.integers(0, POOL_WORDS // region, n)
                                 * region).to(dev)
        mask = torch.full((n,), region - 1, dtype=torch.int64, device=dev) \
            if per_lane else region - 1
        arange = torch.arange(n, dtype=torch.int32, device=dev)
        ids = None if takes_no_ids else arange

        def call():
            return tiara_gather_window(pool, offs, bases, ids, width=width,
                                       mask=mask)
        if not torch.equal(call(), tiara_gather_window_ref(
                pool, offs, bases, arange, width=width, mask=mask)):
            raise AssertionError(f"window form != plain at {name}")
        per = 8 + 8 + (8 if per_lane else 0) + (4 if ids is not None else 0)
        emit(name, n, width, ids is not None, call,
             2 * n * width * 8 + n * per, 3 if ids is not None else 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
