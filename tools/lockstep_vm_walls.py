"""Time the ``lockstep_vm`` kernel of one source tree at the lockstep
waves the port's records follow, on the card.

For each wave of ``core/lockstep_corpus.py`` below, the tree's own engine
packs the operands once (``_Engine.kernel_operands``) and the kernel's
launch alone (``lockstep_vm_kernel``) is timed with CUDA events over
``--reps`` launches after two warm-up launches; the pool is the engine's
private copy, and every wave below reads nothing it writes, so each launch
repeats the same work.  Where the tree has the kernel's clocks build
(``kernel.lockstep_vm_clocks``, ``csrc/lockstep_vm_clocks.cu``), the wave
also runs once on it: thread 0's SM cycles per macro-step in (a) live and
footprints, (b) the conflict sweep, (c) the free lanes, (d) the copies it
waited for after its own replay and (e) its replay of the serial lanes,
and whether its fields equal the main build's.  One JSON line per wave:

    {"tree": ..., "wave": ..., "B": ..., "macro_steps": ..., "us": ...,
     ["cycles_per_step": {"a": ..., ...}, "serial_lane_steps": ...,
      "clocks_equal": ...,] "card": "<nvidia-smi name, power.limit>"}

To compare two trees on one card, run both in one command, in turns
(parent, change, change, parent), e.g. with a parent commit unpacked by
``git archive`` into a directory ``.gitignore`` lists:

    python tools/lockstep_vm_walls.py --src build/chip/parent/src --label parent
    python tools/lockstep_vm_walls.py --src src --label change

The waves: the serving resolver's at Scout's lane count (16 tenants,
16 pages each: 85 macro-steps) and at tiny-lm's geometry (8 tenants, 128
pages: 645 macro-steps), the contended lock at 64 lanes, a mixed stock
wave of 512 lanes (the shape of the chip smoke's forced mixed wave, on a
small pool), and every stock operator at 1024 and 1500 lanes (the waves
whose lanes never meet).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def waves(lc):
    out = [("resolver, Scout's lanes", lc.resolver_wave(n_slots=16,
                                                        pages=16)),
           ("resolver, tiny-lm's geometry", lc.resolver_wave())]
    out += [(w.name, w) for w in lc.stock_waves(64) if "lock" in w.name]
    out.append(("mixed stock, 512 lanes", lc.mixed_stock_wave(512,
                                                              locks=False)))
    for B in (1024, 1500):
        out += [(w.name, w) for w in lc.stock_waves(B, serialized=False)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src",
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("lockstep_vm_walls: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import lockstep_corpus as lc
    from repro_torch.kernels.lockstep_vm import kernel as lk
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for name, w in waves(lc):
        eng = w.engine()
        mem = torch.from_numpy(w.mem).to(dev)
        ops = eng.kernel_operands(mem, *w.args())
        out = None
        for _ in range(2):
            out = lk.lockstep_vm_kernel(**ops)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            lk.lockstep_vm_kernel(**ops)
        e1.record()
        torch.cuda.synchronize()
        row = {"tree": args.label, "wave": name, "B": w.B,
               "macro_steps": int(out.steps.max()),
               "us": e0.elapsed_time(e1) * 1e3 / args.reps}
        if hasattr(lk, "lockstep_vm_clocks"):
            got, words = lk.lockstep_vm_clocks(**ops)
            torch.cuda.synchronize()
            c = dict(zip(lk.CLOCK_WORDS, words.tolist()))
            steps = max(c["steps"], 1)
            row.update(cycles_per_step={k: c[k] / steps for k in "abcde"},
                       serial_lane_steps=c["serial"],
                       clocks_equal=all(torch.equal(getattr(got, f),
                                                    getattr(out, f))
                                        for f in ("ret", "status", "steps",
                                                  "regs", "fault")))
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
