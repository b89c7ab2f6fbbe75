"""Serve a small model with batched requests through the paged-KV engine
on the PyTorch port (continuous batching, Tiara paged-attention decode
path).

    PYTHONPATH=src python examples/serve_paged_torch.py --requests 8
    PYTHONPATH=src python examples/serve_paged_torch.py --resolver tiara --homes 4
    PYTHONPATH=src python examples/serve_paged_torch.py --device cpu

With ``--resolver tiara`` every decode step resolves its block tables by
posting PagedKVFetch operators from per-sequence sessions through the
ServingLoop (the disaggregated path); with ``--homes > 1`` the regions
shard over a mesh of that many shards of the device and the INDIGO-style
re-homing sweep migrates hot regions toward their accessors (see the
audit printed at the end).  It runs on the CUDA card unless ``--device``
names another device, and raises when there is no card and none is
named.
"""

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.vm import resolve_device
from repro_torch.distributed.mesh import make_device_mesh
from repro_torch.models import transformer as tf
from repro_torch.serving import ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--resolver", choices=("host", "tiara"),
                    default="host",
                    help="block-table resolution: local (host) or "
                         "posted through the endpoint (tiara)")
    ap.add_argument("--homes", type=int, default=1,
                    help="mesh shards homing the tiara regions")
    ap.add_argument("--full-size", action="store_true",
                    help="use the full 124.7M tiny-lm (slower on CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tiny-lm")
    if not args.full_size:
        cfg = reduce_config(cfg)
    params = tf.init_params(cfg, seed=0, device=dev)
    mesh = make_device_mesh(args.homes, devices=[dev] * args.homes) \
        if args.homes > 1 else None
    engine = ServingEngine(
        cfg, params, max_slots=args.slots, max_seq=128,
        temperature=args.temperature, eos_id=-1,
        resolver=args.resolver, n_homes=args.homes,
        placement="auto" if args.homes > 1 else "single",
        rehome_every=2, device=dev, mesh=mesh)

    rng = np.random.default_rng(0)
    handles = []
    for i in range(args.requests):
        prompt = [int(t) for t in rng.integers(1, cfg.vocab, 4 + i % 9)]
        handles.append(engine.submit(prompt, max_new=args.max_new))
    print(f"submitted {len(handles)} requests into {args.slots} slots "
          f"({engine.allocator.n_pages} KV pages of {cfg.page_size} tokens, "
          f"resolver={args.resolver})")

    c0 = kernels.launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps = 0
    while not engine.finished():
        engine.step()
        steps += 1
        if steps % 8 == 0:
            act = sum(1 for s in engine.active if s)
            print(f"  step {steps}: active={act} waiting="
                  f"{len(engine.waiting)} page-util="
                  f"{engine.allocator.utilization():.0%}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    c1 = kernels.launch_counts()
    out = engine.results()
    n_tok = sum(len(v) for v in out.values())
    on = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"\ngenerated {n_tok} tokens in {steps} engine steps "
          f"({dt:.1f}s, {n_tok / dt:.1f} tok/s on {on})")
    for h in handles[:4]:
        print(f"  seq {h.sid} [{'ok' if h.ok else h.status}]: "
              f"{out[h.sid]}")
    aud = engine.resolver_audit()
    if aud:
        print(f"resolver audit: {aud['waves']:.0f} waves, "
              f"{aud['rehomes']:.0f} rehomes "
              f"({aud['rehomed_words']:.0f} words moved), "
              f"cross-device reply words {aud['cross_device_words']:.0f}, "
              f"home skew {aud['home_skew']:.2f}")
    if engine.allocator.free_pages != engine.allocator.n_pages:
        raise AssertionError("page leak!")
    return dict(tokens={h.sid: out[h.sid] for h in handles},
                statuses={h.sid: h.status for h in handles},
                ok=all(h.ok for h in handles), steps=steps, wall_s=dt,
                tok_per_s=n_tok / dt, audit=aud,
                launches={k: c1[k] - c0.get(k, 0) for k in c1})


if __name__ == "__main__":
    main()
