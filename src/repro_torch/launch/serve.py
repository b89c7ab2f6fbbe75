"""Serving launcher: --arch <id> through the paged-KV engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-lm --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Runs on the CUDA card unless ``--device`` names another device; with no
card and no device named it raises.  The output has the form of the
reference launcher's (``src/repro/launch/serve.py``): one line per
sequence, ``seq <sid>: [tokens]``.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.vm import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serving import ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--resolver", default="host", choices=("host", "tiara"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    params = tf.init_params(cfg, seed=0, device=device)
    eng = ServingEngine(cfg, params, max_slots=args.slots, max_seq=128,
                        temperature=args.temperature, eos_id=-1,
                        resolver=args.resolver, device=device)
    rng = np.random.default_rng(0)
    handles = [eng.submit(list(rng.integers(1, cfg.vocab, 5)),
                          max_new=args.max_new)
               for _ in range(args.requests)]
    out = eng.run_to_completion()
    for h in handles:
        print(f"seq {h.sid}: {out[h.sid]}")


if __name__ == "__main__":
    main()
