"""Training launcher: --arch <id> on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

The reference launcher's flags (``src/repro/launch/train.py``), plus
``--device``: it runs on the CUDA card unless ``--device`` names another
device; with no card and no device named it raises.
"""

import argparse

from repro_torch.configs import get_config, reduce_config
from repro_torch.data import DataConfig
from repro_torch.training import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--state-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=5,
                         ckpt_every=max(args.steps // 4, 1),
                         ckpt_dir=args.ckpt, peak_lr=args.lr,
                         warmup=max(args.steps // 10, 1),
                         state_bits=args.state_bits,
                         micro_batches=args.micro_batches)
    state = Trainer(cfg, tcfg, dcfg, device=args.device).run()
    print(f"finished at step {int(state.step)}")


if __name__ == "__main__":
    main()
