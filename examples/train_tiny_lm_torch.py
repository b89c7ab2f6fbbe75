"""End-to-end training on the PyTorch port: the 124.7M-parameter
tiny-lm for a few hundred steps on the synthetic (learnable) stream, with
checkpoint/restart.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_tiny_lm_torch.py --steps 400   # resumes
    PYTHONPATH=src python examples/train_tiny_lm_torch.py --device cpu --steps 20

A second call with more ``--steps`` resumes from the newest checkpoint
in ``--ckpt`` (``tiny_lm_ckpt_torch`` in the temporary directory,
``$TMPDIR`` or ``/tmp``, unless named).  It runs on the CUDA card unless ``--device`` names another
device, and raises when there is no card and none is named.
"""

import argparse
import os
import tempfile
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.vm import resolve_device
from repro_torch.data import DataConfig
from repro_torch.training import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    # a directory of its own under the temporary directory (TMPDIR): the
    # reference's example writes /tmp/tiny_lm_ckpt, and neither package
    # resumes from the other's run
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "tiny_lm_ckpt_torch"))
    ap.add_argument("--state-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tiny-lm")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=10,
                         ckpt_every=50, ckpt_dir=args.ckpt,
                         peak_lr=args.lr, warmup=30,
                         state_bits=args.state_bits)
    trainer = Trainer(cfg, tcfg, dcfg, device=dev)
    state = trainer.init_or_restore()
    start = int(state.step)
    if start:
        print(f"resuming from the step-{start} checkpoint in {args.ckpt}")
    state = trainer.run(state)
    first = trainer.metrics_log[0]["loss"] if trainer.metrics_log else None
    last = trainer.metrics_log[-1]["loss"] if trainer.metrics_log else None
    if first is not None:
        print(f"\ndone at step {int(state.step)}: loss {first:.3f} -> "
              f"{last:.3f}  (stragglers flagged: "
              f"{len(trainer.straggler_steps)})")
    else:
        print(f"\ndone at step {int(state.step)}: no step left to run")
    return dict(start_step=start, final_step=int(state.step),
                first_loss=first, last_loss=last,
                logged_steps=[int(m["step"]) for m in trainer.metrics_log],
                step_walls_s=list(trainer.step_times),
                stragglers=list(trainer.straggler_steps))


if __name__ == "__main__":
    main()
