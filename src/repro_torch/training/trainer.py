"""Training driver: checkpoint/restart, async saves, straggler watchdog.

The reference's ``training/trainer.py`` in PyTorch.  Every piece of run
state (model, optimizer, step, data position) restores from disk; saves
are atomic and asynchronous; a per-step watchdog flags stragglers (steps
slower than ``straggler_factor`` x the running median of the last 32) and
calls the configured hook; SIGINT/SIGTERM trigger a final synchronous save
so that preemption never loses more than one step.

The trainer runs on the CUDA card unless ``device`` names another device;
with no card and no device named it raises.  The reference jits its step
and donates the state; here the step runs eagerly and updates the state
in place.  A step's wall time ends where its metrics reach the host
(``float``), which waits for the card.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ArchConfig
from repro_torch.core.vm import resolve_device
from repro_torch.data.pipeline import DataConfig, LMPipeline
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import AdamWConfig, warmup_cosine
from repro_torch.training.train_step import TrainState, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    peak_lr: float = 3e-4
    warmup: int = 20
    micro_batches: int = 1
    state_bits: int = 32
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 data_cfg: DataConfig, *,
                 grad_compressor: Optional[Callable] = None,
                 straggler_hook: Optional[Callable[[int, float], None]]
                 = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.pipeline = LMPipeline(data_cfg)
        opt_cfg = AdamWConfig(
            lr=warmup_cosine(tcfg.peak_lr, tcfg.warmup, tcfg.total_steps),
            state_bits=tcfg.state_bits)
        self._init_state, self.train_step = make_train_step(
            cfg, opt_cfg, micro_batches=tcfg.micro_batches,
            grad_compressor=grad_compressor)
        self.saver = ckpt.AsyncSaver()
        self.straggler_hook = straggler_hook
        self.step_times: List[float] = []
        self.straggler_steps: List[int] = []
        self.metrics_log: List[Dict[str, float]] = []
        self._interrupted = False

    # -- lifecycle --------------------------------------------------------

    def init_or_restore(self) -> TrainState:
        state = self._init_state(self.tcfg.seed, device=self.device)
        d = self.tcfg.ckpt_dir
        if d is not None and ckpt.latest_step(d) is not None:
            state = ckpt.restore(state, d, device=self.device)
            tf.trainable(state.params)
        return state

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._interrupted = True
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass    # not in main thread (tests)

    # -- main loop ----------------------------------------------------------

    def run(self, state: Optional[TrainState] = None) -> TrainState:
        self._install_signal_handlers()
        if state is None:
            state = self.init_or_restore()
        start = int(state.step)
        for step in range(start, self.tcfg.total_steps):
            t0 = time.monotonic()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch(step).items()}
            state, metrics = self.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self._watchdog(step, dt)
            if step % self.tcfg.log_every == 0 or \
                    step == self.tcfg.total_steps - 1:
                metrics["step"] = step
                metrics["sec_per_step"] = dt
                self.metrics_log.append(metrics)
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} "
                      f"gnorm {metrics['grad_norm']:.3f} [{dt:.2f}s]",
                      flush=True)
            if self.tcfg.ckpt_dir and (
                    (step + 1) % self.tcfg.ckpt_every == 0):
                self.saver.save(state, self.tcfg.ckpt_dir, step + 1)
                self.saver.wait()
                ckpt.retain(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)
                self.pipeline.save_state(
                    f"{self.tcfg.ckpt_dir}/data_state.json", step + 1)
            if self._interrupted:
                print(f"interrupted at step {step}; saving and exiting",
                      flush=True)
                break
        if self.tcfg.ckpt_dir:
            self.saver.wait()
            ckpt.save(state, self.tcfg.ckpt_dir, int(state.step))
            self.pipeline.save_state(
                f"{self.tcfg.ckpt_dir}/data_state.json", int(state.step))
        return state

    # -- straggler mitigation --------------------------------------------

    def _watchdog(self, step: int, dt: float) -> None:
        self.step_times.append(dt)
        window = self.step_times[-32:]
        if len(window) >= 8:
            med = statistics.median(window)
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_steps.append(step)
                if self.straggler_hook is not None:
                    self.straggler_hook(step, dt / med)
