"""Data pipeline: deterministic synthetic LM stream + memmap token corpus.

Both sources are *stateless functions of (step, shard)* so the pipeline is
exactly resumable from a checkpointed step with no replay buffer — the
fault-tolerance story needs the data side to be restartable too.  Each
data-parallel host pulls only its shard of the global batch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    shard: int = 0              # this host's data shard
    num_shards: int = 1
    corpus_path: Optional[str] = None    # .bin int32 tokens (memmap)

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards


class LMPipeline:
    """batch(step) -> {tokens, labels}; deterministic and resumable."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._corpus = None
        if cfg.corpus_path:
            self._corpus = np.memmap(cfg.corpus_path, dtype=np.int32,
                                     mode="r")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard]))
        if self._corpus is None:
            # synthetic but learnable: arithmetic sequences mod vocab with
            # per-sequence stride + 10% noise — a model reduces loss from
            # bigram statistics within tens of steps (pure iid tokens
            # cannot be learned at all)
            idx = np.arange(cfg.seq_len + 1)
            start = rng.integers(0, cfg.vocab, (cfg.local_batch, 1))
            stride = rng.integers(1, 4, (cfg.local_batch, 1))
            seq = ((start + stride * idx[None, :]) % cfg.vocab)
            noise = rng.integers(0, cfg.vocab,
                                 (cfg.local_batch, cfg.seq_len + 1))
            seq = np.where(rng.random(seq.shape) < 0.1, noise,
                           seq).astype(np.int32)
        else:
            n = self._corpus.shape[0] - (cfg.seq_len + 1)
            starts = rng.integers(0, n, cfg.local_batch)
            seq = np.stack([self._corpus[s:s + cfg.seq_len + 1]
                            for s in starts]).astype(np.int32)
            seq = np.clip(seq, 0, cfg.vocab - 1)
        return {"tokens": seq[:, :-1],
                "labels": seq[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1

    # -- checkpointable state ------------------------------------------

    def state(self, step: int) -> Dict:
        return {"step": step, "seed": self.cfg.seed,
                "shard": self.cfg.shard,
                "num_shards": self.cfg.num_shards}

    def save_state(self, path: str, step: int) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state(step), f)
        os.replace(tmp, path)

    @staticmethod
    def load_state(path: str) -> Dict:
        with open(path) as f:
            return json.load(f)
