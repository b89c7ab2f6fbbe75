from repro_torch.training.optimizer import (AdamWConfig, make_adamw,
                                            warmup_cosine)
from repro_torch.training.train_step import (TrainState, lm_loss,
                                             make_train_step)
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = [
    "AdamWConfig",
    "make_adamw",
    "warmup_cosine",
    "TrainState",
    "lm_loss",
    "make_train_step",
    "Trainer",
    "TrainerConfig",
]
