"""Mamba layer spec.

Only the frozen spec dataclass so far: configs name it.  The selective
scan itself comes with the port's other model families.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None

    def dims(self, d_model: int) -> Tuple[int, int]:
        d_inner = self.expand * d_model
        dt_rank = self.dt_rank or max(1, d_model // 16)
        return d_inner, dt_rank
