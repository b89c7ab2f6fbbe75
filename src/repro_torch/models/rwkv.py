"""RWKV-6 layer spec.

Only the frozen spec dataclass so far: configs name it.  Time and
channel mixing come with the port's other model families.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    head_size: int = 64
    decay_lora: int = 64
