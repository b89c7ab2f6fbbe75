"""Mixture-of-experts layer spec.

Only the frozen spec dataclass so far: configs name it.  Routing and
dispatch come with the port's other model families.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False     # Llama-4 style always-on shared expert
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2
