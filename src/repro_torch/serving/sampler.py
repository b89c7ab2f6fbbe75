"""Token sampling: greedy / temperature / top-k."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0,
                  top_k: Optional[int] = None) -> np.ndarray:
    """logits (B, V) -> (B,) int32.  Greedy takes the first maximum, as
    ``jnp.argmax`` does; temperature / top-k sampling draws from
    ``generator`` (on the logits' device), which does not give JAX's
    draws."""
    logits = torch.as_tensor(logits).float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    logits = logits / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32).cpu().numpy()
