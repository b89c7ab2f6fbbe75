"""The plain PyTorch version of the selective scan: Mamba's recurrence
``h = exp(dt A) h + dt x B``, ``y = h . C`` in chunks.

The reference forms the (B, C, d_inner, d_state) f32 coefficients
``a = exp(dt A)`` and ``bx = dt x B`` for chunks of 256 tokens, or for the
whole sequence when its length is no multiple of 256: 4.3 GB each at
Jamba's width for 8 sequences of 1024 tokens.  The plain version forms
them for chunks of at most ``SCAN_CHUNK_BYTES`` and runs the recurrence in
place on ``bx``, one fused multiply-add per step (``bx[t] += a[t] * h``),
so the chunk's ``bx`` ends up holding the states and the outputs ``y = h .
C`` are one batched product per chunk.  The arithmetic per step is the
reference's.  When gradients flow, autograd could not differentiate
through states overwritten in place, so the same step runs out of place
(``h = torch.addcmul(bx[t], a[t], h)``) and the chunk's states are
stacked: the same arithmetic, and the memory of one more chunk-sized
tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Bytes of each f32 chunk coefficient (a, bx): the scan runs in chunks of
# as many steps as fit (at least one).
SCAN_CHUNK_BYTES = 1 << 28


def _chunk_steps(b: int, d_inner: int, d_state: int) -> int:
    return max(1, SCAN_CHUNK_BYTES // (4 * b * d_inner * d_state))


def selective_scan_ref(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
                       bm: torch.Tensor, cm: torch.Tensor,
                       a_mat: torch.Tensor, valid: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over the S steps of ``dt``, ``x`` (B, S, d) and
    ``bm``, ``cm`` (B, S, N) from the state ``h`` (B, d, N), with ``a_mat``
    (d, N); steps where ``valid`` (B, S) is false leave the state as it
    was.  Returns (the last state, y (B, S, d) f32)."""
    b, s, d = dt.shape
    ys = dt.new_empty((b, s, d))
    step = _chunk_steps(b, d, a_mat.shape[-1])
    for c0 in range(0, s, step):
        c1 = min(s, c0 + step)
        dt_c = dt[:, c0:c1].transpose(0, 1)                 # (C, B, d)
        a = torch.exp(dt_c[..., None] * a_mat)              # (C, B, d, N)
        bx = (dt_c * x[:, c0:c1].transpose(0, 1))[..., None] \
            * bm[:, c0:c1].transpose(0, 1)[:, :, None, :]
        if valid is not None:
            vm = valid[:, c0:c1].transpose(0, 1)[..., None, None]
            a = torch.where(vm, a, 1.0)
            bx = torch.where(vm, bx, 0.0)
        if torch.is_grad_enabled() and (a.requires_grad or bx.requires_grad
                                        or h.requires_grad):
            # out of place: autograd keeps every state
            states = []
            for t in range(c1 - c0):
                h = torch.addcmul(bx[t], a[t], h)
                states.append(h)
            bx = torch.stack(states)
        else:
            for t in range(c1 - c0):   # bx[t] becomes the state after t
                h = bx[t].addcmul_(a[t], h)
        ys[:, c0:c1] = torch.einsum("cbdn,cbn->bcd", bx,
                                    cm[:, c0:c1].transpose(0, 1))
        del a, bx                   # freed before the next chunk's
    return h.clone(), ys
