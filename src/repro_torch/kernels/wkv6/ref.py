"""The plain PyTorch version of RWKV-6's wkv recurrence, in chunks.

The scan works in chunks of at most ``SCAN_CHUNK_BYTES`` per (C, B, H, hd,
hd) f32 tensor: the chunk's ``kv = k v^T`` is formed at once, the state
update ``S_t = w_t S_{t-1} + kv_t`` runs in place on it (one fused
multiply-add per step, so the buffer ends up holding the states), and the
outputs ``y_t = r_t (S_{t-1} + u kv_t)`` are two batched operations per
chunk.  The arithmetic per step is the reference's; as there, ``y`` reads
the state before the decay update, and a padded step's ``y`` takes the
bonus of its own (unmasked) ``k v``.  When gradients flow, the update runs
out of place (``torch.addcmul``) and the chunk's states are stacked, as
autograd cannot differentiate through states overwritten in place: the
same arithmetic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Bytes of each f32 chunk tensor of the time-mix scan: it runs in chunks
# of as many steps as fit (at least one).
SCAN_CHUNK_BYTES = 1 << 28


def _chunk_steps(b: int, nh: int, hs: int) -> int:
    return max(1, SCAN_CHUNK_BYTES // (4 * b * nh * hs * hs))


def wkv6_ref(state: torch.Tensor, rh: torch.Tensor, kh: torch.Tensor,
             vh: torch.Tensor, wh: torch.Tensor, uh: torch.Tensor,
             valid: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wkv recurrence over the S steps of (B, S, H, hs) f32 inputs from
    ``state`` (B, H, hs, hs), with the bonus ``uh`` (H, hs); steps where
    ``valid`` (B, S) is false leave the state as it was.  Returns (the
    last state, y (B, S, H, hs))."""
    b, s, nh, hs = rh.shape
    ys = rh.new_empty((b, s, nh, hs))
    step = _chunk_steps(b, nh, hs)
    for c0 in range(0, s, step):
        c1 = min(s, c0 + step)

        def chunk(t):
            return t[:, c0:c1].transpose(0, 1)              # (C, B, H, hs)
        r_c, k_c, v_c, w_c = chunk(rh), chunk(kh), chunk(vh), chunk(wh)
        kv = k_c[..., :, None] * v_c[..., None, :]          # (C,B,H,hs,hs)
        # the state before each step, plus the bonus term
        pre = uh[:, :, None] * kv
        if valid is not None:
            vm = chunk(valid)[..., None, None, None]
            w_c = torch.where(vm[..., 0], w_c, 1.0)
            kv = torch.where(vm, kv, 0.0)
        s_in = state
        if torch.is_grad_enabled() and (kv.requires_grad
                                        or w_c.requires_grad
                                        or state.requires_grad):
            # out of place: autograd keeps every state
            states = [s_in]
            for t in range(c1 - c0):
                state = torch.addcmul(kv[t], w_c[t][..., None], state)
                states.append(state)
            pre = pre + torch.stack(states[:-1])
        else:
            for t in range(c1 - c0):  # kv[t] becomes the state after t
                state = kv[t].addcmul_(w_c[t][..., None], state)
            pre[0] += s_in
            pre[1:] += kv[:-1]
        ys[:, c0:c1] = torch.einsum("cbhi,cbhij->bchj", r_c, pre)
        del kv, pre                 # freed before the next chunk's
    return state.clone(), ys
