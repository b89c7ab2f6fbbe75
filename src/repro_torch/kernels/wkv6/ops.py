"""Public entry point for RWKV-6's wkv recurrence."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.wkv6.kernel import wkv6_kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref


def wkv6(state: torch.Tensor, rh: torch.Tensor, kh: torch.Tensor,
         vh: torch.Tensor, wh: torch.Tensor, uh: torch.Tensor,
         valid: Optional[torch.Tensor] = None, *, impl: str = "auto"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence ``y_t = r_t (S_{t-1} + u k_t v_t^T)``, ``S_t = w_t
    S_{t-1} + k_t v_t^T`` over the S steps of (B, S, H, hs) f32 inputs
    from ``state`` (B, H, hs, hs), with the bonus ``uh`` (H, hs); steps
    where ``valid`` (B, S) is false leave the state as it was.  Returns
    (the last state, y (B, S, H, hs)).

    impl: ``"auto"`` launches the CUDA kernel on CUDA tensors and runs the
    plain version on CPU (and ``meta``) tensors; ``"cuda"`` always
    launches the kernel; ``"torch"`` takes CPU tensors only.

    The kernel has no backward yet.  On a CUDA tensor where autograd needs
    the graph (gradients on and an input that requires one) the call
    raises before anything launches, under ``"auto"`` as under ``"cuda"``;
    on CPU tensors the plain version's autograd-safe form runs.
    """
    route = resolve_impl(impl, rh)
    if route == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (state, rh, kh, vh, wh, uh)):
        raise ValueError("wkv6 has no backward kernel (still to port): it "
                         "cannot run on the card where autograd needs the "
                         "graph")
    if route == "cuda":
        return wkv6_kernel(*(t.contiguous() for t in
                             (state, rh, kh, vh, wh, uh)),
                           None if valid is None else valid.contiguous())
    return wkv6_ref(state, rh, kh, vh, wh, uh, valid)


def wkv6_plain(state: torch.Tensor, rh: torch.Tensor, kh: torch.Tensor,
               vh: torch.Tensor, wh: torch.Tensor, uh: torch.Tensor,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version :func:`wkv6` runs on CPU tensors, on any device.
    Never a fallback for the kernel — the tests and the card checks call
    it by name."""
    return wkv6_ref(state, rh, kh, vh, wh, uh, valid)
