"""Public entry point for Mamba's selective scan."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.selective_scan.kernel import selective_scan_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
                   bm: torch.Tensor, cm: torch.Tensor, a_mat: torch.Tensor,
                   valid: Optional[torch.Tensor] = None, *,
                   impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence ``h = exp(dt A) h + dt x B``, ``y = h . C`` over the
    S steps of ``dt``, ``x`` (B, S, d) and ``bm``, ``cm`` (B, S, N) from
    the state ``h`` (B, d, N), with ``a_mat`` = A (d, N), all f32; steps
    where ``valid`` (B, S) is false leave the state as it was.  Returns
    (the last state, y (B, S, d)).

    impl: ``"auto"`` launches the CUDA kernel on CUDA tensors and runs the
    plain version on CPU (and ``meta``) tensors; ``"cuda"`` always
    launches the kernel; ``"torch"`` takes CPU tensors only.

    The kernel has no backward yet.  On a CUDA tensor where autograd needs
    the graph (gradients on and an input that requires one) the call
    raises before anything launches, under ``"auto"`` as under ``"cuda"``;
    on CPU tensors the plain version's autograd-safe form runs.
    """
    route = resolve_impl(impl, dt)
    if route == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, dt, x, bm, cm, a_mat)):
        raise ValueError("selective_scan has no backward kernel (still to "
                         "port): it cannot run on the card where autograd "
                         "needs the graph")
    if route == "cuda":
        return selective_scan_kernel(
            h.contiguous(), dt.contiguous(), x.contiguous(), bm, cm,
            a_mat.contiguous(), valid)
    return selective_scan_ref(h, dt, x, bm, cm, a_mat, valid)


def selective_scan_plain(h: torch.Tensor, dt: torch.Tensor, x: torch.Tensor,
                         bm: torch.Tensor, cm: torch.Tensor,
                         a_mat: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version :func:`selective_scan` runs on CPU tensors, on
    any device.  Never a fallback for the kernel — the tests and the card
    checks call it by name."""
    return selective_scan_ref(h, dt, x, bm, cm, a_mat, valid)
