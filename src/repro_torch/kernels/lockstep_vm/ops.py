"""Public entry point of a lockstep wave."""

from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.lockstep_vm.ref import lockstep_vm_ref


def lockstep_vm(engine, mem, params, homes, failed, op_sel, *,
                impl: str = "auto"):
    """One wave of ``engine`` (a ``core.vm._Engine``) against the pool
    ``mem``: on a CUDA pool one ``lockstep_vm`` launch (``impl`` "auto"
    or "cuda"), on a CPU pool the host loop (``impl`` "auto" or "torch").
    "cuda" on a CPU pool and "torch" on a CUDA pool raise."""
    if resolve_impl(impl, mem) == "cuda":
        return engine.run_kernel(mem, params, homes, failed, op_sel)
    return lockstep_vm_ref(engine, mem, params, homes, failed, op_sel)
