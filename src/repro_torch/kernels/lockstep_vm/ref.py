"""The plain version of the ``lockstep_vm`` kernel: the lockstep engine's
host loop (``core/vm.py``, ``_Engine.run_host_loop``) — one vectorized or
serialized torch macro-step at a time, each ended by one host read of a
few flags, MEMCPY through ``tiara_gather``'s window form."""

from __future__ import annotations


def lockstep_vm_ref(engine, mem, params, homes, failed, op_sel):
    """Run one wave of ``engine`` (a ``core.vm._Engine``) with its host
    loop; the same result, bit for bit, as :func:`lockstep_vm_kernel`."""
    return engine.run_host_loop(mem, params, homes, failed, op_sel)
