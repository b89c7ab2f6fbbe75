"""Launch wrapper of the hand-written CUDA ``lockstep_vm`` kernel.

One launch runs a whole wave of the lockstep Tiara engine on the card
(``csrc/lockstep_vm.cu``; the algorithm is ``csrc/lockstep_vm.cuh``): B
requests over a merged instruction store against a pool of ``n_dev``
device rows, from the first macro-step to the last, with no host read in
between.  The kernel reaches the pool only through a table of row
addresses: the rows of the dense engine's one flat buffer, or one buffer
per shard for the sharded engine on one card.  Its MEMCPY is
``tiara_gather``'s window copy, done inside the wave.  The kernel
replaces, on the port's main path, the JAX engines' ``lax.while_loop``s
(``src/repro/core/vm.py``: the dense engine's and the sharded engine's
inside ``shard_map``) and the one ``tiara_gather`` window launch per
macro-step of the port's host loops, which stay as the plain versions
(``core/vm.py``, ``_Engine.run_host_loop`` and
``_ShardedEngine.run_host_loop``).

:func:`wave_inputs` packs a wave's per-lane inputs and the row table into
one tensor; :func:`pack` lays a launch's operands out as one int64 header
in the order of ``HEADER`` (the source's ``Hdr`` enum): device pointers
and sizes.  :func:`lockstep_vm_kernel` allocates the outputs and the
scratch, packs, launches on the current stream and returns without
waiting.

``COUNTS["lockstep_vm"]`` counts the kernel's launches — the one place it
is incremented is right where the kernel is launched, so a run can show
that its main path went through the kernel.

For measurement only (the main path never calls them, and they count no
launch): :func:`lockstep_vm_clocks` runs a wave on the build with
per-phase clocks (``csrc/lockstep_vm_clocks.cu``) and
:func:`pointer_chase` times dependent loads through a buffer.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

COUNTS = {"lockstep_vm": 0}
_COUNT_LOCK = threading.Lock()

# the operand header, in the order of lockstep_vm.cuh's Hdr enum
HEADER = ("code", "n_instr", "rbase", "rmask", "n_regions", "slot_start",
          "slot_end", "slot_fuel", "n_ops", "inputs", "n_params", "B",
          "n_dev", "pool_words", "max_window", "protect", "sweep", "rows",
          "ret", "status", "steps", "regs", "fault", "scratch")
# per-lane state words (kCtlWords control words, 16 registers, the loop
# stack's 3 * kDepth words) and queued-copy words (kDescWords)
CTL_WORDS = 12
LANE_WORDS = CTL_WORDS + 16 + 3 * 8
DESC_WORDS = 8
MAX_WINDOW = 4096
MAX_THREADS = 512
NUM_REGS = 16
# the clock words of the phase-clocks build (lockstep_vm.cuh's K_* enum)
CLOCK_WORDS = ("a", "b", "c", "d", "e", "steps", "serial", "total")


def sort_size(batch: int) -> int:
    """The sorted sweep's size: the 2B windows padded to a power of
    two."""
    n = 2
    while n < 2 * int(batch):
        n <<= 1
    return n


def scratch_words(batch: int) -> int:
    """The global scratch of a wave of ``batch`` lanes, in int64 words
    (lockstep_vm.cuh's ``scratch_words``): every part of the lane state,
    the footprints, the sorted sweep and its scan, and the copy queue."""
    B = int(batch)
    return B * (LANE_WORDS + 4 + DESC_WORDS) + 2 * sort_size(B) \
        + 3 * MAX_THREADS

_I64 = torch.int64


class WaveOut(NamedTuple):
    """The per-request fields a wave writes."""
    ret: torch.Tensor        # i64 [B]
    status: torch.Tensor     # i64 [B]
    steps: torch.Tensor      # i64 [B]
    regs: torch.Tensor       # i64 [B, 16]
    fault: torch.Tensor      # i64 [B, 4]


def threads_for(batch: int, max_window: int) -> int:
    """The block size of a wave: enough threads for its lanes and for
    about 8 words of a macro-step's copies each, in whole warps, 32 to
    512 (a wave of at most 32 lanes with short windows runs as one warp,
    whose barriers cost little; past 512 lanes a thread owns several)."""
    want = max(int(batch), int(batch) * int(max_window) // 8)
    return int(min(MAX_THREADS, max(32, -(-want // 32) * 32)))


def wave_inputs(params: np.ndarray, op_sel, homes, failed,
                rows) -> torch.Tensor:
    """One wave's per-lane inputs and the pool's row table as the one
    int64 tensor the kernel reads, on the rows' device: ``params (B,
    n_params)``, ``op_sel (B,)``, ``homes (B,)``, ``failed (n_dev,)`` (0
    or 1) and the ``n_dev`` rows' addresses, back to back (one copy to
    the card, staged from pageable memory at once, no stream sync)."""
    p = np.asarray(params, dtype=np.int64)
    B = p.shape[0]
    t = torch.from_numpy(np.concatenate([
        p.reshape(-1),
        np.asarray(op_sel, dtype=np.int64).reshape(B),
        np.asarray(homes, dtype=np.int64).reshape(B),
        np.asarray(failed, dtype=np.int64).reshape(-1),
        np.asarray([r.data_ptr() for r in rows], dtype=np.int64)]))
    dev = rows[0].device
    return t if dev.type == "cpu" else t.to(dev, non_blocking=True)


def pack(*, code: torch.Tensor, rbase: torch.Tensor, rmask: torch.Tensor,
         slot_start: torch.Tensor, slot_end: torch.Tensor,
         slot_fuel: torch.Tensor, inputs: torch.Tensor, n_params: int,
         B: int, n_dev: int, pool_words: int, max_window: int,
         protect: bool, sweep: bool, rows, out: WaveOut,
         scratch: torch.Tensor) -> np.ndarray:
    """One launch's operand header.  Every tensor must be int64,
    contiguous and on one device; ``rows`` are the pool's ``n_dev`` rows
    of ``pool_words`` words and ``inputs`` is :func:`wave_inputs`'s
    tensor, whose last ``n_dev`` words hold their addresses (the header's
    ``rows`` word points there)."""
    if len(rows) != n_dev:
        raise ValueError(f"lockstep_vm: {len(rows)} pool rows for "
                         f"{n_dev} devices")
    ts = dict(code=code, rbase=rbase, rmask=rmask, slot_start=slot_start,
              slot_end=slot_end, slot_fuel=slot_fuel, inputs=inputs,
              scratch=scratch, **out._asdict(),
              **{f"row {d}": r for d, r in enumerate(rows)})
    dev = inputs.device
    for name, t in ts.items():
        if t.device != dev or t.dtype != _I64 or not t.is_contiguous():
            raise ValueError(f"lockstep_vm operand {name} must be a "
                             f"contiguous int64 tensor on {dev}")
    n_ops = int(slot_start.numel())
    head = B * n_params + 2 * B + n_dev
    shapes = dict(code=(code.shape[0], 10), rbase=rbase.shape,
                  rmask=rbase.shape, slot_start=(n_ops,),
                  slot_end=(n_ops,), slot_fuel=(n_ops,),
                  inputs=(head + n_dev,),
                  scratch=(scratch_words(B),),
                  ret=(B,), status=(B,), steps=(B,), regs=(B, NUM_REGS),
                  fault=(B, 4),
                  **{f"row {d}": (pool_words,) for d in range(n_dev)})
    for name, shape in shapes.items():
        if tuple(ts[name].shape) != tuple(shape):
            raise ValueError(f"lockstep_vm operand {name}: shape "
                             f"{tuple(ts[name].shape)}, expected "
                             f"{tuple(shape)}")
    if not 1 <= max_window <= MAX_WINDOW:
        raise ValueError(f"max_window {max_window} outside [1, "
                         f"{MAX_WINDOW}]")
    if min(B, n_dev, code.shape[0], rbase.numel(), n_ops) < 1:
        raise ValueError("a wave needs a lane, a device, an instruction, "
                         "a region and a program")
    vals = {name: t.data_ptr() for name, t in ts.items()}
    vals.update(rows=inputs.data_ptr() + 8 * head,
                n_instr=code.shape[0], n_regions=rbase.numel(),
                n_ops=n_ops, n_params=n_params, B=B, n_dev=n_dev,
                pool_words=pool_words, max_window=max_window,
                protect=int(bool(protect)), sweep=int(bool(sweep)))
    return np.asarray([int(vals[k]) for k in HEADER], dtype=np.int64)


def alloc(B: int, device: torch.device):
    """The outputs and the scratch of a wave of ``B`` lanes (the kernel
    initializes them)."""
    out = WaveOut(*(torch.empty(shape, dtype=_I64, device=device)
                    for shape in ((B,), (B,), (B,), (B, NUM_REGS), (B, 4))))
    scratch = torch.empty(scratch_words(B), dtype=_I64, device=device)
    return out, scratch


def _launcher(name="lockstep_vm_launch", extra=()):
    fn = getattr(_build.load(), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, *extra]
        fn.restype = ctypes.c_int
    return fn


def _launch(operands, name, extra=()):
    dev = operands["inputs"].device
    if dev.type != "cuda":
        raise ValueError("lockstep_vm_kernel needs CUDA tensors")
    out, scratch = alloc(int(operands["B"]), dev)
    header = pack(out=out, scratch=scratch, **operands)
    launch = _launcher(name, tuple(ctypes.c_void_p for _ in extra))
    threads = threads_for(operands["B"], operands["max_window"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(header.ctypes.data, header.size, threads, stream,
                     *extra)
    if err != 0:
        raise RuntimeError(f"lockstep_vm launch failed: cudaError {err}")
    return out


def lockstep_vm_kernel(**operands) -> WaveOut:
    """Run one wave on the card: ``operands`` are :func:`pack`'s less
    ``out`` and ``scratch``, all on one CUDA device.  Returns the wave's
    fields as device tensors at once (the launch is asynchronous; the
    pool's rows are updated in place).  Raises on anything the kernel
    does not take and on a refused launch — there is no fallback."""
    out = _launch(operands, "lockstep_vm_launch")
    with _COUNT_LOCK:
        COUNTS["lockstep_vm"] += 1
    return out


def lockstep_vm_clocks(**operands):
    """One wave on the build with per-phase clocks, as
    :func:`lockstep_vm_kernel` takes it: returns the wave's fields and
    the thread-0 clock words (``CLOCK_WORDS``: cycles in phases (a)-(e),
    macro-steps, serial lane steps, the phases' sum) as a device tensor.
    Measurement only: no launch is counted."""
    clocks = torch.zeros(len(CLOCK_WORDS), dtype=_I64,
                         device=operands["inputs"].device)
    out = _launch(operands, "lockstep_vm_launch_clocks",
                  (clocks.data_ptr(),))
    return out, clocks


def pointer_chase(buf: torch.Tensor, start: int, steps: int) -> torch.Tensor:
    """Follow ``steps`` dependent loads ``i = buf[i]`` from ``start`` with
    one thread on the card; returns ``(cycles, last index)`` as a device
    tensor.  Measurement only: no launch is counted."""
    if not buf.is_cuda or buf.dtype != _I64 or not buf.is_contiguous():
        raise ValueError("pointer_chase needs a contiguous int64 CUDA "
                         "tensor")
    out = torch.zeros(2, dtype=_I64, device=buf.device)
    fn = _build.load().lockstep_vm_pointer_chase
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = fn(buf.data_ptr(), int(start), int(steps), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"pointer_chase launch failed: cudaError {err}")
    return out
