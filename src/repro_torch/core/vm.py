"""PyTorch execution engines for verified Tiara operators.

The port of ``repro.core.vm``'s dense engines.  One memory processor
(MP) frontend steps **B independent requests at once** against one
shared memory pool; the carry is the architectural state of the paper's
Fig. 4 datapath — pc, the 16x64 b register file, the depth-8 loop stack,
the in-flight async counter.

Execution semantics of a batch (deterministic round-robin interleaving):
each macro-step, every live request executes its current instruction in
request-index order, and request *i* observes all memory effects of
requests ``j < i`` within the same macro-step.  When the requests'
memory footprints are disjoint this is bit-identical to running them one
after another on the ``pyvm`` oracle; under contention (e.g. CAS on a
shared latch) the ordering stays deterministic — the lowest-indexed
request wins.

Two step implementations share that semantics:

  * a fully vectorized step (active-mask semantics, every opcode computed
    for every lane and combined with masks, scatters of dead lanes routed
    to a sink word past the pool) used whenever the per-step sweep-line
    conflict check proves no request's write window can touch another's
    read or write window, and
  * the exact serialized step — requests ``0..B-1`` one after another,
    each executing the vectorized step on its own one-lane slice against
    the pool — used for contended steps so atomics (STORE/CAS/CAA) keep
    pyvm ordering.  The one-lane vectorized step *is* the scalar
    interpreter (``_make_scalar_step``): one definition of the semantics
    serves both paths, so they cannot drift apart.

Where the JAX engine is one ``lax.while_loop``, this engine is one
launch of the hand-written ``lockstep_vm`` CUDA kernel per wave on a card
pool (``kernels/lockstep_vm``): the whole wave runs on the card, with no
host read until the caller retires it.  On a CPU pool it runs its plain
version, the host loop (``_Engine.run_host_loop``): each macro-step ends
in one host read of a few flags (any request live, conflict found, which
memory routes the step needs), so a step costs one device
synchronization.  The engines' ``impl`` picks the route: "auto" (the
pool's device decides), "cuda" or "torch"; the route that does not match
the pool raises.  ``B == 1`` is the classic single-MP datapath with no
conflict machinery.

**Mixed batches**: the engine runs over a *merged instruction store* —
every registered program laid out back to back, exactly the registry's
shared BRAM — and each request carries an ``op_sel`` slot index; request
``b`` starts at ``start_pc[op_sel[b]]`` and terminates against its own
program end and its own verified step bound.  ``build_batched_vm`` is the
one-program specialization (``op_sel`` pinned to slot 0).

**MEMCPY**: the kernel copies every lane's window inside the wave
(``tiara_gather``'s window copy); the host loop reads the source windows
through the ``tiara_gather`` kernel's window form (one mask per lane) on
a card pool, and through its plain version on a CPU pool: one launch per
macro-step in which some lane copies.

**Memory ownership**: an engine run never mutates its input pool unless
the caller donates it.  It copies the pool once into a private flat
buffer with one spare *sink* word at the end (dead lanes scatter there —
torch has no ``mode="drop"`` scatter), updates that buffer in place, and
returns a view of it as the result's pool.  A launch that fails therefore
leaves the caller's pool untouched.  Within :func:`donate` (the
endpoint's doorbell), the next lockstep run on exactly the donated tensor
— a pool laid out as that private buffer, flat with its sink word
(:func:`resident_pool`) — takes it as its buffer instead: the wave writes
the pool in place and no second pool is allocated.  A launch refused
before it runs still leaves it untouched (the endpoint's retry path
relies on it).

**Devices**: every entry point runs where its pool lies.  A numpy pool
goes to ``device`` — the CUDA card unless the caller names the CPU; with
no card and no device named the call raises instead of quietly running on
the CPU.  Results keep ``mem`` on the device (the pool stays resident);
:func:`materialize_result` copies only the per-request fields to the
host.

Semantics are defined by ``repro_torch.core.pyvm`` — keep the two in
lockstep.  All ISA values are int64; torch integer arithmetic wraps like
the hardware, and ``SHR`` is emulated as a logical shift (torch's ``>>``
on int64 is arithmetic).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.isa import (Alu, Op, FLAG_ASYNC, FLAG_DEV_REG,
                                  FLAG_DSTDEV_REG, FLAG_IMMB, FLAG_LEN_REG,
                                  FLAG_MREG, FLAG_SRCDEV_REG, FLAG_THR_REG,
                                  DEV_LOCAL, ERR_REG)
from repro_torch.core.memory import RegionTable
from repro_torch.core.verifier import VerifiedOperator
from repro_torch.distributed import mesh as _mesh
from repro_torch.kernels import IMPLS
from repro_torch.kernels.lockstep_vm.kernel import (lockstep_vm_kernel,
                                                   wave_inputs)
from repro_torch.kernels.lockstep_vm.ops import lockstep_vm
from repro_torch.kernels.tiara_gather.ops import tiara_gather_window

_REG_MASK = isa.NUM_REGS - 1
# the instruction fields that can name a register a step reads
_READ_FIELDS = (isa.F_A, isa.F_B, isa.F_C, isa.F_D, isa.F_E, isa.F_DST,
                isa.F_IMM2)
_I64 = torch.int64
_BIG = 1 << 62


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the named one, else the CUDA
    card.  Raises when no device is named and no card is present — the
    port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda")


def as_pool(mem, device=None) -> torch.Tensor:
    """An int64 ``(n_devices, pool_words)`` pool tensor: a tensor stays
    on its own device (``device``, when given, must match), a numpy array
    is copied to ``device`` (the card unless named), a sharded pool is
    gathered onto ``device`` (its first shard's unless named)."""
    if isinstance(mem, _mesh.Sharded):
        # a single-device engine over a sharded pool: the one explicit
        # gather of the shards onto one device
        return mem.full(device if device is not None else mem.device)
    if isinstance(mem, torch.Tensor):
        if device is not None and \
                torch.device(device).type != mem.device.type:
            raise ValueError(
                f"pool lies on {mem.device}, call asked for {device}")
        return mem if mem.dtype == _I64 else mem.to(_I64)
    return torch.as_tensor(np.asarray(mem, dtype=np.int64),
                           device=resolve_device(device)).clone()


class ReqState(NamedTuple):
    """Per-request architectural state; every leaf carries a leading
    batch dimension.  The shared memory pool is threaded separately so B
    requests step against one pool."""

    pc: torch.Tensor          # i64 [B]
    regs: torch.Tensor        # i64 [B, 16]
    lstack: torch.Tensor      # i64 [B, 8, 3]  (start, end, remaining)
    lsp: torch.Tensor         # i64 [B]
    inflight: torch.Tensor    # i64 [B]
    halted: torch.Tensor      # bool [B]
    ret: torch.Tensor         # i64 [B]
    status: torch.Tensor      # i64 [B]
    steps: torch.Tensor       # i64 [B]
    ctrl: torch.Tensor        # i64 [B]: 0 = advance, 1 = taken jump
    pc_new: torch.Tensor      # i64 [B]
    fault: torch.Tensor       # i64 [B, 4]: (pc, opcode, addr, device)


class VMResult(NamedTuple):
    mem: torch.Tensor
    ret: torch.Tensor
    status: torch.Tensor
    steps: torch.Tensor
    regs: torch.Tensor
    fault: torch.Tensor       # i64 [B, 4] FaultInfo rows (pc=-1 = no fault)


# The "no fault" FaultInfo row every clean lane carries (pc = -1).
NO_FAULT = np.asarray([-1, 0, 0, 0], dtype=np.int64)


def _unrun_lanes(params: torch.Tensor, B: int) -> dict:
    """The result fields of ``B`` lanes before their first step, on
    ``params``' device: ret 0, status fell off, no step, the params in the
    registers, no fault.  Every lockstep wave starts from them, and a
    padding lane (``op_sel < 0``), which never runs, returns them."""
    dev = params.device
    regs = torch.zeros((B, isa.NUM_REGS), dtype=_I64, device=dev)
    params = params.reshape(B, -1)
    k = min(int(params.shape[1]), isa.NUM_REGS)
    if k:
        regs[:, :k] = params[:, :k]
    return dict(
        ret=torch.zeros(B, dtype=_I64, device=dev),
        status=torch.full((B,), isa.STATUS_FELL_OFF, dtype=_I64,
                          device=dev),
        steps=torch.zeros(B, dtype=_I64, device=dev), regs=regs,
        fault=torch.as_tensor(NO_FAULT, device=dev).repeat(B, 1))


def fault_info(row) -> Optional[isa.FaultInfo]:
    """Decode one [4] fault row into a FaultInfo (None when clean)."""
    if isinstance(row, torch.Tensor):
        row = row.cpu().numpy()
    row = np.asarray(row, dtype=np.int64).reshape(4)
    if int(row[0]) < 0:
        return None
    return isa.FaultInfo(pc=int(row[0]), opcode=int(row[1]),
                         addr=int(row[2]), device=int(row[3]))


def shr_logical(a: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 ``a`` by ``sh`` in 0..63: the
    arithmetic shift with the sign-extended high bits masked off (the
    mask of the low ``64 - sh`` bits is ``~((-1 << (63 - sh)) << 1)``,
    all ones at ``sh == 0``)."""
    low = ~((torch.full_like(sh, -1) << (63 - sh)) << 1)
    return (a >> sh) & low


def _alu_table(a, b):
    """All 16 ALU results for operands ``a``/``b`` (any common shape),
    indexed by ``Alu`` opcode — the single definition the vectorized
    evaluator selects from."""
    sh = b & 63
    return [
        a + b, a - b, a * b, a & b, a | b, a ^ b,
        a << sh, shr_logical(a, sh),
        (a == b).to(_I64), (a != b).to(_I64),
        (a < b).to(_I64), (a >= b).to(_I64),
        torch.minimum(a, b), torch.maximum(a, b), a, a,
    ]


# ---------------------------------------------------------------------------
# Memory access — the one seam between instruction semantics and the
# pool's physical layout (the JAX engine's ``_DenseOps``).  ``memx`` is the
# engine's private flat pool plus one sink word at index ``sink``.
# ---------------------------------------------------------------------------


class _DenseOps:
    """Direct access to the full ``(n_devices, pool_words)`` pool held flat
    in ``memx``; a masked write goes to the sink word."""

    def __init__(self, n_dev: int, pool_words: int):
        self.n_dev = n_dev
        self.P = pool_words
        self.sink = n_dev * pool_words

    def readv(self, memx, dev, addr):
        return memx[dev.clamp(0, self.n_dev - 1) * self.P
                    + addr.clamp(0, self.P - 1)]

    def writev(self, memx, dev, addr, val, mask):
        tgt = torch.where(mask, dev * self.P + addr,
                          torch.full_like(addr, self.sink))
        memx.index_put_((tgt,), val)

    def readv_win(self, memx, dev, base, off, mask, width: int):
        """Word ``w < width`` of lane ``b``'s window: ``memx[dev[b] * P +
        base[b] + ((off[b] + w) & mask[b])]`` — the ``tiara_gather``
        kernel's window form with one mask per lane (each lane copies
        from its own region) on a card pool, its plain version on a CPU
        pool.  Masking the offsets keeps every index inside its region,
        the kernel's precondition; they stay int64, as a region may hold
        2**31 words or more."""
        return tiara_gather_window(
            memx, (off & mask).contiguous(),
            dev.clamp(0, self.n_dev - 1) * self.P + base,
            width=width, mask=mask.contiguous())

    def writev_win(self, memx, dev, phys, val, live):
        tgt = torch.where(live, dev[:, None] * self.P + phys,
                          torch.full_like(phys, self.sink))
        memx.index_put_((tgt.reshape(-1),), val.reshape(-1))


class _ShardOps:
    """Collective-routed access to one shard of the pool inside
    ``shard_map`` (the JAX engine's ``_ShardOps``): ``memx`` is this
    shard's private ``(pool_words + 1,)`` row plus its sink word.

    Reads are answered by the owning shard (masked contribution +
    ``psum`` across the mesh axis); writes are applied only by the owner
    (non-owners route the scatter to the sink).  The *vector* form routes
    different per-shard requests: they are ``all_gather``-ed across the
    axis, every shard contributes the words it owns — a window read
    through the ``tiara_gather`` kernel's window form on the owner's own
    shard — and the ``psum`` carries each answer back: the software
    spelling of the fabric's remote-read round trip.  The *replicated*
    form (``replicated=True``) serves the serialized fallback, where
    every shard asks the identical question, so a masked ``psum``
    suffices and a write needs no collective at all."""

    def __init__(self, pool_words: int, axis: str, me: int,
                 replicated: bool = False):
        self.P = pool_words
        self.sink = pool_words
        self.axis = axis
        self.me = me
        self.replicated = replicated

    def _own(self, memx, addr):
        return memx[addr.clamp(0, self.P - 1)]

    def readv(self, memx, dev, addr):
        if self.replicated:
            own = torch.where(dev == self.me, self._own(memx, addr), 0)
            return _mesh.psum(own, self.axis)
        req = _mesh.all_gather(torch.stack([dev, addr]), self.axis)
        own = torch.where(req[:, 0] == self.me,
                          self._own(memx, req[:, 1]), 0)      # (n, B)
        return _mesh.psum(own, self.axis)[self.me]

    def writev(self, memx, dev, addr, val, mask):
        if not self.replicated:
            pay = _mesh.all_gather(
                torch.stack([dev, addr, val, mask.to(_I64)]), self.axis)
            dev, addr, val = (pay[:, i].reshape(-1) for i in range(3))
            mask = pay[:, 3].reshape(-1) != 0
        mine = mask & (dev == self.me)
        tgt = torch.where(mine, addr.clamp(0, self.P - 1),
                          torch.full_like(addr, self.sink))
        memx.index_put_((tgt,), val)

    def readv_win(self, memx, dev, base, off, mask, width: int):
        """Lane ``b``'s window (see ``_DenseOps.readv_win``), read by the
        shard that owns ``dev[b]`` through ``tiara_gather``'s window form
        on its own row (one launch per shard) and routed back."""
        B = int(dev.shape[0])
        if not self.replicated:
            req = _mesh.all_gather(torch.stack([dev, base, off, mask]),
                                   self.axis)                 # (n, 4, B)
            dev, base, off, mask = (req[:, i].reshape(-1)
                                    for i in range(4))
        win = tiara_gather_window(
            memx, (off & mask).contiguous(), base.contiguous(),
            width=width, mask=mask.contiguous())
        own = torch.where((dev == self.me)[:, None], win, 0)
        got = _mesh.psum(own, self.axis)
        if self.replicated:
            return got
        return got[self.me * B:(self.me + 1) * B]

    def writev_win(self, memx, dev, phys, val, live):
        if not self.replicated:
            dev = _mesh.all_gather(dev, self.axis).reshape(-1)
            pay = _mesh.all_gather(
                torch.stack([phys, val, live.to(_I64)]), self.axis)
            phys, val = pay[:, 0].flatten(0, 1), pay[:, 1].flatten(0, 1)
            live = pay[:, 2].flatten(0, 1) != 0
        mine = live & (dev == self.me)[:, None]
        tgt = torch.where(mine, phys.clamp(0, self.P - 1),
                          torch.full_like(phys, self.sink))
        memx.index_put_((tgt.reshape(-1),), val.reshape(-1))


# ---------------------------------------------------------------------------
# Step emitters
# ---------------------------------------------------------------------------


def _sweep_conflict(r_lo, r_hi, w_lo, w_hi):
    """Conflict existence over per-lane footprint intervals (see
    ``lane_intervals``): does some lane's write window overlap another
    lane's read or write window?  A sweep line over the sorted interval
    starts with exclusive running maxima of the ends — O(L log L).
    Returns a 0-d bool tensor."""
    empty_hi = -_BIG
    L = r_lo.shape[0]
    lo = torch.cat([r_lo, w_lo])
    hi = torch.cat([r_hi, w_hi])
    isw = torch.cat([torch.zeros(L, dtype=torch.bool, device=lo.device),
                     torch.ones(L, dtype=torch.bool, device=lo.device)])
    order = torch.argsort(lo, stable=True)
    lo_s, hi_s, w_s = lo[order], hi[order], isw[order]
    hi_w = torch.where(w_s, hi_s, torch.full_like(hi_s, empty_hi))
    neg1 = torch.full((1,), empty_hi, dtype=_I64, device=lo.device)
    excl_all = torch.cat([neg1, torch.cummax(hi_s, 0).values[:-1]])
    excl_w = torch.cat([neg1, torch.cummax(hi_w, 0).values[:-1]])
    return (excl_w > lo_s).any() | (w_s & (excl_all > lo_s)).any()


def _lane_conflicts(r_lo, r_hi, w_lo, w_hi):
    """Per lane: does its write window overlap another lane's read or
    write window, or its read window another lane's write window?  The
    pairwise form of :func:`_sweep_conflict` (a lane's own windows never
    conflict with each other).  Returns bool ``(L,)``."""
    def meet(alo, ahi, blo, bhi):
        return (alo[:, None] < bhi[None, :]) & (blo[None, :] < ahi[:, None])

    pair = meet(w_lo, w_hi, w_lo, w_hi) | meet(w_lo, w_hi, r_lo, r_hi) \
        | meet(r_lo, r_hi, w_lo, w_hi)
    pair.fill_diagonal_(False)
    return pair.any(dim=1)


def _make_vector_step(*, base_c, mask_c, n_regions, n_dev, pool_words,
                      max_window, depth, failed, ops, protect=True):
    """The vectorized macro-step plus the per-lane footprint intervals
    feeding the conflict sweep.  Returns ``(vector_step,
    lane_intervals)``; both take the lanes' ``homes`` so the same closure
    serves the whole batch and the one-lane slices of the serialized
    step.

    Every opcode path is computed for every lane and combined with
    masks.  With ``protect`` (the default) the runtime protection checks
    are decoded per lane and a faulting lane halts with
    ``STATUS_PROT_FAULT``, all channels masked.
    """
    dev_t = base_c.device
    lane16 = torch.arange(isa.NUM_REGS, dtype=_I64, device=dev_t)[None, :]
    lane8 = torch.arange(depth, dtype=_I64, device=dev_t)[None, :]
    col3 = torch.arange(3, dtype=_I64, device=dev_t)[None, None, :]
    iw_full = torch.arange(max_window, dtype=_I64, device=dev_t)[None, :]

    fields = torch.as_tensor(_READ_FIELDS, dtype=_I64, device=dev_t)

    def reads(s, rows):
        """Every register a step can read, in one gather: ``r[f][b] =
        regs[b, rows[b, f] & 15]`` for each field ``f`` of
        ``_READ_FIELDS`` (the register file as the step finds it)."""
        g = s.regs.gather(1, rows[:, fields] & _REG_MASK)
        return {f: g[:, i] for i, f in enumerate(_READ_FIELDS)}

    def dev_of_v(reg, field, via_reg, homes):
        d = torch.where(via_reg, reg, field)
        return torch.where(d == DEV_LOCAL, homes, torch.remainder(d, n_dev))

    def dev_oob_v(reg, via_reg):
        return via_reg & (reg != DEV_LOCAL) & ((reg < 0) | (reg >= n_dev))

    def _decode(s, rows, homes, r):
        """Shared per-lane decode of memory operands (word ops and
        memcpy windows) used by both the vector step and the conflict
        check; ``r`` is the step's register reads."""
        flags = rows[:, isa.F_FLAGS]
        # word ops (LOAD/STORE/CAS/CAA) share the same addressing form
        w_rid = rows[:, isa.F_A].clamp(0, n_regions - 1)
        w_via = (flags & FLAG_DEV_REG) != 0
        w_dev = dev_of_v(r[isa.F_E], rows[:, isa.F_E], w_via, homes)
        w_off = r[isa.F_B] + rows[:, isa.F_IMM]
        w_addr = base_c[w_rid] + (w_off & mask_c[w_rid])
        # memcpy operands
        m_drid = rows[:, isa.F_A].clamp(0, n_regions - 1)
        m_srid = rows[:, isa.F_D].clamp(0, n_regions - 1)
        m_via_d = (flags & FLAG_DSTDEV_REG) != 0
        m_via_s = (flags & FLAG_SRCDEV_REG) != 0
        m_ddev = dev_of_v(r[isa.F_DST], rows[:, isa.F_DST], m_via_d,
                          homes)
        m_sdev = dev_of_v(r[isa.F_C], rows[:, isa.F_C], m_via_s, homes)
        cap = rows[:, isa.F_IMM]
        lnreg = r[isa.F_IMM2]
        ln = torch.where((flags & FLAG_LEN_REG) != 0,
                         torch.minimum(lnreg.clamp(min=0), cap), cap)
        ln = torch.minimum(torch.minimum(ln, mask_c[m_drid] + 1),
                           mask_c[m_srid] + 1)
        m_fail = failed[m_ddev] | failed[m_sdev]
        m_soff = r[isa.F_E]
        m_doff = r[isa.F_B]
        out = dict(flags=flags, w_rid=w_rid, w_dev=w_dev, w_addr=w_addr,
                   m_drid=m_drid, m_srid=m_srid, m_ddev=m_ddev,
                   m_sdev=m_sdev, m_fail=m_fail, m_soff=m_soff,
                   m_doff=m_doff)
        if protect:
            # word-op fault columns (mirrors pyvm's word-op checks)
            w_draw = torch.where(w_via, r[isa.F_E],
                                 rows[:, isa.F_E])
            w_oob_dev = dev_oob_v(r[isa.F_E], w_via)
            w_flt = w_oob_dev | (w_off != (w_off & mask_c[w_rid])) | \
                failed[w_dev]
            # memcpy fault columns (4-way priority, pre-fail-zero ln)
            oob_dd = dev_oob_v(r[isa.F_DST], m_via_d)
            oob_sd = dev_oob_v(r[isa.F_C], m_via_s)
            d_oob = (m_doff != (m_doff & mask_c[m_drid])) | \
                (m_doff + ln > mask_c[m_drid] + 1)
            s_oob = (m_soff != (m_soff & mask_c[m_srid])) | \
                (m_soff + ln > mask_c[m_srid] + 1)
            m_flt = (ln > 0) & (oob_dd | oob_sd | d_oob | s_oob)
            m_faddr = torch.where(oob_dd | (~oob_sd & d_oob), m_doff,
                                  m_soff)
            m_fdev = torch.where(
                oob_dd, r[isa.F_DST],
                torch.where(oob_sd, r[isa.F_C],
                            torch.where(d_oob, m_ddev, m_sdev)))
            m_fail = m_fail & ~m_flt
            ln = torch.where(m_flt, torch.zeros_like(ln), ln)
            out.update(w_flt=w_flt, w_off=w_off,
                       w_fdev=torch.where(w_oob_dev, w_draw, w_dev),
                       m_flt=m_flt, m_faddr=m_faddr, m_fdev=m_fdev,
                       m_fail=m_fail)
        ln = torch.where(m_fail, torch.zeros_like(ln), ln)
        out["ln"] = ln
        return out

    def lane_intervals(s, rows, active, homes):
        """Per-lane read/write footprint intervals in flat
        ``dev * pool_words + addr`` coordinates.

        Word ops contribute exact one-word intervals; memcpy its exact
        window when it does not wrap the region mask, else the whole
        region.  An atomic's read is the same word as its write, so it
        contributes one write interval only.  The only false positive is
        a memcpy whose *own* source and destination windows overlap
        (memmove within one request), which merely takes the exact
        serialized path.  Never unsound."""
        d = _decode(s, rows, homes, reads(s, rows))
        opv = rows[:, isa.F_OP]
        is_load = active & (opv == int(Op.LOAD))
        is_store = active & (opv == int(Op.STORE))
        is_atom = active & ((opv == int(Op.CAS)) | (opv == int(Op.CAA)))
        is_mcpy = active & (opv == int(Op.MEMCPY))
        P = pool_words
        wf = d["w_dev"] * P + d["w_addr"]
        zero = torch.zeros_like(wf)
        # memcpy source span
        s_size = mask_c[d["m_srid"]] + 1
        s_start = d["m_soff"] & mask_c[d["m_srid"]]
        s_wrap = (s_start + d["ln"]) > s_size
        src_lo = d["m_sdev"] * P + base_c[d["m_srid"]] + \
            torch.where(s_wrap, zero, s_start)
        src_hi = src_lo + torch.where(s_wrap, s_size, d["ln"])
        # memcpy destination span
        d_size = mask_c[d["m_drid"]] + 1
        d_start = d["m_doff"] & mask_c[d["m_drid"]]
        d_wrap = (d_start + d["ln"]) > d_size
        dst_lo = d["m_ddev"] * P + base_c[d["m_drid"]] + \
            torch.where(d_wrap, zero, d_start)
        dst_hi = dst_lo + torch.where(d_wrap, d_size, d["ln"])

        e_lo = torch.full_like(wf, _BIG)
        e_hi = torch.full_like(wf, -_BIG)
        r_lo = torch.where(is_load, wf, torch.where(is_mcpy, src_lo, e_lo))
        r_hi = torch.where(is_load, wf + 1,
                           torch.where(is_mcpy, src_hi, e_hi))
        w_lo = torch.where(is_store | is_atom, wf,
                           torch.where(is_mcpy, dst_lo, e_lo))
        w_hi = torch.where(is_store | is_atom, wf + 1,
                           torch.where(is_mcpy, dst_hi, e_hi))
        # zero-length memcpy windows must be empty, not points
        r_hi = torch.where(r_hi <= r_lo, e_hi, r_hi)
        w_hi = torch.where(w_hi <= w_lo, e_hi, w_hi)
        return r_lo, r_hi, w_lo, w_hi

    def alu_eval_v(aop, a, b):
        stacked = torch.stack(_alu_table(a, b))      # (16, B)
        return stacked.gather(0, aop.clamp(0, 15)[None, :])[0]

    def vector_step(s: ReqState, memx, rows, active, homes,
                    gates=None) -> ReqState:
        """One macro-step over the lanes of ``s``; updates ``memx`` in
        place and returns the new state.  ``gates`` = host-known
        ``(any word read, any word write, any memcpy)`` among the active
        lanes: a route no lane needs is skipped (None runs every route —
        the result is the same either way).  A fourth gate bounds the
        loop-stack fixup: the most frames any active lane can hold after
        this step (its live frames, plus one at a LOOP) — each pass of
        the fixup pops or iterates at most one frame per lane, so that
        many passes do all the work ``depth`` passes would, and none is
        needed when no frame is live."""
        B = s.pc.shape[0]
        g_read, g_write, g_mcpy = gates[:3] if gates is not None \
            else (True, True, True)
        n_fix = depth if gates is None or len(gates) < 4 \
            else min(int(gates[3]), depth)
        r = reads(s, rows)
        d = _decode(s, rows, homes, r)
        opv = rows[:, isa.F_OP]
        flags = d["flags"]
        imm = rows[:, isa.F_IMM]
        imm2 = rows[:, isa.F_IMM2]

        def is_op(o):
            return active & (opv == int(o))

        is_movi, is_alu = is_op(Op.MOVI), is_op(Op.ALU)
        is_load, is_store = is_op(Op.LOAD), is_op(Op.STORE)
        is_mcpy = is_op(Op.MEMCPY)
        is_cas, is_caa = is_op(Op.CAS), is_op(Op.CAA)
        is_jump, is_loop = is_op(Op.JUMP), is_op(Op.LOOP)
        is_wait, is_ret = is_op(Op.WAIT), is_op(Op.RET)
        is_atom = is_cas | is_caa
        zero = torch.zeros_like(s.pc)
        one = torch.ones_like(s.pc)

        # --- runtime protection faults -----------------------------
        if protect:
            flt = (d["w_flt"] & (is_load | is_store | is_atom)) | \
                (d["m_flt"] & is_mcpy)
            f_addr = torch.where(is_mcpy, d["m_faddr"], d["w_off"])
            f_dev = torch.where(is_mcpy, d["m_fdev"], d["w_fdev"])
            frows = torch.stack([s.pc, opv, f_addr, f_dev], dim=-1)
        else:
            flt = torch.zeros(B, dtype=torch.bool, device=dev_t)

        # --- ALU / MOVI --------------------------------------------
        alu_rhs = torch.where((flags & FLAG_IMMB) != 0, imm,
                              r[isa.F_B])
        alu_val = alu_eval_v(rows[:, isa.F_D],
                             r[isa.F_A], alu_rhs)

        # --- LOAD / CAS / CAA reads (step-start memory: the conflict
        # check guarantees no same-step writer touches these words)
        w_old = ops.readv(memx, d["w_dev"], d["w_addr"]) if g_read \
            else zero
        hit = w_old == r[isa.F_C]
        swp = r[isa.F_D]
        atom_new = torch.where(
            hit, torch.where(is_cas, swp, w_old + swp), w_old)

        # --- register write channel (one per opcode at most) --------
        err_old = s.regs[:, ERR_REG]
        err_new = torch.where(d["m_fail"], err_old | 1, err_old)
        reg_w_mask = (is_movi | is_alu | is_load | is_atom | is_mcpy) \
            & ~flt
        reg_w_idx = torch.where(
            is_mcpy, torch.full_like(opv, ERR_REG),
            rows[:, isa.F_DST] & _REG_MASK)
        reg_w_val = torch.where(
            is_movi, imm,
            torch.where(is_alu, alu_val,
                        torch.where(is_load | is_atom, w_old, err_new)))
        upd = (lane16 == reg_w_idx[:, None]) & reg_w_mask[:, None]
        regs = torch.where(upd, reg_w_val[:, None], s.regs)

        # --- single-word scatter (STORE / CAS / CAA) -----------------
        if g_write:
            sw_mask = (is_store | is_atom) & ~flt
            sw_val = torch.where(is_store, r[isa.F_DST],
                                 atom_new)
            ops.writev(memx, d["w_dev"], d["w_addr"], sw_val, sw_mask)

        # --- memcpy window gather + scatter --------------------------
        # skipped on the (frequent) macro-steps where no live lane is
        # copying: the window machinery materializes (B, max_window)
        if g_mcpy:
            dphys = base_c[d["m_drid"]][:, None] + \
                ((d["m_doff"][:, None] + iw_full)
                 & mask_c[d["m_drid"]][:, None])
            live = is_mcpy[:, None] & (iw_full < d["ln"][:, None])
            svals = ops.readv_win(memx, d["m_sdev"], base_c[d["m_srid"]],
                                  d["m_soff"], mask_c[d["m_srid"]],
                                  max_window)
            ops.writev_win(memx, d["m_ddev"], dphys, svals, live)

        # --- inflight ------------------------------------------------
        inflight = torch.where(
            is_mcpy & ~flt & ((flags & FLAG_ASYNC) != 0),
            torch.clamp(s.inflight + 1, max=isa.MAX_INFLIGHT), s.inflight)
        thr = torch.where((flags & FLAG_THR_REG) != 0,
                          r[isa.F_A], imm)
        inflight = torch.where(
            is_wait, torch.minimum(inflight, thr.clamp(min=0)), inflight)

        # --- RET / protection fault ----------------------------------
        halted = s.halted | is_ret | flt
        ret = torch.where(is_ret, r[isa.F_A], s.ret)
        status = torch.where(
            is_ret, imm,
            torch.where(flt, torch.full_like(imm, isa.STATUS_PROT_FAULT),
                        s.status))

        # --- control flow -------------------------------------------
        jcond = rows[:, isa.F_D]
        jlhs = r[isa.F_A]
        jrhs = torch.where((flags & FLAG_IMMB) != 0, imm,
                           r[isa.F_B])
        take = torch.where(
            jcond == int(Alu.ALWAYS), torch.ones_like(active),
            torch.where(jcond == int(Alu.EQ), jlhs == jrhs,
                        torch.where(jcond == int(Alu.NE), jlhs != jrhs,
                                    torch.where(jcond == int(Alu.LT),
                                                jlhs < jrhs,
                                                jlhs >= jrhs))))
        # LOOP push
        cap = imm
        m = torch.where((flags & FLAG_MREG) != 0,
                        torch.minimum(r[isa.F_B]
                                      .clamp(min=0), cap),
                        cap)
        skip = m <= 0
        push = is_loop & ~skip
        frame = torch.stack([s.pc + 1, s.pc + imm2, m], dim=-1)  # (B, 3)
        sp = s.lsp.clamp(0, depth - 1)
        push_lane = (lane8 == sp[:, None]) & push[:, None]       # (B, 8)
        lstack = torch.where(push_lane[:, :, None], frame[:, None, :],
                             s.lstack)
        lsp = torch.where(push, s.lsp + 1, s.lsp)

        pc_new = torch.where(
            is_jump & take, s.pc + 1 + imm2,
            torch.where(is_loop & skip, s.pc + 1 + imm2, s.pc + 1))
        ctrl = torch.where(is_jump & take, one, zero)

        # --- loop fixup, vectorized over the batch -------------------
        def top(field, stk, lsp_v):
            idx = (lsp_v - 1).clamp(0, depth - 1)
            return stk[:, :, field].gather(1, idx[:, None])[:, 0]

        # taken jump: pop every frame whose body the jump escaped
        pop_lsp = lsp
        for _ in range(n_fix):
            cond = (pop_lsp > 0) & (top(1, lstack, pop_lsp) < pc_new)
            pop_lsp = torch.where(cond, pop_lsp - 1, pop_lsp)

        # normal advance: iterate / pop frames whose body just ended
        it_stack, it_lsp, it_pcn = lstack, lsp, pc_new
        done = torch.zeros(B, dtype=torch.bool, device=dev_t)
        for _ in range(n_fix):
            idx = (it_lsp - 1).clamp(0, depth - 1)
            t_end = top(1, it_stack, it_lsp)
            cond = (~done) & (it_lsp > 0) & (it_pcn == t_end + 1)
            rem = top(2, it_stack, it_lsp) - 1
            cont = rem > 0
            set_m = cond & cont
            upd2 = (lane8 == idx[:, None]) & set_m[:, None]
            it_stack = torch.where(upd2[:, :, None] & (col3 == 2),
                                   rem[:, None, None], it_stack)
            it_pcn = torch.where(set_m, top(0, it_stack, it_lsp), it_pcn)
            it_lsp = torch.where(cond & ~cont, it_lsp - 1, it_lsp)
            done = done | set_m

        is_jtaken = ctrl == 1
        fix = active & ~is_ret & ~flt
        pc = torch.where(fix, torch.where(is_jtaken, pc_new, it_pcn), s.pc)
        lsp_f = torch.where(fix, torch.where(is_jtaken, pop_lsp, it_lsp),
                            torch.where(active, lsp, s.lsp))
        lstack_f = torch.where(
            fix[:, None, None],
            torch.where(is_jtaken[:, None, None], lstack, it_stack),
            torch.where(active[:, None, None], lstack, s.lstack))

        # --- merge, masking out inactive lanes -----------------------
        regs = torch.where(active[:, None], regs, s.regs)
        fault = s.fault
        if protect:
            fault = torch.where(flt[:, None], frows, s.fault)
        return ReqState(
            pc=pc, regs=regs, lstack=lstack_f, lsp=lsp_f,
            inflight=torch.where(active, inflight, s.inflight),
            halted=torch.where(active, halted, s.halted),
            ret=torch.where(active, ret, s.ret),
            status=torch.where(active, status, s.status),
            steps=s.steps + active.to(_I64),
            ctrl=torch.where(active, ctrl, s.ctrl),
            pc_new=torch.where(active, pc_new, s.pc_new),
            fault=fault)

    return vector_step, lane_intervals


def _make_scalar_step(vector_step):
    """The scalar (one-request) interpreter — the semantic reference the
    vectorized batch must match: the vectorized step on one lane's
    slice, so the two share one definition.  Returns ``step_one(s, memx,
    b, rows, homes, gates=None)`` executing request ``b`` in place of
    ``s`` (``gates`` as for the vector step)."""

    def step_one(s: ReqState, memx, b: int, rows, homes,
                 gates=None) -> ReqState:
        sl = slice(b, b + 1)
        one = ReqState(*(f[sl] for f in s))
        active = torch.ones(1, dtype=torch.bool, device=rows.device)
        s1 = vector_step(one, memx, rows[sl], active, homes[sl], gates)
        for dst, src in zip(s, s1):
            dst[sl] = src
        return s

    return step_one


def _lane_gates(op: int, lsp: int):
    """One lane's vector-step gates from its opcode and loop depth before
    the step (see ``vector_step``)."""
    return (op in (int(Op.LOAD), int(Op.CAS), int(Op.CAA)),
            op in (int(Op.STORE), int(Op.CAS), int(Op.CAA)),
            op == int(Op.MEMCPY), lsp + (op == int(Op.LOOP)))


def _serial_step_fn(step_one):
    """The contention-exact macro-step: requests 0..B-1 each execute one
    instruction in lane order against the shared pool, each through the
    routes its own opcode needs."""
    def serial_step(s: ReqState, memx, rows, homes, active) -> ReqState:
        s = ReqState(*(f.clone() for f in s))
        B = int(active.shape[0])
        host = torch.cat([active.to(_I64), rows[:, isa.F_OP],
                          s.lsp]).tolist()
        for b in range(B):
            if host[b]:
                s = step_one(s, memx, b, rows, homes,
                             gates=_lane_gates(host[B + b],
                                               host[2 * B + b]))
        return s

    return serial_step


def _route_probe(active, opv, lsp, read_t, write_t):
    """The per-step values a host loop reads in its one sync (int64):
    any lane live, then the vector step's gates — any word read, any word
    write, any memcpy, and the most loop frames an active lane can hold
    after the step."""
    frames = torch.where(active, lsp + (opv == int(Op.LOOP)).to(_I64),
                         torch.zeros_like(lsp))
    return [f.to(_I64) for f in (
        active.any(), (active & torch.isin(opv, read_t)).any(),
        (active & torch.isin(opv, write_t)).any(),
        (active & (opv == int(Op.MEMCPY))).any())] + [frames.max()]


def _program_statics(codes, fuels):
    """Normalize a merged instruction store: per-slot entry/end/fuel
    vectors plus the static memcpy window."""
    codes = [np.asarray(c, dtype=np.int64).reshape(-1, isa.INSTR_WIDTH)
             for c in codes]
    if not codes:
        raise ValueError("engine needs at least one program")
    code_np = np.concatenate(codes, axis=0)
    lens_np = np.asarray([c.shape[0] for c in codes], dtype=np.int64)
    start_np = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(lens_np)[:-1]])
    end_np = start_np + lens_np
    fuel_np = np.asarray([int(f) for f in fuels], dtype=np.int64)
    if fuel_np.shape != (len(codes),):
        raise ValueError("one step bound per program required")
    # Static memcpy window: the largest cap used by any merged program.
    memcpy_caps = [int(r[isa.F_IMM]) for r in code_np
                   if int(r[isa.F_OP]) == int(Op.MEMCPY)]
    max_window = int(min(max(memcpy_caps, default=1), isa.MAX_MEMCPY_WORDS))
    return code_np, start_np, end_np, fuel_np, max_window


def private_pool(mem: torch.Tensor, device=None) -> torch.Tensor:
    """The engine's private copy of ``mem`` (on ``device``, else where
    ``mem`` lies): flat, plus one zeroed sink word at the end that masked
    writes land in."""
    n = mem.numel()
    memx = torch.empty(n + 1, dtype=_I64,
                       device=mem.device if device is None else device)
    memx[:n].copy_(mem.reshape(-1))
    memx[n] = 0
    return memx


def resident_pool(host: np.ndarray, device) -> torch.Tensor:
    """``host`` as a ``(n_devices, pool_words)`` pool on ``device`` laid
    out as :func:`private_pool`'s buffer: a view of a flat tensor with one
    zeroed sink word after the pool, so a lockstep wave can be donated it
    (:func:`donate`)."""
    host = np.ascontiguousarray(host, np.int64)
    return private_pool(torch.from_numpy(host), device)[:-1].view(host.shape)


def _sink_view(mem: torch.Tensor) -> Optional[torch.Tensor]:
    """The flat view, sink word included, of a pool laid out as
    :func:`private_pool`'s buffer; None for any other tensor."""
    n = mem.numel()
    if mem.dtype != _I64 or not mem.is_contiguous() \
            or mem.storage_offset() != 0 \
            or mem.untyped_storage().nbytes() != (n + 1) * 8:
        return None
    return mem.as_strided((n + 1,), (1,), 0)


_DONATED: contextvars.ContextVar = contextvars.ContextVar(
    "lockstep_donated", default=None)


@contextlib.contextmanager
def donate(pool: Optional[torch.Tensor]):
    """Within the block, the next lockstep engine run (kernel or host
    loop) on exactly ``pool`` — the same tensor object — writes it in
    place instead of a private copy, when ``pool`` is laid out as
    :func:`resident_pool` makes it; the result's pool is then a view of
    the same storage.  One run only: any later run copies as usual.
    ``donate(None)`` withdraws an enclosing donation (a wave of several
    launches, which must not leave a half-written pool behind if a later
    launch fails)."""
    token = _DONATED.set([pool])
    try:
        yield
    finally:
        _DONATED.reset(token)


def donated(mem) -> bool:
    """Would the next lockstep run on ``mem`` write it in place?"""
    box = _DONATED.get()
    return bool(box) and box[0] is mem and _sink_view(mem) is not None


def _engine_pool(mem: torch.Tensor) -> torch.Tensor:
    """An engine run's flat buffer: the donated pool itself (taking the
    donation) or a private copy."""
    if donated(mem):
        _DONATED.get()[0] = None
        return _sink_view(mem)
    return private_pool(mem)


class _Engine:
    """The lockstep engine over a *merged* instruction store (see
    :func:`_build_engine`).  Device-agnostic: the constant tables are
    placed on each pool's device on first use."""

    def __init__(self, codes, fuels, regions: RegionTable, n_devices: int,
                 batch: int, protect: bool, static_noconflict: bool,
                 impl: str = "auto"):
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of "
                             f"{IMPLS}")
        self.impl = impl
        (self.code_np, self.start_np, self.end_np, self.fuel_np,
         self.max_window) = _program_statics(codes, fuels)
        self.n_ops = int(self.fuel_np.shape[0])
        self.n_instr = int(self.code_np.shape[0])
        self.base_np, self.mask_np, _ = regions.as_arrays()
        self.n_regions = int(self.base_np.shape[0])
        self.n_dev = int(n_devices)
        self.B = int(batch)
        self.protect = bool(protect)
        self.static_noconflict = bool(static_noconflict)
        self._consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def _const(self, dev: torch.device):
        c = self._consts.get(dev)
        if c is None:
            c = tuple(torch.as_tensor(a, dtype=_I64, device=dev)
                      for a in (self.code_np, self.base_np, self.mask_np,
                                self.start_np, self.end_np, self.fuel_np))
            self._consts[dev] = c
        return c

    def __call__(self, mem, params, homes, failed, op_sel) -> VMResult:
        """One wave: the ``lockstep_vm`` kernel on a card pool, the host
        loop on a CPU pool (see ``impl``)."""
        return lockstep_vm(self, mem, params, homes, failed, op_sel,
                           impl=self.impl)

    def wave_operands(self, rows, params, homes, failed, op_sel,
                      batch: int):
        """The ``lockstep_vm`` kernel's operands for one wave of ``batch``
        lanes against the pool rows ``rows`` (``n_dev`` int64 tensors of
        ``pool_words`` words on one device), less its outputs and scratch:
        the constant tables and the wave's inputs and row table packed
        into one tensor (``kernels.lockstep_vm.kernel.wave_inputs``)."""
        code, base_c, mask_c, start_c, end_c, fuel_c = \
            self._const(rows[0].device)
        p = _host(params).astype(np.int64).reshape(batch, -1)
        p = p[:, :isa.NUM_REGS]
        return dict(code=code, rbase=base_c, rmask=mask_c,
                    slot_start=start_c, slot_end=end_c, slot_fuel=fuel_c,
                    inputs=wave_inputs(p, _host(op_sel), _host(homes),
                                       _host(failed), rows),
                    n_params=int(p.shape[1]), B=int(batch),
                    n_dev=self.n_dev, pool_words=int(rows[0].numel()),
                    max_window=self.max_window, protect=self.protect,
                    sweep=batch > 1 and not self.static_noconflict,
                    rows=rows)

    def kernel_operands(self, mem, params, homes, failed, op_sel):
        """The ``lockstep_vm`` kernel's operands for one wave on ``mem``'s
        device (:meth:`wave_operands`): the rows are those of the
        engine's private flat copy of the pool (the pool itself when it
        is donated, :func:`donate`), row ``d`` at ``d * pool_words``."""
        memx = _engine_pool(mem)
        P = int(mem.shape[1])
        rows = [memx[d * P:(d + 1) * P] for d in range(self.n_dev)]
        return self.wave_operands(rows, params, homes, failed, op_sel,
                                  self.B)

    def run_kernel(self, mem, params, homes, failed, op_sel) -> VMResult:
        """One wave as one ``lockstep_vm`` launch on ``mem``'s card; the
        result's tensors are filled when the launch lands."""
        ops = self.kernel_operands(mem, params, homes, failed, op_sel)
        out = lockstep_vm_kernel(**ops)
        P = ops["pool_words"]
        flat = ops["rows"][0]
        return VMResult(mem=flat.as_strided((self.n_dev, P), (P, 1)),
                        ret=out.ret, status=out.status, steps=out.steps,
                        regs=out.regs, fault=out.fault)

    def run_host_loop(self, mem, params, homes, failed, op_sel) -> VMResult:
        """The kernel's plain version: the wave one torch macro-step at a
        time, each ended by one host read of a few flags.  Runs on any
        device (on a card pool its MEMCPY launches ``tiara_gather``'s
        window form) and honours a donation as the kernel does."""
        dev = mem.device
        code, base_c, mask_c, start_c, end_c, fuel_c = self._const(dev)
        B, n_dev, depth = self.B, self.n_dev, isa.LOOP_STACK_DEPTH
        pool_words = int(mem.shape[1])
        homes = torch.as_tensor(homes, dtype=_I64, device=dev).reshape(B)
        failed = torch.as_tensor(failed, dtype=torch.bool, device=dev)
        op_sel = torch.as_tensor(op_sel, dtype=_I64, device=dev) \
            .reshape(B).clamp(0, self.n_ops - 1)
        pc0 = start_c[op_sel]
        end_arr = end_c[op_sel]
        fuel_arr = fuel_c[op_sel]

        params = torch.as_tensor(params, dtype=_I64, device=dev)

        memx = _engine_pool(mem)
        ops = _DenseOps(n_dev, pool_words)
        vector_step, lane_intervals = _make_vector_step(
            base_c=base_c, mask_c=mask_c, n_regions=self.n_regions,
            n_dev=n_dev, pool_words=pool_words,
            max_window=self.max_window, depth=depth, failed=failed,
            ops=ops, protect=self.protect)
        serial_step = _serial_step_fn(_make_scalar_step(vector_step))

        zb = torch.zeros(B, dtype=_I64, device=dev)
        s = ReqState(
            pc=pc0,
            lstack=torch.zeros((B, depth, 3), dtype=_I64, device=dev),
            lsp=zb, inflight=zb,
            halted=torch.zeros(B, dtype=torch.bool, device=dev),
            ctrl=zb, pc_new=zb, **_unrun_lanes(params, B))
        sweep = B > 1 and not self.static_noconflict
        op_read = (int(Op.LOAD), int(Op.CAS), int(Op.CAA))
        op_write = (int(Op.STORE), int(Op.CAS), int(Op.CAA))
        read_t = torch.as_tensor(op_read, dtype=_I64, device=dev)
        write_t = torch.as_tensor(op_write, dtype=_I64, device=dev)

        while True:
            active = (~s.halted) & (s.pc < end_arr) & (s.steps < fuel_arr)
            rows = code[s.pc.clamp(0, self.n_instr - 1)]
            opv = rows[:, isa.F_OP]
            probe = _route_probe(active, opv, s.lsp, read_t, write_t)
            if sweep:
                probe.append(_sweep_conflict(
                    *lane_intervals(s, rows, active, homes)).to(_I64))
            flags = torch.stack(probe).tolist()      # the step's one sync
            if not flags[0]:
                break
            if sweep and flags[5]:
                s = serial_step(s, memx, rows, homes, active)
            else:
                s = vector_step(s, memx, rows, active, homes,
                                gates=flags[1:5])

        status = torch.where(
            s.halted, s.status,
            torch.where(s.steps >= fuel_arr,
                        torch.full_like(s.status, isa.STATUS_FUEL),
                        torch.full_like(s.status, isa.STATUS_FELL_OFF)))
        return VMResult(mem=memx[:-1].view(n_dev, pool_words), ret=s.ret,
                        status=status, steps=s.steps, regs=s.regs,
                        fault=_op_local_fault(s.fault, pc0))


def _op_local_fault(fault: torch.Tensor, pc0: torch.Tensor) -> torch.Tensor:
    """FaultInfo rows with each faulting pc counted from the lane's own
    operator entry (the merged store's pc less ``pc0``), as pyvm and the
    single-op engines report it: the same post gets the same FaultInfo
    whichever engine the cost model picks."""
    pc = fault[:, 0]
    local = torch.where(pc >= 0, pc - pc0, pc)
    return torch.cat([local[:, None], fault[:, 1:]], dim=1)


def _build_engine(codes: Sequence[np.ndarray], fuels: Sequence[int],
                  regions: RegionTable, n_devices: int, batch: int,
                  protect: bool = True,
                  static_noconflict: bool = False, impl: str = "auto"):
    """Build the lockstep engine over a *merged* instruction store.

    ``codes`` holds one program per dispatch-table slot, laid out back to
    back in slot order — the registry's shared BRAM layout, so slot ``i``
    starts at the registry's ``start_pc[i]``.  Returns
    ``f(mem, params, homes, failed, op_sel) -> VMResult`` where
    ``op_sel``: int64[batch] picks each request's program.

    ``mem``: int64[n_devices, pool_words] tensor shared by the whole
    batch (never mutated); ``params``: int64[batch, <=8]; ``homes``:
    int64[batch]; ``failed``: bool[n_devices].  Result fields are
    tensors on ``mem``'s device.

    ``static_noconflict=True`` builds the engine *without* the per-step
    sweep-line conflict check: every macro-step takes the vectorized
    path.  The caller must hold a registration-time proof
    (``access.prove_wave_noconflict``) that no macro-step of any wave run
    on this engine can conflict; the engine trusts the flag.

    ``impl``: "auto" runs the ``lockstep_vm`` kernel on a card pool and
    the host loop on a CPU pool; "cuda" and "torch" insist on one route
    and raise on a pool of the other kind.
    """
    return _Engine(codes, fuels, regions, n_devices, batch, protect,
                   static_noconflict, impl)


def build_batched_vm(op: VerifiedOperator, regions: RegionTable,
                     n_devices: int, batch: int, protect: bool = True,
                     static_noconflict: bool = False, impl: str = "auto"):
    """Returns ``f(mem, params, homes, failed) -> VMResult`` — the
    one-program specialization of :func:`_build_engine`."""
    eng = _build_engine([op.code], [op.step_bound], regions, n_devices,
                        batch, protect=protect,
                        static_noconflict=static_noconflict, impl=impl)
    sel0 = np.zeros(int(batch), dtype=np.int64)

    def run(mem, params, homes, failed):
        return eng(mem, params, homes, failed, sel0)

    return run


def build_mixed_batched_vm(ops: Sequence[VerifiedOperator],
                           regions: RegionTable, n_devices: int,
                           batch: int, protect: bool = True,
                           static_noconflict: bool = False,
                           impl: str = "auto"):
    """The multi-tenant engine: one lockstep run executing a batch of
    requests whose per-request ``op_sel`` picks among the ``ops``
    programs.  Returns ``f(mem, params, homes, failed, op_sel) ->
    VMResult``."""
    return _build_engine([o.code for o in ops],
                         [o.step_bound for o in ops],
                         regions, n_devices, batch, protect=protect,
                         static_noconflict=static_noconflict, impl=impl)


def sharded_route(impl: str, mesh: "_mesh.Mesh") -> str:
    """The sharded engine's route on ``mesh``: "cuda" (the wave as one
    ``lockstep_vm`` launch) or "torch" (the host loop).  On a mesh whose
    shards all name one CUDA card, "auto" and "cuda" take the kernel; on
    any other mesh (CPU shards, or shards spread over several cards, where
    one launch would need peer access) "auto" runs the host loop and
    "cuda" raises.  "torch" runs the host loop on any mesh."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "torch":
        return "torch"
    devs = mesh.flat_devices
    if all(d.type == "cuda" for d in devs) and len(
            {torch.cuda.current_device() if d.index is None else d.index
             for d in devs}) == 1:
        return "cuda"
    if impl == "cuda":
        raise ValueError(
            "impl='cuda' runs a sharded wave as one lockstep_vm launch, "
            "which needs every shard on one CUDA card; this mesh's shards "
            f"lie on {sorted({str(d) for d in devs})}")
    return "torch"


class _ShardedEngine:
    """The mesh-sharded lockstep engine (see :func:`_build_sharded_engine`).
    Holds no mesh: each call runs on the mesh it is given, whose devices
    it was keyed by."""

    def __init__(self, codes, fuels, regions: RegionTable, n_devices: int,
                 batch_per_device: int, axis: str, protect: bool,
                 static_noconflict: bool, impl: str = "auto"):
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of "
                             f"{IMPLS}")
        self.impl = impl
        self.dense = _Engine(codes, fuels, regions, n_devices,
                             batch_per_device, protect, static_noconflict)
        self.axis = axis

    def __call__(self, mesh: "_mesh.Mesh", mem: "_mesh.Sharded", params,
                 homes, failed, op_sel, arrival) -> VMResult:
        """One wave: one ``lockstep_vm`` launch on a mesh of one card, the
        host loop elsewhere (see :func:`sharded_route`)."""
        run = self.run_kernel if sharded_route(self.impl, mesh) == "cuda" \
            else self.run_host_loop
        return run(mesh, mem, params, homes, failed, op_sel, arrival)

    def run_kernel(self, mesh: "_mesh.Mesh", mem: "_mesh.Sharded", params,
                   homes, failed, op_sel, arrival) -> VMResult:
        """The wave as ONE ``lockstep_vm`` launch over the shards' rows,
        which lie on one card: each shard's row copied privately (as the
        host loop copies it), the kernel's row table pointing at the
        copies, the live lanes (``op_sel >= 0``) laid out in arrival order
        — the dense wave whose replay order is the global arrival order —
        and the fields scattered back to the device-major layout the host
        loop returns.  No collective and no ``tiara_gather`` launch: the
        window copies run inside the wave."""
        e = self.dense
        n_dev, Bp = e.n_dev, e.B
        N = n_dev * Bp
        sel = np.asarray(_host(op_sel), dtype=np.int64).reshape(N)
        order = np.argsort(np.asarray(arrival, dtype=np.int64).reshape(N),
                           kind="stable")
        lanes = order[sel[order] >= 0]
        p = np.asarray(_host(params), dtype=np.int64).reshape(N, -1)
        memx = [private_pool(r) for r in mem.shards]
        P = int(mem.shards[0].shape[-1])
        ops = e.wave_operands(
            [m[:P] for m in memx], p[lanes],
            np.asarray(_host(homes), dtype=np.int64).reshape(N)[lanes],
            failed, sel[lanes], int(lanes.size))
        out = lockstep_vm_kernel(**ops)
        # the live lanes' fields over those the padding lanes keep
        dev = ops["inputs"].device
        idx = torch.from_numpy(lanes).to(dev, non_blocking=True)
        full = _unrun_lanes(torch.from_numpy(p).to(dev, non_blocking=True),
                            N)
        for f, v in full.items():
            v.index_copy_(0, idx, getattr(out, f))
        axis = self.axis

        def shards(v):
            return _mesh.Sharded(
                mesh, _mesh.P(axis, *(None,) * (v.dim() - 1)),
                [v[r * Bp:(r + 1) * Bp] for r in range(n_dev)])
        return VMResult(
            mem=_mesh.Sharded(mesh, _mesh.P(axis, None),
                              [m[:P].view(1, P) for m in memx]),
            **{f: shards(v) for f, v in full.items()})

    def run_host_loop(self, mesh: "_mesh.Mesh", mem: "_mesh.Sharded",
                      params, homes, failed, op_sel, arrival) -> VMResult:
        """The kernel route's plain version: ``shard_map`` over the mesh,
        each shard stepping its sub-wave against its own row one macro-step
        at a time, remote traffic on collectives (:meth:`_shard`)."""
        e = self.dense
        for d in set(mesh.flat_devices):     # constant tables, once each
            e._const(d)
        n_dev, Bp, axis = e.n_dev, e.B, self.axis
        N = n_dev * Bp
        t = torch.as_tensor
        homes = t(np.asarray(homes, dtype=np.int64))
        arrival = np.asarray(arrival, dtype=np.int64)
        # every shard replays a contended macro-step in global arrival
        # order; the order is known before the wave starts
        perm = np.argsort(arrival.reshape(-1), kind="stable").tolist()
        spec_l, spec_r = _mesh.P(axis, None), _mesh.P()
        run = _mesh.shard_map(
            lambda *a: self._shard(perm, *a), mesh,
            in_specs=(spec_l, _mesh.P(axis, None, None), spec_l, spec_r,
                      spec_l, spec_r),
            out_specs=VMResult(mem=spec_l, ret=_mesh.P(axis),
                               status=_mesh.P(axis), steps=_mesh.P(axis),
                               regs=spec_l, fault=spec_l))
        return run(mem, t(np.asarray(params, dtype=np.int64)), homes,
                   t(np.asarray(failed, dtype=bool)),
                   t(np.asarray(op_sel, dtype=np.int64)),
                   homes.reshape(N))

    def _shard(self, perm, mem, params, homes, failed, op_sel, homes_all
               ) -> VMResult:
        """One shard's run: its sub-wave of ``Bp`` lanes against its own
        row, in lockstep with the other shards."""
        e, axis = self.dense, self.axis
        me = _mesh.axis_index(axis)
        dev = mem.device
        code, base_c, mask_c, start_c, end_c, fuel_c = e._const(dev)
        n_dev, B, depth = e.n_dev, e.B, isa.LOOP_STACK_DEPTH
        pool_words = int(mem.shape[1])
        homes = homes.reshape(B)
        homes_all = homes_all.to(dev)
        failed = failed.to(dev)
        op_sel = op_sel.reshape(B)
        pad = op_sel < 0
        sel = op_sel.clamp(0, e.n_ops - 1)
        pc0, end_arr, fuel_arr = start_c[sel], end_c[sel], fuel_c[sel]

        memx = private_pool(mem)
        common = dict(base_c=base_c, mask_c=mask_c, n_regions=e.n_regions,
                      n_dev=n_dev, pool_words=pool_words,
                      max_window=e.max_window, depth=depth, failed=failed,
                      protect=e.protect)
        vector_step, lane_intervals = _make_vector_step(
            ops=_ShardOps(pool_words, axis, me), **common)
        rep_step, _ = _make_vector_step(
            ops=_ShardOps(pool_words, axis, me, replicated=True),
            **common)
        step_one = _make_scalar_step(rep_step)
        op_read = (int(Op.LOAD), int(Op.CAS), int(Op.CAA))
        op_write = (int(Op.STORE), int(Op.CAS), int(Op.CAA))

        def gather(x):
            return _mesh.all_gather(x, axis, tiled=True)

        def serial_macro(s, rows, active, iv):
            # contended macro-step.  A lane whose footprint overlaps no
            # other lane's (``_lane_conflicts`` over the gathered
            # intervals) commutes with every other lane, so those lanes
            # take one vector step; the rest replay in GLOBAL ARRIVAL
            # order (the home-bucketed wave order is not arrival order)
            # with the whole wave's state replicated on every shard.
            # Register state stays replicated through the replay — reads
            # are psum-routed, so every shard computes identical values —
            # and each shard applies only its own row's writes.
            conf = _lane_conflicts(iv[0], iv[1], iv[2], iv[3])
            s_all = ReqState(*(gather(f) for f in s))
            rows_all, act_all = gather(rows), gather(active)
            free = act_all & ~conf
            ops_all = rows_all[:, isa.F_OP]
            N = n_dev * B
            host = torch.cat([
                (act_all & conf).to(_I64), ops_all, s_all.lsp,
                torch.stack(_route_probe(free, ops_all, s_all.lsp, read_t,
                                         write_t))]).tolist()
            replay, ops_h, lsp_h = host[:N], host[N:2 * N], host[2 * N:3 * N]
            mine = slice(me * B, (me + 1) * B)
            s_vec = s
            if host[3 * N]:
                s_vec = vector_step(s, memx, rows, free[mine], homes,
                                    gates=host[3 * N + 1:])
            for lane in perm:
                if replay[lane]:
                    s_all = step_one(s_all, memx, lane, rows_all,
                                     homes_all,
                                     gates=_lane_gates(ops_h[lane],
                                                       lsp_h[lane]))
            c = conf[mine]
            return ReqState(*(
                torch.where(c.reshape((B,) + (1,) * (a.dim() - 1)),
                            a[mine], v)
                for a, v in zip(s_all, s_vec)))

        zb = torch.zeros(B, dtype=_I64, device=dev)
        s = ReqState(
            pc=pc0,
            lstack=torch.zeros((B, depth, 3), dtype=_I64, device=dev),
            lsp=zb, inflight=zb,
            halted=pad,                       # padding lanes never run
            ctrl=zb, pc_new=zb, **_unrun_lanes(params.to(dev), B))
        sweep = n_dev * B > 1 and not e.static_noconflict
        read_t = torch.as_tensor(op_read, dtype=_I64, device=dev)
        write_t = torch.as_tensor(op_write, dtype=_I64, device=dev)

        while True:
            active = (~s.halted) & (s.pc < end_arr) & (s.steps < fuel_arr)
            rows = code[s.pc.clamp(0, e.n_instr - 1)]
            opv = rows[:, isa.F_OP]
            # the loop condition and the routes a step needs are global
            # questions: every shard must take the same branch, or the
            # collectives inside would wait for a shard that never comes
            probe = [_mesh.pmax(torch.stack(_route_probe(
                active, opv, s.lsp, read_t, write_t)), axis)]
            if sweep:
                # conflict existence too: sweep every shard's footprint
                iv = _mesh.all_gather(
                    torch.stack(lane_intervals(s, rows, active, homes)),
                    axis, axis=1, tiled=True)
                probe.append(_sweep_conflict(iv[0], iv[1], iv[2],
                                             iv[3]).to(_I64)[None])
            flags = torch.cat(probe).tolist()       # the step's one sync
            if not flags[0]:
                break
            if sweep and flags[5]:
                s = serial_macro(s, rows, active, iv)
            else:
                s = vector_step(s, memx, rows, active, homes,
                                gates=flags[1:5])

        status = torch.where(
            s.halted, s.status,
            torch.where(s.steps >= fuel_arr,
                        torch.full_like(s.status, isa.STATUS_FUEL),
                        torch.full_like(s.status, isa.STATUS_FELL_OFF)))
        return VMResult(mem=memx[:-1].view(1, pool_words), ret=s.ret,
                        status=status, steps=s.steps, regs=s.regs,
                        fault=_op_local_fault(s.fault, pc0))


def _build_sharded_engine(codes: Sequence[np.ndarray], fuels: Sequence[int],
                          regions: RegionTable, n_devices: int,
                          batch_per_device: int, axis: str = "pool",
                          protect: bool = True,
                          static_noconflict: bool = False,
                          impl: str = "auto"):
    """Build the mesh-sharded lockstep engine: the pool's leading
    ``n_devices`` axis is sharded over a 1-D device mesh (``shard_map``,
    one host thread per shard), each shard executes the home-bucketed
    sub-wave it owns against its own row, and remote LOAD/MEMCPY/STORE
    traffic lowers to collectives across the mesh axis (``all_gather``
    the requests, owning shards answer, ``psum`` routes the words back —
    see :class:`_ShardOps`).

    Semantics are *identical* to the dense mixed engine run over the
    same wave in arrival order: macro-steps stay in lockstep across the
    mesh (the loop condition, the routes a step needs and the conflict
    predicate are globally agreed each step), conflict-free steps
    vectorize per shard, and a contended macro-step falls back to a
    replicated serialized replay in **global arrival order** — the
    home-bucketed wave order is not the arrival order, so each lane
    carries its arrival rank and the fallback replays by it.  That is
    what lets deterministic round-robin STORE/CAS contention survive
    sharding bit for bit.

    Returns ``f(mesh, mem, params, homes, failed, op_sel, arrival) ->
    VMResult`` with device-major fields: ``mem`` is the sharded
    ``(n_devices, pool_words)`` pool (one private row per shard, never
    gathered), ``ret/status/steps`` are ``(n_devices, batch_per_device)``
    and ``regs`` is ``(n_devices, batch_per_device, 16)``, each kept per
    shard.  Lanes with ``op_sel < 0`` are padding (sub-waves are ragged)
    and start halted.

    Two routes compute that result (``impl``, :func:`sharded_route`).
    On a mesh whose shards all name one CUDA card, "auto" and "cuda" run
    the wave as ONE ``lockstep_vm`` launch: the kernel addresses the
    shards' rows through its row table and runs the live lanes in arrival
    order, the dense wave the contract names — the counterpart of the
    reference's one device program per wave (``shard_map`` around a
    ``lax.while_loop``).  The host loop ("torch", and "auto" on any other
    mesh) steps the shards in ``shard_map`` one macro-step at a time; it
    is the kernel route's plain version and the only route of a mesh
    whose shards span several cards (one launch there would need peer
    access), where "cuda" raises.  Neither route falls back to the
    other."""
    return _ShardedEngine(codes, fuels, regions, n_devices,
                          batch_per_device, axis, protect,
                          static_noconflict, impl)


def build_sharded_mixed_vm(ops: Sequence[VerifiedOperator],
                           regions: RegionTable, n_devices: int,
                           batch_per_device: int, axis: str = "pool",
                           protect: bool = True,
                           static_noconflict: bool = False,
                           impl: str = "auto"):
    """The pod-scale engine: the pool's leading axis sharded over a 1-D
    device mesh, one home-bucketed sub-wave per shard, cross-shard
    LOAD/MEMCPY lowered to collectives or, on one card, the whole wave
    one ``lockstep_vm`` launch (see :func:`_build_sharded_engine` for the
    semantics contract and the routes ``impl`` picks)."""
    return _build_sharded_engine([o.code for o in ops],
                                 [o.step_bound for o in ops],
                                 regions, n_devices, batch_per_device,
                                 axis, protect=protect,
                                 static_noconflict=static_noconflict,
                                 impl=impl)


def build_vm(op: VerifiedOperator, regions: RegionTable, n_devices: int,
             protect: bool = True, impl: str = "auto"):
    """Single-request entry point: ``f(mem, params, home, failed)`` —
    the ``batch=1`` specialization with scalar result fields."""
    batched = build_batched_vm(op, regions, n_devices, batch=1,
                               protect=protect, impl=impl)

    def run(mem, params, home, failed):
        params = torch.as_tensor(params, dtype=_I64).reshape(1, -1)
        out = batched(mem, params, [int(home)], failed)
        return VMResult(mem=out.mem, ret=out.ret[0], status=out.status[0],
                        steps=out.steps[0], regs=out.regs[0],
                        fault=out.fault[0])

    return run


# Serializing a program's code for its cache key costs tobytes() over the
# whole instruction array; a registry hot path keys the full merged store
# per wave, so memoize per live VerifiedOperator.  Keyed by id() but
# guarded by a weakref identity check — recycled ids miss and recompute,
# and dead entries are purged on the weakref callback.
_CODE_BYTES_MEMO: Dict[int, Tuple[object, bytes]] = {}


def _code_bytes(op: VerifiedOperator) -> bytes:
    ent = _CODE_BYTES_MEMO.get(id(op))
    if ent is not None and ent[0]() is op:
        return ent[1]
    key = id(op)
    b = op.code.tobytes()
    _CODE_BYTES_MEMO[key] = (
        weakref.ref(op, lambda _: _CODE_BYTES_MEMO.pop(key, None)), b)
    return b


def engine_key(op: VerifiedOperator, regions: RegionTable, n_dev: int,
               batch: int, *extra) -> Tuple:
    """Content-addressed cache key for a built engine (object ids recycle
    after GC — never key on id).  Shared with the compiled-path cache."""
    base, mask, _ = regions.as_arrays()
    return (_code_bytes(op), base.tobytes(), mask.tobytes(),
            op.step_bound, n_dev, batch) + extra


def mixed_engine_key(ops: Sequence[VerifiedOperator], regions: RegionTable,
                     n_dev: int, batch: int, *extra) -> Tuple:
    """Content-addressed cache key for a mixed (multi-program) engine."""
    base, mask, _ = regions.as_arrays()
    return (tuple((_code_bytes(o), int(o.step_bound)) for o in ops),
            base.tobytes(), mask.tobytes(), n_dev, batch) + extra


# Engines are cached per (operator, regions, n_devices, batch), exactly as
# the reference caches its jit-compiled engines, so the dispatch cost
# model's cache-miss charge sees the same hits and misses.
_VM_CACHE: Dict[Tuple, object] = {}


def engine_cached(op: VerifiedOperator, regions: RegionTable, n_dev: int,
                  batch: int, protect: bool = True,
                  static_noconflict: bool = False,
                  impl: str = "auto") -> bool:
    """True iff the batched interpreter engine for this (op, batch) is
    already built."""
    return engine_key(op, regions, n_dev, batch, bool(protect),
                      bool(static_noconflict), impl) in _VM_CACHE


def mixed_engine_cached(ops: Sequence[VerifiedOperator],
                        regions: RegionTable, n_dev: int,
                        batch: int, protect: bool = True,
                        static_noconflict: bool = False,
                        impl: str = "auto") -> bool:
    return mixed_engine_key(ops, regions, n_dev, batch, bool(protect),
                            bool(static_noconflict), impl) in _VM_CACHE


def _cached_engine(op: VerifiedOperator, regions: RegionTable, n_dev: int,
                   batch: int, protect: bool = True,
                   static_noconflict: bool = False, impl: str = "auto"):
    key = engine_key(op, regions, n_dev, batch, bool(protect),
                     bool(static_noconflict), impl)
    fn = _VM_CACHE.get(key)
    if fn is None:
        fn = build_batched_vm(op, regions, n_dev, batch, protect=protect,
                              static_noconflict=static_noconflict,
                              impl=impl)
        _VM_CACHE[key] = fn
    return fn


def _cached_mixed_engine(ops: Sequence[VerifiedOperator],
                         regions: RegionTable, n_dev: int, batch: int,
                         protect: bool = True,
                         static_noconflict: bool = False,
                         impl: str = "auto"):
    key = mixed_engine_key(ops, regions, n_dev, batch, bool(protect),
                           bool(static_noconflict), impl)
    fn = _VM_CACHE.get(key)
    if fn is None:
        fn = build_mixed_batched_vm(ops, regions, n_dev, batch,
                                    protect=protect,
                                    static_noconflict=static_noconflict,
                                    impl=impl)
        _VM_CACHE[key] = fn
    return fn


def _sharded_engine_key(ops: Sequence[VerifiedOperator],
                        regions: RegionTable, n_dev: int,
                        batch_per_device: int, axis: str,
                        protect: bool = True,
                        static_noconflict: bool = False,
                        mesh: Optional["_mesh.Mesh"] = None,
                        impl: str = "auto") -> Tuple:
    dev_ids = None if mesh is None else tuple(
        str(d) for d in mesh.flat_devices)
    return mixed_engine_key(ops, regions, n_dev, batch_per_device,
                            "sharded", axis, dev_ids, bool(protect),
                            bool(static_noconflict), impl)


def sharded_engine_cached(ops: Sequence[VerifiedOperator],
                          regions: RegionTable, n_dev: int,
                          batch_per_device: int,
                          axis: str = "pool",
                          protect: bool = True,
                          static_noconflict: bool = False,
                          mesh: Optional["_mesh.Mesh"] = None,
                          impl: str = "auto") -> bool:
    """True iff the sharded mesh engine for this (ops, sub-wave size,
    mesh devices, route) is already built — the dispatch cost model
    charges a miss, as the reference charges its compile."""
    return _sharded_engine_key(ops, regions, n_dev, batch_per_device,
                               axis, protect, static_noconflict,
                               mesh, impl) in _VM_CACHE


def _cached_sharded_engine(ops: Sequence[VerifiedOperator],
                           regions: RegionTable, n_dev: int,
                           batch_per_device: int, axis: str = "pool",
                           protect: bool = True,
                           static_noconflict: bool = False,
                           mesh: Optional["_mesh.Mesh"] = None,
                           impl: str = "auto"):
    key = _sharded_engine_key(ops, regions, n_dev, batch_per_device, axis,
                              protect, static_noconflict, mesh, impl)
    fn = _VM_CACHE.get(key)
    if fn is None:
        fn = build_sharded_mixed_vm(ops, regions, n_dev, batch_per_device,
                                    axis, protect=protect,
                                    static_noconflict=static_noconflict,
                                    impl=impl)
        _VM_CACHE[key] = fn
    return fn


def finish_result(res: "BatchedInvokeResult", *,
                  block: bool) -> "BatchedInvokeResult":
    """Seal a launched result: on a CUDA pool record the completion
    event on the current stream; then retire it now (``block=True``) or
    hand it back deferred."""
    if res.mem.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(res.mem.device))
        res.event = ev
    return materialize_result(res) if block else res


def run_batched_fn(fn, mem, p: np.ndarray, h: np.ndarray,
                   failed: Optional[Set[int]], *, block: bool = True,
                   device=None) -> "BatchedInvokeResult":
    """Execute a built batched engine.  ``mem`` is a pool tensor (the
    engine runs on its device) or a numpy pool (copied to ``device``).

    With ``block=False`` the per-request fields stay device tensors and
    the result carries a CUDA event recorded after the launch: the
    endpoint's split-phase doorbell retires it later with
    :func:`materialize_result`.  On the CPU the work is eager either way.
    The launch itself happens here, so malformed waves raise here."""
    mem_t = as_pool(mem, device)
    n_dev = int(mem_t.shape[0])
    out = fn(mem_t, p, h, _failed_mask(n_dev, failed))
    res = BatchedInvokeResult(mem=out.mem, ret=out.ret, status=out.status,
                              steps=out.steps, regs=out.regs,
                              fault=out.fault)
    return finish_result(res, block=block)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def materialize_result(res: "BatchedInvokeResult") -> "BatchedInvokeResult":
    """Retire a (possibly deferred) batched result: wait for its launch
    and copy the per-request fields (ret, status, steps, regs, fault) to
    host numpy arrays.  ``mem`` stays where it is — on the card the pool
    is never copied to the host here.  A no-op on a materialized
    result."""
    if res.event is not None:
        res.event.synchronize()
    return BatchedInvokeResult(
        mem=res.mem, ret=_host(res.ret), status=_host(res.status),
        steps=_host(res.steps), regs=_host(res.regs),
        fault=None if res.fault is None else _host(res.fault))


def result_ready(res: "BatchedInvokeResult") -> bool:
    """Non-blocking readiness probe of a deferred batched result: True
    once its launch has landed (a CPU or materialized result is always
    ready)."""
    return res.event is None or bool(res.event.query())


def _wrap_param(v) -> np.int64:
    return np.int64(np.uint64(v & (2**64 - 1)).astype(np.uint64)
                    .view(np.int64)) \
        if v > 2**63 - 1 or v < -2**63 else np.int64(v)


def _failed_mask(n_dev: int, failed: Optional[Set[int]]) -> np.ndarray:
    m = np.zeros(n_dev, dtype=bool)
    for f in (failed or ()):
        m[f] = True
    return m


def homes_array(homes: Union[int, Sequence[int]],
                batch: int) -> np.ndarray:
    """Normalize a ``homes`` argument (scalar broadcast or per-request
    sequence) to i64[batch] — the one place that marshalling lives."""
    h = np.full(batch, homes, dtype=np.int64) if np.isscalar(homes) \
        else np.asarray(list(homes), dtype=np.int64)
    if h.shape != (batch,):
        raise ValueError(f"homes shape {h.shape} != ({batch},)")
    return h


def _marshal_batch(params: Sequence[Sequence[int]],
                   homes: Union[int, Sequence[int]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate and pack a request batch: params -> i64[B, width],
    homes -> i64[B].  Shared by the interpreter and compiled wrappers."""
    batch = len(params)
    if batch == 0:
        raise ValueError("empty request batch")
    width = max(max((len(row) for row in params), default=0), 1)
    p = np.zeros((batch, width), dtype=np.int64)
    for b, row in enumerate(params):
        for i, v in enumerate(row):
            p[b, i] = _wrap_param(v)
    return p, homes_array(homes, batch)


def invoke(op: VerifiedOperator, regions: RegionTable, mem,
           params: Sequence[int] = (), *, home: int = 0,
           failed: Optional[Set[int]] = None,
           protect: bool = True, device=None,
           impl: str = "auto") -> "InvokeResult":
    """Single-request entry point: pool tensor or numpy in, host fields
    out (``mem`` stays on the pool's device).  ``impl`` picks the
    engine's route (see :func:`_build_engine`)."""
    p, h = _marshal_batch([list(params)], home)
    mem_t = as_pool(mem, device)
    fn = _cached_engine(op, regions, int(mem_t.shape[0]), batch=1,
                        protect=protect, impl=impl)
    out = run_batched_fn(fn, mem_t, p, h, failed)
    return InvokeResult(mem=out.mem, ret=int(out.ret[0]),
                        status=int(out.status[0]), steps=int(out.steps[0]),
                        regs=out.regs[0], fault=fault_info(out.fault[0]))


def invoke_batched(op: VerifiedOperator, regions: RegionTable,
                   mem, params: Sequence[Sequence[int]],
                   *, homes: Union[int, Sequence[int]] = 0,
                   failed: Optional[Set[int]] = None,
                   block: bool = True,
                   protect: bool = True,
                   static_noconflict: bool = False,
                   device=None, impl: str = "auto") -> "BatchedInvokeResult":
    """Run a batch of requests against one shared pool.

    ``params`` is a [B][k] nested sequence (one row per request); ``homes``
    is a scalar (all requests from the same host) or a [B] sequence.
    ``block=False`` defers retirement (see :func:`run_batched_fn`).
    ``static_noconflict=True`` asserts the caller holds a registration-time
    proof that the wave is conflict-free; the engine then skips the
    per-step runtime sweep.  ``impl`` picks the engine's route (see
    :func:`_build_engine`).
    """
    p, h = _marshal_batch(params, homes)
    mem_t = as_pool(mem, device)
    fn = _cached_engine(op, regions, int(mem_t.shape[0]), p.shape[0],
                        protect=protect,
                        static_noconflict=static_noconflict, impl=impl)
    return run_batched_fn(fn, mem_t, p, h, failed, block=block)


def invoke_batched_mixed(ops: Sequence[VerifiedOperator],
                         regions: RegionTable, mem,
                         op_sel: Sequence[int],
                         params: Sequence[Sequence[int]], *,
                         homes: Union[int, Sequence[int]] = 0,
                         failed: Optional[Set[int]] = None,
                         block: bool = True,
                         protect: bool = True,
                         static_noconflict: bool = False,
                         device=None,
                         impl: str = "auto") -> "BatchedInvokeResult":
    """Run a *mixed* batch — request ``b`` executes ``ops[op_sel[b]]`` —
    against one shared pool in one lockstep run.

    Semantics are the engine's deterministic round-robin interleaving
    across programs: each macro-step, request ``i`` executes the next
    instruction *of its own operator* and observes all same-step memory
    effects of requests ``j < i``.  ``impl`` picks the engine's route
    (see :func:`_build_engine`).
    """
    p, h = _marshal_batch(params, homes)
    B = p.shape[0]
    sel = np.asarray(list(op_sel), dtype=np.int64)
    if sel.shape != (B,):
        raise ValueError(f"op_sel shape {sel.shape} != ({B},)")
    if sel.size and (sel.min() < 0 or sel.max() >= len(ops)):
        raise ValueError(
            f"op_sel entries must be in [0, {len(ops)}) for {len(ops)} "
            f"programs; got range [{sel.min()}, {sel.max()}]")
    mem_t = as_pool(mem, device)
    eng = _cached_mixed_engine(tuple(ops), regions, int(mem_t.shape[0]), B,
                               protect=protect,
                               static_noconflict=static_noconflict,
                               impl=impl)

    def fn(mem_j, p_j, h_j, failed_j):
        return eng(mem_j, p_j, h_j, failed_j, sel)

    return run_batched_fn(fn, mem_t, p, h, failed, block=block)


def invoke_sharded_mixed(ops: Sequence[VerifiedOperator],
                         regions: RegionTable, mem,
                         plan, params: Sequence[Sequence[int]], *,
                         failed: Optional[Set[int]] = None,
                         axis: str = "pool",
                         protect: bool = True,
                         static_noconflict: bool = False,
                         mesh: Optional["_mesh.Mesh"] = None,
                         impl: str = "auto") -> "BatchedInvokeResult":
    """Run a mixed wave on the mesh-sharded engine.
    ``static_noconflict=True`` asserts a registration-time conflict proof;
    the engine then skips the per-step sweep (and, on the host loop, the
    footprint all_gather).  ``impl`` picks the route
    (:func:`sharded_route`): on a mesh whose shards all name one CUDA
    card the wave is one ``lockstep_vm`` launch and makes no collective;
    elsewhere "auto" runs the host loop.

    ``plan`` is a home-bucketed :class:`~repro_torch.core.compile.MixedPlan`
    (built with ``plan_mixed_batch(op_ids, homes=..., n_devices=...)``):
    its ``order`` lays the wave out device-major, each shard's ragged
    sub-wave is padded to ``plan.batch_per_device`` lanes, and results
    scatter back to arrival order through the same permutation.  The
    result is bit-identical to :func:`invoke_batched_mixed` over the
    arrival-order wave (contended STORE/CAS included — the engine's
    serialized fallback replays by arrival rank).

    ``mem`` is a sharded pool (kept per shard: the result's ``mem`` is
    the new one, never gathered), a pool tensor or a numpy pool (placed
    on ``mesh`` with :func:`~repro_torch.core.memory.shard_pool`).
    ``mesh`` defaults to the sharded pool's, else a 1-D mesh over the
    first ``n_devices`` cards (raising when fewer are visible).  The
    per-request fields come back as host arrays."""
    from repro_torch.core import memory as _memory
    if getattr(plan, "device_counts", None) is None:
        raise ValueError(
            "plan carries no device placement; build it with "
            "plan_mixed_batch(op_ids, homes=..., n_devices=...)")
    n_dev = int(mem.shape[0])
    if plan.n_devices != n_dev:
        raise ValueError(
            f"plan places {plan.n_devices} devices but the pool has "
            f"{n_dev} rows")
    if isinstance(mem, _mesh.Sharded):
        if mesh is not None and mesh is not mem.mesh:
            raise ValueError("the pool is sharded over another mesh")
        mesh = mem.mesh
    elif mesh is None:
        mesh = _mesh.make_device_mesh(n_dev, axis)
    if mesh.size != n_dev:
        raise ValueError(f"a mesh of {mesh.size} shards for a pool of "
                         f"{n_dev} rows")
    p, h = _marshal_batch(params, plan.homes)
    B = plan.batch
    if p.shape[0] != B:
        raise ValueError(f"{p.shape[0]} param rows for a {B}-request plan")
    Bp = int(plan.batch_per_device)
    width = p.shape[1]
    # device-major marshal: plan.order is home-bucketed, so shard d's
    # sub-wave is one contiguous slice of the sorted batch; pad lanes
    # carry op_sel = -1 (start halted) and arrival ranks past the wave
    sel = np.full((n_dev, Bp), -1, dtype=np.int64)
    pz = np.zeros((n_dev, Bp, width), dtype=np.int64)
    hz = np.zeros((n_dev, Bp), dtype=np.int64)
    az = np.full((n_dev, Bp), B, dtype=np.int64)
    pos = 0
    for d in range(n_dev):
        c = int(plan.device_counts[d])
        lanes = plan.order[pos:pos + c]
        sel[d, :c] = plan.op_ids[lanes]
        pz[d, :c] = p[lanes]
        hz[d, :c] = h[lanes]
        hz[d, c:] = d
        az[d, :c] = lanes            # arrival rank = arrival index
        pos += c
    eng = _cached_sharded_engine(tuple(ops), regions, n_dev, Bp, axis,
                                 protect=protect,
                                 static_noconflict=static_noconflict,
                                 mesh=mesh, impl=impl)
    mem_sh = _memory.shard_pool(mem, mesh, axis)
    out = eng(mesh, mem_sh, pz, hz, _failed_mask(n_dev, failed), sel, az)
    got = {f: _host(getattr(out, f).full("cpu"))
           for f in ("ret", "status", "steps", "regs", "fault")}
    got = {f: v.reshape((n_dev, Bp) + v.shape[1:]) for f, v in got.items()}
    ret = np.zeros(B, dtype=np.int64)
    status = np.zeros(B, dtype=np.int64)
    steps = np.zeros(B, dtype=np.int64)
    regs = np.zeros((B, isa.NUM_REGS), dtype=np.int64)
    fault = np.tile(NO_FAULT, (B, 1))
    pos = 0
    for d in range(n_dev):
        c = int(plan.device_counts[d])
        lanes = plan.order[pos:pos + c]
        ret[lanes] = got["ret"][d, :c]
        status[lanes] = got["status"][d, :c]
        steps[lanes] = got["steps"][d, :c]
        regs[lanes] = got["regs"][d, :c]
        fault[lanes] = got["fault"][d, :c]
        pos += c
    return BatchedInvokeResult(mem=out.mem, ret=ret, status=status,
                               steps=steps, regs=regs, fault=fault)


@dataclasses.dataclass
class InvokeResult:
    mem: torch.Tensor
    ret: int
    status: int
    steps: int
    regs: np.ndarray
    fault: Optional[isa.FaultInfo] = None

    @property
    def ok(self) -> bool:
        return self.status == isa.STATUS_OK


@dataclasses.dataclass
class BatchedInvokeResult:
    mem: Union[torch.Tensor, "_mesh.Sharded"]   # sharded: per shard
    ret: Union[np.ndarray, torch.Tensor]       # i64 [B]
    status: Union[np.ndarray, torch.Tensor]    # i64 [B]
    steps: Union[np.ndarray, torch.Tensor]     # i64 [B]
    regs: Union[np.ndarray, torch.Tensor]      # i64 [B, 16]
    fault: Optional[Union[np.ndarray, torch.Tensor]] = None  # i64 [B, 4]
    # CUDA event recorded after the launch (None on the CPU / once
    # materialized): what result_ready() queries
    event: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def ok(self) -> np.ndarray:
        return _host(self.status) == isa.STATUS_OK

    def fault_at(self, b: int) -> Optional[isa.FaultInfo]:
        """The decoded FaultInfo of lane ``b`` (None when clean)."""
        if self.fault is None:
            return None
        return fault_info(_host(self.fault)[b])
