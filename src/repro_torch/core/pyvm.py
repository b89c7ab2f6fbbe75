"""Pure-Python reference interpreter — the semantic oracle.

This file *defines* Tiara execution semantics at word level; the JAX VM
(`repro_torch.core.vm`) and the Pallas data-path kernels are validated against
it.  It also emits the executed-instruction trace that the cycle-level MP
simulator (`repro_torch.core.simulator`) charges timing against, playing the
role of the paper's Verilator model.

Semantics notes (shared with the JAX VM — keep in lockstep):
  * all values are 64-bit two's complement; arithmetic wraps;
  * shifts mask the amount to 0..63; SHR is logical;
  * device operands: DEV_LOCAL (-1) resolves to the executing host, any
    other value is taken mod n_devices (the device-id router);
  * offsets are masked to the region size (power of two) — the no-runtime-
    check isolation mechanism;
  * Memcpy reads its whole source window before writing (memmove
    semantics); lengths clamp to the DMA burst limit and to both region
    sizes;
  * an async Memcpy touching a failed device sets the error register
    (r15 |= 1) and performs no writes; execution continues (paper §3.2);
  * with ``protect=True`` (the default) data-dependent accesses are
    checked at runtime: a word op or memcpy whose offset falls outside
    its region, whose register-held device operand is neither DEV_LOCAL
    nor a valid device id, or (word ops only) whose resolved device is
    in the ``failed`` set, raises a *protection fault* — the lane halts
    with ``STATUS_PROT_FAULT`` and a :class:`~repro_torch.core.isa.FaultInfo`,
    the faulting instruction performs no architectural effect, and no
    further writes leak into the pool (containment).  ``protect=False``
    restores the paper's mask-and-wrap data path exactly;
  * Wait(threshold) lowers the in-flight counter (copies are functionally
    applied at issue; *timing* of async completion is the simulator's job);
  * a taken forward jump pops loop frames it escapes (break); normal
    advance past a body end decrements the trip counter and re-enters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set

import numpy as np

from repro_torch.core import isa
from repro_torch.core.isa import (Alu, Op, FLAG_ASYNC, FLAG_DEV_REG,
                            FLAG_DSTDEV_REG, FLAG_IMMB, FLAG_LEN_REG,
                            FLAG_MREG, FLAG_SRCDEV_REG, FLAG_THR_REG,
                            DEV_LOCAL)
from repro_torch.core.memory import RegionTable
from repro_torch.core.verifier import VerifiedOperator

_U64 = 1 << 64
_S63 = 1 << 63


def wrap64(x: int) -> int:
    """Fold a Python int into signed 64-bit two's complement."""
    return ((int(x) + _S63) % _U64) - _S63


def _alu(op: int, a: int, b: int) -> int:
    if op == Alu.ADD:
        return wrap64(a + b)
    if op == Alu.SUB:
        return wrap64(a - b)
    if op == Alu.MUL:
        return wrap64(a * b)
    if op == Alu.AND:
        return wrap64(a & b)
    if op == Alu.OR:
        return wrap64(a | b)
    if op == Alu.XOR:
        return wrap64(a ^ b)
    if op == Alu.SHL:
        return wrap64(a << (b & 63))
    if op == Alu.SHR:
        return wrap64((a % _U64) >> (b & 63))
    if op == Alu.EQ:
        return int(a == b)
    if op == Alu.NE:
        return int(a != b)
    if op == Alu.LT:
        return int(a < b)
    if op == Alu.GE:
        return int(a >= b)
    if op == Alu.MIN:
        return min(a, b)
    if op == Alu.MAX:
        return max(a, b)
    raise ValueError(f"bad alu op {op}")


@dataclasses.dataclass
class TraceEvent:
    pc: int
    op: Op
    is_async: bool = False
    n_words: int = 0          # memcpy payload
    remote: bool = False      # memcpy/load touching a non-home device
    src_remote: bool = False  # memcpy source on a non-home device
    dst_remote: bool = False  # memcpy destination on a non-home device
    dst_dev: int = -1         # memcpy destination device (for RTT counting)
    wait_thr: int = 0         # WAIT: resolved in-flight threshold


@dataclasses.dataclass
class Result:
    ret: int
    status: int
    steps: int
    regs: List[int]
    mem: np.ndarray
    trace: List[TraceEvent]
    fault: Optional[isa.FaultInfo] = None

    @property
    def ok(self) -> bool:
        return self.status == isa.STATUS_OK

    @property
    def faulted(self) -> bool:
        return self.status == isa.STATUS_PROT_FAULT


def run(op: VerifiedOperator, regions: RegionTable, mem: np.ndarray,
        params: Sequence[int] = (), *, home: int = 0,
        failed: Optional[Set[int]] = None, record_trace: bool = False,
        fuel: Optional[int] = None, protect: bool = True) -> Result:
    """Execute a verified operator against ``mem`` (modified in place)."""
    code = op.code
    base, mask, _ = regions.as_arrays()
    n_dev = int(mem.shape[0])
    failed = failed or set()
    fuel = int(fuel if fuel is not None else op.step_bound)

    regs = [0] * isa.NUM_REGS
    for i, p in enumerate(params):
        regs[i] = wrap64(p)

    # loop stack entries: [start, end, remaining]
    lstack: List[List[int]] = []
    inflight = 0
    pc = 0
    steps = 0
    halted = False
    ret_val = 0
    status = isa.STATUS_FELL_OFF
    fault: Optional[isa.FaultInfo] = None
    trace: List[TraceEvent] = []

    def dev_of(field: int, via_reg: bool) -> int:
        d = regs[field] if via_reg else field
        if d == DEV_LOCAL:
            return home
        return int(d) % n_dev

    def phys(rid: int, off: int) -> int:
        return int(base[rid]) + (wrap64(off) & int(mask[rid]))

    def dev_raw(field: int, via_reg: bool) -> int:
        return regs[field] if via_reg else field

    def dev_invalid(field: int, via_reg: bool) -> bool:
        """A register-held device operand must be DEV_LOCAL or a real
        device id; static fields stay verifier-territory (they wrap)."""
        if not via_reg:
            return False
        d = regs[field]
        return d != DEV_LOCAL and not (0 <= d < n_dev)

    def off_oob(rid: int, off: int) -> bool:
        """In-bounds iff masking is the identity: 0 <= off < size."""
        off = wrap64(off)
        return off != (off & int(mask[rid]))

    def word_fault(rid: int, off: int, field: int,
                   via_reg: bool) -> Optional[isa.FaultInfo]:
        """PROT_FAULT check shared by LOAD/STORE/CAS/CAA: wild device
        register, out-of-region offset, or a failed blade."""
        if not protect:
            return None
        if dev_invalid(field, via_reg):
            return isa.FaultInfo(pc=pc, opcode=int(o), addr=wrap64(off),
                                 device=regs[field])
        dev = dev_of(field, via_reg)
        if off_oob(rid, off) or dev in failed:
            return isa.FaultInfo(pc=pc, opcode=int(o), addr=wrap64(off),
                                 device=dev)
        return None

    n = code.shape[0]
    while not halted and pc < n and steps < fuel:
        row = code[pc]
        o = Op(int(row[isa.F_OP]))
        dst, a, b, c, d, e = (int(row[isa.F_DST]), int(row[isa.F_A]),
                              int(row[isa.F_B]), int(row[isa.F_C]),
                              int(row[isa.F_D]), int(row[isa.F_E]))
        flags, imm, imm2 = (int(row[isa.F_FLAGS]), int(row[isa.F_IMM]),
                            int(row[isa.F_IMM2]))
        steps += 1
        jumped = False
        skipped_to: Optional[int] = None
        flt: Optional[isa.FaultInfo] = None
        ev = TraceEvent(pc=pc, op=o) if record_trace else None

        if o == Op.NOP:
            pass
        elif o == Op.MOVI:
            regs[dst] = wrap64(imm)
        elif o == Op.ALU:
            rhs = imm if (flags & FLAG_IMMB) else regs[b]
            regs[dst] = _alu(d, regs[a], rhs)
        elif o == Op.LOAD:
            flt = word_fault(a, regs[b] + imm, e, bool(flags & FLAG_DEV_REG))
            if flt is None:
                dev = dev_of(e, bool(flags & FLAG_DEV_REG))
                regs[dst] = int(mem[dev, phys(a, regs[b] + imm)])
                if ev:
                    ev.remote = dev != home
        elif o == Op.STORE:
            flt = word_fault(a, regs[b] + imm, e, bool(flags & FLAG_DEV_REG))
            if flt is None:
                dev = dev_of(e, bool(flags & FLAG_DEV_REG))
                mem[dev, phys(a, regs[b] + imm)] = np.int64(regs[dst])
                if ev:
                    ev.remote = dev != home
        elif o == Op.MEMCPY:
            via_d = bool(flags & FLAG_DSTDEV_REG)
            via_s = bool(flags & FLAG_SRCDEV_REG)
            if flags & FLAG_LEN_REG:
                ln = min(max(regs[imm2], 0), imm)
            else:
                ln = imm
            ln = min(ln, isa.MAX_MEMCPY_WORDS,
                     int(mask[a]) + 1, int(mask[d]) + 1)
            is_async = bool(flags & FLAG_ASYNC)
            doff, soff = wrap64(regs[b]), wrap64(regs[e])
            if protect and ln > 0:
                # check order is part of the semantics (engines mirror
                # it): dst device, src device, dst window, src window
                if dev_invalid(dst, via_d):
                    flt = isa.FaultInfo(pc=pc, opcode=int(o), addr=doff,
                                        device=regs[dst])
                elif dev_invalid(c, via_s):
                    flt = isa.FaultInfo(pc=pc, opcode=int(o), addr=soff,
                                        device=regs[c])
                elif off_oob(a, doff) or doff + ln > int(mask[a]) + 1:
                    flt = isa.FaultInfo(pc=pc, opcode=int(o), addr=doff,
                                        device=dev_of(dst, via_d))
                elif off_oob(d, soff) or soff + ln > int(mask[d]) + 1:
                    flt = isa.FaultInfo(pc=pc, opcode=int(o), addr=soff,
                                        device=dev_of(c, via_s))
            if flt is None:
                ddev = dev_of(dst, via_d)
                sdev = dev_of(c, via_s)
                fail = (ddev in failed) or (sdev in failed)
                if fail:
                    regs[isa.ERR_REG] = wrap64(regs[isa.ERR_REG] | 1)
                else:
                    window = [int(mem[sdev, phys(d, soff + i)])
                              for i in range(ln)]
                    for i in range(ln):
                        mem[ddev, phys(a, doff + i)] = np.int64(window[i])
                if is_async:
                    inflight = min(inflight + 1, isa.MAX_INFLIGHT)
                if ev:
                    ev.is_async = is_async
                    ev.n_words = ln
                    ev.src_remote = sdev != home
                    ev.dst_remote = ddev != home
                    ev.remote = ev.src_remote or ev.dst_remote
                    ev.dst_dev = ddev
        elif o in (Op.CAS, Op.CAA):
            flt = word_fault(a, regs[b] + imm, e, bool(flags & FLAG_DEV_REG))
            if flt is None:
                dev = dev_of(e, bool(flags & FLAG_DEV_REG))
                addr = phys(a, regs[b] + imm)
                old = int(mem[dev, addr])
                if old == regs[c]:
                    new = regs[d] if o == Op.CAS else wrap64(old + regs[d])
                    mem[dev, addr] = np.int64(new)
                regs[dst] = old
                if ev:
                    ev.remote = dev != home
        elif o == Op.JUMP:
            cond = int(d)
            if cond == Alu.ALWAYS:
                take = True
            else:
                rhs = imm if (flags & FLAG_IMMB) else regs[b]
                take = bool(_alu(cond, regs[a], rhs))
            if take:
                pc_new = pc + 1 + imm2
                while lstack and lstack[-1][1] < pc_new:
                    lstack.pop()       # break out of escaped loops
                pc = pc_new
                jumped = True
        elif o == Op.LOOP:
            m = min(max(regs[b], 0), imm) if (flags & FLAG_MREG) else imm
            if m <= 0:
                skipped_to = pc + 1 + imm2
            else:
                assert len(lstack) < isa.LOOP_STACK_DEPTH, "verifier bug"
                lstack.append([pc + 1, pc + imm2, m])
        elif o == Op.WAIT:
            thr = regs[a] if (flags & FLAG_THR_REG) else imm
            inflight = min(inflight, max(int(thr), 0))
            if ev:
                ev.wait_thr = max(int(thr), 0)
        elif o == Op.RET:
            halted = True
            ret_val = regs[a]
            status = imm
        else:
            raise ValueError(f"pc {pc}: bad opcode {o}")

        if flt is not None:
            # protection fault: the lane halts with zero architectural
            # effect from the faulting instruction (containment) — the
            # step itself is counted (the MP fetched and killed it)
            halted = True
            status = isa.STATUS_PROT_FAULT
            fault = flt
        if record_trace:
            trace.append(ev)
        if halted:
            break
        if not jumped:
            pc_new = skipped_to if skipped_to is not None else pc + 1
            # normal advance: iterate / pop loops whose body just ended
            while lstack and pc_new == lstack[-1][1] + 1:
                lstack[-1][2] -= 1
                if lstack[-1][2] > 0:
                    pc_new = lstack[-1][0]
                    break
                lstack.pop()
            pc = pc_new

    if not halted and steps >= fuel:
        status = isa.STATUS_FUEL
    return Result(ret=ret_val, status=status, steps=steps, regs=regs,
                  mem=mem, trace=trace, fault=fault)
