"""Operator builder — the assembler-level programming interface.

This is the layer the compiler frontend (`repro_torch.core.frontend`) lowers
into; it can also be used directly, like writing eBPF assembly by hand.
It tracks register allocation, forward-label patching, and the Loop(M,N)
body-length back-patching, and records the *static* region declarations
the verifier will check against the tenant grant.

Shape of an operator (paper §3.1): up to 8 parameters arrive in r0..r7;
temporaries live in r8..r14; r15 is the async error-flag register.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple, Union

import numpy as np

from repro_torch.core import isa
from repro_torch.core.isa import (Alu, Instr, Op, FLAG_ASYNC, FLAG_DEV_REG,
                            FLAG_DSTDEV_REG, FLAG_IMMB, FLAG_LEN_REG,
                            FLAG_MREG, FLAG_SRCDEV_REG, FLAG_THR_REG,
                            DEV_LOCAL)
from repro_torch.core.memory import RegionTable


@dataclasses.dataclass(frozen=True)
class Reg:
    """A register handle; operators never touch raw indices."""

    idx: int

    def __post_init__(self):
        if not (0 <= self.idx < isa.NUM_REGS):
            raise ValueError(f"register index {self.idx} out of range")


Operand = Union[Reg, int]
Device = Union[Reg, int]


@dataclasses.dataclass(frozen=True)
class TiaraProgram:
    """A compiled (but not yet verified/registered) operator."""

    name: str
    code: np.ndarray                    # (n, INSTR_WIDTH) int64
    n_params: int
    regions_read: Tuple[int, ...]       # statically declared region ids
    regions_written: Tuple[int, ...]
    region_names: Tuple[str, ...] = ()  # for diagnostics

    @property
    def n_instr(self) -> int:
        return int(self.code.shape[0])

    def disassemble(self) -> str:
        return isa.disassemble(self.code)


class Label:
    def __init__(self, name: str):
        self.name = name
        self.pc: Optional[int] = None
        self.pending: List[int] = []    # pcs of jumps waiting for this label


class _LoopCtx:
    def __init__(self, builder: "OperatorBuilder", pc: int):
        self.builder = builder
        self.pc = pc

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.builder._close_loop(self.pc)
        return False


class OperatorBuilder:
    """Incremental assembler with labels, loops, and region tracking."""

    def __init__(self, name: str, *, n_params: int,
                 regions: Optional[RegionTable] = None):
        if not (0 <= n_params <= isa.NUM_PARAM_REGS):
            raise ValueError(f"n_params must be in [0, {isa.NUM_PARAM_REGS}]")
        self.name = name
        self.n_params = n_params
        self.regions = regions
        self._instrs: List[Instr] = []
        self._next_reg = max(n_params, 0)
        self._labels: List[Label] = []
        self._open_loops: List[int] = []
        self._regions_read: Set[int] = set()
        self._regions_written: Set[int] = set()

    # -- registers ----------------------------------------------------

    def param(self, i: int) -> Reg:
        if not (0 <= i < self.n_params):
            raise ValueError(f"operator has {self.n_params} params")
        return Reg(i)

    @property
    def params(self) -> List[Reg]:
        return [Reg(i) for i in range(self.n_params)]

    def reg(self) -> Reg:
        """Allocate a fresh temporary register."""
        if self._next_reg >= isa.ERR_REG:
            raise RuntimeError("out of registers (r8..r14 are temporaries)")
        r = Reg(self._next_reg)
        self._next_reg += 1
        return r

    @property
    def err(self) -> Reg:
        return Reg(isa.ERR_REG)

    # -- region bookkeeping --------------------------------------------

    def _rid(self, region: Union[int, str], *, write: bool) -> int:
        if isinstance(region, str):
            if self.regions is None:
                raise ValueError("string region names need a RegionTable")
            rid = self.regions.rid(region)
        else:
            rid = int(region)
        self._regions_read.add(rid)
        if write:
            self._regions_written.add(rid)
        return rid

    # -- emit helpers ---------------------------------------------------

    def _emit(self, ins: Instr) -> int:
        pc = len(self._instrs)
        if pc >= isa.INSTR_STORE_SIZE:
            raise RuntimeError("operator exceeds the 1024-entry instruction store")
        self._instrs.append(ins)
        return pc

    @staticmethod
    def _dev(dev: Device) -> Tuple[int, int]:
        """Returns (field_value, extra_flags) for a device operand."""
        if isinstance(dev, Reg):
            return dev.idx, FLAG_DEV_REG
        return int(dev), 0

    # -- instructions ----------------------------------------------------

    def nop(self) -> None:
        self._emit(Instr(Op.NOP))

    def movi(self, dst: Reg, imm: int) -> Reg:
        self._emit(Instr(Op.MOVI, dst=dst.idx, imm=int(imm)))
        return dst

    def const(self, imm: int) -> Reg:
        """Materialize a constant in a fresh register."""
        return self.movi(self.reg(), imm)

    def alu(self, dst: Reg, a: Reg, op: Alu, b: Operand) -> Reg:
        if isinstance(b, Reg):
            self._emit(Instr(Op.ALU, dst=dst.idx, a=a.idx, b=b.idx, d=int(op)))
        else:
            self._emit(Instr(Op.ALU, dst=dst.idx, a=a.idx, d=int(op),
                             flags=FLAG_IMMB, imm=int(b)))
        return dst

    # common sugar
    def add(self, dst, a, b):
        return self.alu(dst, a, Alu.ADD, b)

    def sub(self, dst, a, b):
        return self.alu(dst, a, Alu.SUB, b)

    def mul(self, dst, a, b):
        return self.alu(dst, a, Alu.MUL, b)

    def shl(self, dst, a, b):
        return self.alu(dst, a, Alu.SHL, b)

    def shr(self, dst, a, b):
        return self.alu(dst, a, Alu.SHR, b)

    def band(self, dst, a, b):
        return self.alu(dst, a, Alu.AND, b)

    def mov(self, dst: Reg, src: Reg) -> Reg:
        return self.alu(dst, src, Alu.ADD, 0)

    def load(self, dst: Reg, region: Union[int, str], off: Reg,
             disp: int = 0, dev: Device = DEV_LOCAL) -> Reg:
        rid = self._rid(region, write=False)
        devf, fl = self._dev(dev)
        self._emit(Instr(Op.LOAD, dst=dst.idx, a=rid, b=off.idx, e=devf,
                         flags=fl, imm=int(disp)))
        return dst

    def store(self, src: Reg, region: Union[int, str], off: Reg,
              disp: int = 0, dev: Device = DEV_LOCAL) -> None:
        rid = self._rid(region, write=True)
        devf, fl = self._dev(dev)
        self._emit(Instr(Op.STORE, dst=src.idx, a=rid, b=off.idx, e=devf,
                         flags=fl, imm=int(disp)))

    def memcpy(self, *, dst_region: Union[int, str], dst_off: Reg,
               src_region: Union[int, str], src_off: Reg,
               n_words: Union[int, Tuple[Reg, int]],
               dst_dev: Device = DEV_LOCAL, src_dev: Device = DEV_LOCAL,
               is_async: bool = False) -> None:
        """Bulk copy. ``n_words`` is either a static word count, or a
        ``(reg, cap)`` pair — a dynamic count statically capped at ``cap``
        (the cap is what the verifier bounds against)."""
        drid = self._rid(dst_region, write=True)
        srid = self._rid(src_region, write=False)
        flags = FLAG_ASYNC if is_async else 0
        if isinstance(dst_dev, Reg):
            dfield, flags = dst_dev.idx, flags | FLAG_DSTDEV_REG
        else:
            dfield = int(dst_dev)
        if isinstance(src_dev, Reg):
            sfield, flags = src_dev.idx, flags | FLAG_SRCDEV_REG
        else:
            sfield = int(src_dev)
        if isinstance(n_words, tuple):
            len_reg, cap = n_words
            if not (0 < cap <= isa.MAX_MEMCPY_WORDS):
                raise ValueError(f"memcpy cap {cap} out of range")
            self._emit(Instr(Op.MEMCPY, dst=dfield, a=drid, b=dst_off.idx,
                             c=sfield, d=srid, e=src_off.idx,
                             flags=flags | FLAG_LEN_REG, imm=int(cap),
                             imm2=len_reg.idx))
        else:
            if not (0 < int(n_words) <= isa.MAX_MEMCPY_WORDS):
                raise ValueError(f"memcpy length {n_words} out of range")
            self._emit(Instr(Op.MEMCPY, dst=dfield, a=drid, b=dst_off.idx,
                             c=sfield, d=srid, e=src_off.idx, flags=flags,
                             imm=int(n_words)))

    def cas(self, dst: Reg, region: Union[int, str], off: Reg, cmp: Reg,
            swap: Reg, disp: int = 0, dev: Device = DEV_LOCAL) -> Reg:
        rid = self._rid(region, write=True)
        devf, fl = self._dev(dev)
        self._emit(Instr(Op.CAS, dst=dst.idx, a=rid, b=off.idx, c=cmp.idx,
                         d=swap.idx, e=devf, flags=fl, imm=int(disp)))
        return dst

    def caa(self, dst: Reg, region: Union[int, str], off: Reg, cmp: Reg,
            addend: Reg, disp: int = 0, dev: Device = DEV_LOCAL) -> Reg:
        rid = self._rid(region, write=True)
        devf, fl = self._dev(dev)
        self._emit(Instr(Op.CAA, dst=dst.idx, a=rid, b=off.idx, c=cmp.idx,
                         d=addend.idx, e=devf, flags=fl, imm=int(disp)))
        return dst

    # -- control flow -----------------------------------------------------

    def mklabel(self, name: str = "L") -> Label:
        lbl = Label(f"{name}{len(self._labels)}")
        self._labels.append(lbl)
        return lbl

    def bind(self, label: Label) -> None:
        if label.pc is not None:
            raise ValueError(f"label {label.name} already bound")
        label.pc = len(self._instrs)
        for jpc in label.pending:
            self._patch_jump(jpc, label.pc)
        label.pending.clear()

    def _patch_jump(self, jpc: int, target_pc: int) -> None:
        delta = target_pc - jpc - 1
        # delta == 0 (target = pc+1) is meaningful: a taken jump pops loop
        # frames it escapes (break), while fall-through iterates the loop.
        if delta < 0:
            raise ValueError(
                f"jump at pc {jpc} to pc {target_pc} goes backward")
        ins = self._instrs[jpc]
        self._instrs[jpc] = dataclasses.replace(ins, imm2=delta)

    def jump(self, label: Label, a: Optional[Reg] = None,
             cond: Alu = Alu.ALWAYS, b: Operand = 0) -> None:
        """Forward-only (conditionally) jump to ``label``."""
        if cond != Alu.ALWAYS and a is None:
            raise ValueError("conditional jump needs a register operand")
        if isinstance(b, Reg):
            ins = Instr(Op.JUMP, a=a.idx if a else 0, b=b.idx, d=int(cond))
        else:
            ins = Instr(Op.JUMP, a=a.idx if a else 0, d=int(cond),
                        flags=FLAG_IMMB, imm=int(b))
        jpc = self._emit(ins)
        if label.pc is not None:
            self._patch_jump(jpc, label.pc)
        else:
            label.pending.append(jpc)

    def loop(self, m: Union[int, Tuple[Reg, int]]) -> _LoopCtx:
        """``with b.loop(M):`` — body length is back-patched on exit.

        ``m`` is a static trip count, or ``(reg, cap)`` for a dynamic count
        statically capped at ``cap`` (the verifier bounds with ``cap``).
        """
        if isinstance(m, tuple):
            mreg, cap = m
            if cap <= 0:
                raise ValueError("loop cap must be positive")
            pc = self._emit(Instr(Op.LOOP, b=mreg.idx, flags=FLAG_MREG,
                                  imm=int(cap)))
        else:
            if int(m) < 0:
                raise ValueError("loop trip count must be >= 0")
            pc = self._emit(Instr(Op.LOOP, imm=int(m)))
        self._open_loops.append(pc)
        return _LoopCtx(self, pc)

    def _close_loop(self, loop_pc: int) -> None:
        if not self._open_loops or self._open_loops[-1] != loop_pc:
            raise RuntimeError("mismatched loop close")
        self._open_loops.pop()
        n_body = len(self._instrs) - loop_pc - 1
        if n_body < 1:
            raise ValueError("empty loop body")
        ins = self._instrs[loop_pc]
        self._instrs[loop_pc] = dataclasses.replace(ins, imm2=n_body)

    def wait(self, threshold: Operand = 0) -> None:
        if isinstance(threshold, Reg):
            self._emit(Instr(Op.WAIT, a=threshold.idx, flags=FLAG_THR_REG))
        else:
            self._emit(Instr(Op.WAIT, imm=int(threshold)))

    def ret(self, value: Optional[Reg] = None, status: int = isa.STATUS_OK) -> None:
        self._emit(Instr(Op.RET, a=value.idx if value is not None else 0,
                         imm=int(status)))

    # -- finalize ----------------------------------------------------------

    def build(self) -> TiaraProgram:
        if self._open_loops:
            raise RuntimeError("unclosed loop at build time")
        unbound = [l.name for l in self._labels if l.pending]
        if unbound:
            raise RuntimeError(f"unbound labels with pending jumps: {unbound}")
        names: Tuple[str, ...] = ()
        if self.regions is not None:
            names = tuple(self.regions.names())
        return TiaraProgram(
            name=self.name,
            code=isa.encode_program(self._instrs),
            n_params=self.n_params,
            regions_read=tuple(sorted(self._regions_read)),
            regions_written=tuple(sorted(self._regions_written)),
            region_names=names,
        )
