"""Tiara instruction set — encoding and constants.

The paper's Table 2 defines eight instruction families:

    Load/Store   register <-> local/remote memory; a loaded value can be the
                 next address (register-chained loads, the key enabler)
    Memcpy       bulk transfer with unified (device, region, offset)
                 addressing; subsumes RDMA Read/Write
    CAS/CAA      atomic compare-and-swap / compare-and-add
    Jump         forward-only conditional branch
    Loop(M,N)    execute next N ops for M iterations (depth-8 loop stack)
    Wait         block until in-flight async ops <= threshold
    Ret          return result to caller
    ComputeOp    integer arithmetic / logical / shift for address computation

We encode each instruction as a row of ``INSTR_WIDTH`` int64 fields so the
whole operator is a dense ``(n_instr, INSTR_WIDTH)`` int64 array — the JAX
VM bakes it in as a compile-time constant (the "BRAM instruction store"),
and the verifier walks the same array.

Addressing is *region-relative*: every memory operand names a statically
declared ``region_id`` plus a dynamic word offset.  Regions are power-of-two
sized so the hardware masks the offset for free (``off & (size-1)``); the
verifier only has to check the static region set against the tenant grant —
this is how the paper gets isolation "with no runtime checks" even though
the chased pointers themselves are data-dependent (see DESIGN.md §2).

All memory is word-addressed (1 word = 8 bytes), matching the 64-bit
register file of the paper's memory processors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Machine parameters (paper §3: Fig. 4 and §4.1)
# ---------------------------------------------------------------------------

NUM_REGS = 16              # 16 x 64b register file per memory processor
NUM_PARAM_REGS = 8         # a client invocation carries up to 8 parameters
LOOP_STACK_DEPTH = 8       # depth-8 loop stack
MAX_INFLIGHT = 32          # 32-entry in-flight async counter
INSTR_STORE_SIZE = 1024    # 1024-entry BRAM instruction store
OP_TABLE_SIZE = 256        # 256-entry op_id -> start_pc dispatch table
MAX_MEMCPY_WORDS = 4096    # max words per single Memcpy DMA burst (32 KB)
WORD_BYTES = 8

# Register 15 is the asynchronous error flag register: a Memcpy targeting a
# failed device sets a bit here instead of faulting, so operators can test
# it with Jump and take a fallback path (paper §3.2).
ERR_REG = 15

# Instruction fields -------------------------------------------------------

INSTR_WIDTH = 10
F_OP, F_DST, F_A, F_B, F_C, F_D, F_E, F_FLAGS, F_IMM, F_IMM2 = range(INSTR_WIDTH)


class Op(enum.IntEnum):
    NOP = 0
    MOVI = 1      # dst <- imm
    ALU = 2       # dst <- aluop(regs[a], regs[b] | imm)
    LOAD = 3      # dst <- mem[dev][region(a)][regs[b] + imm]
    STORE = 4     # mem[dev][region(a)][regs[b] + imm] <- regs[dst]
    MEMCPY = 5    # bulk copy, optionally async
    CAS = 6       # dst <- old; if old == regs[c]: mem <- regs[d]
    CAA = 7       # dst <- old; if old == regs[c]: mem <- old + regs[d]
    JUMP = 8      # forward-only: if cond(regs[a], regs[b]|imm): pc += 1 + imm2
    LOOP = 9      # run next imm2 instructions for imm (or min(regs[b], imm)) iters
    WAIT = 10     # block until inflight <= (imm | regs[a])
    RET = 11      # return regs[a] with status imm


class Alu(enum.IntEnum):
    ADD = 0
    SUB = 1
    MUL = 2
    AND = 3
    OR = 4
    XOR = 5
    SHL = 6
    SHR = 7       # logical shift right
    EQ = 8
    NE = 9
    LT = 10       # signed
    GE = 11       # signed
    MIN = 12
    MAX = 13
    ALWAYS = 15   # only meaningful as a JUMP condition


# Flag bits ----------------------------------------------------------------

FLAG_IMMB = 1        # ALU/JUMP: second operand is the immediate, not regs[b]
FLAG_ASYNC = 2       # MEMCPY: asynchronous (counts toward in-flight)
FLAG_DEV_REG = 4     # LOAD/STORE/CAS/CAA: device operand e is a register index
FLAG_LEN_REG = 8     # MEMCPY: length is regs[imm2] capped at imm, else imm
FLAG_MREG = 8        # LOOP: trip count is min(regs[b], imm), else imm
FLAG_DSTDEV_REG = 16  # MEMCPY: dst field is a register index holding the device
FLAG_SRCDEV_REG = 32  # MEMCPY: c field is a register index holding the device
FLAG_THR_REG = 64    # WAIT: threshold is regs[a], else imm

# Device operand value meaning "the executing NIC's own host memory".
DEV_LOCAL = -1

# Return statuses ----------------------------------------------------------

STATUS_OK = 0
STATUS_FAIL = 1          # conventional app-level failure (e.g. lock busy)
STATUS_EAGAIN = 122      # admission reject: SQ full / rate limited / shed
                         # before execution (the RNIC "try again" errno)
STATUS_TIMEOUT = 123     # per-post deadline expired before launch (no run)
STATUS_FLUSHED = 124     # post flushed from an errored session's SQ (no run)
STATUS_PROT_FAULT = 125  # runtime protection fault: data-dependent access
                         # outside the grant/pool (lane halted, writes masked)
STATUS_FELL_OFF = 126    # pc ran past the end without RET (verifier rejects)
STATUS_FUEL = 127        # exceeded the static step bound (must be unreachable)


@dataclasses.dataclass(frozen=True)
class FaultInfo:
    """Where a runtime protection fault hit — the CQE error payload.

    ``addr`` is the *offending* value exactly as the lane computed it
    (the raw word offset for an out-of-bounds access, before region
    masking), and ``device`` the raw device operand (before the
    ``% n_devices`` router) — so a wild pointer is reported as the wild
    value, not as the clamped location it would have silently hit.
    """

    pc: int
    opcode: int
    addr: int
    device: int

    def describe(self) -> str:
        try:
            name = Op(self.opcode).name
        except ValueError:
            name = f"op{self.opcode}"
        return (f"protection fault at pc {self.pc} ({name}): "
                f"offset {self.addr}, device {self.device}")


@dataclasses.dataclass(frozen=True)
class Instr:
    """One decoded instruction; packs to an int64[INSTR_WIDTH] row."""

    op: Op
    dst: int = 0
    a: int = 0
    b: int = 0
    c: int = 0
    d: int = 0
    e: int = 0
    flags: int = 0
    imm: int = 0
    imm2: int = 0

    def encode(self) -> np.ndarray:
        row = np.zeros(INSTR_WIDTH, dtype=np.int64)
        row[F_OP] = int(self.op)
        row[F_DST] = self.dst
        row[F_A] = self.a
        row[F_B] = self.b
        row[F_C] = self.c
        row[F_D] = self.d
        row[F_E] = self.e
        row[F_FLAGS] = self.flags
        row[F_IMM] = self.imm
        row[F_IMM2] = self.imm2
        return row

    @staticmethod
    def decode(row: Sequence[int]) -> "Instr":
        return Instr(
            op=Op(int(row[F_OP])),
            dst=int(row[F_DST]),
            a=int(row[F_A]),
            b=int(row[F_B]),
            c=int(row[F_C]),
            d=int(row[F_D]),
            e=int(row[F_E]),
            flags=int(row[F_FLAGS]),
            imm=int(row[F_IMM]),
            imm2=int(row[F_IMM2]),
        )


def encode_program(instrs: Sequence[Instr]) -> np.ndarray:
    """Pack a list of instructions into the (n, INSTR_WIDTH) int64 store."""
    if not instrs:
        return np.zeros((0, INSTR_WIDTH), dtype=np.int64)
    return np.stack([i.encode() for i in instrs]).astype(np.int64)


def decode_program(code: np.ndarray) -> list:
    return [Instr.decode(code[i]) for i in range(code.shape[0])]


# Pretty-printing (used by the registry's `dump` and by tests) -------------

_ALU_SYM = {
    Alu.ADD: "+", Alu.SUB: "-", Alu.MUL: "*", Alu.AND: "&", Alu.OR: "|",
    Alu.XOR: "^", Alu.SHL: "<<", Alu.SHR: ">>", Alu.EQ: "==", Alu.NE: "!=",
    Alu.LT: "<", Alu.GE: ">=", Alu.MIN: "min", Alu.MAX: "max",
    Alu.ALWAYS: "always",
}


def format_instr(ins: Instr, pc: Optional[int] = None) -> str:
    p = f"{pc:4d}: " if pc is not None else ""
    f = ins.flags
    if ins.op == Op.NOP:
        return f"{p}nop"
    if ins.op == Op.MOVI:
        return f"{p}r{ins.dst} = {ins.imm}"
    if ins.op == Op.ALU:
        rhs = f"{ins.imm}" if f & FLAG_IMMB else f"r{ins.b}"
        sym = _ALU_SYM[Alu(ins.d)]
        return f"{p}r{ins.dst} = r{ins.a} {sym} {rhs}"
    dev = (f"r{ins.e}" if f & FLAG_DEV_REG else
           ("local" if ins.e == DEV_LOCAL else f"dev{ins.e}"))
    if ins.op == Op.LOAD:
        return f"{p}r{ins.dst} = load {dev}:rgn{ins.a}[r{ins.b} + {ins.imm}]"
    if ins.op == Op.STORE:
        return f"{p}store {dev}:rgn{ins.a}[r{ins.b} + {ins.imm}] = r{ins.dst}"
    if ins.op == Op.MEMCPY:
        dd = f"r{ins.dst}" if f & FLAG_DSTDEV_REG else (
            "local" if ins.dst == DEV_LOCAL else f"dev{ins.dst}")
        sd = f"r{ins.c}" if f & FLAG_SRCDEV_REG else (
            "local" if ins.c == DEV_LOCAL else f"dev{ins.c}")
        ln = f"min(r{ins.imm2}, {ins.imm})" if f & FLAG_LEN_REG else f"{ins.imm}"
        a = " async" if f & FLAG_ASYNC else ""
        return (f"{p}memcpy{a} {dd}:rgn{ins.a}[r{ins.b}] <- "
                f"{sd}:rgn{ins.d}[r{ins.e}] x{ln}")
    if ins.op == Op.CAS:
        return (f"{p}r{ins.dst} = cas {dev}:rgn{ins.a}[r{ins.b} + {ins.imm}]"
                f" cmp r{ins.c} swap r{ins.d}")
    if ins.op == Op.CAA:
        return (f"{p}r{ins.dst} = caa {dev}:rgn{ins.a}[r{ins.b} + {ins.imm}]"
                f" cmp r{ins.c} add r{ins.d}")
    if ins.op == Op.JUMP:
        rhs = f"{ins.imm}" if f & FLAG_IMMB else f"r{ins.b}"
        tgt = (pc + 1 + ins.imm2) if pc is not None else f"+{1 + ins.imm2}"
        if Alu(ins.d) == Alu.ALWAYS:
            return f"{p}jump -> {tgt}"
        return f"{p}if r{ins.a} {_ALU_SYM[Alu(ins.d)]} {rhs}: jump -> {tgt}"
    if ins.op == Op.LOOP:
        m = f"min(r{ins.b}, {ins.imm})" if f & FLAG_MREG else f"{ins.imm}"
        return f"{p}loop {m} times over next {ins.imm2} ops"
    if ins.op == Op.WAIT:
        thr = f"r{ins.a}" if f & FLAG_THR_REG else f"{ins.imm}"
        return f"{p}wait inflight <= {thr}"
    if ins.op == Op.RET:
        return f"{p}ret r{ins.a} (status={ins.imm})"
    return f"{p}<op{int(ins.op)}>"


def disassemble(code: np.ndarray) -> str:
    return "\n".join(format_instr(ins, pc)
                     for pc, ins in enumerate(decode_program(code)))
