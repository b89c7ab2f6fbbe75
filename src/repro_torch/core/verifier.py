"""Registration-time static verification (paper §3.3).

Two guarantees, both established before an operator ever touches the data
path, so the runtime needs **no per-access checks**:

1. *Termination*: jumps are forward-only and loops have static trip-count
   bounds, so every operator has a statically computable upper bound on
   executed steps.  The verifier computes the exact worst-case bound
   (sum over instructions of the product of enclosing loop bounds) and
   rejects operators above a configurable limit.  The bound doubles as the
   JAX VM's fuel: if the VM ever hits it, that is a *verifier* bug, and a
   hypothesis property test asserts it never happens.

2. *Region isolation*: every memory access names a statically-declared
   region id; the verifier checks the declared set against the tenant's
   grant (read + write separately).  Offsets are data-dependent but are
   masked to the power-of-two region size by the data path, so no reachable
   access can leave a granted region, no matter what the chased pointers
   contain.

Structural rules enforced:
  * jumps strictly forward, targets inside the program;
  * jumps never enter a loop body from outside (they may exit one — that is
    the distributed-lock "break" in Fig. 5 of the paper);
  * loop bodies properly nested, static nesting depth <= 8 (the hardware
    loop stack);
  * the final instruction is Ret (no fall-off-the-end path);
  * register/immediate fields in range; Memcpy lengths capped at the DMA
    burst limit.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.core import access, isa, wcet
from repro_torch.core.isa import (Alu, Instr, Op, FLAG_DEV_REG, FLAG_DSTDEV_REG,
                            FLAG_IMMB, FLAG_LEN_REG, FLAG_MREG,
                            FLAG_SRCDEV_REG, FLAG_THR_REG)
from repro_torch.core.memory import Grant, RegionTable
from repro_torch.core.program import TiaraProgram

DEFAULT_MAX_STEPS = 1 << 20


class VerificationError(Exception):
    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        super().__init__("; ".join(self.errors))


@dataclasses.dataclass(frozen=True)
class LoopInfo:
    pc: int            # pc of the LOOP instruction
    start: int         # first body pc
    end: int           # last body pc (inclusive)
    bound: int         # static trip-count bound (cap for dynamic counts)


@dataclasses.dataclass(frozen=True)
class VerifiedOperator:
    """The registration artifact: program + proven facts.

    ``footprint`` is the registration-time symbolic access footprint
    (``core/access``): per static access site an affine-in-params
    offset, a trip-scaled loop window, or top (whole region).  It is
    what wave-formation substitutes concrete params into to prove a
    mixed wave conflict-free and skip the runtime sweep.

    ``certificate`` is the registration-time line-rate certificate
    (``core/wcet``): sound upper bounds on worst-case cycles, traffic,
    and per-resource occupancy, derived against the default hardware
    model.  The registry enforces it against its budget, the serving
    loop fail-fasts statically-infeasible deadlines with it, and the
    cost model clamps its learned wave prices to it.
    """

    program: TiaraProgram
    step_bound: int
    loops: Tuple[LoopInfo, ...]
    max_loop_depth: int
    n_async_sites: int
    footprint: Optional[access.OpFootprint] = None
    certificate: Optional[wcet.LineRateCertificate] = None

    @property
    def name(self) -> str:
        return self.program.name

    @property
    def code(self) -> np.ndarray:
        return self.program.code


def _reg_ok(idx: int) -> bool:
    return 0 <= idx < isa.NUM_REGS


def _collect_loops(instrs: List[Instr], errors: List[str]) -> List[LoopInfo]:
    loops: List[LoopInfo] = []
    n = len(instrs)
    for pc, ins in enumerate(instrs):
        if ins.op != Op.LOOP:
            continue
        n_body = ins.imm2
        if n_body < 1:
            errors.append(f"pc {pc}: loop with empty body")
            continue
        if pc + 1 + n_body > n:
            errors.append(f"pc {pc}: loop body extends past program end")
            continue
        bound = int(ins.imm)
        if bound < 0:
            errors.append(f"pc {pc}: negative loop bound")
            continue
        if (ins.flags & FLAG_MREG) and bound < 1:
            errors.append(f"pc {pc}: dynamic loop needs a positive static cap")
            continue
        loops.append(LoopInfo(pc=pc, start=pc + 1, end=pc + n_body, bound=bound))
    return loops


def _check_nesting(loops: List[LoopInfo], errors: List[str]) -> int:
    """Bodies must be disjoint or strictly nested; returns max depth."""
    for i, a in enumerate(loops):
        for b in loops[i + 1:]:
            lo, hi = (a, b) if a.pc < b.pc else (b, a)
            # hi's LOOP instruction sits either inside lo's body or after it.
            if hi.pc <= lo.end:
                if hi.end > lo.end:
                    errors.append(
                        f"loops at pc {lo.pc} and {hi.pc} overlap without nesting")
            # else disjoint — fine.
    max_depth = 0
    for a in loops:
        depth = 1 + sum(1 for b in loops
                        if b.pc != a.pc and b.start <= a.pc and a.end <= b.end)
        max_depth = max(max_depth, depth)
    if max_depth > isa.LOOP_STACK_DEPTH:
        errors.append(f"loop nesting depth {max_depth} exceeds hardware "
                      f"stack of {isa.LOOP_STACK_DEPTH}")
    return max_depth


def _enclosing(loops: List[LoopInfo], pc: int) -> FrozenSet[int]:
    return frozenset(l.pc for l in loops if l.start <= pc <= l.end)


# one multiplier definition for the step bound, the footprint lattice,
# and the line-rate certificate (they must agree for the certificate's
# mp_cycles == step_bound identity to hold)
_multiplier = access.loop_multiplier


def verify(program: TiaraProgram, *, grant: Optional[Grant] = None,
           regions: Optional[RegionTable] = None,
           max_steps: int = DEFAULT_MAX_STEPS) -> VerifiedOperator:
    """Statically verify ``program``; raises VerificationError on failure."""
    errors: List[str] = []
    instrs = isa.decode_program(program.code)
    n = len(instrs)
    if n == 0:
        raise VerificationError([f"{program.name}: empty program"])
    if n > isa.INSTR_STORE_SIZE:
        errors.append(f"program of {n} instructions exceeds the "
                      f"{isa.INSTR_STORE_SIZE}-entry instruction store")
    if not (0 <= program.n_params <= isa.NUM_PARAM_REGS):
        errors.append(f"n_params {program.n_params} out of range")

    n_regions = len(regions) if regions is not None else None

    def check_region(pc: int, rid: int, *, write: bool) -> None:
        if n_regions is not None and not (0 <= rid < n_regions):
            errors.append(f"pc {pc}: region id {rid} not registered")
            return
        if regions is not None and write and not regions[rid].writable:
            errors.append(f"pc {pc}: region {regions[rid].name!r} is read-only")
        if grant is not None:
            if rid not in grant.readable:
                errors.append(f"pc {pc}: region {rid} not readable by tenant "
                              f"{grant.tenant!r}")
            if write and rid not in grant.writable:
                errors.append(f"pc {pc}: region {rid} not writable by tenant "
                              f"{grant.tenant!r}")

    def check_reg(pc: int, idx: int, what: str) -> None:
        if not _reg_ok(idx):
            errors.append(f"pc {pc}: {what} register r{idx} out of range")

    def check_dev(pc: int, field: int, flag_set: bool) -> None:
        if flag_set:
            check_reg(pc, field, "device")
        # Static device ids are masked to the pool size by the data path;
        # DEV_LOCAL (-1) means the executing host.

    loops = _collect_loops(instrs, errors)
    max_depth = _check_nesting(loops, errors)

    n_async = 0
    for pc, ins in enumerate(instrs):
        op = ins.op
        if op in (Op.NOP,):
            continue
        if op == Op.MOVI:
            check_reg(pc, ins.dst, "dst")
        elif op == Op.ALU:
            check_reg(pc, ins.dst, "dst")
            check_reg(pc, ins.a, "a")
            if not (ins.flags & FLAG_IMMB):
                check_reg(pc, ins.b, "b")
            if ins.d not in (int(x) for x in Alu if x != Alu.ALWAYS):
                errors.append(f"pc {pc}: invalid ALU op {ins.d}")
        elif op == Op.LOAD:
            check_reg(pc, ins.dst, "dst")
            check_reg(pc, ins.b, "offset")
            check_dev(pc, ins.e, bool(ins.flags & FLAG_DEV_REG))
            check_region(pc, ins.a, write=False)
        elif op == Op.STORE:
            check_reg(pc, ins.dst, "src")
            check_reg(pc, ins.b, "offset")
            check_dev(pc, ins.e, bool(ins.flags & FLAG_DEV_REG))
            check_region(pc, ins.a, write=True)
        elif op == Op.MEMCPY:
            check_reg(pc, ins.b, "dst offset")
            check_reg(pc, ins.e, "src offset")
            check_dev(pc, ins.dst, bool(ins.flags & FLAG_DSTDEV_REG))
            check_dev(pc, ins.c, bool(ins.flags & FLAG_SRCDEV_REG))
            check_region(pc, ins.a, write=True)
            check_region(pc, ins.d, write=False)
            if not (0 < ins.imm <= isa.MAX_MEMCPY_WORDS):
                errors.append(f"pc {pc}: memcpy length/cap {ins.imm} outside "
                              f"(0, {isa.MAX_MEMCPY_WORDS}]")
            if ins.flags & FLAG_LEN_REG:
                check_reg(pc, ins.imm2, "length")
            if ins.flags & isa.FLAG_ASYNC:
                n_async += 1
        elif op in (Op.CAS, Op.CAA):
            check_reg(pc, ins.dst, "dst")
            check_reg(pc, ins.b, "offset")
            check_reg(pc, ins.c, "cmp")
            check_reg(pc, ins.d, "swap/add")
            check_dev(pc, ins.e, bool(ins.flags & FLAG_DEV_REG))
            check_region(pc, ins.a, write=True)
        elif op == Op.JUMP:
            if ins.d != int(Alu.ALWAYS):
                check_reg(pc, ins.a, "cond lhs")
                if not (ins.flags & FLAG_IMMB):
                    check_reg(pc, ins.b, "cond rhs")
                if ins.d not in (int(Alu.EQ), int(Alu.NE), int(Alu.LT),
                                 int(Alu.GE)):
                    errors.append(f"pc {pc}: invalid jump condition {ins.d}")
            if ins.imm2 < 0:
                errors.append(f"pc {pc}: backward jump")
                continue
            target = pc + 1 + ins.imm2
            if target >= n:
                errors.append(f"pc {pc}: jump target {target} outside program")
                continue
            # May only jump out of (or within) loop bodies, never into one.
            if not _enclosing(loops, target) <= _enclosing(loops, pc):
                errors.append(f"pc {pc}: jump to {target} enters a loop body")
        elif op == Op.LOOP:
            if ins.flags & FLAG_MREG:
                check_reg(pc, ins.b, "trip count")
        elif op == Op.WAIT:
            if ins.flags & FLAG_THR_REG:
                check_reg(pc, ins.a, "threshold")
            elif ins.imm < 0:
                errors.append(f"pc {pc}: negative wait threshold")
        elif op == Op.RET:
            check_reg(pc, ins.a, "return value")
        else:
            errors.append(f"pc {pc}: unknown opcode {int(ins.op)}")

    if instrs and instrs[-1].op != Op.RET:
        errors.append("last instruction must be Ret (no fall-off paths)")

    # Termination bound: sum over instructions of the product of enclosing
    # loop bounds.  Forward jumps can only skip work, so this is sound.
    step_bound = sum(_multiplier(loops, pc) for pc in range(n))
    if step_bound > max_steps:
        errors.append(f"worst-case step bound {step_bound} exceeds the "
                      f"configured limit of {max_steps}")

    if errors:
        # diagnostics carry the operator name so multi-operator
        # registration failures stay attributable
        raise VerificationError(
            [f"{program.name}: {e}" for e in errors])

    return VerifiedOperator(
        program=program,
        step_bound=int(step_bound),
        loops=tuple(loops),
        max_loop_depth=max_depth,
        n_async_sites=n_async,
        footprint=access.analyze(program, loops, regions),
        certificate=wcet.certify(program, loops, regions),
    )
