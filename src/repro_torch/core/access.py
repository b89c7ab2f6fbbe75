"""Registration-time access analysis — symbolic footprints and static
conflict proofs (ROADMAP open item 2).

The verifier already proves termination and region isolation at
registration; conflict detection, however, is still paid at *runtime*:
every macro-step of every engine runs an O(B log B) sweep-line over the
live lanes' footprints (``vm._sweep_conflict``), and on the sharded
engine that sweep is fed by an ``all_gather`` of every device's
intervals — a static question answered with a collective per step.

This module answers the question once, at registration time.  A small
abstract interpreter walks the verified program and derives, per static
access site, a **symbolic footprint**:

* **affine-in-params** offsets — ``const + sum(coeff_i * param_i)``
  plus a closed interval of slack (the value lattice
  :class:`SymVal`);
* **loop-strided windows** — pure-increment loop counters widen to the
  affine entry value plus ``[cap*d_lo, cap*d_hi]`` slack, so a
  reply-slot cursor stays a *bounded window*, not unknown;
* **top (data-dependent)** — pointer-chased offsets (a LOAD result
  feeding an address) degrade to the *whole region*, which is always
  sound because the datapath masks every offset into its region
  (``pyvm.phys`` / ``vm.lane_intervals`` do the same wrap).

At wave-formation time :func:`prove_wave_noconflict` substitutes each
lane's concrete parameters into its operator's footprint and proves the
wave conflict-free: per-lane merged write/read interval sets, a global
sweep over the merged write spans (any overlap is necessarily
cross-lane), reads checked only against *other* lanes' writes, and a
per-MEMCPY src/dst self-overlap check (the one same-lane case the
runtime sweep flags).  A proof lets ``vm.py`` skip the runtime sweep —
and, sharded, the footprint all_gather — entirely; top footprints keep
the sweep as the verbatim fallback.

Soundness invariants (property-tested in
``tests/test_access_analysis.py``):

* every footprint interval is a **superset** of every runtime
  ``lane_intervals`` window the lane can produce at any macro-step, so
  if the dynamic sweep would flag a wave, the static proof refuses to
  clear it;
* symbolic evaluation tracks a monotone **absolute-magnitude bound**
  (``SymVal.aconst``/``acoeffs``); substitution only trusts the affine
  form when that bound shows no intermediate wrap64 could have fired,
  otherwise the access degrades to the whole region.

No imports from ``pyvm``/``verifier`` (they import us); the few scalar
semantics needed (wrap64, ALU const-folds) are replicated locally.
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, List, Optional, Protocol, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core import isa
from repro_torch.core.isa import Alu, Instr, Op
from repro_torch.core.memory import RegionTable

_U64 = 1 << 64
_S63 = 1 << 63

# collapse pathologically access-heavy programs to per-region summaries
# beyond this many records (keeps proof time linear in B, not program
# unrolling)
MAX_ACCESS_RECORDS = 96


def _wrap64(x: int) -> int:
    """Signed 64-bit two's-complement fold (mirrors ``pyvm.wrap64``)."""
    return ((int(x) + _S63) % _U64) - _S63


# ---------------------------------------------------------------------------
# value lattice
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SymVal:
    """``const + sum(coeff*sym) + [lo, hi]`` with a wrap certificate.

    ``coeffs`` maps symbol index -> integer coefficient (sorted tuple of
    pairs so the value hashes).  Symbols ``0..NUM_PARAM_REGS-1`` are the
    parameter registers; symbols ``NUM_PARAM_REGS + j`` are *auxiliary
    trip counters* — one per dynamically-bounded (``FLAG_MREG``) loop,
    ranging over ``[0, clamp(m)]`` so a reply-slot cursor's window
    scales with the lane's actual trip count, not the static cap.
    ``[lo, hi]`` is inclusive slack — loop widening and unresolved
    comparisons land here.  ``aconst`` / ``acoeffs`` bound the absolute
    magnitude of every intermediate value in the expression's
    computation history:
    ``|any intermediate| <= aconst + sum(ac_i * max|sym_i|)``.  The
    bound only ever *accumulates* (no cancellation), so if it evaluates
    below 2**63 for a concrete symbol vector, no wrap64 fired anywhere
    in the computation and the unbounded affine evaluation equals the
    datapath's wrapped value exactly.
    """

    const: int = 0
    coeffs: Tuple[Tuple[int, int], ...] = ()
    lo: int = 0
    hi: int = 0
    aconst: int = 0
    acoeffs: Tuple[Tuple[int, int], ...] = ()

    # -- constructors ---------------------------------------------------

    @staticmethod
    def exact(v: int) -> "SymVal":
        v = _wrap64(v)
        return SymVal(const=v, aconst=abs(v))

    @staticmethod
    def param(i: int) -> "SymVal":
        return SymVal(coeffs=((i, 1),), aconst=0, acoeffs=((i, 1),))

    @staticmethod
    def sym(i: int, coeff: int = 1) -> "SymVal":
        return SymVal(coeffs=((i, coeff),),
                      acoeffs=((i, abs(coeff)),))

    @staticmethod
    def interval(lo: int, hi: int) -> "SymVal":
        return SymVal(lo=lo, hi=hi, aconst=max(abs(lo), abs(hi)))

    # -- predicates -----------------------------------------------------

    @property
    def is_exact(self) -> bool:
        return not self.coeffs and self.lo == 0 and self.hi == 0

    @property
    def value(self) -> int:
        assert self.is_exact
        return self.const

    # -- arithmetic -----------------------------------------------------

    def _merge(self, other: "SymVal", sign: int) -> "SymVal":
        c: Dict[int, int] = dict(self.coeffs)
        for k, v in other.coeffs:
            c[k] = c.get(k, 0) + sign * v
        a: Dict[int, int] = dict(self.acoeffs)
        for k, v in other.acoeffs:
            a[k] = a.get(k, 0) + v
        lo = self.lo + (other.lo if sign > 0 else -other.hi)
        hi = self.hi + (other.hi if sign > 0 else -other.lo)
        return SymVal(
            const=self.const + sign * other.const,
            coeffs=tuple(sorted((k, v) for k, v in c.items() if v)),
            lo=lo, hi=hi,
            aconst=self.aconst + other.aconst,
            acoeffs=tuple(sorted(a.items())))

    def add(self, other: "SymVal") -> "SymVal":
        return self._merge(other, 1)

    def sub(self, other: "SymVal") -> "SymVal":
        return self._merge(other, -1)

    def scale(self, k: int) -> "SymVal":
        lo, hi = self.lo * k, self.hi * k
        if k < 0:
            lo, hi = hi, lo
        return SymVal(
            const=self.const * k,
            coeffs=tuple((i, c * k) for i, c in self.coeffs if c * k),
            lo=lo, hi=hi,
            aconst=self.aconst * abs(k),
            acoeffs=tuple((i, c * abs(k)) for i, c in self.acoeffs
                          if c * k))

    def widen(self, lo: int, hi: int) -> "SymVal":
        """Add ``[lo, hi]`` slack (loop widening)."""
        return SymVal(const=self.const, coeffs=self.coeffs,
                      lo=self.lo + lo, hi=self.hi + hi,
                      aconst=self.aconst + max(abs(lo), abs(hi)),
                      acoeffs=self.acoeffs)

    def join(self, other: "SymVal") -> Optional["SymVal"]:
        """Least upper bound; ``None`` (top) when affine parts differ."""
        if self.coeffs != other.coeffs:
            return None
        d = other.const - self.const
        a: Dict[int, int] = dict(self.acoeffs)
        for k, v in other.acoeffs:
            a[k] = max(a.get(k, 0), v)
        return SymVal(
            const=self.const, coeffs=self.coeffs,
            lo=min(self.lo, other.lo + d),
            hi=max(self.hi, other.hi + d),
            aconst=max(self.aconst, other.aconst),
            acoeffs=tuple(sorted(a.items())))

    # -- substitution ---------------------------------------------------

    def concrete_range(
            self, syms: Sequence[Tuple[int, int]]
    ) -> Optional[Tuple[int, int]]:
        """``[lo, hi]`` of the value for a concrete symbol vector (each
        symbol an inclusive ``(lo, hi)`` range; params are point
        ranges), or ``None`` when the wrap certificate cannot rule out
        an intermediate wrap64 (caller degrades to the whole region)."""
        absb = self.aconst
        for i, c in self.acoeffs:
            if i < len(syms):
                slo, shi = syms[i]
                absb += c * max(abs(slo), abs(shi))
        if absb >= _S63:
            return None
        vlo = vhi = self.const
        for i, c in self.coeffs:
            slo, shi = syms[i] if i < len(syms) else (0, 0)
            vlo += min(c * slo, c * shi)
            vhi += max(c * slo, c * shi)
        return vlo + self.lo, vhi + self.hi

    @staticmethod
    def _sym_name(i: int) -> str:
        if i < isa.NUM_PARAM_REGS:
            return f"p{i}"
        return f"t{i - isa.NUM_PARAM_REGS}"

    def describe(self) -> str:
        parts: List[str] = []
        if self.const or not (self.coeffs or self.lo != self.hi):
            parts.append(str(self.const))
        for i, c in self.coeffs:
            n = self._sym_name(i)
            parts.append(n if c == 1 else f"{c}*{n}")
        s = "+".join(parts) if parts else "0"
        if self.lo != self.hi or self.lo:
            s += f"+[{self.lo},{self.hi}]"
        return s


# ---------------------------------------------------------------------------
# access records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Access:
    """One static access site's symbolic footprint.

    ``offset is None`` means top: the access may touch any word of the
    region (the datapath masks it in-region, so the whole region is the
    exact upper bound).  ``extent`` is the static window length in
    words (1 for word ops; the imm cap for MEMCPY).  ``dev`` is
    ``isa.DEV_LOCAL`` for the lane's home, a static device id, or
    ``None`` when the device is register-held and unresolved (any
    device).  MEMCPY's two accesses share a ``pair`` id so the
    same-step src/dst self-overlap check can find them.
    """

    rid: int
    write: bool
    offset: Optional[SymVal]
    extent: int
    dev: Optional[int]
    pc: int
    pair: int = -1

    def describe(self, regions: Optional[RegionTable] = None) -> str:
        name = str(self.rid)
        if regions is not None:
            name = regions[self.rid].name
        kind = "w" if self.write else "r"
        off = "⊤" if self.offset is None else self.offset.describe()
        ext = f"×{self.extent}" if self.extent != 1 else ""
        return f"{kind} {name}[{off}]{ext}"


@dataclasses.dataclass(frozen=True)
class OpFootprint:
    """The derived read/write footprint of one verified operator.

    ``aux_trips`` defines the auxiliary trip-count symbols, in
    allocation order: ``(m_expr, cap)`` per dynamically-bounded loop.
    At substitution time symbol ``NUM_PARAM_REGS + j`` ranges over
    ``[0, min(max(m, 0), cap)]`` where ``m`` evaluates ``m_expr``
    against the lane's params (``m_expr is None`` means unresolved —
    the full ``[0, cap]``).
    """

    accesses: Tuple[Access, ...]
    n_params: int
    aux_trips: Tuple[Tuple[Optional[SymVal], int], ...] = ()

    @property
    def exact(self) -> bool:
        """True when no access degraded to top."""
        return all(a.offset is not None for a in self.accesses)

    def lane_syms(self, params: Sequence[int]
                  ) -> List[Tuple[int, int]]:
        """The concrete symbol-range vector for one lane: wrapped
        params as point ranges, then each trip counter's range."""
        syms: List[Tuple[int, int]] = []
        for i in range(isa.NUM_PARAM_REGS):
            v = _wrap64(params[i]) if i < len(params) else 0
            syms.append((v, v))
        for m_expr, cap in self.aux_trips:
            hi = cap
            if m_expr is not None:
                rng = m_expr.concrete_range(syms)
                if rng is not None:
                    hi = min(max(rng[1], 0), cap)
            syms.append((0, hi))
        return syms

    def describe(self, regions: Optional[RegionTable] = None) -> str:
        if not self.accesses:
            return "∅"
        s = " ".join(a.describe(regions) for a in self.accesses)
        if self.aux_trips:
            trips = ",".join(
                f"t{j}≤{'m' if m is None else m.describe()}"
                f"∧{cap}" for j, (m, cap) in enumerate(self.aux_trips))
            s += f"  ({trips})"
        return s


# ---------------------------------------------------------------------------
# abstract interpretation
# ---------------------------------------------------------------------------


_State = List[Optional[SymVal]]

# structural protocol for verifier.LoopInfo without importing it
# (verifier imports this module; ``core/wcet`` consumes the same shape
# for its trip-scaled cost multipliers, so the protocol is public)


class LoopLike(Protocol):
    pc: int
    start: int
    end: int
    bound: int


_LoopLike = LoopLike


def loop_multiplier(loops: Sequence[LoopLike], pc: int) -> int:
    """Product of the loop-trip caps of every loop body enclosing
    ``pc`` — how many times that instruction can execute per
    invocation.  Shared by the verifier's step bound, the footprint
    lattice's trip scaling, and the line-rate certifier's per-pc cost
    attribution (one definition, three consumers)."""
    m = 1
    for l in loops:
        if l.start <= pc <= l.end:
            m *= max(int(l.bound), 0)
    return m


def _copy(state: _State) -> _State:
    return list(state)


def _join_states(a: Optional[_State],
                 b: Optional[_State]) -> Optional[_State]:
    if a is None:
        return None if b is None else _copy(b)
    if b is None:
        return _copy(a)
    out: _State = []
    for x, y in zip(a, b):
        out.append(None if x is None or y is None else x.join(y))
    return out


def _fold_alu(aop: int, a: SymVal, b: SymVal) -> Optional[SymVal]:
    """Abstract ALU transfer.  ``None`` = top."""
    if a.is_exact and b.is_exact:
        # exact const-fold replicating pyvm._alu bit-for-bit
        x, y = a.value, b.value
        if aop == Alu.ADD:
            return SymVal.exact(x + y)
        if aop == Alu.SUB:
            return SymVal.exact(x - y)
        if aop == Alu.MUL:
            return SymVal.exact(x * y)
        if aop == Alu.AND:
            return SymVal.exact(x & y)
        if aop == Alu.OR:
            return SymVal.exact(x | y)
        if aop == Alu.XOR:
            return SymVal.exact(x ^ y)
        if aop == Alu.SHL:
            return SymVal.exact(x << (y & 63))
        if aop == Alu.SHR:
            return SymVal.exact((x % _U64) >> (y & 63))
        if aop == Alu.EQ:
            return SymVal.exact(int(x == y))
        if aop == Alu.NE:
            return SymVal.exact(int(x != y))
        if aop == Alu.LT:
            return SymVal.exact(int(x < y))
        if aop == Alu.GE:
            return SymVal.exact(int(x >= y))
        if aop == Alu.MIN:
            return SymVal.exact(min(x, y))
        if aop == Alu.MAX:
            return SymVal.exact(max(x, y))
        return None
    if aop == Alu.ADD:
        return a.add(b)
    if aop == Alu.SUB:
        return a.sub(b)
    if aop == Alu.MUL:
        if a.is_exact:
            return b.scale(a.value)
        if b.is_exact:
            return a.scale(b.value)
        return None
    if aop == Alu.SHL and b.is_exact and 0 <= (b.value & 63) < 63:
        return a.scale(1 << (b.value & 63))
    if aop in (Alu.EQ, Alu.NE, Alu.LT, Alu.GE):
        return SymVal.interval(0, 1)
    if aop == Alu.AND:
        # a logical AND with a known non-negative mask is bounded by it
        # regardless of the other operand (index-masking idiom)
        for m in (a, b):
            if m.is_exact and m.value >= 0:
                return SymVal.interval(0, m.value)
        return None
    if aop in (Alu.MIN, Alu.MAX) and not a.coeffs and not b.coeffs:
        alo, ahi = a.const + a.lo, a.const + a.hi
        blo, bhi = b.const + b.lo, b.const + b.hi
        if aop == Alu.MIN:
            return SymVal.interval(min(alo, blo), min(ahi, bhi))
        return SymVal.interval(max(alo, blo), max(ahi, bhi))
    return None


def _multiplier_within(loops: Sequence[_LoopLike], outer: _LoopLike,
                       pc: int) -> int:
    """Product of the bounds of loops nested strictly inside ``outer``
    that enclose ``pc`` — how often one outer iteration can run it."""
    m = 1
    for l in loops:
        if l.pc == outer.pc:
            continue
        if outer.start <= l.pc <= outer.end and l.start <= pc <= l.end:
            m *= max(int(l.bound), 0)
    return m


_REG_WRITERS = (Op.MOVI, Op.ALU, Op.LOAD, Op.CAS, Op.CAA)


class _Analyzer:
    def __init__(self, instrs: Sequence[Instr],
                 loops: Sequence[_LoopLike], n_params: int,
                 regions: Optional[RegionTable]):
        self.instrs = instrs
        self.loops = list(loops)
        self.loop_by_pc = {l.pc: l for l in self.loops}
        self.n_params = n_params
        self.regions = regions
        self.accesses: List[Access] = []
        self.joins: Dict[int, Optional[_State]] = {}
        self.n_pairs = 0
        self.aux: List[Tuple[Optional[SymVal], int]] = []

    # -- helpers --------------------------------------------------------

    def _reg(self, state: _State, idx: int) -> Optional[SymVal]:
        return state[int(idx) & (isa.NUM_REGS - 1)]

    def _static_extent(self, ins: Instr) -> int:
        ext = min(int(ins.imm), isa.MAX_MEMCPY_WORDS)
        if self.regions is not None:
            for rid in (int(ins.a), int(ins.d)):
                if 0 <= rid < len(self.regions):
                    ext = min(ext, int(self.regions[rid].size))
        return max(ext, 0)

    def _dev(self, state: _State, field: int, via_reg: bool
             ) -> Optional[int]:
        if not via_reg:
            return int(field)
        v = self._reg(state, field)
        if v is not None and v.is_exact:
            return int(v.value)
        return None

    def _record(self, *, rid: int, write: bool,
                offset: Optional[SymVal], extent: int,
                dev: Optional[int], pc: int, pair: int = -1) -> None:
        self.accesses.append(Access(rid=int(rid), write=write,
                                    offset=offset, extent=int(extent),
                                    dev=dev, pc=int(pc), pair=pair))

    # -- loop widening --------------------------------------------------

    def _widen_loop(self, state: _State, loop: _LoopLike) -> _State:
        """Entry state covering *every* point of every loop iteration
        and the post-loop state after 0..cap trips (MREG early exits
        and jump breaks included).

        Pure-increment registers — every body write is ``ALU ADD/SUB``
        with an immediate and ``dst == a`` — widen to the entry value
        plus a trip-scaled window; every other body-written register
        goes top.  For an MREG loop whose trip register is itself
        affine at entry, the window is scaled by a fresh trip-count
        symbol ``t in [0, clamp(m)]`` so it tracks the lane's *actual*
        trip count; otherwise the verifier-checked static cap bounds
        the window (cap-bounded, never top).
        """
        cap = max(int(loop.bound), 0)
        ins_loop = self.instrs[loop.pc]
        m_val: Optional[SymVal] = None
        if ins_loop.flags & isa.FLAG_MREG:
            m_val = self._reg(state, ins_loop.b)
        t_idx: Optional[int] = None
        written: Dict[int, List[int]] = {}
        for pc in range(loop.start, loop.end + 1):
            ins = self.instrs[pc]
            if ins.op in _REG_WRITERS:
                written.setdefault(int(ins.dst), []).append(pc)
        out = _copy(state)
        for reg, pcs in written.items():
            deltas: List[int] = []
            pure = True
            for pc in pcs:
                ins = self.instrs[pc]
                if (ins.op == Op.ALU and int(ins.d) in (int(Alu.ADD),
                                                        int(Alu.SUB))
                        and (ins.flags & isa.FLAG_IMMB)
                        and int(ins.dst) == int(ins.a)):
                    step = int(ins.imm)
                    if int(ins.d) == int(Alu.SUB):
                        step = -step
                    deltas.append(
                        step * _multiplier_within(self.loops, loop, pc))
                else:
                    pure = False
                    break
            cur = out[reg]
            if not pure or cur is None:
                out[reg] = None
                continue
            d_lo = sum(min(0, d) for d in deltas)
            d_hi = sum(max(0, d) for d in deltas)
            if d_lo == 0 and d_hi == 0:
                out[reg] = cur
                continue
            if m_val is not None and (d_lo == 0 or d_hi == 0):
                # trip-scaled window: one shared symbol per loop
                if t_idx is None:
                    t_idx = isa.NUM_PARAM_REGS + len(self.aux)
                    self.aux.append((m_val, cap))
                coeff = d_hi if d_lo == 0 else d_lo
                out[reg] = cur.add(SymVal.sym(t_idx, coeff))
            else:
                out[reg] = cur.widen(cap * d_lo, cap * d_hi)
        return out

    # -- the walk -------------------------------------------------------

    def walk(self, lo: int, hi: int,
             state: Optional[_State]) -> None:
        pc = lo
        while pc < hi:
            if pc in self.joins:
                state = _join_states(state, self.joins.pop(pc))
            loop = self.loop_by_pc.get(pc)
            if loop is not None:
                body_hi = loop.end + 1
                if state is not None:
                    state = self._widen_loop(state, loop)
                    self.walk(loop.start, body_hi, _copy(state))
                pc = body_hi
                continue
            if state is None:
                pc += 1
                continue
            state = self._transfer(pc, state)
            pc += 1

    def _transfer(self, pc: int, state: _State) -> Optional[_State]:
        ins = self.instrs[pc]
        o = ins.op
        if o == Op.NOP or o == Op.WAIT:
            return state
        if o == Op.MOVI:
            state = _copy(state)
            state[int(ins.dst)] = SymVal.exact(int(ins.imm))
            return state
        if o == Op.ALU:
            a = self._reg(state, ins.a)
            rhs = (SymVal.exact(int(ins.imm))
                   if (ins.flags & isa.FLAG_IMMB)
                   else self._reg(state, ins.b))
            state = _copy(state)
            if a is None or rhs is None:
                # top op of a known non-negative mask still bounds AND
                if (int(ins.d) == int(Alu.AND) and rhs is not None
                        and rhs.is_exact and rhs.value >= 0):
                    state[int(ins.dst)] = SymVal.interval(0, rhs.value)
                elif (int(ins.d) == int(Alu.AND) and a is not None
                        and a.is_exact and a.value >= 0):
                    state[int(ins.dst)] = SymVal.interval(0, a.value)
                elif int(ins.d) in (int(Alu.EQ), int(Alu.NE),
                                    int(Alu.LT), int(Alu.GE)):
                    state[int(ins.dst)] = SymVal.interval(0, 1)
                else:
                    state[int(ins.dst)] = None
            else:
                state[int(ins.dst)] = _fold_alu(int(ins.d), a, rhs)
            return state
        if o in (Op.LOAD, Op.STORE, Op.CAS, Op.CAA):
            base_off = self._reg(state, ins.b)
            off = (None if base_off is None
                   else base_off.add(SymVal.exact(int(ins.imm))))
            dev = self._dev(state, int(ins.e),
                            bool(ins.flags & isa.FLAG_DEV_REG))
            self._record(rid=int(ins.a), write=(o != Op.LOAD),
                         offset=off, extent=1, dev=dev, pc=pc)
            if o != Op.STORE:
                state = _copy(state)
                state[int(ins.dst)] = None   # loaded value: data-dep
            return state
        if o == Op.MEMCPY:
            ext = self._static_extent(ins)
            pair = self.n_pairs
            self.n_pairs += 1
            doff = self._reg(state, ins.b)
            soff = self._reg(state, ins.e)
            ddev = self._dev(state, int(ins.dst),
                             bool(ins.flags & isa.FLAG_DSTDEV_REG))
            sdev = self._dev(state, int(ins.c),
                             bool(ins.flags & isa.FLAG_SRCDEV_REG))
            if ext > 0:
                self._record(rid=int(ins.a), write=True, offset=doff,
                             extent=ext, dev=ddev, pc=pc, pair=pair)
                self._record(rid=int(ins.d), write=False, offset=soff,
                             extent=ext, dev=sdev, pc=pc, pair=pair)
            return state
        if o == Op.JUMP:
            target = pc + 1 + int(ins.imm2)
            taken = _copy(state)
            if target in self.joins:
                self.joins[target] = _join_states(self.joins[target],
                                                  taken)
            else:
                self.joins[target] = taken
            if int(ins.d) == int(Alu.ALWAYS):
                return None
            return state
        if o == Op.RET:
            return None
        if o == Op.LOOP:
            # a LOOP the verifier did not record (malformed) — give up
            # on everything after it conservatively
            return None
        return state


def analyze(program: "object", loops: Sequence[_LoopLike],
            regions: Optional[RegionTable] = None) -> OpFootprint:
    """Derive the symbolic access footprint of a verified program.

    ``program`` is a ``TiaraProgram`` (duck-typed: ``.code`` and
    ``.n_params``); ``loops`` the verifier's ``LoopInfo`` records.
    ``regions`` (optional) tightens MEMCPY extents by region size.
    """
    instrs = isa.decode_program(program.code)          # type: ignore[attr-defined]
    n_params = int(program.n_params)                   # type: ignore[attr-defined]
    state: _State = [SymVal.exact(0)] * isa.NUM_REGS
    # every param register is symbolic: the datapath writes regs[i] for
    # each *provided* param, and an absent param substitutes 0 at proof
    # time — so modelling all of them is exact in both cases
    for i in range(isa.NUM_PARAM_REGS):
        state[i] = SymVal.param(i)
    state[isa.ERR_REG] = None   # mutated by failed-device MEMCPYs
    an = _Analyzer(instrs, loops, n_params, regions)
    an.walk(0, len(instrs), state)
    accesses = an.accesses
    if len(accesses) > MAX_ACCESS_RECORDS:
        # collapse to one whole-region record per (rid, write, dev)
        seen: Dict[Tuple[int, bool, Optional[int]], Access] = {}
        for a in accesses:
            key = (a.rid, a.write, a.dev)
            if key not in seen:
                seen[key] = Access(rid=a.rid, write=a.write, offset=None,
                                   extent=1, dev=a.dev, pc=a.pc)
        accesses = list(seen.values())
    return OpFootprint(accesses=tuple(accesses), n_params=n_params,
                       aux_trips=tuple(an.aux))


# ---------------------------------------------------------------------------
# wave-level conflict proof
# ---------------------------------------------------------------------------


def _lane_intervals(fp: OpFootprint, params: Sequence[int], home: int,
                    base: np.ndarray, sizes: np.ndarray,
                    pool_words: int, n_devices: int
                    ) -> Optional[Tuple[List[Tuple[int, int, int]],
                                        List[Tuple[int, int, int]]]]:
    """Substitute one lane's params into its footprint.

    Returns ``(writes, reads)`` as lists of ``(lo, hi, pair)`` flat
    half-open word intervals (device-major coordinates), or ``None``
    when the lane has a same-site MEMCPY src/dst self-overlap (the one
    same-lane case the runtime sweep flags — cannot be cleared).
    """
    writes: List[Tuple[int, int, int]] = []
    reads: List[Tuple[int, int, int]] = []
    syms = fp.lane_syms(params)
    for a in fp.accesses:
        size = int(sizes[a.rid])
        ext = min(a.extent, size)
        span: Optional[Tuple[int, int]] = None
        if a.offset is not None:
            rng = a.offset.concrete_range(syms)
            if rng is not None:
                vlo, vhi = rng
                if 0 <= vlo and vhi + ext <= size:
                    span = (vlo, vhi + ext)
        if span is None:
            span = (0, size)                    # whole region (masked)
        if a.dev is None:
            devs = list(range(n_devices))
        elif a.dev == isa.DEV_LOCAL:
            devs = [int(home)]
        else:
            devs = [int(a.dev) % n_devices]
        for d in devs:
            off = d * pool_words + int(base[a.rid])
            rec = (off + span[0], off + span[1], a.pair)
            (writes if a.write else reads).append(rec)
    # same-site MEMCPY src/dst self-overlap: the runtime sweep sees both
    # windows in the same macro-step and flags the lane against itself
    for wlo, whi, wp in writes:
        if wp < 0:
            continue
        for rlo, rhi, rp in reads:
            if rp == wp and wlo < rhi and rlo < whi:
                return None
    return writes, reads


def _merge(spans: List[Tuple[int, int, int]]) -> List[Tuple[int, int]]:
    """Merge a lane's intervals into disjoint sorted spans."""
    if not spans:
        return []
    spans.sort()
    out: List[Tuple[int, int]] = []
    clo, chi = spans[0][0], spans[0][1]
    for lo, hi, _ in spans[1:]:
        if lo <= chi:
            chi = max(chi, hi)
        else:
            out.append((clo, chi))
            clo, chi = lo, hi
    out.append((clo, chi))
    return out


def prove_wave_noconflict(
        footprints: Sequence[OpFootprint],
        params: Sequence[Sequence[int]],
        homes: Sequence[int],
        regions: RegionTable,
        n_devices: int = 1) -> bool:
    """Statically prove a wave conflict-free.

    True only when no macro-step of the wave can make the runtime
    sweep (``vm._sweep_conflict`` over ``vm.lane_intervals``) flag a
    conflict: cross-lane write/write and write/read overlaps are ruled
    out on merged per-lane footprint supersets, and each lane's MEMCPY
    sites are src/dst self-disjoint.  A ``False`` is *not* a proof of
    conflict — just "could not prove"; callers fall back to the
    runtime sweep.
    """
    B = len(footprints)
    if B <= 1:
        return True
    base, mask, _ = regions.as_arrays()
    sizes = mask + 1
    pool_words = int(regions.pool_words)
    n_devices = max(int(n_devices), 1)

    w_lo: List[int] = []
    w_hi: List[int] = []
    w_lane: List[int] = []
    r_lo: List[int] = []
    r_hi: List[int] = []
    r_lane: List[int] = []
    for b in range(B):
        lane = _lane_intervals(footprints[b], params[b], int(homes[b]),
                               base, sizes, pool_words, n_devices)
        if lane is None:
            return False
        writes, reads = lane
        for lo, hi in _merge(writes):
            w_lo.append(lo)
            w_hi.append(hi)
            w_lane.append(b)
        for lo, hi in _merge(reads):
            r_lo.append(lo)
            r_hi.append(hi)
            r_lane.append(b)

    if not w_lo:
        return True                      # read-only waves never conflict
    wl = np.asarray(w_lo, dtype=np.int64)
    wh = np.asarray(w_hi, dtype=np.int64)
    wb = np.asarray(w_lane, dtype=np.int64)
    order = np.argsort(wl, kind="stable")
    wl, wh, wb = wl[order], wh[order], wb[order]
    # global write/write sweep: per-lane spans are merged-disjoint, so
    # any overlap here is necessarily cross-lane
    if wl.size > 1:
        run_hi = np.maximum.accumulate(wh)[:-1]
        if bool(np.any(wl[1:] < run_hi)):
            return False
    if r_lo:
        rl = np.asarray(r_lo, dtype=np.int64)
        rh = np.asarray(r_hi, dtype=np.int64)
        rb = np.asarray(r_lane, dtype=np.int64)
        # writes are globally disjoint and sorted: the spans overlapping
        # read [lo, hi) are exactly w[i0:i1]
        i0 = np.searchsorted(wh, rl, side="right")
        i1 = np.searchsorted(wl, rh, side="left")
        hits = np.nonzero(i1 > i0)[0]
        for i in hits:
            if bool(np.any(wb[int(i0[i]):int(i1[i])] != rb[i])):
                return False
    return True


def describe_footprint(fp: Optional[OpFootprint],
                       regions: Optional[RegionTable] = None) -> str:
    if fp is None:
        return "(no footprint)"
    return fp.describe(regions)
