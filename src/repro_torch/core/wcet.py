"""Registration-time line-rate certification — static WCET, traffic,
and occupancy bounds (the NIC-admission story of paper §3.3).

The verifier proves *termination* (a worst-case step count); nothing
there bounds an operator's *cost*: cycles, memory traffic, or port
occupancy.  This module closes that gap at the eBPF-load moment.
:func:`certify` abstractly interprets a verified program against the
``simulator.py`` hardware model and attaches a
:class:`LineRateCertificate` to every ``VerifiedOperator`` — sound
upper bounds the rest of the stack *enforces*:

* ``OperatorRegistry.register`` rejects over-:class:`Budget` operators
  with a per-pc diagnostic (the eBPF "program too large" moment);
* ``ServingLoop.submit`` fail-fasts ``STATUS_TIMEOUT`` at admission
  when the certified WCET already exceeds the post's deadline — the
  post is never queued, never launched, and still retires exactly one
  CQE;
* ``DispatchCostModel.wave_us`` clamps its learned EWMA to the wave's
  summed certified bound, so a cold or poisoned EWMA can never price a
  wave above what is statically possible.

Soundness argument (property-tested in ``tests/test_wcet.py`` and
re-proved over a seeded corpus on every ``benchmarks/bench_wcet.py``
run — the ``wcet_sound_ok`` hard bit):

1. The *serialized* simulator timeline (every MEMCPY synchronous)
   upper-bounds the split-phase one: by induction over events, the
   async timeline's clock, channel-free and wire-free horizons, and
   every outstanding completion time all stay <= the serialized clock
   (a serialized MEMCPY absorbs its occupancy *and* latency into ``t``,
   so ``chan_free``/``wire_free`` never run ahead of it, and WAIT/the
   implicit pre-reply join can only wait for completions that the
   serialized clock has already passed).
2. In the serialized timeline every event starts at ``t`` (the ports
   are never ahead of the clock), so total time is the *sum* of per-
   event charges — and each charge is maximized here over every device
   resolution (remote unless the operand is statically ``DEV_LOCAL``),
   every dynamic MEMCPY length (the static cap ``imm``, which the
   datapath always applies, further clamped by the region sizes —
   exactly ``pyvm``'s clamp), and the slower of the wire/PCIe rates.
3. Per-pc execution counts are bounded by the verifier's loop-cap
   multipliers (forward jumps only *skip* work), so scaling each pc's
   worst charge by its multiplier bounds any real trace.

Pipelined MPs, mid-flight MEMCPY aborts, and reply payloads only
*reduce* the charged time relative to this bound (the certificate is
computed at ``reply_payload_bytes=0``, which both the latency and the
wire-byte figures state explicitly).

Import topology: the verifier imports this module, so nothing here may
import ``verifier``/``pyvm``/``simulator``.  The three wire/DMA
constants that used to live in ``simulator.py`` moved here (simulator
re-imports them); loop metadata arrives structurally via
``access.LoopLike`` and trip multipliers via ``access.loop_multiplier``
(the verifier's step-bound definition, so ``mp_cycles == step_bound``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import isa
from repro_torch.core.access import LoopLike, loop_multiplier
from repro_torch.core.costmodel import DEFAULT_HW, HW
from repro_torch.core.isa import Instr, Op
from repro_torch.core.memory import RegionTable
from repro_torch.core.program import TiaraProgram

# Bulk-DMA engine setup cost per transfer (descriptor fetch + doorbell),
# [calib: anchors Fig. 10's ~8.7 GB/s at 4 KB blocks].  Shared with the
# trace simulator (simulator.py re-imports these three).
DMA_SETUP_CYCLES = 18
REQUEST_BYTES = 64      # op id + 8 param registers + header
REPLY_BYTES = 16        # status + return value + header

_SMALL_OPS = (Op.LOAD, Op.STORE, Op.CAS, Op.CAA)
_SMALL_WIRE_BYTES = 2 * 32      # small RDMA read/write + ack


@dataclasses.dataclass(frozen=True)
class PcCost:
    """Worst-case charges attributed to one static instruction site."""

    pc: int
    op: str                 # mnemonic, for diagnostics
    count: int              # worst-case executions (enclosing-loop caps)
    cycles: float           # serialized NIC-resident cycles charged here
    wire_bytes: int
    memcpy_bytes: int

    def to_json(self) -> Dict[str, object]:
        return {"pc": self.pc, "op": self.op, "count": self.count,
                "cycles": self.cycles, "wire_bytes": self.wire_bytes,
                "memcpy_bytes": self.memcpy_bytes}


# resource name -> PcCost attribute the per-pc ranking reads
_RESOURCE_ATTR = {"cycles": "cycles", "wire_bytes": "wire_bytes",
                  "memcpy_bytes": "memcpy_bytes"}


@dataclasses.dataclass(frozen=True)
class LineRateCertificate:
    """Sound static upper bounds on one operator's worst-case cost.

    Every figure bounds the corresponding ``TaskSim`` field of *any*
    trace of the operator (at ``reply_payload_bytes=0``): cycles/us
    bound the NIC-resident timeline, ``words_read``/``words_written``
    bound the exact dynamic word traffic, ``memcpy_bytes`` the summed
    MEMCPY payload, ``dma_channel_cycles``/``wire_bytes`` the
    per-resource occupancy the bottleneck law divides by.
    """

    wcet_cycles: float          # NIC-resident cycles, incl. dispatch
    wcet_nic_us: float          # = wcet_cycles * clk
    wcet_latency_us: float      # client end-to-end, zero reply payload
    mp_cycles: int              # issue-slot bound (== verifier step bound)
    words_read: int
    words_written: int
    memcpy_bytes: int           # summed MEMCPY payload (local + remote)
    dma_small_reqs: int
    dma_channel_cycles: float
    wire_bytes: int             # request + reply + worst remote traffic
    bottleneck: str             # statically predicted binding resource
    per_pc: Tuple[PcCost, ...]  # cycle/traffic attribution per site

    def hottest(self, resource: str = "cycles") -> Optional[PcCost]:
        """The site contributing most to ``resource`` ("cycles",
        "wire_bytes", or "memcpy_bytes")."""
        attr = _RESOURCE_ATTR[resource]
        ranked = [p for p in self.per_pc if getattr(p, attr) > 0]
        if not ranked:
            return None
        return max(ranked, key=lambda p: float(getattr(p, attr)))

    def to_json(self) -> Dict[str, object]:
        return {
            "wcet_cycles": self.wcet_cycles,
            "wcet_nic_us": self.wcet_nic_us,
            "wcet_latency_us": self.wcet_latency_us,
            "mp_cycles": self.mp_cycles,
            "words_read": self.words_read,
            "words_written": self.words_written,
            "memcpy_bytes": self.memcpy_bytes,
            "dma_small_reqs": self.dma_small_reqs,
            "dma_channel_cycles": self.dma_channel_cycles,
            "wire_bytes": self.wire_bytes,
            "bottleneck": self.bottleneck,
            "per_pc": [p.to_json() for p in self.per_pc],
        }

    def describe(self) -> str:
        """One-line summary for ``registry.dump()`` / quickstart."""
        return (f"wcet {self.wcet_nic_us:.2f}us nic / "
                f"{self.wcet_latency_us:.2f}us e2e, "
                f"{self.wcet_cycles:.0f} cycles, "
                f"rd {self.words_read} wr {self.words_written} words, "
                f"memcpy {self.memcpy_bytes}B, wire {self.wire_bytes}B, "
                f"bottleneck {self.bottleneck}")


def _static_local(flags: int, field: int, reg_flag: int) -> bool:
    """True iff the device operand is statically the executing host
    (``DEV_LOCAL``) — the only case the worst-case analysis may treat
    as local; register-held or non-local static devices charge the
    remote worst case."""
    return not (flags & reg_flag) and int(field) == isa.DEV_LOCAL


def memcpy_word_bound(ins: Instr,
                      regions: Optional[RegionTable]) -> int:
    """Sound static bound on one MEMCPY's transferred words.  The
    datapath clamps even a register-held length at the static ``imm``
    cap, then at the burst limit and both region sizes — the exact
    ``pyvm`` clamp sequence, evaluated on the caps."""
    ext = min(int(ins.imm), isa.MAX_MEMCPY_WORDS)
    if regions is not None:
        n = len(regions)
        if 0 <= int(ins.a) < n:
            ext = min(ext, int(regions[int(ins.a)].size))
        if 0 <= int(ins.d) < n:
            ext = min(ext, int(regions[int(ins.d)].size))
    return max(ext, 0)


def certify(program: TiaraProgram, loops: Sequence[LoopLike],
            regions: Optional[RegionTable] = None,
            hw: HW = DEFAULT_HW) -> LineRateCertificate:
    """Derive the operator's line-rate certificate by abstract
    interpretation against the hardware model (see module docstring for
    the soundness argument)."""
    clk = hw.clk_ns
    dma_lat = float(hw.pcie_dma_cycles)
    rtt_cy = float(hw.rdma_rtt_cycles)
    wire_bpc = hw.wire_eff_gbs * clk            # bytes per cycle
    pcie_bpc = hw.pcie_gbs * clk
    worst_bpc = min(wire_bpc, pcie_bpc)         # cut-through worst case
    worst_lat = max(rtt_cy, dma_lat)

    instrs = isa.decode_program(program.code)
    per_pc: List[PcCost] = []
    cycles = float(hw.dispatch_cycles)
    mp_cycles = 0
    words_read = 0
    words_written = 0
    memcpy_bytes = 0
    dma_small = 0
    chan = 0.0
    wire = REQUEST_BYTES + REPLY_BYTES

    for pc, ins in enumerate(instrs):
        mult = loop_multiplier(loops, pc)
        if mult == 0:
            continue
        op = ins.op
        t = float(hw.instr_cycles)
        wb = 0
        mb = 0
        if op in _SMALL_OPS:
            dma_small += mult
            chan += mult * hw.dma_issue_cycles
            if _static_local(ins.flags, ins.e, isa.FLAG_DEV_REG):
                t += dma_lat
            else:
                t += worst_lat
                wb = _SMALL_WIRE_BYTES
            if op != Op.STORE:          # LOAD/CAS/CAA read the old word
                words_read += mult
            if op != Op.LOAD:           # STORE/CAS/CAA may write it
                words_written += mult
        elif op == Op.MEMCPY:
            n_words = memcpy_word_bound(ins, regions)
            nbytes = n_words * isa.WORD_BYTES
            words_read += mult * n_words
            words_written += mult * n_words
            mb = nbytes
            dst_local = _static_local(ins.flags, ins.dst,
                                      isa.FLAG_DSTDEV_REG)
            src_local = _static_local(ins.flags, ins.c,
                                      isa.FLAG_SRCDEV_REG)
            if dst_local and src_local:
                occ = DMA_SETUP_CYCLES + nbytes / pcie_bpc
                t += dma_lat + occ
            else:
                occ = DMA_SETUP_CYCLES + nbytes / worst_bpc
                t += occ + worst_lat
                wb = nbytes + 32        # payload + write-ack header
            chan += mult * occ
        # NOP/MOVI/ALU/JUMP/LOOP/WAIT/RET: one MP cycle.  WAIT charges
        # nothing beyond it: in the serialized bound nothing is ever
        # outstanding, and invariant (1) covers the async stalls.
        mp_cycles += mult
        cyc = mult * t
        cycles += cyc
        wire += mult * wb
        memcpy_bytes += mult * mb
        per_pc.append(PcCost(pc=pc, op=op.name, count=mult, cycles=cyc,
                             wire_bytes=mult * wb, memcpy_bytes=mult * mb))

    clk_us = clk / 1e3
    nic_us = cycles * clk_us
    latency_us = (hw.rtt_us
                  + (REQUEST_BYTES + REPLY_BYTES) / wire_bpc * clk_us
                  + nic_us)
    demands_us = {
        "mp": mp_cycles * clk_us / hw.n_mps,
        "dma_channel": chan * clk_us,
        "wire": wire / hw.wire_bytes_per_us,
        "slots": nic_us / hw.slots,
    }
    bottleneck = max(demands_us, key=lambda k: demands_us[k])
    return LineRateCertificate(
        wcet_cycles=cycles, wcet_nic_us=nic_us,
        wcet_latency_us=latency_us, mp_cycles=mp_cycles,
        words_read=words_read, words_written=words_written,
        memcpy_bytes=memcpy_bytes, dma_small_reqs=dma_small,
        dma_channel_cycles=chan, wire_bytes=wire, bottleneck=bottleneck,
        per_pc=tuple(per_pc))


# ---------------------------------------------------------------------------
# budgets — the registration-time admission contract
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Budget:
    """Registration-time admission budget.  ``None`` fields are
    unlimited; a :class:`LineRateCertificate` exceeding any limit makes
    ``OperatorRegistry.register`` reject the operator eBPF-style with a
    per-pc diagnostic (see :meth:`violations`)."""

    max_cycles: Optional[float] = None      # worst-case NIC-resident cycles
    max_wire_bytes: Optional[int] = None    # worst-case wire traffic
    max_memcpy_bytes: Optional[int] = None  # worst-case MEMCPY payload
    max_latency_us: Optional[float] = None  # worst-case end-to-end latency

    def violations(self, cert: LineRateCertificate) -> List[str]:
        """Budget-violation diagnostics, each naming the resource, the
        certified worst case, the limit, and the hottest contributing
        pc — empty when the certificate fits."""
        checks: Tuple[Tuple[str, Optional[float], float, str], ...] = (
            ("cycles", self.max_cycles, cert.wcet_cycles, "cycles"),
            ("wire bytes", None if self.max_wire_bytes is None
             else float(self.max_wire_bytes), float(cert.wire_bytes),
             "wire_bytes"),
            ("memcpy bytes", None if self.max_memcpy_bytes is None
             else float(self.max_memcpy_bytes), float(cert.memcpy_bytes),
             "memcpy_bytes"),
            ("latency us", self.max_latency_us, cert.wcet_latency_us,
             "cycles"),
        )
        out: List[str] = []
        for resource, limit, value, attr in checks:
            if limit is None or value <= limit:
                continue
            hot = cert.hottest(attr)
            where = "" if hot is None else (
                f" (hottest: pc {hot.pc} {hot.op} x{hot.count}, "
                f"{float(getattr(hot, _RESOURCE_ATTR[attr])):.0f} "
                f"{_RESOURCE_ATTR[attr]})")
            out.append(f"certified worst-case {resource} {value:.0f} "
                       f"exceeds budget {limit:.0f}{where}")
        return out


# Default admission contract: roughly 10 ms of NIC residency and 64 MB
# of traffic per invocation — far above any line-rate operator (every
# stock workload certifies orders of magnitude below), low enough to
# reject unbounded-cost programs at load time.  Gated shrink-only by
# tools/check_budgets.py against tools/wcet_baseline.json.
DEFAULT_BUDGET = Budget(max_cycles=float(1 << 21),
                        max_wire_bytes=64 << 20,
                        max_memcpy_bytes=64 << 20,
                        max_latency_us=20_000.0)
