"""Cycle-level memory-processor simulator (the paper's Verilator stand-in).

The paper measures Tiara on a cycle-accurate model of the Alveo U50 build
(5 ns clock, 150-cycle PCIe DMA, 500-cycle RDMA RTT) and derives saturated
throughput from latency at 8 MPs x 12 outstanding tasks.  We replay the
*executed instruction trace* of a verified operator (from the pyvm oracle,
so timing follows the exact data-dependent path) against the same machine
parameters:

  * each instruction costs one MP cycle (sequential scalar FSM);
  * Load/Store/CAS issue a small PCIe DMA: ``dma_issue_cycles`` of channel
    occupancy, ``pcie_dma_cycles`` of latency;
  * Memcpy moves payload at the PCIe bulk rate (local) or wire rate
    (remote, plus one RTT for the write+ack);
  * async Memcpy is a true split-phase transfer: issue charges only the
    channel/wire *occupancy* (the port is busy for the transfer's
    duration), the MP keeps executing, and the copy retires in the
    background at its completion time;
  * Wait(thr) blocks the MP only until the in-flight count drops to
    ``thr`` — completions retire in completion-time order, so a
    double-buffered chain (``Wait(1)`` between chunks) overlaps chunk
    k+1's resolution with chunk k's transfer; completions that have
    already landed by the time Wait executes cost nothing;
  * the reply and request each cross half an RTT plus wire serialization
    (any still-outstanding async copy joins implicitly before the reply).

Two MP variants (DESIGN.md discusses the calibration):
  * ``pipelined=False`` — FPGA-faithful: every load stalls the FSM for the
    full DMA latency (register-chained loads are made correct by stalling
    fetch until writeback).
  * ``pipelined=True``  — the production-ASIC/software-pipelined model the
    paper's §4.6 numbers imply: loads inside a loop body whose iterations
    are *independent* (no loop-carried address chain — PagedAttention and
    MoE gather, NOT pointer chasing) hide their latency behind previous
    iterations after the first (pipeline fill), costing only channel
    occupancy.  The caller asserts independence via ``serial_chain``.

Saturated throughput uses operational bottleneck analysis, which is exact
for the steady state of identical tasks: the slowest of
{MP issue, DMA channel, wire, dispatcher-slot residency} binds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Set

from repro_torch.core import isa
from repro_torch.core.costmodel import HW, DEFAULT_HW
from repro_torch.core.isa import Op
from repro_torch.core.pyvm import TraceEvent
from repro_torch.core.verifier import VerifiedOperator
# The per-transfer DMA setup cost and wire header sizes are shared with
# the static line-rate certifier (the certificate must charge exactly
# what this simulator charges); ``core/wcet`` is their single source of
# truth and this module re-exports them for its existing callers.
from repro_torch.core.wcet import (  # noqa: F401
    DMA_SETUP_CYCLES, REPLY_BYTES, REQUEST_BYTES)


@dataclasses.dataclass
class TaskSim:
    """Timing of one operator invocation."""

    latency_us: float          # client-observed end-to-end
    nic_resident_us: float     # dispatcher-slot occupancy
    mp_cycles: int
    dma_channel_cycles: int    # PCIe small-request + bulk occupancy
    dma_small_reqs: int
    dma_bulk_bytes: int
    wire_bytes: int            # request + reply + remote Memcpy payload
    n_instr_executed: int
    async_issued: int = 0      # split-phase Memcpys issued
    wait_stall_cycles: float = 0.0   # cycles the MP blocked in WAIT /
    #                                # the implicit pre-reply join
    failed_transfers: int = 0  # injected mid-flight Memcpy aborts


def simulate_task(vop: VerifiedOperator, trace: Sequence[TraceEvent],
                  hw: HW = DEFAULT_HW, *, pipelined: bool = False,
                  serial_chain: bool = True,
                  reply_payload_bytes: int = 0,
                  serialize_async: bool = False,
                  fail_memcpy_at: Sequence[int] = ()) -> TaskSim:
    """Charge cycle costs along one executed trace.

    ``reply_payload_bytes``: data returned to the caller beyond the status
    word (e.g. the gathered KV blocks), serialized onto the wire.

    ``serialize_async=True`` treats every async Memcpy as synchronous —
    the no-overlap timeline a split-phase operator is compared against
    (``bench_async_overlap`` reports the ratio).

    ``fail_memcpy_at``: fault-injection hook — the i-th Memcpy (0-based
    issue index, sync or async) aborts halfway through its transfer: it
    occupies its port for half the full occupancy, delivers half the
    payload, and retires (with an error CQE on real hardware) at the
    abort time.  ``TaskSim.failed_transfers`` counts them; WAIT still
    joins an aborted async copy at its abort time, so the timing of the
    paper's degraded-mode fallback path (test ERR_REG, re-issue) can be
    simulated against the same trace.
    """
    clk = hw.clk_ns
    dma_lat = hw.pcie_dma_cycles
    rtt_cy = hw.rdma_rtt_cycles
    wire_bpc = hw.wire_eff_gbs * clk            # bytes per cycle
    pcie_bpc = hw.pcie_gbs * clk

    loop_pcs: Set[int] = set()
    for l in vop.loops:
        loop_pcs.update(range(l.start, l.end + 1))
    can_pipeline = pipelined and not serial_chain

    t = float(hw.dispatch_cycles)     # cycles since dispatch
    mp_cycles = 0
    chan = 0.0
    small = 0
    bulk_bytes = 0
    wire_bytes = REQUEST_BYTES + REPLY_BYTES + reply_payload_bytes
    outstanding: List[float] = []     # completion times of in-flight copies
    async_issued = 0
    wait_stall = 0.0
    seen_pcs: Set[int] = set()
    # serializing shared resources (per-NIC): the PCIe channel and the
    # network port — async transfers queue on them, which is what makes a
    # pipelined gather line-rate-bound rather than latency-bound
    chan_free = 0.0
    wire_free = 0.0
    fail_at = set(int(i) for i in fail_memcpy_at)
    memcpy_idx = 0
    failed_transfers = 0

    for ev in trace:
        mp_cycles += 1
        t += hw.instr_cycles
        if ev.op in (Op.LOAD, Op.STORE, Op.CAS, Op.CAA):
            small += 1
            chan += hw.dma_issue_cycles
            if ev.remote:
                t += rtt_cy
                wire_bytes += 2 * 32       # small RDMA read/write + ack
            else:
                start = max(t, chan_free)
                chan_free = start + hw.dma_issue_cycles
                if can_pipeline and ev.pc in loop_pcs and ev.pc in seen_pcs:
                    t = start + hw.dma_issue_cycles  # latency pipelined away
                else:
                    t = start + dma_lat
                    seen_pcs.add(ev.pc)
        elif ev.op == Op.MEMCPY:
            nbytes = ev.n_words * isa.WORD_BYTES
            if memcpy_idx in fail_at:
                # mid-flight abort: half the payload crossed before the
                # port errored; the completion (a NAK) still pays the
                # latency leg below
                nbytes //= 2
                failed_transfers += 1
            memcpy_idx += 1
            if ev.remote:
                # one side is usually the local pool: the stream crosses
                # PCIe *and* the wire (cut-through at the slower rate)
                local_side = not (ev.src_remote and ev.dst_remote)
                eff_bpc = min(wire_bpc, pcie_bpc) if local_side else wire_bpc
                start = max(t, wire_free, chan_free if local_side else 0.0)
                occ = DMA_SETUP_CYCLES + nbytes / eff_bpc
                wire_free = start + occ
                if local_side:
                    chan_free = start + occ
                    chan += occ
                done = start + occ + rtt_cy            # write + ack
                wire_bytes += nbytes + 32
            else:
                start = max(t, chan_free)
                occ = DMA_SETUP_CYCLES + nbytes / pcie_bpc
                chan_free = start + occ
                done = start + dma_lat + occ
                chan += occ
                bulk_bytes += nbytes
            if ev.is_async and not serialize_async:
                # split-phase: the port occupancy is charged above, the
                # MP moves on; the transfer retires at `done`
                outstanding.append(done)
                async_issued += 1
            else:
                t = done
        elif ev.op == Op.WAIT:
            # completions retire in completion-time order; Wait(thr)
            # blocks only until at most `thr` transfers remain in flight
            outstanding = [d for d in outstanding if d > t]
            thr = max(int(getattr(ev, "wait_thr", 0)), 0)
            if len(outstanding) > thr:
                outstanding.sort()
                t_new = outstanding[len(outstanding) - thr - 1]
                wait_stall += max(t_new - t, 0.0)
                t = max(t, t_new)
                outstanding = [d for d in outstanding if d > t]
        # NOP/MOVI/ALU/JUMP/LOOP/RET: 1 MP cycle, already charged

    if outstanding:                    # implicit completion before reply
        t_new = max(outstanding)
        wait_stall += max(t_new - t, 0.0)
        t = max(t, t_new)

    nic_resident_us = t * clk / 1e3
    latency_us = (hw.rtt_us / 2                      # request flight
                  + REQUEST_BYTES / (wire_bpc) * clk / 1e3
                  + nic_resident_us
                  + hw.rtt_us / 2                    # reply flight
                  + (REPLY_BYTES + reply_payload_bytes) / wire_bpc * clk / 1e3)
    return TaskSim(latency_us=latency_us, nic_resident_us=nic_resident_us,
                   mp_cycles=mp_cycles, dma_channel_cycles=int(chan),
                   dma_small_reqs=small, dma_bulk_bytes=bulk_bytes,
                   wire_bytes=wire_bytes, n_instr_executed=len(trace),
                   async_issued=async_issued, wait_stall_cycles=wait_stall,
                   failed_transfers=failed_transfers)


def overlap_speedup(vop: VerifiedOperator, trace: Sequence[TraceEvent],
                    hw: HW = DEFAULT_HW, **kwargs: Any) -> float:
    """NIC-residency ratio of the serialized timeline (every Memcpy
    synchronous) over the split-phase one — how much latency the async
    issue + deferred retirement actually hides for this trace."""
    asyn = simulate_task(vop, trace, hw, **kwargs)
    sync = simulate_task(vop, trace, hw, serialize_async=True, **kwargs)
    return sync.nic_resident_us / max(asyn.nic_resident_us, 1e-12)


def saturated_throughput_mops(sim: TaskSim, hw: HW = DEFAULT_HW) -> float:
    """Bottleneck law over shared resources, in Mops."""
    clk_us = hw.clk_ns / 1e3
    demands_us: Dict[str, float] = {
        "mp": sim.mp_cycles * clk_us / hw.n_mps,
        "dma_channel": sim.dma_channel_cycles * clk_us,
        "wire": sim.wire_bytes / hw.wire_bytes_per_us,
        "slots": sim.nic_resident_us / hw.slots,
    }
    return 1.0 / max(demands_us.values())


def bottleneck(sim: TaskSim, hw: HW = DEFAULT_HW) -> str:
    clk_us = hw.clk_ns / 1e3
    demands_us: Dict[str, float] = {
        "mp": sim.mp_cycles * clk_us / hw.n_mps,
        "dma_channel": sim.dma_channel_cycles * clk_us,
        "wire": sim.wire_bytes / hw.wire_bytes_per_us,
        "slots": sim.nic_resident_us / hw.slots,
    }
    return max(demands_us, key=lambda k: demands_us[k])


def effective_gather_gbs(sim: TaskSim, payload_bytes: int,
                         hw: HW = DEFAULT_HW) -> float:
    """Fig. 10 metric: payload delivered / end-to-end latency."""
    return payload_bytes / sim.latency_us / 1e3
