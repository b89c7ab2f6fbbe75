"""Hardware constants and analytical baseline models (paper §4.1).

The paper's own methodology: Tiara latencies are cycle-accurate on a
calibrated simulator (5 ns clock, 150-cycle PCIe DMA, 500-cycle RDMA RTT);
the non-Tiara baselines are *analytical models* with published constants.
This module carries those constants and the baseline models; the Tiara
side is `repro.core.simulator` (trace-driven, cycle-level).

Every constant is either quoted directly from the paper (marked [paper])
or calibrated to reproduce a number the paper reports (marked [calib],
with the anchor).  Benchmarks print derived vs. paper-claimed side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HW:
    # --- clock & fabric [paper §4.1] -----------------------------------
    clk_ns: float = 5.0                  # 200 MHz MP clock
    pcie_dma_cycles: int = 150           # 0.75 us host DRAM access via PCIe
    rdma_rtt_cycles: int = 500           # 2.5 us RDMA Read RTT
    n_mps: int = 8
    tasks_per_mp: int = 12               # 96 dispatcher slots
    # --- bandwidths ------------------------------------------------------
    wire_gbps: float = 100.0             # 100 GbE
    wire_eff_gbs: float = 12.0           # effective line rate [paper §4.6]
    pcie_gbs: float = 12.8               # PCIe 3 x16 effective bulk
    # PCIe small-request channel: one outstanding DMA issued per
    # ``dma_issue_cycles`` (random 64 B read rate ~100 M/s) [calib:
    # anchors Tiara graph throughput ~29.5 Mops at depth 3]
    dma_issue_cycles: int = 2
    # --- MP micro-costs ---------------------------------------------------
    instr_cycles: int = 1                # scalar FSM, 1 op/cycle
    dispatch_cycles: int = 4             # task setup: op_id lookup + regs
    # --- baseline systems -------------------------------------------------
    rtt_us: float = 2.5                  # [paper]
    rpc_dispatch_us: float = 1.5         # [paper]
    rpc_hop_us: float = 0.17             # cached-DRAM hop [paper]
    rpc_core_rate_mops: float = 0.222    # [calib: 16 cores = 3.55 Mops §4.2]
    rpc_cores: int = 16                  # paper's RPC baseline core count
    rpc_cores_sat: int = 22              # saturation configuration
    redn_wr_us: float = 1.1              # per chained WR [paper]
    prism_hop_us: float = 0.5            # [paper]
    rdma_verb_mops: float = 26.0         # [calib: RedN "26x below RDMA at
    #                                       depth 1" with RedN ~1 Mops §4.2]
    client_wr_build_us: float = 1.2      # client-side WR construction
    #                                    # [calib: batched RDMA 2.7 GB/s at
    #                                    #  4 KB and ~4.3 GB/s at 8 KB, Fig 10]
    rpc_per_expert_us: float = 1.225     # [calib: RPC 41.7 us at k=32 §4.5]

    @property
    def dma_us(self) -> float:
        return self.pcie_dma_cycles * self.clk_ns / 1e3

    @property
    def slots(self) -> int:
        return self.n_mps * self.tasks_per_mp

    @property
    def wire_bytes_per_us(self) -> float:
        return self.wire_eff_gbs * 1e3

    @property
    def pcie_bytes_per_us(self) -> float:
        return self.pcie_gbs * 1e3


DEFAULT_HW = HW()


# =============================================================================
# Analytical baselines — one-sided RDMA, RPC, RedN, PRISM
# =============================================================================

def rdma_chain_latency_us(depth: int, hw: HW = DEFAULT_HW) -> float:
    """Dependent chain of ``depth`` one-sided reads: depth x RTT."""
    return depth * hw.rtt_us


def rdma_chain_throughput_mops(depth: int, hw: HW = DEFAULT_HW) -> float:
    """Verb rate divided across the ``depth`` verbs each op needs."""
    return hw.rdma_verb_mops / max(depth, 1)


def rpc_latency_us(hops: int, hw: HW = DEFAULT_HW) -> float:
    """One RTT + dispatch + node-local cached-DRAM hops."""
    return hw.rtt_us + hw.rpc_dispatch_us + hops * hw.rpc_hop_us


def rpc_throughput_mops(hops: int, hw: HW = DEFAULT_HW,
                        cores: int = 0) -> float:
    del hops  # the paper's RPC rate is message-rate-bound, not hop-bound
    return (cores or hw.rpc_cores) * hw.rpc_core_rate_mops


def redn_latency_us(wrs: int, hw: HW = DEFAULT_HW) -> float:
    """Doorbell-ordered WR chain on the memory-side NIC: 1 RTT + per-WR
    fetch cost (RedN's throughput killer, paper §2.2)."""
    return hw.rtt_us + wrs * hw.redn_wr_us


def redn_throughput_mops(wrs: int, hw: HW = DEFAULT_HW) -> float:
    """8 processing units serialized by doorbell ordering."""
    return min(hw.n_mps / (wrs * hw.redn_wr_us), 1.0)


def prism_latency_us(hops: int, hw: HW = DEFAULT_HW) -> float:
    return hw.rtt_us + hops * hw.prism_hop_us


def prism_throughput_mops(hops: int, hw: HW = DEFAULT_HW) -> float:
    """PRISM tracks RDMA (NIC-native, no doorbell ordering) [paper §4.2]."""
    return rdma_chain_throughput_mops(hops, hw)


# --- workload-specific baselines -------------------------------------------

def rdma_ptw_latency_us(levels: int = 3, hw: HW = DEFAULT_HW) -> float:
    """k levels + final data fetch: (k+1) RTTs (Table 1)."""
    return (levels + 1) * hw.rtt_us


def rdma_lock_latency_us(hw: HW = DEFAULT_HW) -> float:
    """CAS + read + 2 replica writes + release: 5 sequential RTTs."""
    return 5 * hw.rtt_us


def tiara_lock_latency_us(hw: HW = DEFAULT_HW) -> float:
    """Client->primary, local CAS + parallel replica writes, ack: 2 RTTs."""
    return 2 * hw.rtt_us


def redn_lock_latency_us(hw: HW = DEFAULT_HW) -> float:
    """1 RTT but ~6 WRs of doorbell-ordered chain."""
    return hw.rtt_us + 6 * hw.redn_wr_us


def rpc_lock_latency_us(hw: HW = DEFAULT_HW) -> float:
    return 2 * hw.rtt_us + hw.rpc_dispatch_us + 4 * hw.rpc_hop_us


# Contention scaling factors, calibrated to Fig. 9's reported degradations
# between 1 and 16 clients (RDMA 2.5x, RedN 4.9x, RPC ~1.2x; Tiara read off
# the figure at ~1.9x).  latency(c) = latency(1) * (1 + alpha * (c - 1)).
LOCK_CONTENTION_ALPHA = {
    "rdma": (2.5 - 1) / 15,
    "redn": (4.9 - 1) / 15,
    "rpc": (1.2 - 1) / 15,
    "tiara": (1.94 - 1) / 15,
}


def lock_latency_contended_us(system: str, clients: int,
                              hw: HW = DEFAULT_HW) -> float:
    base = {
        "rdma": rdma_lock_latency_us(hw),
        "redn": redn_lock_latency_us(hw),
        "rpc": rpc_lock_latency_us(hw),
        "tiara": tiara_lock_latency_us(hw),
    }[system]
    return base * (1 + LOCK_CONTENTION_ALPHA[system] * (clients - 1))


# --- PagedAttention / bulk gather baselines (Fig. 10) ------------------------

def batched_rdma_gather_gbs(total_bytes: int, block_bytes: int,
                            hw: HW = DEFAULT_HW) -> float:
    """Optimally batched RDMA: 1 RTT for the block table, then the client
    builds one WR per block and posts the batch (Table 1 footnote).  WR
    construction happens before the second round can complete, so it
    serializes with the transfer — this is what keeps batched RDMA at
    2.7 GB/s for 4 KB blocks in Fig. 10."""
    n = max(total_bytes // block_bytes, 1)
    build_us = n * hw.client_wr_build_us
    transfer_us = total_bytes / hw.wire_bytes_per_us
    lat = 2 * hw.rtt_us + build_us + transfer_us
    return total_bytes / lat / 1e3  # GB/s

def rpc_gather_gbs(total_bytes: int, block_bytes: int,
                   hw: HW = DEFAULT_HW) -> float:
    """Server-side RPC resolves and streams; per-block touch cost on the
    server CPU plus wire time."""
    n = max(total_bytes // block_bytes, 1)
    per_block_us = hw.rpc_hop_us * 2
    lat = hw.rtt_us + hw.rpc_dispatch_us + max(n * per_block_us,
                                               total_bytes / hw.wire_bytes_per_us)
    return total_bytes / lat / 1e3


def redn_gather_gbs(total_bytes: int, block_bytes: int,
                    hw: HW = DEFAULT_HW) -> float:
    """WR chain per block: doorbell ordering costs ~1.1 us per block."""
    n = max(total_bytes // block_bytes, 1)
    lat = hw.rtt_us + max(n * hw.redn_wr_us,
                          total_bytes / hw.wire_bytes_per_us)
    return total_bytes / lat / 1e3


# --- MoE expert gather (§4.5) ------------------------------------------------

def rdma_moe_latency_us(k: int, slab_bytes: int = 8192,
                        hw: HW = DEFAULT_HW) -> float:
    """2 RTTs (table read, then batched slab reads) + wire serialization.
    [calib: the paper's 26.7 us at k=32 is exactly 2xRTT + 256 KB/12 GB/s,
    i.e. it charges no WR-build cost here, unlike Fig. 10.]"""
    return 2 * hw.rtt_us + k * slab_bytes / hw.wire_bytes_per_us


def rpc_moe_latency_us(k: int, slab_bytes: int = 8192,
                       hw: HW = DEFAULT_HW) -> float:
    """Per-expert dispatch dominates as k grows (paper §4.5).
    [calib: 41.7 us at k=32 = RTT + 32 x 1.225 us.]"""
    del slab_bytes
    return hw.rtt_us + k * hw.rpc_per_expert_us


# --- offload crossover model (Figs. 2 & 3) -----------------------------------

def offload_chain_latency_us(host_mem_us: float, depth: int,
                             hw: HW = DEFAULT_HW) -> float:
    """Generic memory-side offload: 1 RTT + depth x host-memory accesses.
    Offloading beats client-side RDMA iff host_mem_us < RTT (Fig. 3)."""
    return hw.rtt_us + depth * host_mem_us


BF2_HOST_ACCESS_US = 1.7      # BlueField-2 internal RDMA hop [paper §2.2]
BF3_DPA_HOST_ACCESS_US = 0.85  # BF-3 DPA datasheet [paper §2.2]
TIARA_HOST_ACCESS_US = 0.75    # PCIe DMA [paper]
BF2_CABLE_RTT_US = 1.9         # back-to-back DAC cable [paper §2.2]


# =============================================================================
# Adaptive dispatch: the software-engine cost model
# =============================================================================
#
# The registry's ``mode="auto"`` has to pick an execution engine per call:
# the scalar interpreter (one launch per request), the batch-parallel
# lockstep interpreter (one launch per wave, exact under contention), the
# trace-compiled straight-line path (fastest, needs a compilable CFG and
# a conflict-free wave), or — for mixed-op waves — the one-launch mixed
# engine vs. stable-sort-and-segment through the compiled traces.  The
# analytical model below predicts wall-clock per call from batch size,
# trace length, op-mix composition, and a contention-rate hint, using
# per-engine launch/step constants calibrated against the measured
# ``BENCH_vm_throughput.json`` sweep (10-hop GraphWalk at B=1/64/1024 on
# the CPU backend; [calib] marks each anchor).  Absolute numbers are
# host-dependent — what the decision needs is the *relative* shape:
# launches amortize over B, the vectorized macro-step cost is affine in
# B, and the compiled trace's per-lane cost is ~20x smaller than the
# interpreter's.  ``EngineCost.measured()`` rescales the launch constant
# to the running host.


@dataclasses.dataclass(frozen=True)
class EngineCost:
    """Per-engine launch/step cost constants (microseconds).

    [calib] anchors: the reference's BENCH_vm_throughput.json sweep, on
    the XLA CPU backend (graph_walk depth=10, step bound ~38, B in {1, 64, 1024}): interp
    B=1 ~2.5 ms/call, batched B=64/1024 ~18/~130 ms, compiled B=1/1024
    ~1.2/~7 ms, fit to the affine forms below.  Individual runs drift
    ±20% — the constants carry the *relative shape* (launches amortize
    over B; compiled per-lane cost ~20x below the interpreter's), which
    is all the argmin decisions consume.
    """

    launch_us: float = 1000.0      # one XLA dispatch from Python [calib]
    interp_step_us: float = 40.0   # scalar switch interpreter, per step [calib]
    vstep_us: float = 280.0        # vectorized macro-step, base [calib]
    vlane_us: float = 3.2          # vectorized macro-step, per lane [calib]
    cstep_us: float = 3.0          # compiled trace, per position [calib]
    clane_us: float = 0.15         # compiled trace, per position-lane [calib]
    serial_lane_us: float = 12.0   # contended macro-step scan, per lane
    # Double-buffered gather chains: the split-phase schedule hides this
    # fraction of the chain's per-position cost (chunk k+1's gather
    # overlaps chunk k's scatter) at a fixed per-chunk scheduling cost.
    # ``dbuf_overlap`` starts at the cycle simulator's prior and is the
    # term ``DispatchCostModel.observe_overlap`` learns online from
    # measured serialized-vs-double-buffered pairs.
    dbuf_overlap: float = 0.45
    dbuf_chunk_us: float = 60.0    # per-chunk scatter setup/scheduling
    # Chunk size contract: compile.DBUF_CHUNK reads this field's
    # *default* once at import, so retuning means editing the default
    # here (pricing and the emitted schedule then move together).
    # Overriding it on an EngineCost *instance* is unsupported — it
    # would change pricing only, not the engine's schedule.
    dbuf_chunk_iters: int = 8
    # One cross-device collective group on the mesh axis (all_gather of
    # the requests + psum routing the words back) — the sharded engine
    # pays a fixed number of these per macro-step.  [calib: a scalar
    # psum over 8 forced-host CPU devices measures ~50-150 us; a real
    # NIC fabric hop is 3 orders of magnitude cheaper, so re-calibrate
    # on hardware.]
    collective_us: float = 80.0
    # Collectives per conflict-free sharded macro-step, busy-step upper
    # bound: the interval gather for the conflict sweep plus the
    # word-read, word-write, and memcpy window routes.  The three data
    # routes are any_lane-gated (skipped on macro-steps with no such
    # op), so real waves average below this.
    collectives_per_step: int = 4
    # Building an engine at a new (program, batch) shape is a full XLA
    # compile — seconds, not microseconds [calib: jit of one engine ~2 s
    # on the dev host].  A serving loop reuses each built shape across
    # many waves, so the model charges the amortized share per call.
    compile_us: float = 2_000_000.0
    compile_amortization: int = 100  # expected same-shape waves per build

    def _miss(self, cached: bool) -> float:
        return 0.0 if cached else self.compile_us / max(
            self.compile_amortization, 1)

    # -- per-engine per-call predictions ---------------------------------

    def batched_us(self, batch: int, steps: int,
                   contention_rate: float = 0.0, *,
                   cached: bool = True) -> float:
        """One lockstep launch; contended macro-steps pay the serialized
        scan instead of the vectorized step."""
        if batch <= 1:
            # B=1 skips the conflict machinery: the scalar datapath
            return self._miss(cached) + self.launch_us \
                + steps * self.interp_step_us
        contended = min(max(contention_rate, 0.0), 1.0) * steps
        clean = steps - contended
        return (self._miss(cached) + self.launch_us
                + clean * (self.vstep_us + batch * self.vlane_us)
                + contended * (self.vstep_us
                               + batch * self.serial_lane_us))

    def compiled_us(self, batch: int, trace_len: int, *,
                    cached: bool = True) -> float:
        """One straight-line launch over the unrolled trace."""
        return self._miss(cached) + self.launch_us \
            + trace_len * (self.cstep_us + batch * self.clane_us)

    def compiled_dbuf_us(self, batch: int, trace_len: int,
                         chain_iters: int, *,
                         cached: bool = True) -> float:
        """The double-buffered compiled trace: the gather-chain portion
        (5 trace positions per chain iteration) is discounted by the
        learned overlap term, but every ``dbuf_chunk_iters`` iterations
        pay a fixed chunk-scheduling cost — so short chains lose to the
        monolithic trace and long chains win, which is exactly the
        crossover ``mode="auto"`` needs to find."""
        chain_steps = min(max(5 * chain_iters, 0), trace_len)
        straight = trace_len - chain_steps
        per_pos = self.cstep_us + batch * self.clane_us
        n_chunks = -(-max(chain_iters, 0) // max(self.dbuf_chunk_iters, 1))
        # a chain that fits in one chunk is emitted monolithically (the
        # engine only chunks past DBUF_CHUNK iterations): no overlap to
        # win, only the scheduling cost to lose
        overlap = self.dbuf_overlap if chain_iters > self.dbuf_chunk_iters \
            else 0.0
        return (self._miss(cached) + self.launch_us
                + straight * per_pos
                + chain_steps * per_pos * (1.0 - overlap)
                + n_chunks * self.dbuf_chunk_us)

    def sharded_us(self, batch: int, n_devices: int, steps: int,
                   contention_rate: float = 0.0, *,
                   batch_per_device: Optional[int] = None,
                   cached: bool = True,
                   noconflict: bool = False) -> float:
        """One shard_map launch over the device mesh: per-device
        sub-waves advance in lockstep, each macro-step paying the fixed
        collective group that routes remote LOAD/MEMCPY traffic.  The
        lockstep lane count is the *largest* sub-wave — pass the plan's
        ``batch_per_device`` so home-skewed waves are costed at their
        real width (a fully skewed wave runs ``batch`` lanes on every
        device and sharding buys nothing); without it a balanced wave
        is assumed.  A contended macro-step replicates the wave and
        serializes over the *global* batch with a psum-routed read per
        lane — the term that makes contention catastrophically
        expensive on a mesh, which is exactly the signal placement
        decisions need.

        ``noconflict=True`` prices a statically-proven-conflict-free
        wave: the per-step footprint all_gather (one collective of the
        group) is skipped along with the sweep, and the serialized-
        fallback term vanishes — the proof replaces the contention
        guess entirely."""
        bpd = batch_per_device if batch_per_device is not None \
            else -(-batch // max(n_devices, 1))     # balanced ceil
        if noconflict:
            contention_rate = 0.0
        contended = min(max(contention_rate, 0.0), 1.0) * steps
        clean = steps - contended
        coll = self.collective_us if n_devices > 1 else 0.0
        colls = self.collectives_per_step - (1 if noconflict else 0)
        return (self._miss(cached) + self.launch_us
                + clean * (self.vstep_us + bpd * self.vlane_us
                           + colls * coll)
                + contended * (self.vstep_us
                               + batch * (self.serial_lane_us + coll)))

    @classmethod
    def measured(cls, reps: int = 20, device=None) -> "EngineCost":
        """Measure this host's actual dispatch overhead — one trivial
        torch launch on ``device`` (the pool's device; the CUDA card
        unless named, raising with no card and no device named, as every
        entry point of the port does), synchronized — and replace only
        ``launch_us`` with it.  The launch-vs-step tradeoff is what the
        dispatch decisions hinge on (a slow-dispatch host should batch
        harder and segment less), so only that constant adapts; the step
        constants keep their calibrated values."""
        import time

        import torch

        from repro_torch.core.vm import resolve_device

        dev = resolve_device(device)
        x = torch.zeros((), device=dev)

        def launch():
            y = x + 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return y

        launch()                               # warm the allocator
        t0 = time.perf_counter()
        for _ in range(reps):
            launch()
        us = (time.perf_counter() - t0) / reps * 1e6
        return dataclasses.replace(cls(), launch_us=max(us, 1.0))


def _entropy_bits(counts) -> float:
    p = np.asarray(counts, dtype=float)
    p = p / p.sum()
    return float(-(p * np.log2(p)).sum())


def op_mix_entropy(op_ids) -> float:
    """Shannon entropy (bits) of a wave's op_id mix: 0 for a single-op
    wave, log2(k) for k ops uniformly interleaved."""
    _, counts = np.unique(np.asarray(list(op_ids)), return_counts=True)
    return _entropy_bits(counts)


@dataclasses.dataclass(frozen=True)
class SegmentStats:
    """What the cost model needs to know about one planned segment."""

    size: int
    step_bound: int
    compilable: bool
    batched_cached: bool = True    # lockstep engine built at this size?
    compiled_cached: bool = True   # compiled trace built at this size?


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """An auditable mode choice: the pick plus every candidate's
    predicted per-call cost."""

    mode: str
    costs: Dict[str, float]
    entropy_bits: float = 0.0
    contention_rate: float = 0.0
    # True when a registration-time conflict proof covered the wave: the
    # caller's contention_rate guess was discarded (forced to 0.0) and
    # the engines run with the runtime sweep statically skipped.
    static_noconflict: bool = False

    def __post_init__(self):
        if self.mode not in self.costs:
            raise ValueError(
                f"decision mode {self.mode!r} has no cost entry "
                f"(candidates: {sorted(self.costs)})")


class DispatchCostModel:
    """Analytical engine picker for the registry's ``mode="auto"``.

    Decisions are pure functions of (batch size, per-op trace lengths,
    op-mix composition, contention-rate hint) — deterministic and cheap
    enough to run per call.  A non-zero ``contention_rate`` excludes the
    compiled path: the straight-line trace assumes no request reads a
    word another request writes at the same trace position, while the
    batched interpreter detects conflicts per step and serializes
    exactly, so contended waves must stay on it.
    """

    def __init__(self, cost: Optional[EngineCost] = None):
        self.cost = cost or EngineCost()
        # online calibration state (see observe_dispatch/observe_conflicts):
        # per-(slot key, engine mode) wall-clock scale EWMAs and per-slot
        # conflict-rate EWMAs, both fed by the endpoint while serving
        self._scales: Dict[Tuple[Optional[int], str], float] = {}
        self._conflicts: Dict[Optional[int], float] = {}
        # learned home-access skew (see observe_home_access): EWMA of the
        # hottest device's share of region-access words, fed by the
        # endpoint's per-region access audit while serving
        self._home_skew: Optional[float] = None

    # -- online overlap learning ------------------------------------------

    # EWMA weight of one new overlap observation
    OVERLAP_EWMA_ALPHA = 0.25

    def observe_overlap(self, serial_us: float, dbuf_us: float, *,
                        chain_frac: float = 1.0) -> float:
        """Learn the double-buffer overlap term from one measured pair:
        the same wave timed on the monolithic compiled trace
        (``serial_us``) and on the double-buffered one (``dbuf_us``).
        ``chain_frac`` is the fraction of the trace the gather chain
        accounts for (the discount only applies to the chain portion, so
        a whole-call ratio understates it when the chain is diluted).
        Updates ``self.cost.dbuf_overlap`` by EWMA and returns the new
        value — the "learned overlap term" future ``mode="auto"``
        decisions price with."""
        if serial_us <= 0 or chain_frac <= 0:
            return self.cost.dbuf_overlap
        hidden = (1.0 - dbuf_us / serial_us) / min(chain_frac, 1.0)
        hidden = min(max(hidden, 0.0), 0.95)
        a = self.OVERLAP_EWMA_ALPHA
        new = (1 - a) * self.cost.dbuf_overlap + a * hidden
        self.cost = dataclasses.replace(self.cost, dbuf_overlap=new)
        return new

    # -- online wall-clock calibration (the observe_overlap pattern,
    #    generalized to every engine) -------------------------------------
    #
    # The static [calib] constants carry the engines' *relative shape*;
    # the running host's absolute costs drift (dispatch overhead, cache
    # state, oversubscription).  The endpoint times every retired wave
    # and feeds ``observe_dispatch``: a per-(slot key, engine mode) EWMA
    # of measured/predicted wall clock, clamped and keyed exactly like
    # the decision that will consume it, so ``mode="auto"`` and the
    # serving loop's wave-formation policy adapt online while serving
    # instead of relying on a one-shot ``EngineCost.measured()``
    # calibration.  ``key`` is the operator's slot id for single-op
    # waves and ``None`` (the wave-global bucket) for mixed waves; every
    # per-key observation also updates the global bucket, which is the
    # fallback for keys not yet seen.

    DISPATCH_EWMA_ALPHA = 0.2      # EWMA weight of one wave observation
    CONFLICT_EWMA_ALPHA = 0.2      # EWMA weight of one conflict sample
    _SCALE_CLAMP = (1.0 / 16.0, 16.0)   # one bad sample can't poison auto

    def _unscaled_us(self, mode: str, *, batch: int, step_bound: int,
                     contention_rate: float = 0.0,
                     chain_iters: int = 0) -> Optional[float]:
        """The analytical (pre-EWMA) prediction for one wave on ``mode``,
        or None for modes the model has no closed form for (sharded
        placements, segmented plans without their stats)."""
        if mode in ("mixed", "batched", "interp"):
            return self.cost.batched_us(batch, step_bound, contention_rate)
        if mode == "compiled":
            return self.cost.compiled_us(batch, step_bound)
        if mode == "compiled_dbuf":
            return self.cost.compiled_dbuf_us(batch, step_bound,
                                              chain_iters)
        return None

    def observe_dispatch(self, key: Optional[int], mode: str, *,
                         batch: int, step_bound: int, measured_us: float,
                         contention_rate: float = 0.0,
                         chain_iters: int = 0) -> Optional[float]:
        """Learn from one retired wave: EWMA the ratio of measured wall
        clock to the *unscaled* analytical prediction into the
        ``(key, mode)`` scale (and the global ``(None, mode)`` fallback).
        Returns the new per-key scale, or None when the mode has no
        analytical form (nothing learned)."""
        pred = self._unscaled_us(mode, batch=batch, step_bound=step_bound,
                                 contention_rate=contention_rate,
                                 chain_iters=chain_iters)
        if pred is None or pred <= 0.0 or measured_us <= 0.0:
            return None
        lo, hi = self._SCALE_CLAMP
        ratio = min(max(measured_us / pred, lo), hi)
        a = self.DISPATCH_EWMA_ALPHA
        for k in {(key, mode), (None, mode)}:
            prev = self._scales.get(k, 1.0)
            self._scales[k] = (1 - a) * prev + a * ratio
        return self._scales[(key, mode)]

    def dispatch_scale(self, key: Optional[int], mode: str) -> float:
        """The learned wall-clock scale for ``(key, mode)``: per-key if
        observed, else the global per-mode fallback, else 1.0."""
        s = self._scales.get((key, mode))
        if s is None:
            s = self._scales.get((None, mode), 1.0)
        return s

    def observe_conflicts(self, key: Optional[int], rate: float) -> float:
        """EWMA one wave's conflict (contended-footprint) rate into the
        per-slot estimate ``conflict_hint`` serves back as the default
        contention hint for future waves of the same operator."""
        rate = min(max(float(rate), 0.0), 1.0)
        a = self.CONFLICT_EWMA_ALPHA
        for k in {key, None}:
            prev = self._conflicts.get(k, 0.0)
            self._conflicts[k] = (1 - a) * prev + a * rate
        return self._conflicts[key]

    def conflict_hint(self, key: Optional[int] = None) -> float:
        """The learned conflict rate for a slot (global fallback; 0.0
        before any observation)."""
        c = self._conflicts.get(key)
        if c is None:
            c = self._conflicts.get(None, 0.0)
        return c

    # EWMA weight of one home-access skew sample
    HOME_EWMA_ALPHA = 0.25

    def observe_home_access(self, counts: Sequence[float]) -> float:
        """Learn home skew from one per-device access-word vector (the
        endpoint's region-access audit, see
        ``TiaraEndpoint.note_access``): EWMA the hottest device's share
        of total accessed words.  ``choose_placement`` consumes it as
        the default ``batch_per_device`` when no mixed-batch plan is
        supplied, so a skewed access pattern prices sharding honestly
        (the hot home's sub-wave is the critical path) instead of
        assuming a uniform split."""
        vec = [max(float(c), 0.0) for c in counts]
        total = sum(vec)
        if total <= 0.0 or not vec:
            return self._home_skew if self._home_skew is not None else 0.0
        share = max(vec) / total
        a = self.HOME_EWMA_ALPHA
        prev = self._home_skew if self._home_skew is not None else share
        self._home_skew = (1 - a) * prev + a * share
        return self._home_skew

    def home_skew(self) -> Optional[float]:
        """The learned hottest-home share (None before any
        observation; 1/n_devices means perfectly balanced)."""
        return self._home_skew

    def wave_us(self, *, batch: int, step_bound: int,
                key: Optional[int] = None, mode: str = "mixed",
                contention_rate: float = 0.0,
                chain_iters: int = 0,
                cert_ceiling_us: Optional[float] = None) -> float:
        """Scaled wall-clock prediction for one wave — the serving
        loop's formation-policy estimate (analytical shape x learned
        host scale).

        ``cert_ceiling_us``: the wave's summed certified worst-case
        latency (:class:`~repro_torch.core.wcet.LineRateCertificate`), when
        the caller has one.  The prediction is clamped to it: the EWMA
        scale is a *learned* guess that a cold start or a poisoned
        sample can inflate arbitrarily, while the certificate is a
        static fact — no wave can cost more than the sum of its
        members' certified worst cases, so no prediction should
        either."""
        pred = self._unscaled_us(mode, batch=batch, step_bound=step_bound,
                                 contention_rate=contention_rate,
                                 chain_iters=chain_iters)
        if pred is None:
            pred = self.cost.batched_us(batch, step_bound, contention_rate)
        scaled = pred * self.dispatch_scale(key, mode)
        if cert_ceiling_us is not None:
            scaled = min(scaled, cert_ceiling_us)
        return scaled

    def launch_efficiency(self, *, batch: int, step_bound: int,
                          key: Optional[int] = None,
                          mode: str = "mixed",
                          contention_rate: float = 0.0) -> float:
        """Fraction of a wave's predicted cost that is per-lane (useful)
        work rather than launch/macro-step overhead — monotone in batch
        size, -> 1 as the wave widens.  The continuous batcher rings
        when this crosses its efficiency floor: below it, waiting for
        more posts amortizes the launch better than launching now."""
        total = self.wave_us(batch=batch, step_bound=step_bound, key=key,
                             mode=mode, contention_rate=contention_rate)
        per_lane = (batch * step_bound * self.cost.vlane_us
                    * self.dispatch_scale(key, mode))
        if total <= 0.0:
            return 1.0
        return min(per_lane / total, 1.0)

    # -- single-op waves --------------------------------------------------

    def choose_batched(self, *, batch: int, step_bound: int,
                       compilable: bool,
                       contention_rate: float = 0.0,
                       chain_iters: int = 0,
                       batched_cached: bool = True,
                       compiled_cached: bool = True,
                       dbuf_cached: bool = True,
                       key: Optional[int] = None,
                       static_noconflict: bool = False) -> DispatchDecision:
        """Pick the engine for a single-op wave: "batched" (the lockstep
        interpreter; at B=1 this *is* the classic scalar MP datapath),
        "compiled" (the straight-line trace), or "compiled_dbuf" (the
        double-buffered gather-chain schedule — a candidate only when
        the operator has gather chains, ``chain_iters`` > 0, and wins
        only when they are long enough for the learned overlap term to
        beat the chunk-scheduling cost).  ``*_cached`` flags charge the
        amortized XLA-compile cost for engines not yet built at this
        batch size.  ``key`` (the operator's slot id) applies that
        slot's online-learned wall-clock scales to every candidate, so
        the argmin adapts to the running host (see
        :meth:`observe_dispatch`).

        ``static_noconflict=True`` reports a registration-time conflict
        proof over the wave: the ``contention_rate`` guess is discarded
        (a proven wave never prices the serialized-fallback risk) and
        the compiled candidates stay eligible."""
        if static_noconflict:
            contention_rate = 0.0
        costs = {"batched": self.cost.batched_us(batch, step_bound,
                                                 contention_rate,
                                                 cached=batched_cached)
                 * self.dispatch_scale(key, "batched")}
        if compilable and contention_rate <= 0.0:
            costs["compiled"] = self.cost.compiled_us(
                batch, step_bound, cached=compiled_cached) \
                * self.dispatch_scale(key, "compiled")
            if chain_iters > 0:
                costs["compiled_dbuf"] = self.cost.compiled_dbuf_us(
                    batch, step_bound, chain_iters, cached=dbuf_cached) \
                    * self.dispatch_scale(key, "compiled_dbuf")
        mode = min(costs, key=costs.get)
        return DispatchDecision(mode=mode, costs=costs,
                                contention_rate=contention_rate,
                                static_noconflict=static_noconflict)

    # -- mixed-op waves ---------------------------------------------------

    def segmented_us(self, segments: Sequence[SegmentStats],
                     contention_rate: float = 0.0) -> float:
        """Stable-sort-and-segment: each same-op segment pays its own
        launch (and possibly its own engine compile) on its best
        engine."""
        total = 0.0
        for s in segments:
            best = self.cost.batched_us(s.size, s.step_bound,
                                        contention_rate,
                                        cached=s.batched_cached)
            if s.compilable and contention_rate <= 0.0:
                best = min(best,
                           self.cost.compiled_us(
                               s.size, s.step_bound,
                               cached=s.compiled_cached))
            total += best
        return total

    def mixed_us(self, segments: Sequence[SegmentStats],
                 contention_rate: float = 0.0, *,
                 cached: bool = True) -> float:
        """One mixed lockstep launch: the whole wave advances together,
        so the macro-step count is the *largest* step bound in the mix."""
        batch = sum(s.size for s in segments)
        steps = max(s.step_bound for s in segments)
        return self.cost.batched_us(batch, steps, contention_rate,
                                    cached=cached)

    # -- placement (which device(s) execute the wave) ---------------------

    def choose_placement(self, *, batch: int, n_devices: int,
                         step_bound: int, contention_rate: float = 0.0,
                         batch_per_device: Optional[int] = None,
                         sharded_feasible: bool = True,
                         mixed_cached: bool = True,
                         sharded_cached: bool = True,
                         segments: Optional[Sequence[SegmentStats]] = None,
                         static_noconflict: bool = False
                         ) -> DispatchDecision:
        """Pick where a mixed wave executes: ``"single"`` (the dense
        one-launch mixed engine — every request against the whole pool
        on one chip) vs ``"sharded"`` (home-bucketed per-device
        sub-waves over the mesh, remote traffic on collectives).

        Sharding divides the per-lane vector work by ``n_devices`` but
        adds a per-macro-step collective tax, so it wins on wide waves
        with long traces and loses on small waves — and a contended wave
        is pinned to whichever side predicts cheaper with the serialized
        term included (the sharded fallback serializes over the global
        batch with a collective per lane, so contention strongly favors
        ``"single"``).  ``step_bound`` is the wave's largest per-op
        bound, as in :meth:`mixed_us`; ``batch_per_device`` is the
        plan's real (largest) sub-wave width, so home skew is priced in
        (see :meth:`EngineCost.sharded_us`).  ``sharded_feasible=False``
        removes the sharded candidate entirely — the caller's statement
        that no mesh of ``n_devices`` devices exists on this host (a
        pool can model more homes than the process has devices), so
        "auto" must degrade to "single" rather than pick a placement
        that cannot build.

        ``segments`` (the wave's *dense* — no-homes — plan stats)
        closes the old scope gap: "single" is priced as the best
        single-chip dispatch, the cheaper of the one-launch mixed
        engine and the stable-sort-and-segment path, so a low-entropy
        wave whose best local plan is segmented (per-op compiled
        launches) is no longer routed to the mesh prematurely.  Under
        contention segmentation is excluded (it reorders requests
        across ops — see :meth:`choose_mixed`), and without ``segments``
        the mixed engine alone is priced, as before.  The audit entries
        ``single_mixed``/``single_segmented`` record both candidates.

        ``static_noconflict=True`` reports a registration-time conflict
        proof: the contention guess is discarded, and the sharded
        candidate is priced with the footprint all_gather skipped (see
        :meth:`EngineCost.sharded_us`) — the proof is what lets a
        collective leave the mesh's per-step schedule."""
        if static_noconflict:
            contention_rate = 0.0
        if (batch_per_device is None and n_devices > 1
                and self._home_skew is not None):
            # no plan supplied: price the sharded critical path from the
            # learned access skew (hottest home's share of the batch)
            share = max(self._home_skew, 1.0 / n_devices)
            batch_per_device = max(1, min(batch,
                                          int(np.ceil(batch * share))))
        costs = {"single": self.cost.batched_us(batch, step_bound,
                                                contention_rate,
                                                cached=mixed_cached)}
        if segments and contention_rate <= 0.0:
            costs["single_mixed"] = costs["single"]
            costs["single_segmented"] = self.segmented_us(
                segments, contention_rate)
            costs["single"] = min(costs["single"],
                                  costs["single_segmented"])
        if n_devices > 1 and sharded_feasible:
            costs["sharded"] = self.cost.sharded_us(
                batch, n_devices, step_bound, contention_rate,
                batch_per_device=batch_per_device,
                cached=sharded_cached, noconflict=static_noconflict)
        mode = min(costs, key=costs.get)
        return DispatchDecision(mode=mode, costs=costs,
                                contention_rate=contention_rate,
                                static_noconflict=static_noconflict)

    def choose_mixed(self, *, segments: Sequence[SegmentStats],
                     contention_rate: float = 0.0,
                     mixed_cached: bool = True,
                     key: Optional[int] = None,
                     static_noconflict: bool = False) -> DispatchDecision:
        """Pick the engine for a mixed-op wave: "mixed" (one lockstep
        launch over the merged instruction store) vs "segmented"
        (stable-sort, one compiled/batched launch per same-op segment).

        The op-mix entropy enters through the plan shape: a
        low-entropy wave has a few big segments (launches amortize —
        segmentation wins when traces compile), a high-entropy wave
        shatters into many small segments whose per-segment launches
        dominate (the one-launch mixed engine wins).

        A contended wave (``contention_rate > 0``) is pinned to "mixed":
        segmentation reorders requests across ops (all of segment A
        before any of segment B), which only matches the reference
        round-robin interleaving when cross-segment footprints are
        disjoint — exactly what the contention hint denies.  This
        mirrors :meth:`choose_batched` excluding the compiled trace.

        ``static_noconflict=True`` reports a registration-time conflict
        proof over the wave: the contention guess is discarded, so the
        segmented candidate (which *requires* cross-segment
        disjointness — now proven, not assumed) stays eligible.
        """
        if not segments:
            raise ValueError("mixed wave needs at least one segment")
        if static_noconflict:
            contention_rate = 0.0
        entropy = _entropy_bits([s.size for s in segments])
        costs = {"mixed": self.mixed_us(segments, contention_rate,
                                        cached=mixed_cached)
                 * self.dispatch_scale(key, "mixed")}
        if contention_rate <= 0.0:
            costs["segmented"] = self.segmented_us(segments,
                                                   contention_rate) \
                * self.dispatch_scale(key, "segmented")
        mode = min(costs, key=costs.get)
        return DispatchDecision(mode=mode, costs=costs,
                                entropy_bits=entropy,
                                contention_rate=contention_rate,
                                static_noconflict=static_noconflict)
