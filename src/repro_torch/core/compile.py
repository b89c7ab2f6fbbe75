"""Registration-time trace compiler — the interpreter-free fast path.

The port of ``repro.core.compile``.  The facts the static verifier
already proves about an operator (jumps are forward-only, every loop has
a static trip-count cap, nesting is bounded) are exactly what a trace
compiler needs: the whole program lowers to **straight-line predicated
dataflow** — a chain of gathers and deterministic scatters with no
interpreter dispatch at all.  This is the software analogue of the
paper's point that hot remote-memory paths (pointer chase, page-table
walk, KV block fetch) should run as *superoperators* baked into the
fabric, not as general interpreted programs.

Lowering rules (B = request batch, every value is an int64 ``(B,)`` lane):

  * loops unroll to their static cap; iteration ``j`` runs under the
    predicate ``j < min(trip_reg, cap)``;
  * forward jumps become predicate splits: the fall-through side continues
    under ``pred & ~take`` and the taken lanes re-join at the target pc
    (a jump that escapes loop bodies masks the remaining iterations —
    the Fig. 5 distributed-lock "break");
  * RET latches ``ret``/``status`` under the live predicate and removes
    the lane from every later instruction;
  * LOAD/STORE lower to gathers / deterministic scatters, CAS/CAA to a
    serialized loop over the batch (atomics keep pyvm request-order),
    MEMCPY to a window gather — the ``tiara_gather`` kernel's window form,
    one launch per MEMCPY on a card pool — plus a deterministic
    last-writer-wins scatter in round-robin commit order;
  * the canonical *gather-chain* loop (``load id; load translation;
    memcpy row``) — MoE expert gather and paged-KV block fetch — is
    recognized structurally and fused into one two-level batched gather,
    whose row gather is the hand-written CUDA ``tiara_gather`` kernel
    (one launch per chunk) when the pool lies on the card, and its plain
    version on a CPU pool (``impl="auto"``).

Where the JAX trace is jit-compiled once, this trace is emitted eagerly on
every call: the Python unroll issues the same torch operations in the
same order, so the result is the same.

**Memory ownership**: a run copies the pool once into a private flat
buffer with one sink word at the end (``vm.private_pool``) and updates it
in place; dead lanes and losing duplicates scatter into the sink (torch
has no ``mode="drop"`` scatter).  Every read that the JAX trace takes
from a pre-scatter snapshot (the fused superoperators, the
double-buffered chunks) is issued before the first write it must not
see.

Exactness: at batch=1 the compiled operator is bit-identical to the
``pyvm`` oracle (memory, ret, status, steps, registers).  For batches the
semantics are the engine's round-robin interleaving; like the batched
interpreter's vectorized step it assumes no request *reads* a word another
request *writes at the same trace position* (atomics excepted — they are
fully serialized).  Contended workloads belong on the batched interpreter,
which detects conflicts per step and falls back to exact serialization.

The in-flight async counter is not modeled: WAIT only clamps a counter
that never feeds a value (copies apply functionally at issue; timing is
the simulator's job), so the compiled path drops it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import costmodel as _costmodel
from repro_torch.core import isa
from repro_torch.core.isa import (Alu, Instr, Op, FLAG_ASYNC, FLAG_DEV_REG,
                                  FLAG_DSTDEV_REG, FLAG_IMMB, FLAG_LEN_REG,
                                  FLAG_MREG, FLAG_SRCDEV_REG, DEV_LOCAL,
                                  ERR_REG)
from repro_torch.core.memory import RegionTable
from repro_torch.core.verifier import LoopInfo, VerifiedOperator
from repro_torch.core import vm as _vm
from repro_torch.kernels.tiara_gather.ops import tiara_gather_window

_REG_MASK = isa.NUM_REGS - 1
_I64 = torch.int64

# fault-site device column sentinels (see _Tracer.sites / _finalize_fault):
# >= 0 is a static device id, _DEV_HOME resolves to the lane's home at
# finalization, _DEV_LATCHED reads the runtime f_dev plane
_DEV_HOME = -1
_DEV_LATCHED = -2

DEFAULT_UNROLL_LIMIT = 4096

# Iterations per double-buffered gather-chain chunk.  Single source of
# truth is the cost model's ``dbuf_chunk_iters`` — the auto dispatch
# prices chunk counts and the overlap-eligibility threshold with it, so
# the engine must chunk identically.
DBUF_CHUNK = _costmodel.EngineCost().dbuf_chunk_iters

# The window-gather implementations (every MEMCPY's read and the gather
# chain's row gather): "cuda" launches the
# tiara_gather kernel, "torch" runs its plain version (CPU pools only),
# "auto" picks "cuda" when the pool lies on a CUDA device and "torch"
# otherwise.
IMPLS = ("auto", "torch", "cuda")


class CompileError(Exception):
    pass


def why_not_compilable(op: VerifiedOperator,
                       unroll_limit: int = DEFAULT_UNROLL_LIMIT
                       ) -> Optional[str]:
    """None if the operator can be trace-compiled, else a reason string.

    The verifier already guarantees loop-freeness or bounded unrollability;
    the only extra constraint is that the fully unrolled trace stays small
    enough to be worth emitting as one straight-line program.
    """
    if op.step_bound > unroll_limit:
        return (f"worst-case trace of {op.step_bound} instructions exceeds "
                f"the unroll limit of {unroll_limit}")
    return None


def compilable(op: VerifiedOperator,
               unroll_limit: int = DEFAULT_UNROLL_LIMIT) -> bool:
    return why_not_compilable(op, unroll_limit) is None


# ---------------------------------------------------------------------------
# Shared lowering helpers
# ---------------------------------------------------------------------------

def masked_row_gather(pool: torch.Tensor, idx: torch.Tensor,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[...] = pool[idx[...]]`` with rows outside ``[0, len(pool))``
    (or with ``live == False``) replaced by zeros — the memory-side half
    of the compiled gather chain."""
    n = pool.shape[0]
    ok = (idx >= 0) & (idx < n)
    if live is not None:
        ok = ok & live
    rows = pool[idx.clamp(0, n - 1)]
    shape = tuple(ok.shape) + (1,) * (rows.dim() - ok.dim())
    return torch.where(ok.reshape(shape), rows, torch.zeros_like(rows))


def det_scatter(memx: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                live: torch.Tensor) -> None:
    """Deterministic in-place scatter into a sink-terminated flat pool
    (``memx[-1]`` is the sink): among duplicate targets the **last live
    lane in flat order wins** — flat order is the engine's round-robin
    commit order.  Dead lanes and every losing duplicate are routed to
    the sink, so each real word is written at most once (torch leaves
    the order of duplicate-index writes undefined; the sort makes the
    winner explicit)."""
    sink = memx.shape[0] - 1
    f = torch.where(live, idx, torch.full_like(idx, sink)).reshape(-1)
    v = val.reshape(-1)
    m = f.shape[0]
    # stable grouping: sort by (target, lane); the last element of each
    # run of equal targets is the winner
    comp = f * m + torch.arange(m, dtype=_I64, device=f.device)
    order = torch.argsort(comp)
    fs = f[order]
    last = torch.cat([fs[1:] != fs[:-1],
                      torch.ones(1, dtype=torch.bool, device=f.device)])
    tgt = torch.where(last, fs, torch.full_like(fs, sink))
    memx.index_put_((tgt,), v[order])


def _alu_static(aop: int, a, b):
    """ALU with a *static* opcode — the compiled trace emits only the one
    operation the instruction names (no 16-way select)."""
    if aop == Alu.ADD:
        return a + b
    if aop == Alu.SUB:
        return a - b
    if aop == Alu.MUL:
        return a * b
    if aop == Alu.AND:
        return a & b
    if aop == Alu.OR:
        return a | b
    if aop == Alu.XOR:
        return a ^ b
    if aop == Alu.SHL:
        return a << (b & 63)
    if aop == Alu.SHR:
        return _vm.shr_logical(a, b & 63)
    if aop == Alu.EQ:
        return (a == b).to(_I64)
    if aop == Alu.NE:
        return (a != b).to(_I64)
    if aop == Alu.LT:
        return (a < b).to(_I64)
    if aop == Alu.GE:
        return (a >= b).to(_I64)
    if aop == Alu.MIN:
        return torch.minimum(a, b)
    if aop == Alu.MAX:
        return torch.maximum(a, b)
    raise CompileError(f"bad ALU op {aop}")


# ---------------------------------------------------------------------------
# Mixed-batch planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One same-op_id run of the stable-sorted batch: requests at sorted
    positions ``[start, end)`` all dispatch to ``op_id``.  In a
    home-bucketed plan the run is additionally same-``home`` — the unit
    of placement on the device mesh (the whole segment executes on
    device ``home``)."""

    op_id: int
    start: int
    end: int
    home: int = 0

    @property
    def size(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class MixedPlan:
    """The compiled path's plan for a mixed-op batch.

    A straight-line compiled trace executes one program, so a mixed batch
    is *segmented*: requests are stable-sorted by op_id (preserving
    arrival order within an op — the ordering atomics serialize by), each
    contiguous segment runs through its own compiled trace against the
    shared pool, and per-request outputs scatter back to arrival order
    through ``inverse``.  Planning is pure bookkeeping — O(B log B) once
    per wave — and is exactly the batching a NIC dispatcher would do when
    filling per-MP task queues from a mixed arrival stream.

    **Home-bucketed (sharded) plans**: built with ``homes=`` +
    ``n_devices=``, the stable sort key becomes ``(home, op_id)`` —
    device-major, so device ``d``'s sub-wave is the contiguous slice of
    the sorted batch holding exactly the requests whose ``home`` it
    owns, itself sorted into same-op segments (segments stay the unit of
    placement; each carries its ``home``).  ``device_counts[d]`` is the
    sub-wave's size, ``batch_per_device`` the padded lane count the
    sharded engine runs, and the *same* arrival-order ``inverse``
    permutation still does the reply scatter.
    """

    op_ids: np.ndarray            # i64 [B] arrival-order op ids
    order: np.ndarray             # i64 [B]: sorted position -> arrival idx
    inverse: np.ndarray           # i64 [B]: arrival idx -> sorted position
    segments: Tuple[Segment, ...]
    homes: Optional[np.ndarray] = None   # i64 [B] arrival-order homes
    n_devices: int = 1
    device_counts: Optional[np.ndarray] = None   # i64 [n_devices]

    @property
    def batch(self) -> int:
        return int(self.op_ids.shape[0])

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def sharded(self) -> bool:
        return self.device_counts is not None

    @property
    def batch_per_device(self) -> int:
        """Per-device lane count of the sharded engine: every ragged
        sub-wave padded to the largest one (>= 1 so empty devices still
        hold a halted pad lane)."""
        if self.device_counts is None:
            return self.batch
        return max(int(self.device_counts.max(initial=0)), 1)

    def segment_indices(self, seg: Segment) -> np.ndarray:
        """Arrival indices of the requests in ``seg`` (arrival order)."""
        return self.order[seg.start:seg.end]

    def device_segments(self, device: int) -> Tuple[Segment, ...]:
        """The placement units assigned to ``device`` (sharded plans)."""
        return tuple(s for s in self.segments if s.home == device)


def plan_mixed_batch(op_ids, homes=None,
                     n_devices: Optional[int] = None) -> MixedPlan:
    """Stable-sort a batch's op_ids and segment it into same-op runs.

    With ``homes=`` and ``n_devices=``, additionally bucket the segments
    by ``home`` into per-device sub-waves (sort key ``(home, op_id)``,
    arrival-stable) — the placement plan the sharded engine executes.
    """
    ids = np.asarray(list(op_ids), dtype=np.int64)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError("op_ids must be a non-empty 1-D sequence")
    if homes is None:
        order = np.argsort(ids, kind="stable").astype(np.int64)
        hsort = None
        device_counts = None
        n_dev = 1
    else:
        if n_devices is None:
            raise ValueError("home-bucketed plans need n_devices=")
        n_dev = int(n_devices)
        h = np.asarray(list(homes), dtype=np.int64)
        if h.shape != ids.shape:
            raise ValueError(
                f"homes shape {h.shape} does not match op_ids {ids.shape}")
        if ids.size and (h.min() < 0 or h.max() >= n_dev):
            raise ValueError(
                f"homes must lie in [0, {n_dev}); got range "
                f"[{h.min()}, {h.max()}]")
        # np.lexsort: last key is primary; stable, so arrival order is
        # preserved within each (home, op) bucket
        order = np.lexsort((ids, h)).astype(np.int64)
        hsort = h[order]
        device_counts = np.bincount(h, minlength=n_dev).astype(np.int64)
    inverse = np.empty_like(order)
    inverse[order] = np.arange(ids.size, dtype=np.int64)
    sorted_ids = ids[order]
    brk = sorted_ids[1:] != sorted_ids[:-1]
    if hsort is not None:
        brk = brk | (hsort[1:] != hsort[:-1])
    starts = np.flatnonzero(np.concatenate([[True], brk]))
    bounds = list(starts) + [ids.size]
    segments = tuple(
        Segment(op_id=int(sorted_ids[s]), start=int(s), end=int(e),
                home=int(hsort[s]) if hsort is not None else 0)
        for s, e in zip(bounds[:-1], bounds[1:]))
    return MixedPlan(op_ids=ids, order=order, inverse=inverse,
                     segments=segments,
                     homes=None if homes is None else h,
                     n_devices=n_dev, device_counts=device_counts)


# ---------------------------------------------------------------------------
# Gather-chain superoperator detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GatherChain:
    """The canonical indirection loop (paper §4.5/§4.6):

        loop (n, cap):
            load  id    <- ids_region[i]
            load  paddr <- table_region[id]
            memcpy dst_region[dst] <- pool_region[paddr] x W   (async ok)
            dst += W
            i   += 1
    """

    loop_pc: int
    cap: int
    ids_rid: int
    table_rid: int
    pool_rid: int
    dst_rid: int
    row_words: int
    i_reg: int
    id_reg: int
    paddr_reg: int
    dst_reg: int
    is_async: bool


def _plain_local_load(ins: Instr) -> bool:
    return (ins.op == Op.LOAD and ins.imm == 0 and ins.flags == 0
            and ins.e == DEV_LOCAL)


def _is_add_imm(ins: Instr, reg: int, imm: Optional[int] = None) -> bool:
    """``reg += imm`` (immediate ADD updating ``reg`` in place)."""
    return (ins.op == Op.ALU and ins.d == int(Alu.ADD)
            and bool(ins.flags & FLAG_IMMB) and ins.dst == ins.a == reg
            and (imm is None or ins.imm == imm))


def match_gather_chain_ex(instrs: List[Instr], loop: LoopInfo
                          ) -> Tuple[Optional[GatherChain], Optional[str]]:
    """Structural match of the loop body against the gather-chain shape.
    Purely static — checked once at compile time.  Returns
    ``(chain, None)`` on a match and ``(None, reason)`` on a near-miss,
    where ``reason`` is the *first* structural check that failed — the
    registry surfaces it so a silently-slow almost-chain is explainable.
    """
    body = instrs[loop.start:loop.end + 1]
    if len(body) != 5:
        return None, (f"body has {len(body)} instructions, not the "
                      f"5-instruction chain shape")
    ld_id, ld_tr, mc, add_dst, add_i = body
    lp = instrs[loop.pc]

    if not _plain_local_load(ld_id):
        return None, "body[0] is not a plain local load (imm 0, no flags)"
    if not _plain_local_load(ld_tr):
        return None, "body[1] is not a plain local load (imm 0, no flags)"
    if ld_tr.b != ld_id.dst:                     # chained: id -> translation
        return None, ("body[1] offset register is not body[0]'s "
                      "destination (loads are not chained)")
    if mc.op != Op.MEMCPY:
        return None, "body[2] is not a MEMCPY"
    if mc.flags & (FLAG_LEN_REG | FLAG_DSTDEV_REG | FLAG_SRCDEV_REG):
        return None, "MEMCPY uses a dynamic length or device register"
    if mc.dst != DEV_LOCAL or mc.c != DEV_LOCAL:
        return None, "MEMCPY is not local-to-local"
    if mc.e != ld_tr.dst:                        # src offset = translation
        return None, ("MEMCPY source offset is not the translation "
                      "load's destination")
    w = int(mc.imm)
    if not (0 < w <= isa.MAX_MEMCPY_WORDS):
        return None, f"MEMCPY row width {w} outside (0, MAX_MEMCPY_WORDS]"
    if not _is_add_imm(add_dst, mc.b, w):
        return None, (f"body[3] is not 'dst += {w}' (immediate ADD of the "
                      f"row width)")
    if not _is_add_imm(add_i, ld_id.b, 1):
        return None, "body[4] is not 'i += 1' (immediate ADD of 1)"
    # distinct registers so the fused updates don't alias
    regs = (ld_id.b, ld_id.dst, ld_tr.dst, mc.b)
    if len(set(regs)) != 4:
        return None, "index/id/translation/dst registers are not distinct"
    return GatherChain(
        loop_pc=loop.pc, cap=int(lp.imm), ids_rid=ld_id.a,
        table_rid=ld_tr.a, pool_rid=mc.d, dst_rid=mc.a, row_words=w,
        i_reg=ld_id.b, id_reg=ld_id.dst, paddr_reg=ld_tr.dst,
        dst_reg=mc.b, is_async=bool(mc.flags & FLAG_ASYNC)), None


def match_gather_chain(instrs: List[Instr], loop: LoopInfo
                       ) -> Optional[GatherChain]:
    """Reason-free wrapper of :func:`match_gather_chain_ex` (hot path)."""
    return match_gather_chain_ex(instrs, loop)[0]


def find_gather_chains(op: VerifiedOperator) -> List[GatherChain]:
    """All gather-chain superoperators in a verified program (diagnostic /
    registry-level introspection)."""
    instrs = isa.decode_program(op.code)
    out = []
    for l in op.loops:
        g = match_gather_chain(instrs, l)
        if g is not None:
            out.append(g)
    return out


# ---------------------------------------------------------------------------
# Wider superoperator shapes (footprint-era matchers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScatterReduce:
    """Conditional scatter-accumulate loop — the CAA analogue of the
    gather chain:

        loop (n, cap):
            load v   <- src_region[i]
            caa  old <- acc_region[j] ?= cmp, += v
            j += stride
            i += 1

    Fused to one snapshot gather + elementwise compare + scatter-add.
    The fusion is **only exact when every CAA address in the wave is
    touched at most once** — within a lane that is the static
    ``|stride| * cap <= region size`` check, across lanes it is the
    registration-time conflict proof — so the tracer emits it only in
    ``noconflict`` builds (see :func:`build_compiled`)."""

    loop_pc: int
    cap: int
    src_rid: int
    acc_rid: int
    stride: int
    i_reg: int
    v_reg: int
    j_reg: int
    old_reg: int
    cmp_reg: int


def match_scatter_reduce(instrs: List[Instr], loop: LoopInfo
                         ) -> Optional[ScatterReduce]:
    """Structural match of the loop body against the scatter-reduce
    shape (purely static)."""
    body = instrs[loop.start:loop.end + 1]
    if len(body) != 4:
        return None
    ld, caa, add_j, add_i = body
    lp = instrs[loop.pc]
    if not _plain_local_load(ld):
        return None
    if caa.op != Op.CAA or caa.flags != 0 or caa.imm != 0 \
            or caa.e != DEV_LOCAL:
        return None
    if caa.d != ld.dst:                          # added value = loaded value
        return None
    if not (_is_add_imm(add_j, caa.b) and add_j.imm != 0):
        return None
    if not _is_add_imm(add_i, ld.b, 1):
        return None
    if caa.a == ld.a:          # src window must not alias the acc window
        return None
    regs = (ld.b, ld.dst, caa.b, caa.dst)
    if len(set(regs)) != 4 or caa.c in regs:
        return None
    return ScatterReduce(
        loop_pc=loop.pc, cap=int(lp.imm), src_rid=ld.a, acc_rid=caa.a,
        stride=int(add_j.imm), i_reg=ld.b, v_reg=ld.dst, j_reg=caa.b,
        old_reg=caa.dst, cmp_reg=caa.c)


@dataclasses.dataclass(frozen=True)
class MapLoop:
    """Elementwise map / zip-with over region windows:

        loop (n, cap):                 loop (n, cap):
            load a <- src[i]               load a <- src1[i]
            c = a OP rhs                   load b <- src2[i]
            store c -> dst[j]              c = a OP b
            j += 1                         store c -> dst[j]
            i += 1                         j += 1
                                           i += 1

    ``rhs`` in the unary form is an immediate or a loop-invariant
    register.  Fused to one window gather (two for zip), one
    elementwise ALU, and one deterministic scatter in (iteration,
    request) commit order.  ``src2_rid``/``b_reg`` are -1 and
    ``alu_imm`` carries the immediate for the unary form."""

    loop_pc: int
    cap: int
    src_rid: int
    src2_rid: int
    dst_rid: int
    alu_op: int
    alu_imm: Optional[int]
    rhs_reg: int               # invariant-register rhs for unary map, or -1
    i_reg: int
    j_reg: int
    a_reg: int
    b_reg: int
    c_reg: int
    is_zip: bool


def match_map_loop(instrs: List[Instr], loop: LoopInfo
                   ) -> Optional[MapLoop]:
    """Structural match of the loop body against the map / zip-with
    shapes (purely static)."""
    body = instrs[loop.start:loop.end + 1]
    lp = instrs[loop.pc]
    if len(body) == 5:
        ld_a, alu, st, add_j, add_i = body
        ld_b = None
    elif len(body) == 6:
        ld_a, ld_b, alu, st, add_j, add_i = body
    else:
        return None
    if not _plain_local_load(ld_a):
        return None
    if ld_b is not None:
        if not _plain_local_load(ld_b) or ld_b.b != ld_a.b \
                or ld_b.a == ld_a.a:
            return None
    if alu.op != Op.ALU or alu.d == int(Alu.ALWAYS):
        return None
    if alu.a != ld_a.dst:
        return None
    alu_imm: Optional[int] = None
    rhs_reg = -1
    if ld_b is not None:
        if (alu.flags & FLAG_IMMB) or alu.b != ld_b.dst:
            return None
    elif alu.flags & FLAG_IMMB:
        alu_imm = int(alu.imm)
    else:
        rhs_reg = alu.b
    if st.op != Op.STORE or st.imm != 0 or st.flags != 0 \
            or st.e != DEV_LOCAL:
        return None
    if st.dst != alu.dst:                        # stored value = ALU result
        return None
    if not _is_add_imm(add_j, st.b, 1):
        return None
    if not _is_add_imm(add_i, ld_a.b, 1):
        return None
    # dst window must not alias any src window (the fused gathers read a
    # pre-loop snapshot; distinct regions never alias)
    if st.a == ld_a.a or (ld_b is not None and st.a == ld_b.a):
        return None
    regs = [ld_a.b, st.b, ld_a.dst, alu.dst]
    if ld_b is not None:
        regs.append(ld_b.dst)
    if len(set(regs)) != len(regs):
        return None
    if rhs_reg >= 0 and rhs_reg in regs:         # rhs must be loop-invariant
        return None
    return MapLoop(
        loop_pc=loop.pc, cap=int(lp.imm), src_rid=ld_a.a,
        src2_rid=ld_b.a if ld_b is not None else -1, dst_rid=st.a,
        alu_op=int(alu.d), alu_imm=alu_imm, rhs_reg=rhs_reg,
        i_reg=ld_a.b, j_reg=st.b, a_reg=ld_a.dst,
        b_reg=ld_b.dst if ld_b is not None else -1, c_reg=alu.dst,
        is_zip=ld_b is not None)


def superop_report(op: VerifiedOperator) -> Dict[str, object]:
    """Which superoperators each loop of ``op`` matches, plus — when a
    loop matches nothing — the first structural reason the gather-chain
    matcher bailed (registry introspection; see ``registry.dump()``)."""
    instrs = isa.decode_program(op.code)
    matched: List[Tuple[str, int]] = []
    near_miss: Optional[str] = None
    for l in op.loops:
        g, reason = match_gather_chain_ex(instrs, l)
        if g is not None:
            matched.append(("gather_chain", l.pc))
            continue
        sr = match_scatter_reduce(instrs, l)
        if sr is not None:
            matched.append(("scatter_reduce", l.pc))
            continue
        ml = match_map_loop(instrs, l)
        if ml is not None:
            matched.append(("zip_loop" if ml.is_zip else "map_loop", l.pc))
            continue
        if near_miss is None:
            near_miss = f"pc {l.pc}: {reason}"
    return {"matched": matched, "near_miss": near_miss}



# ---------------------------------------------------------------------------
# The trace emitter
# ---------------------------------------------------------------------------

def _first_true(has: torch.Tensor) -> torch.Tensor:
    """Index of the first True along axis 1 (0 when none), int64."""
    return has.to(torch.int32).argmax(dim=1).to(_I64)


def _pick(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``x[b, col[b]]`` for a (B, n) ``x`` and a (B,) ``col``."""
    return x.gather(1, col[:, None])[:, 0]


class _Tracer:
    """Emits the predicated straight-line trace of one verified operator.

    State: the 16 register lanes, the flattened shared memory pool (with
    its sink word), and the halt/ret/status/step accumulators.  Control
    flow exists only at Python time (the unroll), never in the emitted
    program.
    """

    def __init__(self, *, instrs, loops, base, mask, n_dev, pool_words,
                 batch, homes, failed, memx, regs, impl, superops,
                 double_buffer=False, protect=True, check_failed=True,
                 noconflict=False):
        self.instrs = instrs
        self.loops = loops                  # pc -> LoopInfo
        self.base = base                    # static np arrays
        self.mask = mask
        self.n_dev = n_dev
        self.P = pool_words
        self.B = batch
        self.homes = homes                  # (B,)
        self.failed = failed                # (n_dev,)
        self.memf = memx                    # (n_dev * P + 1,), last = sink
        self.dev = memx.device
        self.regs = regs                    # list of 16 (B,) lanes
        self.impl = impl
        self.superops = superops
        self.double_buffer = double_buffer
        self.protect = protect
        self.check_failed = check_failed
        self.noconflict = noconflict
        zero = self._full(0)
        self.halted = torch.zeros(batch, dtype=torch.bool, device=self.dev)
        self.ret = zero
        self.status = self._full(isa.STATUS_FELL_OFF)
        self.steps = zero
        # fault record: each faulting site appends its (B,) fault lanes
        # plus the runtime address (and device / chain-step, when not
        # static) to `pending`; a faulted lane halts, so at most one
        # site fires per lane and the whole record reduces to one fused
        # sum at trace finalization (`_finalize_fault`).  `sites` is the
        # static side table the (pc, opcode, dev) columns are recovered
        # from; its last column is the site *kind* (0 plain instruction,
        # 1 gather chain, 2 scatter-reduce, 3 map loop, 4 zip loop —
        # fused sites recover pc/opcode from the latched body-instruction
        # index).
        self.sites: List[Tuple[int, int, int, int]] = []
        self.pending: List[Tuple] = []

    # -- small helpers ---------------------------------------------------

    def _full(self, v) -> torch.Tensor:
        return torch.full((self.B,), int(v), dtype=_I64, device=self.dev)

    def _false(self) -> torch.Tensor:
        return torch.zeros(self.B, dtype=torch.bool, device=self.dev)

    def set_reg(self, idx: int, val, p) -> None:
        idx &= _REG_MASK
        self.regs[idx] = torch.where(p, val, self.regs[idx])

    def dev_of(self, field: int, via_reg: bool) -> torch.Tensor:
        if via_reg:
            d = self.regs[field & _REG_MASK]
            return torch.where(d == DEV_LOCAL, self.homes,
                               torch.remainder(d, self.n_dev))
        if field == DEV_LOCAL:
            return self.homes
        return self._full(int(field) % self.n_dev)

    def word_addr(self, ins: Instr) -> torch.Tensor:
        """LOAD/STORE/CAS/CAA all address ``region(a)[regs[b] + imm]``."""
        rid = ins.a
        off = self.regs[ins.b & _REG_MASK] + ins.imm
        return int(self.base[rid]) + (off & int(self.mask[rid]))

    # -- runtime protection ------------------------------------------------

    def _latch_fault(self, p, flt, pc, opcode, addr, dev=None):
        """Latch a protection fault on lanes ``p & flt``: halt them,
        record the static site index plus the runtime address (and the
        device, when it isn't statically known), and return the reduced
        predicate for the faulting instruction's own effects.

        ``dev``: None when the resolved device is statically the lane's
        home, an int when it is a static device id, or a (B,) tensor."""
        f = p & flt
        self.halted = self.halted | f
        k = len(self.sites)
        if dev is None:
            devcol, dtr = _DEV_HOME, None
        elif isinstance(dev, int):
            devcol, dtr = dev, None
        else:
            devcol, dtr = _DEV_LATCHED, dev
        self.sites.append((pc, int(opcode), devcol, 0))
        self.pending.append((k, f, addr, dtr, None))
        return p ^ f

    def _word_fault(self, ins, p, pc):
        """Fault check shared by LOAD/STORE/CAS/CAA; mirrors pyvm's
        priority: wild device register, then out-of-region offset, then
        failed target device."""
        if not self.protect:
            return p
        via = bool(ins.flags & FLAG_DEV_REG)
        off = self.regs[ins.b & _REG_MASK] + ins.imm
        oob_off = off != (off & int(self.mask[ins.a]))
        if via:
            dev = self.dev_of(ins.e, True)
            draw = self.regs[ins.e & _REG_MASK]
            oob_dev = (draw != DEV_LOCAL) & ((draw < 0) | (draw >= self.n_dev))
            fdev = torch.where(oob_dev, draw, dev)
            flt = oob_dev | oob_off
            if self.check_failed:
                flt = flt | self.failed[dev]
            return self._latch_fault(p, flt, pc, int(ins.op), off, fdev)
        flt = oob_off
        if self.check_failed:
            flt = flt | self.failed[self.dev_of(ins.e, False)]
        dev_static = None if ins.e == DEV_LOCAL \
            else int(ins.e) % self.n_dev
        return self._latch_fault(p, flt, pc, int(ins.op), off, dev_static)

    # -- per-opcode lowering ----------------------------------------------

    def _movi(self, ins, p):
        self.set_reg(ins.dst, self._full(ins.imm), p)

    def _alu(self, ins, p):
        rhs = self._full(ins.imm) if ins.flags & FLAG_IMMB \
            else self.regs[ins.b & _REG_MASK]
        self.set_reg(ins.dst, _alu_static(ins.d, self.regs[ins.a & _REG_MASK],
                                          rhs), p)

    def _load(self, ins, p, pc):
        p = self._word_fault(ins, p, pc)
        dev = self.dev_of(ins.e, bool(ins.flags & FLAG_DEV_REG))
        val = self.memf[dev * self.P + self.word_addr(ins)]
        self.set_reg(ins.dst, val, p)

    def _store(self, ins, p, pc):
        p = self._word_fault(ins, p, pc)
        dev = self.dev_of(ins.e, bool(ins.flags & FLAG_DEV_REG))
        idx = dev * self.P + self.word_addr(ins)
        det_scatter(self.memf, idx, self.regs[ins.dst & _REG_MASK], p)

    def _atomic(self, ins, p, pc, is_cas: bool):
        p = self._word_fault(ins, p, pc)
        dev = self.dev_of(ins.e, bool(ins.flags & FLAG_DEV_REG))
        idx = dev * self.P + self.word_addr(ins)
        cmpv = self.regs[ins.c & _REG_MASK]
        arg = self.regs[ins.d & _REG_MASK]
        size = self.memf.shape[0] - 1
        sink = torch.full((1,), size, dtype=_I64, device=self.dev)
        olds = []
        # atomics are serialized over the batch: pyvm request ordering
        # (one-element index tensors keep the loop free of host syncs)
        for b in range(self.B):
            i_b = idx[b:b + 1]
            p_b = p[b:b + 1]
            old = self.memf[i_b.clamp(0, size - 1)]
            hit = (old == cmpv[b:b + 1]) & p_b
            new = torch.where(hit, arg[b:b + 1] if is_cas
                              else old + arg[b:b + 1], old)
            self.memf.index_put_((torch.where(p_b, i_b, sink),), new)
            olds.append(old)
        self.set_reg(ins.dst, torch.cat(olds), p)

    def _memcpy(self, ins, p, pc):
        via_d = bool(ins.flags & FLAG_DSTDEV_REG)
        via_s = bool(ins.flags & FLAG_SRCDEV_REG)
        ddev = self.dev_of(ins.dst, via_d)
        sdev = self.dev_of(ins.c, via_s)
        drid, srid = ins.a, ins.d
        cap = min(int(ins.imm), isa.MAX_MEMCPY_WORDS)
        if ins.flags & FLAG_LEN_REG:
            ln = self.regs[ins.imm2 & _REG_MASK].clamp(0, cap)
        else:
            ln = self._full(cap)
        ln = ln.clamp(max=min(int(self.mask[drid]) + 1,
                              int(self.mask[srid]) + 1))
        if self.protect:
            doff0 = self.regs[ins.b & _REG_MASK]
            soff0 = self.regs[ins.e & _REG_MASK]
            dmask, smask = int(self.mask[drid]), int(self.mask[srid])

            def dev_oob(field, via):
                if not via:
                    return self._false()
                d = self.regs[field & _REG_MASK]
                return (d != DEV_LOCAL) & ((d < 0) | (d >= self.n_dev))

            oob_dd = dev_oob(ins.dst, via_d)
            oob_sd = dev_oob(ins.c, via_s)
            d_oob = (doff0 != (doff0 & dmask)) | (doff0 + ln > dmask + 1)
            s_oob = (soff0 != (soff0 & smask)) | (soff0 + ln > smask + 1)
            flt = (ln > 0) & (oob_dd | oob_sd | d_oob | s_oob)
            faddr = torch.where(oob_dd | (~oob_sd & d_oob), doff0, soff0)
            fdev = torch.where(
                oob_dd, self.regs[ins.dst & _REG_MASK],
                torch.where(oob_sd, self.regs[ins.c & _REG_MASK],
                            torch.where(d_oob, ddev, sdev)))
            p = self._latch_fault(p, flt, pc, int(ins.op), faddr, fdev)
        zero = torch.zeros_like(ln)
        if self.check_failed:
            fail = self.failed[ddev] | self.failed[sdev]
            err = self.regs[ERR_REG]
            self.regs[ERR_REG] = torch.where(p & fail, err | 1, err)
            ln = torch.where(fail | ~p, zero, ln)
        else:
            ln = torch.where(p, ln, zero)
        iw = torch.arange(cap, dtype=_I64, device=self.dev)[None, :]
        doff = self.regs[ins.b & _REG_MASK][:, None]
        dst = ddev[:, None] * self.P + int(self.base[drid]) + \
            ((doff + iw) & int(self.mask[drid]))
        # word w of lane b's window: memf[sdev*P + base + ((soff + w) &
        # mask)], read for every lane and word (``live`` picks what lands)
        vals = self._read_windows(self.regs[ins.e & _REG_MASK],
                                  sdev * self.P + int(self.base[srid]),
                                  width=cap, mask=int(self.mask[srid]))
        live = iw < ln[:, None]
        det_scatter(self.memf, dst, vals, live)

    def _read_windows(self, offs, starts, *, width: int, mask: int):
        """``out[b, w] = memf[starts[b] + ((offs[b] + w) & mask)]`` for
        ``w < width``: the ``tiara_gather`` kernel's window form on a card
        pool, its plain version on a CPU pool.  Masking the offsets keeps
        every index inside the region, the kernel's precondition; they
        stay int64, as a region may hold 2**31 words or more."""
        return tiara_gather_window(
            self.memf, (offs & mask).contiguous(), starts.contiguous(),
            width=width, mask=mask, impl=self.impl)

    # -- the gather-chain superoperator ------------------------------------

    def _fused_gather_chain(self, g: GatherChain, m, p) -> None:
        """One two-level batched gather for the whole loop: ids -> table ->
        pool rows -> destination window.  Commit order is (iteration,
        request) — identical to the lockstep engine.

        With ``double_buffer`` the iteration axis is split into
        ``DBUF_CHUNK``-sized chunks, the schedule of the operator's
        *async* Memcpy: every chunk's rows are read from the pre-chain
        memory and committed chunk by chunk.  Bit-identical to the
        monolithic path by construction — the monolithic path *also*
        reads all rows pre-scatter."""
        B, P = self.B, self.P
        cap, W = g.cap, g.row_words
        jj = torch.arange(cap, dtype=_I64, device=self.dev)[None, :]
        i0 = self.regs[g.i_reg][:, None]
        dst0 = self.regs[g.dst_reg][:, None]
        home = self.homes[:, None]
        valid = (jj < m[:, None]) & p[:, None]                  # (B, cap)

        ids_addr = int(self.base[g.ids_rid]) + \
            ((i0 + jj) & int(self.mask[g.ids_rid]))
        ids = self.memf[home * P + ids_addr]                    # (B, cap)
        tbl_addr = int(self.base[g.table_rid]) + \
            (ids & int(self.mask[g.table_rid]))
        paddr = self.memf[home * P + tbl_addr]                  # (B, cap)

        fail = self.failed[self.homes] if self.check_failed else None
        pool_base = int(self.base[g.pool_rid])
        pool_mask = int(self.mask[g.pool_rid])

        if self.protect:
            # Per-iteration fault scan: body instruction k in {1: load id,
            # 2: load translation, 3: memcpy row} can fault at iteration j;
            # the chain commits exactly the first j* iterations plus the
            # k*-1 committed instructions of iteration j*, mirroring the
            # un-fused engines instruction for instruction.
            dmask = int(self.mask[g.dst_rid])
            lnW = min(W, dmask + 1, pool_mask + 1)
            ids_off = i0 + jj                                   # raw (B, cap)
            doffs = dst0 + jj * W                               # raw (B, cap)
            c1 = ids_off != (ids_off & int(self.mask[g.ids_rid]))
            if fail is not None:
                c1 = fail[:, None] | c1
            c2 = ids != (ids & int(self.mask[g.table_rid]))
            d_oob = (doffs != (doffs & dmask)) | (doffs + lnW > dmask + 1)
            s_oob = (paddr != (paddr & pool_mask)) | \
                (paddr + lnW > pool_mask + 1)
            zero = torch.zeros_like(paddr)
            k_j = torch.where(c1, zero + 1, torch.where(
                c2, zero + 2, torch.where(d_oob | s_oob, zero + 3, zero)))
            k_j = torch.where(valid, k_j, zero)
            has = k_j > 0
            flt = has.any(dim=1)
            js = _first_true(has)
            kstar = _pick(k_j, js)
            a3 = torch.where(_pick(d_oob, js), _pick(doffs, js),
                             _pick(paddr, js))
            faddr = torch.where(
                kstar == 1, _pick(ids_off, js),
                torch.where(kstar == 2, _pick(ids, js), a3))
            self.halted = self.halted | flt
            # body starts at pc+1, so pc of body instruction k* is
            # loop_pc + k* — recovered at finalization from the chain's
            # latched k* (the aux column of the pending record)
            k_site = len(self.sites)
            self.sites.append((g.loop_pc, 0, _DEV_HOME, 1))
            self.pending.append((k_site, flt, faddr, None, kstar))
            m_eff = torch.where(flt, js, m)
            live = valid & (jj < m_eff[:, None])
        else:
            if fail is not None:
                err = self.regs[ERR_REG]
                self.regs[ERR_REG] = torch.where(p & fail & (m > 0),
                                                 err | 1, err)
                live = valid & ~fail[:, None]
            else:
                live = valid
            flt = self._false()
            js = kstar = None
            m_eff = m
        iw = torch.arange(W, dtype=_I64, device=self.dev)
        # The row gather is the tiara_gather kernel's window form (the
        # plain version on a CPU pool): word w of row (b, j) is
        # pool[start + ((paddr + w) & pool_mask)], start the region's
        # start on the request's home device — the interpreter's MEMCPY,
        # at any alignment.
        starts = home * P + pool_base                           # (B, 1)

        def gather_rows(lo, hi):
            # every chunk is gathered before the first scatter, so all
            # rows are read from the pre-chain pool
            return self._read_windows(
                paddr[:, lo:hi].reshape(-1),
                starts.expand(B, hi - lo).reshape(-1), width=W,
                mask=pool_mask).view(B, hi - lo, W)

        dst_addr = home[:, :, None] * P + int(self.base[g.dst_rid]) + \
            ((dst0[:, :, None] + jj[:, :, None] * W + iw)
             & int(self.mask[g.dst_rid]))
        wmask = live[:, :, None].expand(dst_addr.shape)

        if self.double_buffer and cap > DBUF_CHUNK:
            bounds = list(range(0, cap, DBUF_CHUNK)) + [cap]
        else:
            bounds = [0, cap]
        spans = list(zip(bounds[:-1], bounds[1:]))
        chunks = [gather_rows(lo, hi) for lo, hi in spans]
        for (lo, hi), rows_k in zip(spans, chunks):
            # commit chunk k in (iteration, request, word) order
            det_scatter(self.memf, dst_addr[:, lo:hi].transpose(0, 1),
                        rows_k.transpose(0, 1),
                        wmask[:, lo:hi].transpose(0, 1))

        # architectural register effects of the executed iterations; a
        # faulted lane commits the loads that retired before the fault
        if self.protect:
            n_id = torch.where(flt, js + (kstar >= 2).to(_I64), m)
            n_pa = torch.where(flt, js + (kstar >= 3).to(_I64), m)
            steps_n = torch.where(flt, js * 5 + kstar, m * 5)
        else:
            n_id = n_pa = m
            steps_n = m * 5
        self.set_reg(g.i_reg, self.regs[g.i_reg] + m_eff, p)
        self.set_reg(g.dst_reg, self.regs[g.dst_reg] + m_eff * W, p)
        self.set_reg(g.id_reg, _pick(ids, (n_id - 1).clamp(0, cap - 1)),
                     p & (n_id > 0))
        self.set_reg(g.paddr_reg,
                     _pick(paddr, (n_pa - 1).clamp(0, cap - 1)),
                     p & (n_pa > 0))
        self.steps = self.steps + torch.where(p, steps_n,
                                              torch.zeros_like(steps_n))

    # -- the scatter-reduce superoperator ---------------------------------

    def _fused_scatter_reduce(self, sr: ScatterReduce, m, p) -> None:
        """One snapshot gather + elementwise compare + scatter-add for
        the whole CAA loop.  Exact only because every accumulator
        address is touched at most once: within a lane by the static
        ``|stride| * cap <= acc region size`` check (emit_segment), and
        across lanes by the ``noconflict`` wave proof the build asserts
        — so each CAA's ``old`` equals the pre-loop snapshot value and
        the conditional add commutes into one scatter-add."""
        B, P = self.B, self.P
        cap, s = sr.cap, sr.stride
        it = torch.arange(cap, dtype=_I64, device=self.dev)[None, :]
        i0 = self.regs[sr.i_reg][:, None]
        j0 = self.regs[sr.j_reg][:, None]
        home = self.homes[:, None]
        valid = (it < m[:, None]) & p[:, None]                  # (B, cap)
        src_off = i0 + it
        acc_off = j0 + it * s
        src_mask = int(self.mask[sr.src_rid])
        acc_mask = int(self.mask[sr.acc_rid])

        if self.protect:
            # per-iteration fault scan: body instruction k in {1: load,
            # 2: caa} can fault at iteration j; commit exactly the first
            # j* iterations (a faulting CAA has zero effect).
            c1 = src_off != (src_off & src_mask)
            if self.check_failed:
                c1 = self.failed[self.homes][:, None] | c1
            c2 = acc_off != (acc_off & acc_mask)
            zero = torch.zeros_like(src_off)
            k_j = torch.where(c1, zero + 1, torch.where(c2, zero + 2, zero))
            k_j = torch.where(valid, k_j, zero)
            has = k_j > 0
            flt = has.any(dim=1)
            js = _first_true(has)
            kstar = _pick(k_j, js)
            faddr = torch.where(kstar == 1, _pick(src_off, js),
                                _pick(acc_off, js))
            self.halted = self.halted | flt
            k_site = len(self.sites)
            self.sites.append((sr.loop_pc, 0, _DEV_HOME, 2))
            self.pending.append((k_site, flt, faddr, None, kstar))
            m_eff = torch.where(flt, js, m)
        else:
            flt = self._false()
            js = kstar = None
            m_eff = m
        live = valid & (it < m_eff[:, None])

        mem0 = self.memf             # both gathers precede the add
        v = mem0[home * P + int(self.base[sr.src_rid])
                 + (src_off & src_mask)]                        # (B, cap)
        acc_addr = home * P + int(self.base[sr.acc_rid]) + \
            (acc_off & acc_mask)
        old = mem0[acc_addr]                                    # (B, cap)
        hit = (old == self.regs[sr.cmp_reg][:, None]) & live
        delta = torch.where(hit, v, torch.zeros_like(v))
        sink = self.memf.shape[0] - 1
        tgt = torch.where(live, acc_addr, torch.full_like(acc_addr, sink))
        self.memf.index_put_((tgt.reshape(-1),), delta.reshape(-1),
                             accumulate=True)

        if self.protect:
            n_v = torch.where(flt, js + (kstar >= 2).to(_I64), m)
            steps_n = torch.where(flt, js * 4 + kstar, m * 4)
        else:
            n_v = m
            steps_n = m * 4
        self.set_reg(sr.i_reg, self.regs[sr.i_reg] + m_eff, p)
        self.set_reg(sr.j_reg, self.regs[sr.j_reg] + m_eff * s, p)
        self.set_reg(sr.v_reg, _pick(v, (n_v - 1).clamp(0, cap - 1)),
                     p & (n_v > 0))
        self.set_reg(sr.old_reg, _pick(old, (m_eff - 1).clamp(0, cap - 1)),
                     p & (m_eff > 0))
        self.steps = self.steps + torch.where(p, steps_n,
                                              torch.zeros_like(steps_n))

    # -- the map / zip-with superoperator ---------------------------------

    def _fused_map_loop(self, ml: MapLoop, m, p) -> None:
        """Window gather(s) + one elementwise ALU + one deterministic
        scatter in (iteration, request) commit order.  The gathers read
        the pre-loop memory; the matcher requires the destination
        region to differ from every source region, so within a lane no
        store feeds a later load, and across lanes the compiled path's
        standing no-conflict assumption applies (same class as the
        gather chain and plain STORE lowering)."""
        B, P = self.B, self.P
        cap = ml.cap
        body_len = 6 if ml.is_zip else 5
        it = torch.arange(cap, dtype=_I64, device=self.dev)[None, :]
        i0 = self.regs[ml.i_reg][:, None]
        j0 = self.regs[ml.j_reg][:, None]
        home = self.homes[:, None]
        valid = (it < m[:, None]) & p[:, None]
        src_off = i0 + it
        dst_off = j0 + it
        src_mask = int(self.mask[ml.src_rid])
        dst_mask = int(self.mask[ml.dst_rid])
        src2_mask = int(self.mask[ml.src2_rid]) if ml.is_zip else 0
        store_k = 4 if ml.is_zip else 3

        if self.protect:
            c1 = src_off != (src_off & src_mask)
            if self.check_failed:
                c1 = self.failed[self.homes][:, None] | c1
            c2 = (src_off != (src_off & src2_mask)) if ml.is_zip \
                else torch.zeros_like(c1)
            c_st = dst_off != (dst_off & dst_mask)
            zero = torch.zeros_like(src_off)
            k_j = torch.where(c1, zero + 1, torch.where(
                c2, zero + 2, torch.where(c_st, zero + store_k, zero)))
            k_j = torch.where(valid, k_j, zero)
            has = k_j > 0
            flt = has.any(dim=1)
            js = _first_true(has)
            kstar = _pick(k_j, js)
            faddr = torch.where(kstar == store_k, _pick(dst_off, js),
                                _pick(src_off, js))
            self.halted = self.halted | flt
            k_site = len(self.sites)
            self.sites.append((ml.loop_pc, 0, _DEV_HOME,
                               4 if ml.is_zip else 3))
            self.pending.append((k_site, flt, faddr, None, kstar))
            m_eff = torch.where(flt, js, m)
        else:
            flt = self._false()
            js = kstar = None
            m_eff = m
        live = valid & (it < m_eff[:, None])

        mem0 = self.memf             # the gathers precede the scatter
        a_vals = mem0[home * P + int(self.base[ml.src_rid])
                      + (src_off & src_mask)]                   # (B, cap)
        if ml.is_zip:
            b_vals = mem0[home * P + int(self.base[ml.src2_rid])
                          + (src_off & src2_mask)]
            rhs = b_vals
        elif ml.alu_imm is not None:
            rhs = torch.full((B, cap), ml.alu_imm, dtype=_I64,
                             device=self.dev)
            b_vals = None
        else:
            rhs = self.regs[ml.rhs_reg][:, None].expand(B, cap)
            b_vals = None
        c_vals = _alu_static(ml.alu_op, a_vals, rhs)
        dst_addr = home * P + int(self.base[ml.dst_rid]) + \
            (dst_off & dst_mask)
        # commit in (iteration, request) order = the engine's round robin
        det_scatter(self.memf, dst_addr.transpose(0, 1),
                    c_vals.transpose(0, 1), live.transpose(0, 1))

        if self.protect:
            n_a = torch.where(flt, js + (kstar >= 2).to(_I64), m)
            n_c = torch.where(flt, js + (kstar >= store_k).to(_I64), m)
            steps_n = torch.where(flt, js * body_len + kstar, m * body_len)
        else:
            n_a = n_c = m
            steps_n = m * body_len
        self.set_reg(ml.i_reg, self.regs[ml.i_reg] + m_eff, p)
        self.set_reg(ml.j_reg, self.regs[ml.j_reg] + m_eff, p)
        self.set_reg(ml.a_reg, _pick(a_vals, (n_a - 1).clamp(0, cap - 1)),
                     p & (n_a > 0))
        if ml.is_zip:
            n_b = torch.where(flt, js + (kstar >= 3).to(_I64), m) \
                if self.protect else m
            self.set_reg(ml.b_reg,
                         _pick(b_vals, (n_b - 1).clamp(0, cap - 1)),
                         p & (n_b > 0))
        self.set_reg(ml.c_reg, _pick(c_vals, (n_c - 1).clamp(0, cap - 1)),
                     p & (n_c > 0))
        self.steps = self.steps + torch.where(p, steps_n,
                                              torch.zeros_like(steps_n))

    # -- segment emission ---------------------------------------------------

    def emit_segment(self, lo: int, hi: int, pred) -> Dict[int, torch.Tensor]:
        """Emit instructions [lo, hi) under ``pred``; returns the escape
        predicates {target_pc: lanes} for jumps leaving the segment."""
        escapes: Dict[int, torch.Tensor] = {}
        resume: Dict[int, torch.Tensor] = {}
        pc = lo
        while pc < hi:
            if pc in resume:
                pred = pred | resume.pop(pc)
            ins = self.instrs[pc]
            p = pred & ~self.halted

            if ins.op == Op.LOOP:
                l = self.loops[pc]
                body_hi = l.end + 1
                self.steps = self.steps + p.to(_I64)   # LOOP runs once
                cap = int(ins.imm)
                if ins.flags & FLAG_MREG:
                    m = self.regs[ins.b & _REG_MASK].clamp(0, cap)
                else:
                    m = self._full(cap)
                g = match_gather_chain(self.instrs, l) if self.superops \
                    else None
                if g is not None:
                    self._fused_gather_chain(g, m, p)
                    pc = body_hi
                    continue
                if self.superops and cap > 0:
                    # scatter-reduce fusion is exact only under the wave
                    # conflict proof plus the static within-lane address-
                    # uniqueness check (see ScatterReduce docstring)
                    sr = match_scatter_reduce(self.instrs, l) \
                        if self.noconflict else None
                    if sr is not None and \
                            abs(sr.stride) * cap <= int(
                                self.mask[sr.acc_rid]) + 1:
                        self._fused_scatter_reduce(sr, m, p)
                        pc = body_hi
                        continue
                    ml = match_map_loop(self.instrs, l)
                    if ml is not None:
                        self._fused_map_loop(ml, m, p)
                        pc = body_hi
                        continue
                broken = self._false()
                for it in range(cap):
                    it_pred = pred & (it < m) & ~broken
                    esc = self.emit_segment(l.start, body_hi, it_pred)
                    for tgt, ep in esc.items():
                        broken = broken | ep
                        pred = pred & ~ep
                        if tgt < hi:
                            resume[tgt] = resume.get(
                                tgt, self._false()) | ep
                        else:
                            escapes[tgt] = escapes.get(
                                tgt, self._false()) | ep
                pc = body_hi
                continue

            if ins.op == Op.JUMP:
                self.steps = self.steps + p.to(_I64)
                if ins.d == int(Alu.ALWAYS):
                    take = p
                else:
                    lhs = self.regs[ins.a & _REG_MASK]
                    rhs = self._full(ins.imm) if ins.flags & FLAG_IMMB \
                        else self.regs[ins.b & _REG_MASK]
                    take = p & (_alu_static(ins.d, lhs, rhs) != 0)
                tgt = pc + 1 + ins.imm2
                pred = pred & ~take
                if tgt < hi:
                    resume[tgt] = resume.get(tgt, self._false()) | take
                else:
                    escapes[tgt] = escapes.get(tgt, self._false()) | take
                pc += 1
                continue

            self.steps = self.steps + p.to(_I64)
            if ins.op in (Op.NOP, Op.WAIT):
                pass                     # WAIT has no functional effect
            elif ins.op == Op.MOVI:
                self._movi(ins, p)
            elif ins.op == Op.ALU:
                self._alu(ins, p)
            elif ins.op == Op.LOAD:
                self._load(ins, p, pc)
            elif ins.op == Op.STORE:
                self._store(ins, p, pc)
            elif ins.op == Op.MEMCPY:
                self._memcpy(ins, p, pc)
            elif ins.op == Op.CAS:
                self._atomic(ins, p, pc, True)
            elif ins.op == Op.CAA:
                self._atomic(ins, p, pc, False)
            elif ins.op == Op.RET:
                self.ret = torch.where(p, self.regs[ins.a & _REG_MASK],
                                       self.ret)
                self.status = torch.where(p, self._full(ins.imm),
                                          self.status)
                self.halted = self.halted | p
            else:
                raise CompileError(f"pc {pc}: unsupported opcode {ins.op}")
            pc += 1
        return escapes


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _finalize_fault(tracer: _Tracer):
    """Reduce the pending per-site fault lanes to (pc, opcode, addr,
    dev) rows and apply STATUS_PROT_FAULT once.  A faulting lane halts
    at its first fault, so the per-site lane masks are mutually
    exclusive and every latched column is a plain masked sum.  (A
    latched fault also implies the lane halted before any RET could
    retire it, so the single status override is equivalent to a
    per-site status write.)"""
    B, dev = tracer.B, tracer.dev
    zero = torch.zeros(B, dtype=_I64, device=dev)
    if not tracer.pending:
        return tracer.status, torch.stack([zero - 1, zero, zero, zero],
                                          dim=1)
    site, addr, devp, aux = zero, zero, zero, zero
    for k, f, a, d, x in tracer.pending:
        fi = f.to(_I64)
        site = site + fi * (k + 1)
        addr = addr + fi * a
        if d is not None:
            devp = devp + fi * d
        if x is not None:
            aux = aux + fi * x
    site = site - 1
    pc_t, op_t, dev_t, kind_t = (
        torch.as_tensor(np.asarray(col, np.int64), device=dev)
        for col in zip(*tracer.sites))
    sidx = site.clamp(min=0)
    pcs, opv, devc = pc_t[sidx], op_t[sidx], dev_t[sidx]
    kind = kind_t[sidx]
    chain = kind != 0
    # fused sites latch the faulting body-instruction index k* in `aux`;
    # body starts at loop_pc + 1, so the faulting pc is loop_pc + k*,
    # and the opcode follows from the shape (gather chain: k*=3 is the
    # MEMCPY; scatter-reduce: k*=2 is the CAA; map/zip loop: the STORE
    # sits at k*=3/4; everything earlier is a LOAD)
    f_pc = torch.where(chain, pcs + aux, pcs)
    o_load, o_mcpy = zero + int(Op.LOAD), zero + int(Op.MEMCPY)
    o_caa, o_store = zero + int(Op.CAA), zero + int(Op.STORE)
    fused_op = torch.where(
        kind == 1, torch.where(aux == 3, o_mcpy, o_load),
        torch.where(kind == 2,
                    torch.where(aux == 2, o_caa, o_load),
                    torch.where(aux == torch.where(kind == 4, zero + 4,
                                                   zero + 3),
                                o_store, o_load)))
    f_op = torch.where(chain, fused_op, opv)
    f_dev = torch.where(devc == _DEV_LATCHED, devp,
                        torch.where(devc == _DEV_HOME, tracer.homes, devc))
    faulted = site >= 0
    status = torch.where(faulted, zero + isa.STATUS_PROT_FAULT,
                         tracer.status)
    fault = torch.stack([torch.where(faulted, f_pc, zero - 1),
                         torch.where(faulted, f_op, zero), addr,
                         torch.where(faulted, f_dev, zero)], dim=1)
    return status, fault


def build_compiled(op: VerifiedOperator, regions: RegionTable,
                   n_devices: int, batch: int, *, impl: str = "auto",
                   superops: bool = True, double_buffer: bool = False,
                   protect: bool = True, check_failed: bool = True,
                   noconflict: bool = False,
                   unroll_limit: int = DEFAULT_UNROLL_LIMIT):
    """Trace-compile a verified operator; returns
    ``f(mem, params, homes, failed) -> vm.VMResult`` with batched fields
    (the same signature as :func:`vm.build_batched_vm`).  ``mem`` is a
    pool tensor; it is never mutated.

    ``impl``: "cuda" runs the gather-chain row gather on the
    ``tiara_gather`` CUDA kernel; "torch" on its plain version, which
    takes CPU pools only; "auto" takes the kernel when the pool lies on a
    CUDA device and the plain version otherwise.

    ``double_buffer``: emit gather-chain superoperators as a chunked
    schedule (the compiled analogue of the operator's async Memcpy
    pipelining): one row gather per chunk.  Bit-identical results.

    ``check_failed=False`` statically elides every failed-device check
    (the ``failed`` argument is accepted and ignored) — the variant the
    invoke path builds for the fault-free hot path.

    ``noconflict=True`` asserts the caller holds a registration-time
    proof (``access.prove_wave_noconflict``) that no word written by one
    request is touched by another in the waves this engine will run.
    It unlocks the scatter-reduce superoperator fusion, whose
    snapshot-read lowering is exact only under that proof.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    reason = why_not_compilable(op, unroll_limit)
    if reason is not None:
        raise CompileError(reason)
    instrs = isa.decode_program(op.code)
    loops = {l.pc: l for l in op.loops}
    base, mask, _ = regions.as_arrays()
    n_instr = len(instrs)
    n_dev = int(n_devices)
    B = int(batch)

    def run(mem, params, homes, failed):
        dev = mem.device
        pool_words = int(mem.shape[1])
        homes = torch.as_tensor(homes, dtype=_I64, device=dev).reshape(B)
        failed = torch.as_tensor(failed, dtype=torch.bool, device=dev)
        params = torch.as_tensor(params, dtype=_I64, device=dev) \
            .reshape(B, -1)
        zero = torch.zeros(B, dtype=_I64, device=dev)
        regs = [params[:, i] if i < params.shape[1] else zero
                for i in range(isa.NUM_REGS)]
        memx = _vm.private_pool(mem)
        tracer = _Tracer(
            instrs=instrs, loops=loops, base=base, mask=mask, n_dev=n_dev,
            pool_words=pool_words, batch=B, homes=homes, failed=failed,
            memx=memx, regs=regs, impl=impl, superops=superops,
            double_buffer=double_buffer, protect=protect,
            check_failed=check_failed, noconflict=noconflict)
        esc = tracer.emit_segment(
            0, n_instr, torch.ones(B, dtype=torch.bool, device=dev))
        assert not esc, "verifier admitted a jump past the program end"
        status, fault = _finalize_fault(tracer)
        return _vm.VMResult(
            mem=tracer.memf[:-1].view(n_dev, pool_words),
            ret=tracer.ret, status=status, steps=tracer.steps,
            regs=torch.stack(tracer.regs, dim=1), fault=fault)

    return run


_COMPILED_CACHE: Dict = {}


def compiled_cached(op: VerifiedOperator, regions: RegionTable,
                    n_dev: int, batch: int, impl: str = "auto",
                    superops: bool = True, double_buffer: bool = False,
                    protect: bool = True,
                    failed: Optional[Set[int]] = None,
                    noconflict: bool = False) -> bool:
    """True iff the compiled trace for this (op, batch) is already
    built (see :func:`vm.engine_cached`).  ``failed`` mirrors the invoke
    argument: the fault-free hot path (``failed=None``) and the
    degraded-mode path build different variants."""
    return _vm.engine_key(op, regions, n_dev, batch, impl, superops,
                          double_buffer, bool(protect),
                          failed is not None,
                          bool(noconflict)) in _COMPILED_CACHE


def _cached_compiled(op: VerifiedOperator, regions: RegionTable, n_dev: int,
                     batch: int, impl: str, superops: bool,
                     double_buffer: bool = False, protect: bool = True,
                     check_failed: bool = True, noconflict: bool = False):
    key = _vm.engine_key(op, regions, n_dev, batch, impl, superops,
                         double_buffer, bool(protect), bool(check_failed),
                         bool(noconflict))
    fn = _COMPILED_CACHE.get(key)
    if fn is None:
        fn = build_compiled(op, regions, n_dev, batch, impl=impl,
                            superops=superops, double_buffer=double_buffer,
                            protect=protect, check_failed=check_failed,
                            noconflict=noconflict)
        _COMPILED_CACHE[key] = fn
    return fn


def invoke_compiled(op: VerifiedOperator, regions: RegionTable,
                    mem, params: Sequence[Sequence[int]],
                    *, homes: Union[int, Sequence[int]] = 0,
                    failed: Optional[Set[int]] = None, impl: str = "auto",
                    superops: bool = True, double_buffer: bool = False,
                    protect: bool = True, noconflict: bool = False,
                    block: bool = True,
                    device=None) -> "_vm.BatchedInvokeResult":
    """Batched execution on the compiled fast path (same contract as
    :func:`vm.invoke_batched`).  ``failed=None`` selects the variant with
    every failed-device check statically elided.  ``noconflict=True``
    asserts the wave conflict proof (see :func:`build_compiled`)."""
    p, h = _vm._marshal_batch(params, homes)
    mem_t = _vm.as_pool(mem, device)
    fn = _cached_compiled(op, regions, int(mem_t.shape[0]), p.shape[0],
                          impl, superops, double_buffer, protect,
                          check_failed=failed is not None,
                          noconflict=noconflict)
    return _vm.run_batched_fn(fn, mem_t, p, h, failed, block=block)
