"""A seeded corpus of lockstep waves, to hold the ``lockstep_vm`` kernel
to its plain version, the lockstep engine's host loop, bit for bit.

Each :class:`Wave` is everything one engine run takes: the merged
instruction store and its step bounds, the region table, a populated
pool, and the wave's params, programs, homes and failed devices.  The
corpus covers every stock operator (``PagedKVFetch`` and
``MoEExpertGather`` with ``remote_reply=True`` among them), a contended
CAS lock wave (serialized macro-steps), the fault-table rows as single
requests, batches and mixed waves (a wild device register, an
out-of-region offset, a word op on a failed device, MEMCPY to and from a
failed device), a program run with fuel below its verified bound, zero-
trip and nested loops, and random verified operators drawn from a seed
with numpy by the strategy of the reference's property tests
(:func:`random_operator`), at batch sizes from 1 to past 1024.

Nothing here launches anything: ``Wave.engine()`` builds the engine, and
the caller runs it on the device it chooses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import memory, operators, vm
from repro_torch.core.isa import Alu
from repro_torch.core.memory import Grant, RegionTable, packed_table
from repro_torch.core.program import OperatorBuilder, TiaraProgram
from repro_torch.core.verifier import (VerificationError, VerifiedOperator,
                                       verify)

#: the batch sizes of the stock and random waves: one request, a ragged
#: few, a warp pair, the acceptance wave's 1024 and one past it
SIZES = (1, 7, 64, 1024, 1500)


@dataclasses.dataclass
class Wave:
    name: str
    ops: List[VerifiedOperator]
    regions: RegionTable
    mem: np.ndarray                  # (n_dev, pool_words) int64
    params: np.ndarray               # (B, k) int64
    op_sel: np.ndarray               # (B,) int64
    homes: np.ndarray                # (B,) int64
    failed: np.ndarray               # (n_dev,) bool
    protect: bool = True
    static_noconflict: bool = False
    fuels: Optional[List[int]] = None   # the step bounds unless given

    @property
    def B(self) -> int:
        return int(self.params.shape[0])

    @property
    def n_dev(self) -> int:
        return int(self.mem.shape[0])

    def engine(self, impl: str = "auto"):
        fuels = self.fuels if self.fuels is not None else \
            [o.step_bound for o in self.ops]
        return vm._build_engine([o.code for o in self.ops], fuels,
                                self.regions, self.n_dev, self.B,
                                protect=self.protect,
                                static_noconflict=self.static_noconflict,
                                impl=impl)

    def args(self):
        """``(params, homes, failed, op_sel)`` as an engine call takes
        them after the pool."""
        return self.params, self.homes, self.failed, self.op_sel


def _wave(name, ops, rt, mem, params, *, op_sel=None, homes=None,
          failed=(), **kw) -> Wave:
    params = np.asarray(params, dtype=np.int64)
    if params.ndim == 1:
        params = params[:, None]
    B = params.shape[0]
    n_dev = mem.shape[0]
    fmask = np.zeros(n_dev, dtype=bool)
    fmask[list(failed)] = True
    return Wave(name=name, ops=list(ops), regions=rt, mem=mem,
                params=params,
                op_sel=np.zeros(B, np.int64) if op_sel is None
                else np.asarray(op_sel, np.int64),
                homes=np.zeros(B, np.int64) if homes is None
                else np.asarray(homes, np.int64),
                failed=fmask, **kw)


def _verify(prog: TiaraProgram, rt: RegionTable) -> VerifiedOperator:
    return verify(prog, grant=Grant.all_of(rt), regions=rt)


# ---------------------------------------------------------------------------
# random verified operators (the reference's tests/test_vm_properties.py
# strategy, drawn with numpy)
# ---------------------------------------------------------------------------

RANDOM_REGIONS = [("r0", 64), ("r1", 32), ("ro", 16)]


def random_table() -> RegionTable:
    return packed_table(RANDOM_REGIONS)


def random_operator(rng: np.random.Generator, rt: RegionTable, *,
                    nested: bool = False) -> TiaraProgram:
    """A random structurally valid operator: straight-line ALU and memory
    instructions, an optional bounded loop with a conditional break, and
    a final RET.  Offsets and values are unconstrained int64.  With
    ``nested`` the loop may hold a second loop, with a trip count from a
    register (possibly zero or negative), and a break out of both."""
    b = OperatorBuilder("rand", n_params=4, regions=rt)
    regs = [b.reg() for _ in range(4)]

    def pick(seq):
        return seq[int(rng.integers(len(seq)))]

    def ints(lo, hi):
        return int(rng.integers(lo, hi, endpoint=True))

    def rand_instr():
        kind = pick(["movi", "alu", "load", "store", "memcpy", "cas"])
        r = pick(regs)
        a = pick(regs + list(b.params))
        region = pick(["r0", "r1", "ro"])
        wregion = pick(["r0", "r1"])
        if kind == "movi":
            b.movi(r, ints(-2**40, 2**40))
        elif kind == "alu":
            op = pick([Alu.ADD, Alu.SUB, Alu.MUL, Alu.XOR, Alu.SHL,
                       Alu.SHR, Alu.MIN])
            b.alu(r, a, op, pick(regs + [ints(-63, 63)]))
        elif kind == "load":
            b.load(r, region, a, ints(0, 8))
        elif kind == "store":
            b.store(r, wregion, a)
        elif kind == "memcpy":
            b.memcpy(dst_region=wregion, dst_off=r, src_region=region,
                     src_off=a, n_words=ints(1, 16),
                     is_async=bool(rng.integers(2)))
        else:
            b.cas(r, wregion, a, pick(regs), pick(regs))

    for _ in range(ints(1, 4)):
        rand_instr()
    if rng.integers(2):
        brk = b.mklabel("brk")
        with b.loop(ints(0, 5)):
            for _ in range(ints(1, 3)):
                rand_instr()
            if nested and rng.integers(2):
                with b.loop((pick(regs + list(b.params)), ints(1, 4))):
                    rand_instr()
                    if rng.integers(2):
                        b.jump(brk, pick(regs), Alu.LT, ints(-2, 2))
            if rng.integers(2):
                b.jump(brk, regs[0], Alu.EQ, ints(-2, 2))
            b.nop()
        b.bind(brk)
    if rng.integers(2):
        b.wait(0)
    b.ret(regs[0])
    return b.build()


def random_waves(seed: int, n_waves: int, sizes: Sequence[int],
                 *, n_programs: int = 4) -> List[Wave]:
    """Waves of random operators: each wave merges ``n_programs`` of them
    and picks one per lane, over a pool of two device rows of random
    words; the waves alternate ``protect`` and the batch sizes cycle
    through ``sizes``.  Small random offsets make the lanes meet, so
    many macro-steps serialize."""
    rng = np.random.default_rng(seed)
    rt = random_table()
    grant = Grant.of("t", readable=[0, 1, 2], writable=[0, 1])
    out = []
    for w in range(n_waves):
        progs = []
        while len(progs) < n_programs:
            try:
                progs.append(verify(random_operator(rng, rt,
                                                    nested=w % 2 == 1),
                                    grant=grant, regions=rt))
            except VerificationError:
                continue
        B = int(sizes[w % len(sizes)])
        mem = rng.integers(-2**40, 2**40,
                           size=(2, rt.pool_words)).astype(np.int64)
        # half the waves draw offsets inside the regions, so lanes read,
        # write and copy for real instead of faulting at once
        hi = 2**50 if w % 4 < 2 else 96
        params = rng.integers(-hi if hi > 96 else 0, hi,
                              size=(B, 4)).astype(np.int64)
        out.append(_wave(f"random {w} (B={B})", progs, rt, mem, params,
                         op_sel=rng.integers(n_programs, size=B),
                         homes=rng.integers(2, size=B),
                         protect=w % 2 == 0))
    return out


# ---------------------------------------------------------------------------
# the stock operators
# ---------------------------------------------------------------------------

def stock_waves(B: int, *, block_bytes: int = 8192, seed: int = 0,
                serialized: bool = True) -> List[Wave]:
    """Every stock operator of ``core/operators.py`` in a wave of ``B``
    requests, each into its own reply slot; ``PagedKVFetch`` and
    ``MoEExpertGather`` also with ``remote_reply=True`` (every block
    streams to device row 1), and ``DistLock`` with all lanes contending
    on one latch.  ``serialized=False`` leaves out the two waves whose
    lanes meet (the lock, and ``NSASelect``'s shared reply region), whose
    every macro-step the host loop runs one lane at a time."""
    rng = np.random.default_rng(seed + B)
    out = []
    ops = operators
    # graph walk: depth-6 chases from scattered starts
    gw = ops.GraphWalk(n_nodes=256, max_depth=8, reply_words=8 * B)
    rt = gw.regions()
    mem = memory.make_pool(1, rt)
    order = gw.populate(mem, rt, seed=seed)
    params = [[int(order[(7 * i) % 256]) * 8, 2 + i % 7, 8 * i]
              for i in range(B)]
    out.append(_wave(f"graph_walk (B={B})",
                     [_verify(gw.build(rt, reply_param=True), rt)], rt,
                     mem, params))
    # three-level page-table walks
    pt = ops.PageTableWalk(fanout=8, n_pages=16, reply_pages=B)
    rt = pt.regions()
    mem = memory.make_pool(1, rt)
    vas = sorted(pt.populate(mem, rt, seed=seed))
    params = [[vas[i % len(vas)], ops.PAGE_WORDS * i] for i in range(B)]
    out.append(_wave(f"ptw3 (B={B})",
                     [_verify(pt.build(rt, reply_param=True), rt)], rt,
                     mem, params))
    # the contended lock: every lane CASes latch 0
    lk = ops.DistLock(max_retries=4)
    rt = lk.regions()
    mem = memory.make_pool(2, rt)
    params = [[0, 1, 100 + i, 1, 2 + i % 8, 1, 10 + i % 8]
              for i in range(B)]
    if serialized:
        out.append(_wave(f"dist_lock contended (B={B})",
                         [_verify(lk.build(rt), rt)], rt, mem, params,
                         homes=np.zeros(B, np.int64)))
    # paged KV fetch of 4 blocks a request, local and to a remote reply
    nb = 4
    kv = ops.PagedKVFetch(n_blocks_pool=64, block_bytes=block_bytes,
                          max_req_blocks=nb, reply_slots=B)
    rt = kv.regions()
    mem = memory.make_pool(2, rt)
    kv.populate(mem, rt, seed=seed)
    kv.make_request(mem, rt, [int(x) for x in rng.permutation(64)[:nb]])
    slot = nb * kv.block_words
    params = [[1 + i % nb, i * slot] for i in range(B)]
    out.append(_wave(f"paged_kv_fetch (B={B})",
                     [_verify(kv.build(rt, reply_param=True), rt)], rt,
                     mem, params))
    params = [[1 + i % nb, 1, i * slot] for i in range(B)]
    out.append(_wave(f"paged_kv_fetch remote_reply (B={B})",
                     [_verify(kv.build(rt, remote_reply=True,
                                       reply_param=True), rt)], rt,
                     mem.copy(), params))
    # MoE expert gather, local and to a remote reply
    moe = ops.MoEExpertGather(n_experts=16, max_k=4, slab_words=32,
                              reply_slots=B)
    rt = moe.regions()
    mem = memory.make_pool(2, rt)
    moe.populate(mem, rt, seed=seed)
    memory.write_region(mem, rt, 0, "expert_ids", [9, 0, 5, 2])
    params = [[1 + i % 4, i * 4 * 32] for i in range(B)]
    out.append(_wave(f"moe_expert_gather (B={B})",
                     [_verify(moe.build(rt, reply_param=True), rt)], rt,
                     mem, params))
    params = [[1 + i % 4, 1, i * 4 * 32] for i in range(B)]
    out.append(_wave(f"moe_expert_gather remote_reply (B={B})",
                     [_verify(moe.build(rt, remote_reply=True,
                                        reply_param=True), rt)], rt,
                     mem.copy(), params))
    # NSA select: data-dependent fetches (one shared reply region, so the
    # lanes' copies meet)
    if serialized:
        nsa = ops.NSASelect(n_scores=16, block_words=64)
        rt = nsa.regions()
        mem = memory.make_pool(1, rt)
        nsa.populate(mem, rt, seed=seed)
        params = [[1 + i % 16, 20 + (13 * i) % 70] for i in range(B)]
        out.append(_wave(f"nsa_select (B={B})",
                         [_verify(nsa.build(rt), rt)], rt, mem, params))
    return out


def mixed_stock_wave(B: int, *, seed: int = 0, locks: bool = True) -> Wave:
    """One mixed wave over a merged table of five stock operators (the
    reference tests' merged wave, widened): lanes cycle through the
    programs, the lock lanes contend (``locks=False``: the lock's lanes
    run the graph walk instead)."""
    ops = operators
    gw = ops.GraphWalk(n_nodes=64, max_depth=6, reply_words=8 * B)
    ptw = ops.PageTableWalk(fanout=8, n_pages=8, reply_pages=B)
    lk = ops.DistLock(max_retries=2)
    kv = ops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                          max_req_blocks=4, reply_slots=B)
    moe = ops.MoEExpertGather(n_experts=16, max_k=4, slab_words=32,
                              reply_slots=B)
    rt, views = memory.merge_tables([
        ("gw", gw.regions()), ("ptw", ptw.regions()), ("lk", lk.regions()),
        ("kv", kv.regions()), ("moe", moe.regions())])
    mem = memory.make_pool(2, rt)
    order = gw.populate(mem, views["gw"], seed=seed + 1)
    vas = sorted(ptw.populate(mem, views["ptw"], seed=seed + 2))
    kv.populate(mem, views["kv"], seed=seed + 3)
    kv.make_request(mem, views["kv"], [3, 8, 1, 15])
    moe.populate(mem, views["moe"], seed=seed + 4)
    memory.write_region(mem, views["moe"], 0, "expert_ids", [9, 0, 5, 2])
    progs = [gw.build(views["gw"], reply_param=True),
             ptw.build(views["ptw"], reply_param=True),
             lk.build(views["lk"]),
             kv.build(views["kv"], reply_param=True),
             moe.build(views["moe"], reply_param=True)]
    vops = [_verify(p, rt) for p in progs]
    sel = np.arange(B) % 5
    if not locks:
        sel[sel == 2] = 0
    params = np.zeros((B, 7), np.int64)
    for i, s in enumerate(sel):
        row = ([int(order[i % 64]) * 8, 1 + i % 6, 8 * i], [vas[i % len(vas)],
               ops.PAGE_WORDS * i], [0, 1, 77 + i, 1, 2, 1, 3],
               [1 + i % 4, 4 * kv.block_words * i], [1 + i % 4, 128 * i])[s]
        params[i, :len(row)] = row
    return _wave(f"mixed stock{'' if locks else ', no lock'} (B={B})", vops,
                 rt, mem, params, op_sel=sel, homes=np.arange(B) % 2)


def resolver_wave(n_slots: int = 8, pages: int = 128,
                  n_pages: int = 1024, *, seed: int = 0) -> Wave:
    """The serving resolver's wave at tiny-lm's geometry in the chip
    smoke: one tenant per slot, each with its own ``PagedKVFetch`` at
    descriptor granularity (one 8-byte word per page) built with
    ``remote_reply=True``, every slot asking for its whole table of
    ``pages`` pages: one lane per tenant, a few hundred macro-steps of
    one-word MEMCPYs."""
    kv = operators.PagedKVFetch(n_blocks_pool=n_pages, block_bytes=8,
                                max_req_blocks=pages)
    rt, views = memory.merge_tables(
        [(f"seq{i}", kv.regions()) for i in range(n_slots)])
    mem = memory.make_pool(1, rt)
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_slots):
        v = views[f"seq{i}"]
        memory.write_region(mem, v, 0, "req", np.arange(pages))
        memory.write_region(mem, v, 0, "blocktable",
                            rng.permutation(n_pages)[:pages])
        memory.write_region(mem, v, 0, "kvpool", np.arange(n_pages))
        ops.append(_verify(kv.build(v, remote_reply=True), rt))
    return _wave(f"resolver wave ({n_slots} tenants x {pages} pages)", ops,
                 rt, mem, [[pages, 0]] * n_slots,
                 op_sel=np.arange(n_slots))


# ---------------------------------------------------------------------------
# fault rows, fuel, loops
# ---------------------------------------------------------------------------

def _fault_table():
    return packed_table([("data", 256), ("reply", 256)])


def _fault_ops(rt: RegionTable) -> List[VerifiedOperator]:
    """``wload``: reply[p1] = data[p0] read on device p2 (a device
    register); ``rcpy``/``arcpy``: an 8-word MEMCPY from data[0] on
    device p0 to reply[p1], sync and async; ``wcpy``: the same to
    device p0."""
    out = []
    b = OperatorBuilder("wload", n_params=3, regions=rt)
    x = b.reg()
    b.load(x, "data", b.param(0), dev=b.param(2))
    b.store(x, "reply", b.param(1))
    b.ret(x)
    out.append(b.build())
    for name, is_async, side in (("rcpy", False, "src_dev"),
                                 ("arcpy", True, "src_dev"),
                                 ("wcpy", False, "dst_dev")):
        b = OperatorBuilder(name, n_params=2, regions=rt)
        zero = b.const(0)
        b.memcpy(dst_region="reply", dst_off=b.param(1), src_region="data",
                 src_off=zero, n_words=8, is_async=is_async,
                 **{side: b.param(0)})
        if is_async:
            b.wait(0)
        b.ret(b.err)
        out.append(b.build())
    return [_verify(p, rt) for p in out]


def fault_waves() -> List[Wave]:
    """The fault-table rows, each as one request (the interp engine), a
    batch of 8 with the faulting lanes at 2 and 5, and a mixed wave with
    MEMCPYs beside them: a wild device register, an out-of-region
    offset, a word op on a failed device, and MEMCPY from and to a
    failed device (``ERR_REG``, no copy)."""
    rt = _fault_table()
    ops = _fault_ops(rt)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 1 << 40, size=(2, rt.pool_words)).astype(
        np.int64)
    out = []
    rows = {"wild device register": (dict(dev=7), ()),
            "out-of-region offset": (dict(off=256 + 5), ()),
            "failed device word op": (dict(dev=1), (1,))}
    for kind, (bad, failed) in rows.items():
        def wl(k, bad_lane):
            if bad_lane:
                return [bad.get("off", k), 8 * k, bad.get("dev", 0)]
            return [k, 8 * k, 0 if failed else k % 2]
        out.append(_wave(f"{kind} / interp", [ops[0]], rt, base.copy(),
                         [wl(0, True)], failed=failed))
        params = [wl(k, k in (2, 5)) for k in range(8)]
        out.append(_wave(f"{kind} / batched", [ops[0]], rt, base.copy(),
                         params, failed=failed))
        # beside them: a MEMCPY from device 1, an async one from device
        # 0, and one to device 1
        sel = [0] * 8 + [1, 2, 3]
        params = [p + [0] * (3 - len(p)) for p in
                  params + [[1, 128], [0, 136], [1, 144]]]
        out.append(_wave(f"{kind} / mixed", ops, rt, base.copy(), params,
                         op_sel=sel, homes=np.arange(11) % 2,
                         failed=failed))
    for k, name in ((1, "rcpy"), (2, "arcpy"), (3, "wcpy")):
        params = [[1, 8 * j] if j % 2 else [0, 8 * j] for j in range(6)]
        out.append(_wave(f"MEMCPY with a failed device / {name}",
                         [ops[k]], rt, base.copy(), params, failed=(1,)))
    return out


def loop_waves() -> List[Wave]:
    """Zero-trip, register-counted and nested loops (three deep, with a
    break out of two of them), and the same program run with fuel below
    its verified bound (``STATUS_FUEL``)."""
    rt = packed_table([("acc", 64)])
    b = OperatorBuilder("loops", n_params=3, regions=rt)
    n0, n1, n2 = b.params[:3]
    acc, i, t = b.const(0), b.const(0), b.reg()
    brk = b.mklabel("brk")
    with b.loop(0):                                  # zero trips
        b.add(acc, acc, 1000)
    with b.loop((n0, 4)):                            # from a register
        b.add(acc, acc, 1)
        with b.loop((n1, 3)):
            b.add(acc, acc, 10)
            with b.loop((n2, 3)):
                b.add(i, i, 1)
                b.band(t, i, 63)
                b.store(acc, "acc", t)
                b.jump(brk, i, Alu.GE, 9)            # out of the inner two
            b.nop()
        b.bind(brk)
        b.add(acc, acc, 100)
    b.ret(acc)
    op = _verify(b.build(), rt)
    mem = memory.make_pool(1, rt)
    params = [[n0, n1, n2] for n0 in (0, 1, 4, -3) for n1 in (0, 2, 3)
              for n2 in (0, 1, 3, 7)]
    out = [_wave("zero-trip and nested loops", [op], rt, mem, params,
                 static_noconflict=False)]
    # each lane alone, so the stores never meet
    out += [_wave(f"nested loops, one lane {p}", [op], rt, mem.copy(), [p])
            for p in ([4, 3, 7], [1, 2, 3], [4, 0, 3])]
    long_runs = [p for p in params if p[0] == 4]
    out.append(_wave("fuel below the verified bound", [op], rt, mem.copy(),
                     long_runs, fuels=[op.step_bound // 3]))
    return out


#: the largest batch at which the corpus holds waves whose lanes meet
SERIAL_MAX_B = 64


def corpus(*, sizes: Sequence[int] = SIZES, n_random: int = 48,
           seed: int = 0, block_bytes: int = 8192,
           resolver: bool = True) -> List[Wave]:
    """The whole corpus: the stock operators at every size in ``sizes``
    (the waves whose lanes meet up to ``SERIAL_MAX_B`` lanes), a mixed
    stock wave with contending locks at the largest size up to that and
    one without at the largest, the fault rows, the loops and fuel, and
    ``n_random`` random waves at the sizes up to ``SERIAL_MAX_B`` (their
    lanes meet in small regions), and with ``resolver`` the serving
    resolver's wave (:func:`resolver_wave`).  The host loop serializes a whole
    macro-step when two lanes meet, so it holds the serialized waves in
    seconds only at a few dozen lanes."""
    sizes = [int(B) for B in sizes]
    small = [B for B in sizes if B <= SERIAL_MAX_B] or [min(sizes)]
    out: List[Wave] = []
    for B in sizes:
        out += stock_waves(B, block_bytes=block_bytes, seed=seed,
                           serialized=B <= SERIAL_MAX_B)
    out.append(mixed_stock_wave(max(small), seed=seed))
    if max(sizes) > max(small):
        out.append(mixed_stock_wave(max(sizes), seed=seed, locks=False))
    out += fault_waves()
    out += loop_waves()
    out += random_waves(seed, n_random, small)
    if resolver:
        out.append(resolver_wave(seed=seed))
    return out


__all__ = ["Wave", "SIZES", "SERIAL_MAX_B", "corpus", "stock_waves",
           "mixed_stock_wave", "resolver_wave",
           "fault_waves", "loop_waves", "random_waves", "random_operator",
           "random_table"]
